#!/usr/bin/env python3
"""Time text variants of the intra and half-pel luma kernels on the card.

    python3 tools/kernel_variants.py [--rounds N]

Each variant is csrc/<source>.cu with a few text replacements (VARIANTS
below), built with the flags of kernels/_build.py into a temporary
directory and put in place of the package's library, so the package's
wrapper launches it. On the bench inputs chip_smoke.py uses (the intra
kernel on the first P frame of assets/bench_1080p.264, the half-pel luma
kernel on the encoder's first P-VOP at 1280x720), every variant must
equal the plain version bit for bit (the run fails otherwise); then the
device time of each (the
median of 25 calls, chip_smoke.device_ms) is taken in turns, base first
and last, N rounds (default 2), with each variant's SASS instruction
count (tools/kernel_resources.py). Needs a CUDA card; the last line is
one JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

_SPIN = "  while (!(*p & 1)) __nanosleep(16);"
_WARPS = "constexpr int WARPS = 16;"
_MBS = "constexpr int MBS = 4;"
_SAD = "sad[d] = (int)__sad(cv[q], hp[2 * q + d], (unsigned)sad[d]);"

_PACK = r'''
// the low bytes of four ints, as one word
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

__device__ __forceinline__ void add_row(const int (&hp)[19],
                                        const int (&cv)[8], int* sad) {
  const uint32_t cw[2] = {pack4(cv[0], cv[1], cv[2], cv[3]),
                          pack4(cv[4], cv[5], cv[6], cv[7])};
  // the even and the odd half-pel samples, 4 to a word
  const uint32_t e[3] = {pack4(hp[0], hp[2], hp[4], hp[6]),
                         pack4(hp[8], hp[10], hp[12], hp[14]),
                         pack4(hp[16], hp[18], 0, 0)};
  const uint32_t o[3] = {pack4(hp[1], hp[3], hp[5], hp[7]),
                         pack4(hp[9], hp[11], hp[13], hp[15]),
                         pack4(hp[17], 0, 0, 0)};
#pragma unroll
  for (int d = 0; d < 5; ++d) {
    const uint32_t* s = (d & 1) ? o : e;
    const int k = d >> 1;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const uint32_t w = k ? __funnelshift_r(s[g], s[g + 1], 8 * k) : s[g];
      sad[d] += (int)__vsadu4(cw[g], w);
    }
  }
}
'''


# the alternatives to the committed sources that were measured (PERF.md)
VARIANTS = {
    "intra": {
        "spin": [(_SPIN, "  while (!(*p & 1)) {\n  }")],
        "sleep100": [(_SPIN, "  while (!(*p & 1)) __nanosleep(100);")],
        "warps8": [(_WARPS, "constexpr int WARPS = 8;")],
        "warps32": [(_WARPS, "constexpr int WARPS = 32;")],
    },
    "hpel": {
        "plain_abs": [(_SAD, "sad[d] += abs(cv[q] - hp[2 * q + d]);")],
        "packed_sad": ["packed_sad"],
        "mbs1": [(_MBS, "constexpr int MBS = 1;")],
        "mbs2": [(_MBS, "constexpr int MBS = 2;")],
        "mbs8": [(_MBS, "constexpr int MBS = 8;")],
    },
}


def apply(src: str, reps) -> str:
    for rep in reps:
        if rep == "packed_sad":
            # add_row with __vsadu4 on byte strings in place of __sad
            i = src.index("// SAD terms of one half-pel row")
            j = src.index("__global__ void __launch_bounds__(MBS * 32)")
            src = src[:i] + _PACK.lstrip() + "\n" + src[j:]
        else:
            old, new = rep
            assert old in src, old
            src = src.replace(old, new)
    return src


def build(name: str, label: str, src: str, tmp: str):
    from librempeg_tpu_torch.kernels import _build

    path = os.path.join(tmp, f"{name}-{label}.cu")
    with open(path, "w") as f:
        f.write(src)
    so = path[:-3] + ".so"
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", so, path], check=True, capture_output=True)
    return ctypes.CDLL(so), path


def sass_count(name: str, path: str, tmp: str) -> int:
    import kernel_resources as KR

    want = "intra_kernel" if name == "intra" else "refine_luma_kernel"
    res = KR.resources(os.path.basename(path)[:-3], tmp, path)
    return next(r["sass"] for fn, r in res.items() if want in fn)


def inputs():
    import chip_smoke as CS
    from librempeg_tpu_torch.codecs.h264 import device_recon as DR
    from librempeg_tpu_torch.codecs.h264 import intra_pallas as IP
    from librempeg_tpu_torch.codecs.h264 import mc_pallas as MC

    args, frames = CS.capture_p_frame("cuda")
    (idx, vals, qp, kind, info, i4m, ilist, mv, ref, luma4, upad, vpad,
     mb_w, mb_h, cqo, _, _, _, _) = args
    pred = MC.mc_predict(luma4, upad, vpad, mv, ref, mb_w, mb_h)
    y, u, v, lres_t, cres_t = DR.recon_p_frame_pred_noscan(
        *pred, idx, vals, qp, kind, mb_w, mb_h, cqo, fold_i16=True)
    scal = IP.build_intra_scalars(ilist, kind, info, i4m, mb_w, mb_h)
    return ((y, u, v), scal, lres_t, cres_t, mb_w, mb_h), \
        CS.hpel_inputs("cuda", frames)


def runner(name, intra_in, hpel_in):
    """(run, restore, check) of one kernel on its bench inputs; "intra1":
    the intra kernel on the first entry of the list only (the launch,
    the set-up and one step)."""
    import torch

    from librempeg_tpu_torch.codecs.h264 import intra_pallas as IP
    from librempeg_tpu_torch.codecs.mpeg4 import me_pallas as MEP
    from librempeg_tpu_torch.kernels import intra as KI

    if name in ("intra", "intra1"):
        planes, scal, lres_t, cres_t, mb_w, mb_h = intra_in
        if name == "intra1":
            scal = scal[:1].contiguous()
        want = IP.intra_scan_plain(*planes, scal, lres_t, cres_t, mb_w, mb_h)
        work = [p.clone() for p in planes]

        def restore():
            for w, p in zip(work, planes):
                w.copy_(p)

        def run():
            KI.launch(*work, scal, lres_t, cres_t, mb_w, mb_h)

        def ok():
            restore()
            run()
            return all(torch.equal(a, b) for a, b in zip(work, want))
        return run, restore, ok
    cur, ry, _, _, mv_i = hpel_in
    want = MEP.refine_mc_luma_plain(cur, ry, mv_i)

    def run():
        return MEP.refine_mc_luma(cur, ry, mv_i)

    def ok():
        return all(torch.equal(a, b) for a, b in zip(run(), want))
    return run, None, ok


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    rounds = ap.parse_args(argv).rounds
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from librempeg_tpu_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    for name in VARIANTS:
        _build.load(name)
    intra_in, hpel_in = inputs()
    out = {"device": smi}
    with tempfile.TemporaryDirectory() as tmp:
        for name, variants in VARIANTS.items():
            src = open(os.path.join(ROOT, "librempeg_tpu_torch", "csrc",
                                    f"{name}.cu")).read()
            libs = {"base": build(name, "base", src, tmp)}
            for label, reps in variants.items():
                libs[label] = build(name, label, apply(src, reps), tmp)
            res = {}
            for label, (lib, path) in libs.items():
                _build._libs[name] = lib
                res[label] = {"exact": bool(runner(name, intra_in,
                                                   hpel_in)[2]()),
                              "sass": sass_count(name, path, tmp),
                              "device_ms": []}
                if name == "intra":
                    res[label]["one_entry_exact"] = bool(
                        runner("intra1", intra_in, hpel_in)[2]())
                    res[label]["one_entry_ms"] = []
            bad = [k for k, r in res.items()
                   if not (r["exact"] and r.get("one_entry_exact", True))]
            if bad:
                raise RuntimeError(f"{name} variants differ from the plain "
                                   f"version: {bad}")
            for _ in range(rounds):
                for label in list(libs) + ["base"]:
                    _build._libs[name] = libs[label][0]
                    run, restore, _ = runner(name, intra_in, hpel_in)
                    res[label]["device_ms"].append(CS.device_ms(run, restore))
                    if name == "intra":
                        run, restore, _ = runner("intra1", intra_in, hpel_in)
                        res[label]["one_entry_ms"].append(
                            CS.device_ms(run, restore))
            for label, r in res.items():
                print(f"{name} {label}: " + ", ".join(
                    f"{k} {v}" for k, v in r.items()), flush=True)
            out[name] = res
            _build._libs.pop(name)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
