#!/usr/bin/env python3
"""Time text variants of the intra, half-pel, MC, shaper and residual
kernels on the card.

    python3 tools/kernel_variants.py [--rounds N] [--parent DIR] [SOURCE ...]

Each variant is csrc/<source>.cu with a few text replacements (VARIANTS
below; SOURCE picks some of intra, hpel, mc, shape_scan, residual,
default all), built with the flags of kernels/_build.py into a
temporary directory and put in place of the package's library, so the
package's wrappers launch it. On the bench inputs chip_smoke.py uses
(the intra, MC and residual kernels on the first P frame of
assets/bench_1080p.264, the residual kernel on its compact rows; the
half-pel kernels on the encoder's first P-VOP at 1280x720; the shaper
on one convert of the audio path: 2 x 1120 samples of
testgen.audio_mix resampled to 48 kHz in LSB units, the lipshitz
ditherer's noise, K = 5), every entry of a variant must equal its
plain version by value (the run fails otherwise); then the device time
of each entry (the median of 25 calls, chip_smoke.device_ms, and for
the entries that do not write their inputs the back-to-back time,
chip_smoke.device_ms_b2b) is taken in turns, base first and last, N
rounds (default 2), with each kernel's SASS instruction count
(tools/kernel_resources.py). The entries timed: intra (and intra1, the
first list entry alone); hpel (the fused kernel), hpel_luma and
hpel_chroma; mc; shape_scan; residual. --parent DIR adds the variant
"parent": the source of the checkout at DIR (an earlier commit,
unpacked with git archive), timed in the same turns; entries whose C
function it lacks are left out, and a parent whose C function takes
other arguments (residual before its one-launch form) cannot be timed.
The first line after the card's name is the device time of an empty
kernel by both timings (chip_smoke.floor_ms). Needs a CUDA card; the
last line is one JSON object.
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
_PREFETCH = "if (CHROMA && lane < 2 * CW)"
_WIN = "chroma_warp(cwin[warp], oyc, oxc, lane,"
_MCMBS = "constexpr int MBS = 16; "
_BYTES4 = """__device__ __forceinline__ uint32_t bytes4(const uint8_t* row, int c) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row + (c & ~3));
  return __funnelshift_r(__ldg(w), __ldg(w + 1), 8 * (c & 3));
}"""
# the bytes c .. c+n-1 of a row, the second word loaded only where they
# reach it
_ROW_BYTES = """__device__ __forceinline__ uint32_t bytes4(const uint8_t* row, int c,
                                           int n = 4) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row + (c & ~3));
  const uint32_t lo = __ldg(w);
  return (c & 3) + n > 4 ? __funnelshift_r(lo, __ldg(w + 1), 8 * (c & 3))
                         : lo >> (8 * (c & 3));
}"""
_CHROMA_ROWS = """  for (int j = 0; j < 3; ++j) {
    su[j] = bytes4(cu + j * wc, cix);
    sv[j] = bytes4(cv + j * wc, cix);
  }"""
# chroma: the third column only where dx != 0, the third row only where
# dy != 0 (the taps of weight 0 not read)
_CHROMA_NEEDED = """  for (int j = 0; j < 3; ++j) {
    const int n = (mvx & 7) ? 3 : 2;
    const bool row = j < 2 || (mvy & 7);
    su[j] = row ? bytes4(cu + j * wc, cix, n) : 0u;
    sv[j] = row ? bytes4(cv + j * wc, cix, n) : 0u;
  }"""
_FAST = "const bool fast ="
_FB = """  float fb = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) fb = __fmaf_rn(e[k], cf[k], fb);"""
_RING = "constexpr int B = 4;"
_GROUP = "constexpr int G = 4;"
_RMBS = "constexpr int MBS = 8; "
_RTHREADS = "constexpr int THREADS = 128;"
_QMPACK = "constexpr uint64_t kQMLo = qm_pack(0), kQMHi = qm_pack(1);"
_QMREAD = ("const int q = (int)(((key & 8) ? kQMHi : kQMLo) >> "
           "(8 * (key & 7))) & 0xff;")

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
        # the fused kernel's chroma window loaded after the argmin, at
        # the winner's chroma MV, not beside the luma window
        "late_chroma": [(_PREFETCH, "if (false)"),
                        (_WIN, "chroma_mb(cwin[warp], ref_u, ref_v, hc, "
                               "lane,")],
    },
    "mc": {
        "mbs4": [(_MCMBS, "constexpr int MBS = 4; ")],
        "mbs8": [(_MCMBS, "constexpr int MBS = 8; ")],
        "constant_qm": ["constant_qm"],
        # only the words that hold bytes of non-zero weight loaded
        "needed_words": [(_BYTES4, _ROW_BYTES),
                         (_CHROMA_ROWS, _CHROMA_NEEDED)],
    },
    "shape_scan": {
        # every chunk rounded by rintf (the range test never passes)
        "rint_only": [(_FAST, "const bool fast = false &&")],
        # every chunk on the fast rounding (exact on the path's inputs
        # only: the cost of the range test)
        "always_fast": [(_FAST, "const bool fast = true ||")],
        # the first feedback term as a product (fma(e0, c0, +0) by value)
        "fmul_first": [(_FB, """  float fb = __fmul_rn(e[0], cf[0]);
#pragma unroll
  for (int k = 1; k < K; ++k) fb = __fmaf_rn(e[k], cf[k], fb);""")],
        # the shared ring: 3 handovers in place of 4 (5 would pass the
        # 48 KB of static shared memory)
        "ring3": [(_RING, "constexpr int B = 3;")],
        # chunks per handover (one __syncthreads each): 1 or 2 for 4
        "g1": [(_GROUP, "constexpr int G = 1;")],
        "g2": [(_GROUP, "constexpr int G = 2;")],
    },
    "residual": {
        # output rows (MBs) per block: 4 or 16 in place of 8
        "mbs4": [(_RMBS, "constexpr int MBS = 4; ")],
        "mbs16": [(_RMBS, "constexpr int MBS = 16; ")],
        "threads256": [(_RTHREADS, "constexpr int THREADS = 256;")],
    },
}
# the kernels of each source whose SASS is counted (a part of the
# mangled name)
# the C function each entry calls
ENTRY_FNS = {"intra": "intra_scan", "intra1": "intra_scan",
             "hpel": "hpel_refine_mc", "hpel_luma": "refine_mc_luma",
             "hpel_chroma": "mc_chroma", "mc": "mc_predict",
             "shape_scan": "shape_scan", "residual": "expand_residual"}
KERNEL_FNS = {"intra": {"intra": "intra_kernel"},
              "hpel": {"hpel": "hpel_kernelILb1E",
                       "hpel_luma": "hpel_kernelILb0E",
                       "hpel_chroma": "chroma_kernel"},
              "mc": {"mc": "mc_kernel"},
              "shape_scan": {"shape_scan": "shape_scan_kernelILi5E"},
              "residual": {"residual": "residual_kernel"}}


def _constant_qm() -> str:
    """The packed quarter-pel table as a __constant__ array (the MC
    kernel's first form read device_recon._QM from constant memory)."""
    from librempeg_tpu_torch.codecs.h264 import device_recon as DR

    vals = [int(e[0] | e[1] << 2 | e[2] << 3 | e[3] << 4 | e[4] << 6
                | e[5] << 7) for e in DR._QM]
    return "__constant__ int kQMc[16] = {%s};" % ", ".join(map(str, vals))


def apply(src: str, reps) -> str:
    for rep in reps:
        if rep == "packed_sad":
            # add_row with __vsadu4 on byte strings in place of __sad
            i = src.index("// SAD terms of one half-pel row")
            j = src.index("// CHROMA: also predict both chroma planes")
            src = src[:i] + _PACK.lstrip() + "\n" + src[j:]
        elif rep == "constant_qm":
            src = src.replace(_QMPACK, _constant_qm()).replace(
                _QMREAD, "const int q = kQMc[key];")
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


def sass_count(name: str, path: str, tmp: str) -> dict:
    import kernel_resources as KR

    res = KR.resources(os.path.basename(path)[:-3], tmp, path)
    return {label: next((r["sass"] for fn, r in res.items() if part in fn),
                        None)
            for label, part in KERNEL_FNS[name].items()}


def scan_inputs(n: int = 1120):
    """One convert of the dithered audio path: [2, n] samples resampled
    from 44.1 to 48 kHz in LSB units, the lipshitz noise, its taps and a
    zero history."""
    import torch

    from librempeg_tpu_torch.resample import dither as RD
    from librempeg_tpu_torch.resample.resampler import Resampler
    from librempeg_tpu_torch.utils import testgen

    x = torch.from_numpy(testgen.audio_mix(44100, 2 * n)).cuda()
    r = Resampler(44100, 48000, 2, device="cuda")
    xl = (r.process(x.float()) * 32768.0)[:, :n].contiguous()
    noise = torch.from_numpy(RD.Ditherer("lipshitz")._noise((2, n))).cuda()
    cs = RD._SHAPER_COEFS["lipshitz"]
    return (xl, noise, torch.tensor(cs, dtype=torch.float32, device="cuda"),
            torch.zeros((len(cs), 2), dtype=torch.float32, device="cuda"))


def inputs(names):
    """{source: the bench inputs of its kernels}, for the sources named."""
    if names == ["shape_scan"]:
        return {"shape_scan": scan_inputs()}
    import torch

    import chip_smoke as CS
    from librempeg_tpu_torch.codecs.h264 import device_recon as DR
    from librempeg_tpu_torch.codecs.h264 import intra_pallas as IP
    from librempeg_tpu_torch.codecs.h264 import mc_pallas as MC
    from librempeg_tpu_torch.codecs.h264 import residual_pallas as RP

    args, frames = CS.capture_p_frame("cuda")
    (idx, vals, qp, kind, info, i4m, ilist, mv, ref, luma4, upad, vpad,
     mb_w, mb_h, cqo, _, _, _, _) = args
    margs = (luma4, upad, vpad, mv, ref, mb_w, mb_h)
    pred = MC.mc_predict_plain(*margs)
    y, u, v, lres_t, cres_t = DR.recon_p_frame_pred_noscan(
        *pred, idx, vals, qp, kind, mb_w, mb_h, cqo, fold_i16=True)
    scal = IP.build_intra_scalars(ilist, kind, info, i4m, mb_w, mb_h)
    nmb = mb_w * mb_h
    coeffs = DR.dense_coeffs(idx, vals, nmb)
    ids, levels = RP.compact_rows(coeffs.cpu().numpy(), qp.cpu().numpy(),
                                  kind.cpu().numpy(), cqo, mb_w, mb_h)
    packed = torch.from_numpy(RP.pack_rows(ids, levels)).cuda()
    return {"intra": ((y, u, v), scal, lres_t, cres_t, mb_w, mb_h),
            "hpel": CS.hpel_inputs("cuda", frames), "mc": margs,
            "shape_scan": scan_inputs(), "residual": (packed, nmb)}


def _pure(fn, plain, args):
    """(run, restore, ok) of a kernel wrapper that only writes new
    tensors."""
    import torch

    want = plain(*args)

    def run():
        return fn(*args)

    def ok():
        return all(torch.equal(a, b) for a, b in zip(run(), want))
    return run, None, ok


def runners(name, ins) -> dict:
    """{entry: (run, restore, ok)} of source `name`'s kernels on their
    bench inputs; "intra1": the intra kernel on the first entry of the
    list only (the launch, the set-up and one step)."""
    import torch

    from librempeg_tpu_torch.codecs.h264 import intra_pallas as IP
    from librempeg_tpu_torch.codecs.h264 import mc_pallas as MC
    from librempeg_tpu_torch.codecs.mpeg4 import me_pallas as MEP
    from librempeg_tpu_torch.kernels import intra as KI

    if name == "mc":
        return {"mc": _pure(MC.mc_predict, MC.mc_predict_plain, ins["mc"])}
    if name == "residual":
        from librempeg_tpu_torch.codecs.h264 import residual_pallas as RP

        return {"residual": _pure(
            lambda p, n: (RP.expand_residual(p, None, n),),
            lambda p, n: (RP.expand_residual_plain(p, n),),
            ins["residual"])}
    if name == "shape_scan":
        from librempeg_tpu_torch.resample import dither as RD

        return {"shape_scan": _pure(RD.shape_scan, RD.shape_scan_plain,
                                    ins["shape_scan"])}
    if name == "hpel":
        cur, ry, ru, rv, mv_i = ins["hpel"]
        mv_h = MEP.refine_mc_luma_plain(cur, ry, mv_i)[0]
        return {"hpel": _pure(MEP.hpel_refine_mc, MEP.hpel_refine_mc_plain,
                              ins["hpel"]),
                "hpel_luma": _pure(MEP.refine_mc_luma,
                                   MEP.refine_mc_luma_plain, (cur, ry, mv_i)),
                "hpel_chroma": _pure(MEP.mc_chroma, MEP.mc_chroma_plain,
                                     (ru, rv, mv_h))}
    out = {}
    for entry in ("intra", "intra1"):
        planes, scal, lres_t, cres_t, mb_w, mb_h = ins["intra"]
        if entry == "intra1":
            scal = scal[:1].contiguous()
        want = IP.intra_scan_plain(*planes, scal, lres_t, cres_t, mb_w, mb_h)
        work = [p.clone() for p in planes]

        def restore(work=work, planes=planes):
            for w, p in zip(work, planes):
                w.copy_(p)

        def run(work=work, scal=scal):
            KI.launch(*work, scal, lres_t, cres_t, mb_w, mb_h)

        def ok(work=work, want=want, restore=restore, run=run):
            restore()
            run()
            return all(torch.equal(a, b) for a, b in zip(work, want))
        out[entry] = (run, restore, ok)
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--parent", metavar="DIR",
                    help="an earlier checkout whose sources are timed too")
    ap.add_argument("sources", nargs="*", help=f"some of {list(VARIANTS)}")
    a = ap.parse_args(argv)
    names = a.sources or list(VARIANTS)
    if set(names) - set(VARIANTS):
        ap.error(f"sources must be among {list(VARIANTS)}")
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
    print(f"device floor: {CS.floor_ms()} ms (an empty kernel)", flush=True)
    for name in names:
        _build.load(name)
    ins = inputs(names)
    out = {"device": smi}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            src = open(os.path.join(ROOT, "librempeg_tpu_torch", "csrc",
                                    f"{name}.cu")).read()
            libs = {"base": build(name, "base", src, tmp)}
            for label, reps in VARIANTS[name].items():
                libs[label] = build(name, label, apply(src, reps), tmp)
            if a.parent:
                libs["parent"] = build(name, "parent", open(os.path.join(
                    a.parent, "librempeg_tpu_torch", "csrc",
                    f"{name}.cu")).read(), tmp)

            def entries(label):
                return {e: r for e, r in runners(name, ins).items()
                        if hasattr(libs[label][0], ENTRY_FNS[e])}
            res = {}
            for label, (lib, path) in libs.items():
                _build._libs[name] = lib
                res[label] = {"exact": {e: bool(r[2]()) for e, r in
                                        entries(label).items()},
                              "sass": sass_count(name, path, tmp),
                              "device_ms": {e: [] for e in entries(label)},
                              "device_ms_b2b": {e: [] for e, r in
                                                entries(label).items()
                                                if r[1] is None}}
            bad = [k for k, r in res.items() if not all(r["exact"].values())]
            if bad:
                raise RuntimeError(f"{name} variants differ from the plain "
                                   f"version: {bad}")
            for _ in range(a.rounds):
                for label in list(libs) + ["base"]:
                    _build._libs[name] = libs[label][0]
                    for e, (run, restore, _) in entries(label).items():
                        res[label]["device_ms"][e].append(
                            CS.device_ms(run, restore))
                        if restore is None:
                            res[label]["device_ms_b2b"][e].append(
                                CS.device_ms_b2b(run))
            for label, r in res.items():
                print(f"{name} {label}: " + ", ".join(
                    f"{k} {v}" for k, v in r.items()), flush=True)
            out[name] = res
            _build._libs.pop(name)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
