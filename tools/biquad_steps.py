#!/usr/bin/env python3
"""Where the biquad kernel's cycles go, on the card.

    python3 tools/biquad_steps.py [--parent DIR] [--out DIR] [--reps N]
                                  [VARIANT ...]

For csrc/biquad.cu of this checkout, with --parent of the checkout at
DIR (an earlier commit unpacked with git archive, whose kernel runs one
stage a launch), and for each VARIANT, a text variant of this
checkout's source (VARIANTS below):

1. SASS. Each source is compiled to a cubin with the flags of
   kernels/_build.py; cuobjdump -sass gives each kernel's code. The
   step loops are straight runs of instructions (between branch targets
   and branches): each run with 8 FFMAs or more prints its length, its
   FFMAs and its static cycles (the stall counts ptxas wrote), and the
   whole listing goes to DIR/biquad_sass_<name>.txt
   (--out, default build/biquad_steps; --listing FILE reads one back
   on any machine).
2. Clock stamps. A copy of each source with clock64() reads added by
   text (at the kernel's entry, at the start and end of each handover's
   chain work in the first block's first lane, and before the final
   state is written) is built and run at F3's shape (2 channels of 1024
   samples, s16: the parent once per stage, the run of four in one
   launch here, and here a run of one too). The cycles split into the
   start (entry to the first handover), the chain's work in each
   handover (H = 128 samples or steps: cycles a step), the waits at the
   handover barrier, and the end; the least of N runs (--reps, default
   5) of each.
3. Back-to-back device time (chip_smoke.device_ms_b2b) of the kernel at
   N = 256 ... 16384 samples, and the least-squares line through the
   points: its slope in cycles a sample at the one-warp SM clock
   (tools/dep_latency.py's measurement, repeated here) and its
   intercept, the fixed cost of a launch.

Needs a CUDA card and nvcc; the last line is one JSON object.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

N_F3, C_F3, S_F3 = 1024, 2, 4
LENGTHS = (256, 1024, 4096, 16384)
NST = 160                  # stamps: entry, 2 per handover (64 at most), end
_STAMP = "if (threadIdx.x == 0 && blockIdx.x == 0"


# the end of the chain's handover: in this checkout's source, and in the
# one-stage parent's
_DONE = (r"\n    __syncthreads\(\);\n  \}\n  if \(chain\) \{",
         r"\n    __syncthreads\(\);\n  \}\n  if \(warp == 1")
_LOOP = "  for (int i = 0; i < handovers; ++i) {\n"


def stamped(src: str) -> str:
    """The source with the clock stamps of step 2 added: at the kernel's
    entry, at the top of the chain's handover loop (its last in the
    source) and before the handover's __syncthreads, and before the
    final states are written."""
    out = src.replace("#include <cuda_runtime.h>\n",
                      "#include <cuda_runtime.h>\n"
                      f"__device__ long long g_st[{NST}];\n", 1)
    entry = "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
    if out.count(entry) != 1 or _LOOP not in out:
        raise RuntimeError("biquad_steps: the entry or loop mark moved")
    out = out.replace(entry, entry + f"  {_STAMP}) g_st[0] = clock64();\n")
    at = out.rindex(_LOOP) + len(_LOOP)
    out = (out[:at] + f"    {_STAMP} && i < 64) g_st[1 + 2 * i] = "
           "clock64();\n" + out[at:])
    n = 0
    for done in _DONE:
        out, k = re.subn(done, f"\n    {_STAMP} && i < 64) g_st[2 + 2 * i] "
                         "= clock64();\\g<0>", out)
        n += k
    out, m = re.subn(r"\n  if \(chain\) \{\n    zout\[",
                     f"\n  {_STAMP}) g_st[{NST - 1}] = clock64();\\g<0>",
                     out)
    if n != 1 or m != 1:
        raise RuntimeError("biquad_steps: the handover or end marks moved")
    return out + ("\nextern \"C\" int biquad_stamps(long long* host) {\n"
                  "  return (int)cudaMemcpyFromSymbol(host, g_st, "
                  "sizeof(g_st));\n}\n")


# text variants of csrc/biquad.cu (PERF.md section 6 reads them): each a
# list of (text, replacement), every text found once in the source
_LEAN = """        load_block(xa, rd(b1 + 1));
        block<FMT, false>(k, xb, rb, ra, wr(b1), b1, start, zi1, zi2, end,
                          cap, prev, z1, z2, zs1, zs2);
        __syncwarp();
"""
_LEAN_LOOP = """#pragma unroll 1
      for (int p = p0; p < p1; ++p) {
        const int b0 = 2 * p, b1 = b0 + 1;
        load_block(xb, rd(b1));
        block<FMT, false>("""
_LEAN_BODY = """        const int b0 = 2 * p, b1 = b0 + 1;
        load_block(xb, rd(b1));
        block<FMT, false>(k, xa, ra, rb, wr(b0), b0, start, zi1, zi2, end,
                          cap, prev, z1, z2, zs1, zs2);
""" + _LEAN
_S16 = """    const float v = fminf(fmaxf(__fmul_rn(out, 32768.0f), -32768.0f),
                          32767.0f);
    return __fsub_rn(__fadd_rn(v, M), M);"""
VARIANTS = {
    # the lean pair loop unrolled by two
    "unroll2": [(_LEAN_LOOP, _LEAN_LOOP.replace("unroll 1", "unroll 2"))],
    # a full handover's pairs unrolled
    "unroll": [("#pragma unroll 1\n      for (int p = p0; p < p1; ++p) {\n"
                + _LEAN_BODY + "      }",
                "if (p1 - p0 == H / D / 2) {\n#pragma unroll\n"
                "      for (int q = 0; q < H / D / 2; ++q) {\n"
                "        const int p = p0 + q;\n" + _LEAN_BODY + "      }\n"
                "      } else {\n#pragma unroll 1\n"
                "      for (int p = p0; p < p1; ++p) {\n" + _LEAN_BODY
                + "      }\n      }")],
    # the s16 round trip by a saturating conversion and back
    "cvt": [(_S16, '    int r;\n    asm("cvt.rni.sat.s16.f32 %0, %1;" : "=r"(r)'
                   ' : "f"(__fmul_rn(out, 32768.0f)));\n    float f;\n'
                   '    asm("cvt.rn.f32.s16 %0, %1;" : "=f"(f) : "h"((short)r));'
                   '\n    return f;')],
    # blocks of 16 steps
    "d16": [("constexpr int D = 8;", "constexpr int D = 16;")],
    # no __syncwarp in the lean loop: timing only, its results are wrong
    "nosync": [(_LEAN, _LEAN.replace("        __syncwarp();\n", ""))],
}


def variant(src: str, name: str) -> str:
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"biquad_steps: variant {name} does not "
                               "apply to this source")
        src = src.replace(old, new)
    return src


def nvcc(args: list[str]) -> None:
    from librempeg_tpu_torch.kernels import _build

    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", *args], check=True,
                   capture_output=True, text=True)


def listing(text: str) -> dict:
    """{kernel: {instructions, runs}} of a cuobjdump -sass listing: runs
    are the straight runs of instructions (between branch targets and
    branches) that hold 8 FFMAs or more, each [address, instructions,
    FFMAs, static cycles], the cycles the sum of the stall counts that
    ptxas wrote into the instructions' control bits (bits 41-44 of each
    instruction's second 64-bit word)."""
    res, fn, run = {}, None, []

    def close():
        ffma = sum(op.startswith("FFMA") for _, op, _ in run)
        if fn and ffma >= 8:
            res[fn]["runs"].append([run[0][0], len(run), ffma,
                                    sum(st for _, _, st in run)])
        run.clear()
    lines = text.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            fn = m.group(1)
            res[fn] = {"instructions": 0, "runs": []}
            continue
        if fn is None:
            continue
        if re.match(r"\s*\.L_x_\d+:", line):
            close()
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if m and i + 1 < len(lines):
            hi = re.search(r"/\* (0x[0-9a-f]+) \*/", lines[i + 1])
            stall = (int(hi.group(1), 16) >> 41) & 0xF if hi else 0
            res[fn]["instructions"] += 1
            run.append((m.group(1), m.group(3), stall))
            if m.group(3).split(".")[0] in ("BRA", "EXIT", "BSYNC",
                                            "WARPSYNC", "BAR", "RET"):
                close()
    close()
    return res


def sass(src: str, tmp: str, name: str, out_dir: str) -> dict:
    """listing() of the source's cubin; the listing itself goes to
    out_dir/biquad_sass_<name>.txt."""
    from librempeg_tpu_torch.kernels import _build

    path = os.path.join(tmp, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    cubin = os.path.join(tmp, f"{name}.cubin")
    nvcc(["-cubin", "-o", cubin, path])
    text = subprocess.run(
        [os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "-sass",
         cubin], capture_output=True, text=True, check=True).stdout
    with open(os.path.join(out_dir, f"biquad_sass_{name}.txt"), "w") as f:
        f.write(text)
    return listing(text)


class Kernel:
    """One build of a biquad source, called through its C entry point
    (the parent's: one stage a launch; this checkout's: a run)."""

    def __init__(self, src: str, tmp: str, name: str):
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        so = os.path.join(tmp, f"{name}.so")
        nvcc(["-shared", "-Xcompiler", "-fPIC", "-o", so, path])
        self.lib = ctypes.CDLL(so)
        self.run = "const float* coefs" in src
        fn = self.lib.biquad
        fn.restype = ctypes.c_int
        if self.run:
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
                ctypes.c_float] * 5 + [ctypes.c_void_p]
        if hasattr(self.lib, "biquad_stamps"):
            self.lib.biquad_stamps.argtypes = [ctypes.c_void_p]

    def __call__(self, x, coefs, z, y, zo, fmt=1):
        """All stages of coefs over x; the parent one launch a stage."""
        import torch

        c, n = x.shape
        st = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if self.run:
            flat = (ctypes.c_float * (5 * len(coefs)))(
                *(float(v) for s in coefs for v in s))
            err = self.lib.biquad(x.data_ptr(), z.data_ptr(), y.data_ptr(),
                                  zo.data_ptr(), c, n, len(coefs), flat, fmt,
                                  st)
        else:
            err = 0
            for i, s in enumerate(coefs):
                err |= self.lib.biquad(x.data_ptr(), z[i].data_ptr(),
                                       y.data_ptr(), zo[i].data_ptr(), c, n,
                                       *(float(v) for v in s), st)
        if err:
            raise RuntimeError(f"biquad_steps: cudaError {err}")

    def stamps(self) -> list[int]:
        buf = (ctypes.c_longlong * NST)()
        if self.lib.biquad_stamps(buf):
            raise RuntimeError("biquad_steps: stamps not read")
        return list(buf)


def f3_case(n: int, c: int = C_F3, s: int = S_F3):
    """F3's run (highpass, lowpass, equalizer, bass at 44.1 kHz) on s16
    samples of a tone and noise."""
    import numpy as np
    import torch

    from librempeg_tpu_torch.filters import biquads as BQ

    specs = [("highpass", 80, 0.707, 0), ("lowpass", 12000, 0.707, 0),
             ("equalizer", 3000, 1.0, 3), ("bass", 100, 0.707, -2)][:s]
    coefs = []
    for kind, f, q, g in specs:
        b, a = BQ._rbj(kind, f, 44100, q, g)
        coefs.append(tuple(np.float32(v / a[0]) for v in b)
                     + (np.float32(a[1] / a[0]), np.float32(a[2] / a[0])))
    rng = np.random.default_rng(0)
    x = np.clip(0.5 * np.sin(np.arange(n) / 9.0)[None]
                + rng.normal(0, 0.2, (c, n)), -1, 1)
    x = torch.from_numpy((np.round(x * 32767) / 32768).astype(np.float32))
    z = torch.zeros((len(coefs), c, 2), dtype=torch.float32)
    return x.cuda(), coefs, z.cuda()


def handovers(src: str, n: int, s: int) -> int:
    """Handovers of one launch over n samples: the parent's of 128
    samples; a run's of 128 steps over its blocks of D (LAG / D blocks a
    stage behind the one before, one more at the end), in pairs."""
    if "const float* coefs" not in src:
        return -(-n // 128)
    d = int(re.search(r"constexpr int D = (\d+);", src).group(1))
    lag = int(re.search(r"constexpr int LAG = (\d+) \* D;", src).group(1))
    blocks = -(-n // d) + lag * (s - 1) + 1
    return -(-((blocks + 1) // 2) * 2 * d // 128)


def split(st: list[int], handovers: int, steps: int) -> dict:
    """Cycles of one launch from its stamps (steps: a handover's)."""
    begin = [st[1 + 2 * i] for i in range(handovers)]
    done = [st[2 + 2 * i] for i in range(handovers)]
    work = [d - b for b, d in zip(begin, done)]
    waits = [b - d for d, b in zip(done, begin[1:])]
    mid = work[1:-1] or work
    return {"total": st[NST - 1] - st[0], "start": begin[0] - st[0],
            "handover_work": work, "handover_wait": waits,
            "cycles_a_step": statistics.median(mid) / steps,
            "wait_median": statistics.median(waits) if waits else 0,
            "end": st[NST - 1] - done[-1]}


def line_fit(points: dict, mhz: float) -> dict:
    ns = sorted(points)
    ts = [points[n] for n in ns]
    mn, mt = statistics.fmean(ns), statistics.fmean(ts)
    slope = (sum((n - mn) * (t - mt) for n, t in zip(ns, ts))
             / sum((n - mn) ** 2 for n in ns))
    return {"b2b_ms": points, "cycles_a_sample": slope * 1e-3 * mhz * 1e6,
            "fixed_ms": mt - slope * mn}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", metavar="DIR")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "biquad_steps"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--listing", metavar="FILE",
                    help="only print listing() of a SASS listing this tool "
                    "wrote (no card needed)")
    ap.add_argument("variants", nargs="*", choices=[[], *VARIANTS],
                    metavar="VARIANT", help=f"of {sorted(VARIANTS)}")
    a = ap.parse_args(argv)
    if a.listing:
        with open(a.listing) as f:
            print(json.dumps(listing(f.read())))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("biquad_steps: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as CS
    import dep_latency

    device = dep_latency.smi("name,power.limit")
    print(device, flush=True)
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(ROOT, "librempeg_tpu_torch", "csrc",
                           "biquad.cu")) as f:
        srcs = {"change": f.read()}
    if a.parent:
        with open(os.path.join(a.parent, "librempeg_tpu_torch", "csrc",
                               "biquad.cu")) as f:
            srcs["parent"] = f.read()
    for name in a.variants:
        srcs[name] = variant(srcs["change"], name)
    res = {"device": device}
    with tempfile.TemporaryDirectory() as tmp:
        lat = dep_latency.build(tmp)
        buf = (ctypes.c_longlong * 2)()
        lat.clock_ratio(1000, buf)
        lat.clock_ratio(5_000_000, buf)
        mhz = buf[0] / buf[1] * 1e3
        res["one_warp_sm_clock_mhz"] = mhz
        print(f"one warp: {mhz} MHz", flush=True)
        for name, src in srcs.items():
            r = res[name] = {"sass": sass(src, tmp, name, a.out)}
            for fn, v in r["sass"].items():
                print(f"{name} {fn}: {v['instructions']} instructions; "
                      f"straight runs [address, instructions, FFMAs, static "
                      f"cycles]: {v['runs']}", flush=True)
            plain, timer = Kernel(src, tmp, name), Kernel(
                stamped(src), tmp, f"{name}_stamped")
            shapes = {"run4": S_F3, "run1": 1} if plain.run else {"stage": 1}
            for label, s in shapes.items():
                x, coefs, z = f3_case(N_F3, s=s)
                y, zo = torch.empty_like(x), torch.empty_like(z)
                runs = []
                for _ in range(a.reps):
                    # one launch: the parent's first stage, or the run
                    timer(x, coefs[:1] if not plain.run else coefs, z, y, zo)
                    torch.cuda.synchronize()
                    runs.append(split(timer.stamps(),
                                      handovers(src, N_F3, s), 128))
                best = min(runs, key=lambda v: v["total"])
                r[f"stamps_{label}"] = best
                print(f"{name} {label}: {best['total']} cycles a launch, "
                      f"start {best['start']}, {best['cycles_a_step']:.2f} "
                      f"cycles a step, barrier wait median "
                      f"{best['wait_median']}, end {best['end']}; handovers "
                      f"{best['handover_work']}", flush=True)
                pts = {}
                for n in LENGTHS:
                    x, coefs, z = f3_case(n, s=s)
                    y, zo = torch.empty_like(x), torch.empty_like(z)
                    pts[n] = CS.device_ms_b2b(
                        lambda: plain(x, coefs[:1] if not plain.run
                                      else coefs, z, y, zo))
                r[f"b2b_{label}"] = line_fit(pts, mhz)
                print(f"{name} {label} back to back: "
                      f"{json.dumps(r[f'b2b_{label}'])}", flush=True)
            # F3's four stages: the run in one launch, the parent's four
            x, coefs, z = f3_case(N_F3)
            y, zo = torch.empty_like(x), torch.empty_like(z)
            r["f3_device_ms"] = CS.device_ms(lambda: plain(x, coefs, z, y, zo))
            r["f3_device_ms_b2b"] = CS.device_ms_b2b(
                lambda: plain(x, coefs, z, y, zo))
            print(f"{name}: F3's four stages on 2 x {N_F3}: device_ms "
                  f"{r['f3_device_ms']:.4f}, back to back "
                  f"{r['f3_device_ms_b2b']:.4f}", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
