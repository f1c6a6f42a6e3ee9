#!/usr/bin/env python3
"""Dependent latencies of the float operations of the noise shaper's
chain, and the SM clock under a one-warp kernel, on the card.

    python3 tools/dep_latency.py [--reps N]

Builds a small CUDA source (below) with nvcc and the flags of
kernels/_build.py into a temporary directory. One warp runs a chain of L
dependent copies of an operation (inline PTX, so nothing is folded)
between two clock64() reads; the cycles per link are
(cycles(2L) - cycles(L)) / L, which cancels the fixed cost of the reads,
the least of N launches (default 5; the steps below: the median). The
links:

  ffma      fma.rn.f32   x = x * a + b   (the feedback terms)
  fadd      add.rn.f32   x = x + b       (want, t, e)
  fmul      mul.rn.f32   x = x * a
  frnd      cvt.rni.f32  x = rint(x)     (rintf, the shaper's rounding)
  magic     add.rn + sub.rn of 1.5 * 2^23 (the fast rounding: one link,
            two instructions)
  copysign  copysign.f32 x = |x| with b's sign
  frnd_fadd cvt.rni then add.rn (one link, two instructions)
  step      a step of csrc/shape_scan.cu's fast path at K = 5, in C
            (5 FMAs, want, t, the add/subtract pair, e: 10 instructions),
            with the memory traffic of the kernel's ways of feeding it
            (x and the noise read a chunk of 32 ahead, q written):
  step_stg      q stored to global memory each step (STG)
  step_stg4     q kept, stored 4 at a time (STG.128)
  step_sts      q stored to shared memory each step (STS)
  step_ldg      x and the noise of the next 32 steps loaded (LDG) at the
                start of each 32, into registers
  step_ldg_stg  both, as csrc/shape_scan.cu does
  step_ldg4_stg4  both, 16 bytes a load and a store

The shaper kernel itself (csrc/shape_scan.cu through its wrapper) on 2
channels of N samples, N = 256 ... 16384 (random samples of s16 scale,
TPDF noise, the lipshitz taps): chip_smoke.device_ms_b2b at each N, and
a least-squares line through them, whose slope is the kernel's cycles
a step at the measured clock and whose intercept its fixed cost.

The clock: one warp runs a dependent FMA loop of about 10 ms between
reads of %globaltimer (ns) and clock64(); their ratio is the SM clock
that such a launch runs at. nvidia-smi's clocks.max.sm and clocks.sm
print beside it. Needs a CUDA card; the last line is one JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OPS = ("ffma", "fadd", "fmul", "frnd", "magic", "copysign", "frnd_fadd")
STEPS = ("step", "step_stg", "step_stg4", "step_sts", "step_ldg",
         "step_ldg_stg", "step_ldg4_stg4")
SOURCE = r'''
#include <cuda_runtime.h>

template <int OP>
__device__ __forceinline__ void link(float& x, float a, float b) {
  if (OP == 0) asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+f"(x) : "f"(a), "f"(b));
  if (OP == 1) asm volatile("add.rn.f32 %0, %0, %1;" : "+f"(x) : "f"(b));
  if (OP == 2) asm volatile("mul.rn.f32 %0, %0, %1;" : "+f"(x) : "f"(a));
  if (OP == 3) asm volatile("cvt.rni.f32.f32 %0, %0;" : "+f"(x));
  if (OP == 4)
    asm volatile("add.rn.f32 %0, %0, 0f4B400000;\n\tsub.rn.f32 %0, %0, 0f4B400000;"
                 : "+f"(x));
  if (OP == 5) asm volatile("copysign.f32 %0, %1, %0;" : "+f"(x) : "f"(b));
  if (OP == 6)
    asm volatile("cvt.rni.f32.f32 %0, %0;\n\tadd.rn.f32 %0, %0, %1;"
                 : "+f"(x) : "f"(b));
}

template <int OP, int L>
__global__ void chain(float a, float b, float* out, long long* cyc) {
  float x = a + threadIdx.x;
  const long long t0 = clock64();
#pragma unroll
  for (int i = 0; i < L; ++i) link<OP>(x, a, b);
  const long long t1 = clock64();
  out[threadIdx.x] = x;
  if (threadIdx.x == 0) *cyc = t1 - t0;
}

__global__ void clock_kernel(float a, float b, int iters, float* out,
                             long long* res) {
  long long g0, g1;
  float x = a + threadIdx.x;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = clock64();
  for (int i = 0; i < iters; ++i) link<0>(x, a, b);
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  out[threadIdx.x] = x;
  if (threadIdx.x == 0) {
    res[0] = c1 - c0;
    res[1] = g1 - g0;
  }
}

// L steps of the shaper's fast path (csrc/shape_scan.cu step<5, true>),
// the taps from memory as in the kernel. MODE: 0 no memory, 1 STG of q
// each step, 2 STG.128 of 4 q, 3 STS of q, 4 LDG of the next 32 x and
// noise every 32 steps, 5 = 4 + 1, 6 = 4 + 2 with LDG.128
template <int MODE, int L>
__global__ void step_chain(const float* __restrict__ taps,
                           const float* __restrict__ in,
                           float* __restrict__ y, long long* cyc) {
  constexpr bool LOADS = MODE >= 4;
  __shared__ float sy[L];
  float cf[5], e[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    cf[k] = taps[k];
    e[k] = 0.1f * (k + threadIdx.x);
  }
  const float* xr = in + threadIdx.x * 2 * (L + 32);
  float xa[32], na[32], xb[32], nb[32], ya[4];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    xa[j] = LOADS ? __ldg(xr + j) : 1000.25f;
    na[j] = LOADS ? __ldg(xr + L + 32 + j) : 0.3f;
  }
  float* yr = y + 32 + threadIdx.x * L;
  const long long t0 = clock64();
#pragma unroll
  for (int c = 0; c < L; c += 32) {
    if (LOADS) {
      if (MODE == 6) {
#pragma unroll
        for (int j = 0; j < 32; j += 4) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(xr + c + 32 + j));
          const float4 b = __ldg(reinterpret_cast<const float4*>(xr + L + 64 + c + j));
          xb[j] = a.x; xb[j + 1] = a.y; xb[j + 2] = a.z; xb[j + 3] = a.w;
          nb[j] = b.x; nb[j + 1] = b.y; nb[j + 2] = b.z; nb[j + 3] = b.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          xb[j] = __ldg(xr + c + 32 + j);
          nb[j] = __ldg(xr + L + 64 + c + j);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float fb = 0.0f;
#pragma unroll
      for (int k = 0; k < 5; ++k) fb = __fmaf_rn(e[k], cf[k], fb);
      const float want = __fsub_rn(xa[j], fb);
      const float q = __fsub_rn(__fadd_rn(__fadd_rn(want, na[j]), 12582912.0f),
                                12582912.0f);
#pragma unroll
      for (int k = 4; k > 0; --k) e[k] = e[k - 1];
      e[0] = __fsub_rn(q, want);
      const int i = c + j;
      if (MODE == 1 || MODE == 5) yr[i] = q;
      if (MODE == 3) sy[i] = q;
      if (MODE == 2 || MODE == 6) {
        ya[j & 3] = q;
        if ((j & 3) == 3)
          *reinterpret_cast<float4*>(yr + i - 3) =
              make_float4(ya[0], ya[1], ya[2], ya[3]);
      }
    }
    if (LOADS) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        xa[j] = xb[j];
        na[j] = nb[j];
      }
    }
  }
  const long long t1 = clock64();
  y[threadIdx.x] = e[0] + e[4] + (MODE == 3 ? sy[threadIdx.x] : 0.0f);
  if (threadIdx.x == 0) *cyc = t1 - t0;
}

template <int OP>
static int run(int twice, float* out, long long* cyc) {
  if (twice)
    chain<OP, 512><<<1, 32>>>(0.999f, 0.5f, out, cyc);
  else
    chain<OP, 256><<<1, 32>>>(0.999f, 0.5f, out, cyc);
  return (int)cudaGetLastError();
}

// out: 32 floats, then y [32][512], then the taps; in: x and noise
template <int MODE>
static int run_step(int twice, float* out, const float* in, long long* cyc) {
  float* taps = out + 32 * 513;
  if (twice)
    step_chain<MODE, 512><<<1, 2>>>(taps, in, out, cyc);
  else
    step_chain<MODE, 256><<<1, 2>>>(taps, in, out, cyc);
  return (int)cudaGetLastError();
}

// cycles of L = 256 (twice = 0) or 512 shaper steps in mode `mode`
extern "C" int step_cycles(int mode, int twice, long long* host) {
  float *out, *in;
  long long* cyc;
  const int nin = 32 * 2 * (512 + 32);
  if (cudaMalloc(&out, (32 * 513 + 5) * sizeof(float)) != cudaSuccess)
    return 1;
  if (cudaMalloc(&in, nin * sizeof(float)) != cudaSuccess) return 1;
  if (cudaMalloc(&cyc, sizeof(long long)) != cudaSuccess) return 1;
  const float h[5] = {2.033f, -2.165f, 1.959f, -1.590f, 0.6149f};
  cudaMemcpy(out + 32 * 513, h, sizeof h, cudaMemcpyHostToDevice);
  float* hin = new float[nin];
  for (int i = 0; i < nin; ++i) hin[i] = (i % 977) * 3.25f - 1500.0f;
  cudaMemcpy(in, hin, nin * sizeof(float), cudaMemcpyHostToDevice);
  delete[] hin;
  int err;
  switch (mode) {
    case 0: err = run_step<0>(twice, out, in, cyc); break;
    case 1: err = run_step<1>(twice, out, in, cyc); break;
    case 2: err = run_step<2>(twice, out, in, cyc); break;
    case 3: err = run_step<3>(twice, out, in, cyc); break;
    case 4: err = run_step<4>(twice, out, in, cyc); break;
    case 5: err = run_step<5>(twice, out, in, cyc); break;
    case 6: err = run_step<6>(twice, out, in, cyc); break;
    default: err = (int)cudaErrorInvalidValue;
  }
  if (!err) err = (int)cudaMemcpy(host, cyc, sizeof(long long),
                                  cudaMemcpyDeviceToHost);
  cudaFree(out);
  cudaFree(in);
  cudaFree(cyc);
  return err;
}

// cycles of a chain of 256 (twice = 0) or 512 links of operation op
extern "C" int dep_cycles(int op, int twice, long long* host) {
  float* out;
  long long* cyc;
  if (cudaMalloc(&out, 32 * sizeof(float)) != cudaSuccess) return 1;
  if (cudaMalloc(&cyc, sizeof(long long)) != cudaSuccess) return 1;
  int err;
  switch (op) {
    case 0: err = run<0>(twice, out, cyc); break;
    case 1: err = run<1>(twice, out, cyc); break;
    case 2: err = run<2>(twice, out, cyc); break;
    case 3: err = run<3>(twice, out, cyc); break;
    case 4: err = run<4>(twice, out, cyc); break;
    case 5: err = run<5>(twice, out, cyc); break;
    case 6: err = run<6>(twice, out, cyc); break;
    default: err = (int)cudaErrorInvalidValue;
  }
  if (!err) err = (int)cudaMemcpy(host, cyc, sizeof(long long),
                                  cudaMemcpyDeviceToHost);
  cudaFree(out);
  cudaFree(cyc);
  return err;
}

// clock cycles and ns of one warp's dependent FMA loop of iters links
extern "C" int clock_ratio(int iters, long long* host) {
  float* out;
  long long* res;
  if (cudaMalloc(&out, 32 * sizeof(float)) != cudaSuccess) return 1;
  if (cudaMalloc(&res, 2 * sizeof(long long)) != cudaSuccess) return 1;
  clock_kernel<<<1, 32>>>(0.999f, 0.5f, iters, out, res);
  int err = (int)cudaGetLastError();
  if (!err) err = (int)cudaMemcpy(host, res, 2 * sizeof(long long),
                                  cudaMemcpyDeviceToHost);
  cudaFree(out);
  cudaFree(res);
  return err;
}
'''


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def build(tmp: str) -> ctypes.CDLL:
    from librempeg_tpu_torch.kernels import _build

    src = os.path.join(tmp, "dep_latency.cu")
    with open(src, "w") as f:
        f.write(SOURCE)
    so = os.path.join(tmp, "dep_latency.so")
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", so, src], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.dep_cycles.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.clock_ratio.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.step_cycles.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def scan_lengths() -> dict:
    """{N: device_ms_b2b of the shaper kernel on [2, N]}."""
    import numpy as np
    import torch

    import chip_smoke as CS
    from librempeg_tpu_torch.resample import dither as RD

    rng = np.random.default_rng(0)
    coefs = torch.tensor(RD._SHAPER_COEFS["lipshitz"], dtype=torch.float32,
                         device="cuda")
    err0 = torch.zeros((5, 2), dtype=torch.float32, device="cuda")
    out = {}
    for n in (256, 1024, 2048, 4096, 8192, 16384):
        x = torch.from_numpy(rng.normal(0, 9000, (2, n)).astype(
            np.float32)).cuda()
        d = torch.from_numpy((rng.random((2, n)) - rng.random((2, n)))
                             .astype(np.float32)).cuda()
        out[n] = CS.device_ms_b2b(lambda: RD.shape_scan(x, d, coefs, err0))
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("dep_latency: needs a CUDA card", file=sys.stderr)
        return 2
    device = smi("name,power.limit")
    print(device, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        buf = (ctypes.c_longlong * 2)()

        def call(fn, *args):
            err = fn(*args, buf)
            if err:
                raise RuntimeError(f"dep_latency: cudaError {err}")
            return list(buf)

        cycles = {}
        for i, op in enumerate(OPS):
            per = [(call(lib.dep_cycles, i, 1)[0]
                    - call(lib.dep_cycles, i, 0)[0]) / 256
                   for _ in range(a.reps)]
            cycles[op] = min(per)
            print(f"{op}: {cycles[op]} cycles a link (runs {per})", flush=True)
        steps = {}
        for i, mode in enumerate(STEPS):
            per = [(call(lib.step_cycles, i, 1)[0]
                    - call(lib.step_cycles, i, 0)[0]) / 256
                   for _ in range(a.reps)]
            steps[mode] = statistics.median(per)
            print(f"{mode}: {steps[mode]} cycles a step, the median (runs "
                  f"{per})", flush=True)
        iters = 5_000_000
        call(lib.clock_ratio, 1000)
        cyc, ns = call(lib.clock_ratio, iters)
    mhz = cyc / ns * 1e3
    res = {"device": device, "cycles_per_link": cycles,
           "cycles_per_step": steps,
           "one_warp_sm_clock_mhz": mhz, "loop_cycles": cyc, "loop_ns": ns,
           "loop_cycles_per_fma": cyc / iters,
           "clocks_max_sm": smi("clocks.max.sm"),
           "clocks_sm_after": smi("clocks.sm")}
    print(f"one warp: {cyc} cycles in {ns} ns, {mhz} MHz "
          f"(clocks.max.sm {res['clocks_max_sm']})", flush=True)
    res["shape_scan_b2b_ms"] = scan_lengths()
    ns_ = sorted(res["shape_scan_b2b_ms"])
    ts = [res["shape_scan_b2b_ms"][n] for n in ns_]
    mn, mt = statistics.fmean(ns_), statistics.fmean(ts)
    slope = (sum((n - mn) * (t - mt) for n, t in zip(ns_, ts))
             / sum((n - mn) ** 2 for n in ns_))
    res["shape_scan_cycles_per_step"] = slope * 1e-3 * mhz * 1e6
    res["shape_scan_fixed_ms"] = mt - slope * mn
    print(f"shape_scan: {res['shape_scan_b2b_ms']} ms back to back; "
          f"{res['shape_scan_cycles_per_step']} cycles a step, "
          f"{res['shape_scan_fixed_ms']} ms fixed", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
