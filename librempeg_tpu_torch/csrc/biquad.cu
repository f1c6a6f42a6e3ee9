// Direct-form-II-transposed biquad over the samples of each channel:
//
//   out  = b0*x + z1
//   z1'  = b1*x - a1*out + z2
//   z2'  = b2*x - a2*out
//
// Replaces librempeg_tpu/filters/biquads.py _df2t_scan (a lax.scan over
// samples, not a Pallas kernel). x is [C, N] float32, z0 [C, 2] the
// carried state (z1, z2); the kernel writes y [C, N] and the final state
// z [C, 2], which the next call takes as z0. The five coefficients are
// float32 values passed by value (b0, b1, b2 and a1, a2, already divided
// by the leading denominator coefficient).
//
// Float order. For a call with two or more channels XLA's CPU code for
// the scan computes out = fma(b0, x, z1), z1' = fma(b1, x, -(a1*out)) +
// z2 with the product a1*out rounded alone, and z2' = fma(b2, x,
// -(a2*out)) (tests/test_torch_biquads.py reads this off the JAX
// package); for a mono call it rounds b0*x before adding z1. The kernel
// takes the two-channel form for every channel count, written with
// intrinsics so that nvcc cannot contract it another way; the plain
// version (kernels/biquad.py biquad_plain) computes the same roundings
// from float64.
//
// Every output depends on the state the sample before left, so a
// channel is one serial chain: one thread per channel walks its N
// samples with (z1, z2) in registers. The chain's thread touches only
// shared memory: a second warp of the block, the memory warp, copies x
// B - 1 handovers of G chunks of U samples ahead into a ring of shared
// buffers (cp.async, 4 bytes a lane, a commit group a handover) and
// writes the chain's outputs of the handover before back to y, 128
// coalesced bytes an instruction; one __syncthreads a handover passes
// the buffers over (the scheme of csrc/shape_scan.cu). Lane c of warp 0
// walks channel c of the block's CH channels.
//
// Bound on the H100: latency. From z1 back to z1 a step is FFMA (out),
// FMUL (a1*out), FFMA (b1*x - that), FADD (+ z2): four dependent
// operations at 4 cycles each (tools/dep_latency.py), 16 cycles a
// sample; z2' hangs off out beside the chain. N samples take N times
// that whatever the bytes (4 read and 4 written a sample).
#include <cuda_runtime.h>

namespace {

constexpr int U = 32;          // samples per chunk (a lane each)
constexpr int G = 4;           // chunks per handover
constexpr int B = 4;           // handovers in the shared ring
constexpr int CH = 8;          // channels per block
constexpr int XS = U + 4;      // a chunk's stride in the ring

struct Coefs {
  float b0, b1, b2, a1, a2;
};

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// every copy group but the newest B - 2 has landed
__device__ __forceinline__ void wait_all_but_newest() {
  asm volatile("cp.async.wait_group %0;" ::"n"(B - 2) : "memory");
}

// One sample: the output, and the state advanced in place.
__device__ __forceinline__ float step(const Coefs& c, float x, float& z1,
                                      float& z2) {
  const float out = __fmaf_rn(c.b0, x, z1);
  z1 = __fadd_rn(__fmaf_rn(c.b1, x, -__fmul_rn(c.a1, out)), z2);
  z2 = __fmaf_rn(c.b2, x, -__fmul_rn(c.a2, out));
  return out;
}

__global__ void __launch_bounds__(64)
    biquad_kernel(const float* __restrict__ x, const float* __restrict__ z0,
                  float* __restrict__ y, float* __restrict__ zout, int C,
                  int N, Coefs cf) {
  __shared__ __align__(16) float sx[B][CH][G][XS];
  __shared__ __align__(16) float sy[2][CH][G][XS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * CH;
  const int cb = min(CH, C - c0);
  const int handovers = (N + U * G - 1) / (U * G);

  // the memory warp: copy handover i's chunks into their buffer (zeros
  // past N)
  auto load = [&](int i) {
    if (i < handovers) {
      for (int ch = 0; ch < cb; ++ch) {
        for (int g = 0; g < G; ++g) {
          const int sm = (i * G + g) * U + lane;
          float* v = &sx[i % B][ch][g][lane];
          if (sm < N)
            copy4(v, x + (size_t)(c0 + ch) * N + sm);
          else
            *v = 0.0f;
        }
      }
    }
    commit();
  };
  // ... and write handover i's outputs back
  auto store = [&](int i) {
    for (int ch = 0; ch < cb; ++ch) {
      for (int g = 0; g < G; ++g) {
        const int sm = (i * G + g) * U + lane;
        if (sm < N) y[(size_t)(c0 + ch) * N + sm] = sy[i & 1][ch][g][lane];
      }
    }
  };

  if (warp == 1) {
    for (int i = 0; i < B - 1; ++i) load(i);
    wait_all_but_newest();
  }
  __syncthreads();

  const bool chain = warp == 0 && lane < cb;
  float z1 = 0.0f, z2 = 0.0f;
  if (chain) {
    z1 = z0[(size_t)(c0 + lane) * 2];
    z2 = z0[(size_t)(c0 + lane) * 2 + 1];
  }
  for (int i = 0; i < handovers; ++i) {
    if (chain) {
#pragma unroll 1
      for (int g = 0; g < G; ++g) {
        const int n = N - (i * G + g) * U;
        if (n <= 0) break;
        // the chunk into registers, 16 bytes a load, and its outputs
        // back the same way: the steps touch no memory
        float xa[U], ya[U];
        const float4* xq = reinterpret_cast<const float4*>(sx[i % B][lane][g]);
#pragma unroll
        for (int j = 0; j < U / 4; ++j) {
          const float4 v = xq[j];
          xa[4 * j] = v.x;
          xa[4 * j + 1] = v.y;
          xa[4 * j + 2] = v.z;
          xa[4 * j + 3] = v.w;
        }
        if (n >= U) {
#pragma unroll
          for (int j = 0; j < U; ++j) ya[j] = step(cf, xa[j], z1, z2);
        } else {
#pragma unroll
          for (int j = 0; j < U; ++j) {
            if (j >= n) break;
            ya[j] = step(cf, xa[j], z1, z2);
          }
        }
        float4* yq = reinterpret_cast<float4*>(sy[i & 1][lane][g]);
#pragma unroll
        for (int j = 0; j < U / 4; ++j)
          yq[j] = make_float4(ya[4 * j], ya[4 * j + 1], ya[4 * j + 2],
                              ya[4 * j + 3]);
      }
    } else if (warp == 1) {
      if (i > 0) store(i - 1);
      load(i + B - 1);
      wait_all_but_newest();
    }
    __syncthreads();
  }
  if (warp == 1 && handovers > 0) store(handovers - 1);
  if (chain) {
    zout[(size_t)(c0 + lane) * 2] = z1;
    zout[(size_t)(c0 + lane) * 2 + 1] = z2;
  }
}

}  // namespace

extern "C" int biquad(const void* x, const void* z0, void* y, void* z, int C,
                      int N, float b0, float b1, float b2, float a1, float a2,
                      void* stream) {
  if (C <= 0) return 0;
  if (N < 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((C + CH - 1) / CH);
  const Coefs cf{b0, b1, b2, a1, a2};
  biquad_kernel<<<blocks, 64, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)z0, (float*)y, (float*)z, C, N, cf);
  return (int)cudaGetLastError();
}
