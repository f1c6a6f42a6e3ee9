// Error-feedback requantisation (the noise shaper of the dither stage):
// for each sample n of each channel c, with the K most recent errors
// e[0] (newest) .. e[K-1],
//
//   fb   = c0*e0 + c1*e1 + ... + c(K-1)*e(K-1)   (left to right, each
//          term added as a fused multiply-add: see the float order below)
//   want = x[c, n] - fb
//   y    = round_half_even(want + noise[c, n])
//   e'   = y - want, pushed in front of the history.
//
// Replaces librempeg_tpu/resample/dither.py _shape_scan (a lax.scan over
// samples, not a Pallas kernel). x and noise are [C, N] float32 in LSB
// units, coefs [K], err0 [K, C] the carried history; the kernel writes
// y [C, N] and the final history hist [K, C], which the next call takes
// as err0.
//
// Every output depends on the rounded error of the K samples before it,
// so a channel is one serial chain: one thread per channel walks its N
// samples with the history in registers.
//
// Float order. XLA's CPU code for the JAX package's einsum "kc,k->c"
// sums k = 0 first and adds each term as an FMA (the exact product, one
// rounding), except in channel 0 of a two-channel call, where it rounds
// each product first (tests/test_torch_resample.py reads this off the
// JAX package). The kernel takes the FMA form in every channel,
// __fmaf_rn; the plain version (resample/dither.py shape_scan_plain)
// computes the same single-rounded FMA from float64, so the two agree
// bit for bit. The other steps are float operations that nvcc must not
// contract (__fsub_rn, __fadd_rn), and the rounding is rintf (half to
// even, as jnp.round and torch.round).
//
// Loads. x and noise do not depend on the chain, so each thread loads
// the next U samples of both into registers while it runs the current
// U: a step's loads are issued a whole chunk before the chain reaches
// them, and only the first chunk waits on global memory.
//
// Bound on the H100: latency. A step is a chain of K + 4 dependent
// operations: the K terms of fb (the newest error enters first, so all
// K follow it), the subtraction, the dither add, rint and the error
// subtraction that feeds the next step. N steps take N times that
// chain's latency whatever the bytes (8 bytes read and 4 written a
// sample).
#include <cuda_runtime.h>

namespace {

constexpr int U = 32;  // samples per chunk, loaded one chunk ahead

// One sample: the feedback sum, the requantised value q (returned) and
// the new error pushed in front of the history.
template <int K>
__device__ __forceinline__ float step(float (&e)[K], const float (&cf)[K],
                                      float xi, float di) {
  float fb = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) fb = __fmaf_rn(e[k], cf[k], fb);
  const float want = __fsub_rn(xi, fb);
  const float q = rintf(__fadd_rn(want, di));
#pragma unroll
  for (int k = K - 1; k > 0; --k) e[k] = e[k - 1];
  e[0] = __fsub_rn(q, want);
  return q;
}

template <int K>
__global__ void shape_scan_kernel(const float* __restrict__ x,
                                  const float* __restrict__ noise,
                                  const float* __restrict__ coefs,
                                  const float* __restrict__ err0,
                                  float* __restrict__ y,
                                  float* __restrict__ hist, int C, int N) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float cf[K], e[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cf[k] = coefs[k];
    e[k] = err0[k * C + c];
  }
  const float* xr = x + (size_t)c * N;
  const float* nr = noise + (size_t)c * N;
  float* yr = y + (size_t)c * N;
  float xa[U], na[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    xa[j] = j < N ? __ldg(xr + j) : 0.0f;
    na[j] = j < N ? __ldg(nr + j) : 0.0f;
  }
  for (int base = 0; base < N; base += U) {
    // the next chunk, its loads checked only where it is the last
    float xb[U], nb[U];
    const int next = base + U;
    if (next + U <= N) {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        xb[j] = __ldg(xr + next + j);
        nb[j] = __ldg(nr + next + j);
      }
    } else {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        xb[j] = next + j < N ? __ldg(xr + next + j) : 0.0f;
        nb[j] = next + j < N ? __ldg(nr + next + j) : 0.0f;
      }
    }
    // this chunk: whole, or the last samples
    if (base + U <= N) {
#pragma unroll
      for (int j = 0; j < U; ++j) yr[base + j] = step(e, cf, xa[j], na[j]);
    } else {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        if (base + j >= N) break;
        yr[base + j] = step(e, cf, xa[j], na[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      xa[j] = xb[j];
      na[j] = nb[j];
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) hist[k * C + c] = e[k];
}

}  // namespace

extern "C" int shape_scan(const void* x, const void* noise, const void* coefs,
                          const void* err0, void* y, void* hist, int K, int C,
                          int N, void* stream) {
  if (C <= 0) return 0;
  const int per = 32;
  const unsigned blocks = (unsigned)((C + per - 1) / per);
  cudaStream_t s = (cudaStream_t)stream;
  const float *xf = (const float*)x, *nf = (const float*)noise;
  const float *cf = (const float*)coefs, *ef = (const float*)err0;
  float *yf = (float*)y, *hf = (float*)hist;
  switch (K) {
    case 3:
      shape_scan_kernel<3><<<blocks, per, 0, s>>>(xf, nf, cf, ef, yf, hf, C, N);
      break;
    case 5:
      shape_scan_kernel<5><<<blocks, per, 0, s>>>(xf, nf, cf, ef, yf, hf, C, N);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
