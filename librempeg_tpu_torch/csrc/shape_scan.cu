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
// contract (__fsub_rn, __fadd_rn).
//
// Rounding. The chain cannot be reordered, so the design shortens its
// links: where it is exact, t is rounded to an integer by adding and
// subtracting M = 1.5 * 2^23 (two FADDs, a shorter link than FRND, the
// rintf instruction). For |t| <= 2^22, M + t lies in [2^23, 2^24],
// where the float spacing is 1, so the addition rounds M + t half to
// even to an integer, and as M is even that is M + rint(t); the
// subtraction is exact. Above 2^22 the addition rounds to a multiple of
// 2 or 1/2 and the form is wrong, so each chunk of U samples takes it
// only where a range test proves |t| < 2^22 for every step of the chunk
// (else rintf), per lane:
//
//   X = max |x|, D = max |noise| over the chunk, E a bound on |e| of
//   the history at the chunk's start, E' = max(E, 1.5 + D),
//   S = sum |c_k|:  the chunk is fast when X + D + S * E' < 2^21.
//
// Why that suffices. By induction over the chunk's steps, every error
// in the history is at most E': |fb| <= S * E' (times 1 + K * 2^-23 for
// the FMAs' roundings), so |t| <= X + S * E' + D plus the roundings of
// want and t; as the test's own float operations (and S's sum) round
// by at most 2^-24 each, the exact sum is below 2^21 * (1 + 2^-21), and
// |t| stays below 2^21 * (1 + 2^-20) + 1 < 2^22, a margin of about 2^21
// for everything above. Then q = rint(t) exactly, and the new error
// |q - want| <= 0.5 + |t - want| <= 0.5 + D + 0.125 (|t| < 2^22: want + d
// rounds by at most a quarter ulp of 0.5), rounded once more, so at most
// 1.5 + D <= E'. After a fast chunk E' bounds the history: the next
// chunk's test needs nothing from the chain. After a rintf chunk E is
// read off the history itself; a call starts from max |err0|.
//
// The maxima are taken over the float bits with the sign cleared, as
// unsigned integers: they order as the magnitudes, and a NaN sorts above
// infinity, so a NaN or an infinity in x, the noise or the history makes
// the test false (a comparison with NaN is false) and its chunk takes
// rintf. s16 and u8 samples (|x| <= 2^15) pass on any sane input;
// s32 (LSB 2^-31) fails at full scale and takes rintf. The test reads
// the data, never the output format: a float input may exceed [-1, 1].
//
// Sign of zero. rintf(-0.3) is -0.0 where the fast form gives +0.0.
// Every operation of a step is an add, a subtract, a multiply-add or a
// rounding to an integer, and the value of each result depends only on
// the values of its operands: a zero's sign decides only the sign of a
// zero result. So the two forms give y and hist equal by value, and a
// y of -0.0 in place of +0.0 is the only difference (clip_to_int makes
// both 0; tests/test_torch_shape_scan.py runs the plain scan from a
// history of -0.0 and +0.0).
//
// Memory off the chain. A global load or store issued by the chain's
// own thread costs the chain time even where nothing waits on its data
// (tools/dep_latency.py, one warp with two lanes as on the path, NVIDIA
// H100 80GB HBM3 at 700 W: the bare step 40 cycles, with its 4-byte
// global store 49, with the next 32 samples loaded into registers
// every 32 steps 63, both 77; with a 4-byte shared store 41). So the
// chain's thread touches only shared memory, and a second warp of the
// block, the memory warp, does all the global traffic, G chunks of U
// samples at a time (a handover): it copies x and the noise B - 1
// handovers ahead into a ring of B shared buffers (cp.async, 4 bytes a
// lane, each handover a commit group), reduces each landed chunk's
// range-test maxima per channel with one __reduce_max_sync each, and
// writes the chain's outputs of the handover before back to y, 128
// coalesced bytes an instruction. One __syncthreads a handover passes
// the buffers over. The chain's thread reads a chunk's x and noise
// (interleaved in the ring) into registers before the chunk's first
// step, 16 bytes a load, and writes its outputs back to shared memory
// after the last. A block serves CH channels: lane c of warp 0 walks
// channel c. The taps are loaded by every thread outside any branch,
// so that they live in uniform registers.
//
// Bound on the H100: latency. A step is a chain of K + 4 dependent
// operations: the K terms of fb (the newest error enters first, so all
// K follow it), the subtraction, the dither add, the rounding and the
// error subtraction that feeds the next step (the fast rounding is two
// of them: K + 5 instructions). N steps take N times that chain's
// latency whatever the bytes (8 bytes read and 4 written a sample).
// Measured on an NVIDIA H100 80GB HBM3 (700 W): 49.3 cycles a step at
// 1980 MHz against the chain's 40 (tools/dep_latency.py), 0.0369 ms for
// 2 x 1120 samples, 0.0338 back to back, against a bound of 0.0204
// (chip_smoke.py).
#include <cuda_runtime.h>

namespace {

constexpr int U = 32;                  // samples per chunk (a lane each)
constexpr int G = 4;                   // chunks per handover
constexpr int B = 4;                   // handovers in the shared ring
constexpr int CH = 8;                  // channels per block
constexpr int XS = 2 * U + 4;          // a channel's stride in the ring
constexpr int YS = U + 4;              // ... in the outputs
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23
constexpr float kLimit = 2097152.0f;   // 2^21: the range test's limit

__device__ __forceinline__ unsigned mag_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

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

// One sample: the feedback sum, the requantised value q (returned) and
// the new error pushed in front of the history.
template <int K, bool FAST>
__device__ __forceinline__ float step(float (&e)[K], const float (&cf)[K],
                                      float xi, float di) {
  float fb = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) fb = __fmaf_rn(e[k], cf[k], fb);
  const float want = __fsub_rn(xi, fb);
  const float t = __fadd_rn(want, di);
  const float q = FAST ? __fsub_rn(__fadd_rn(t, kMagic), kMagic) : rintf(t);
#pragma unroll
  for (int k = K - 1; k > 0; --k) e[k] = e[k - 1];
  e[0] = __fsub_rn(q, want);
  return q;
}

// One chunk of U samples (WHOLE), or the first n of the last one.
template <int K, bool FAST, bool WHOLE>
__device__ __forceinline__ void chunk(float (&e)[K], const float (&cf)[K],
                                      const float (&xa)[U],
                                      const float (&na)[U], float (&ya)[U],
                                      int n) {
#pragma unroll
  for (int j = 0; j < U; ++j) {
    if (!WHOLE && j >= n) break;
    ya[j] = step<K, FAST>(e, cf, xa[j], na[j]);
  }
}

template <int K>
__global__ void __launch_bounds__(64)
    shape_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ noise,
                      const float* __restrict__ coefs,
                      const float* __restrict__ err0, float* __restrict__ y,
                      float* __restrict__ hist, int C, int N) {
  __shared__ __align__(16) float sxn[B][CH][G][XS];  // x, noise interleaved
  __shared__ __align__(16) float sy[2][CH][G][YS];   // the chain's outputs
  __shared__ unsigned sxm[B][CH][G], sdm[B][CH][G];  // max |x|, |noise| bits
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
          const size_t off = (size_t)(c0 + ch) * N + sm;
          float* v = &sxn[i % B][ch][g][2 * lane];
          if (sm < N) {
            copy4(v, x + off);
            copy4(v + 1, noise + off);
          } else {
            v[0] = 0.0f;
            v[1] = 0.0f;
          }
        }
      }
    }
    commit();
  };
  // ... and once they have landed (each lane reads what it copied), the
  // range test's maxima of each chunk
  auto stats = [&](int i) {
    if (i >= handovers) return;
    for (int ch = 0; ch < cb; ++ch) {
      for (int g = 0; g < G; ++g) {
        const float* v = &sxn[i % B][ch][g][2 * lane];
        const unsigned xm = __reduce_max_sync(~0u, mag_bits(v[0]));
        const unsigned dm = __reduce_max_sync(~0u, mag_bits(v[1]));
        if (lane == 0) {
          sxm[i % B][ch][g] = xm;
          sdm[i % B][ch][g] = dm;
        }
      }
    }
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
    stats(0);
  }
  __syncthreads();

  // the taps, loaded by every thread (the same address) outside any
  // branch, so that they can live in uniform registers
  float cf[K], e[K];
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cf[k] = __ldg(coefs + k);
    s += fabsf(cf[k]);
  }
  const bool chain = warp == 0 && lane < cb;
  unsigned eb = 0;  // bits of the bound on |e| of the history
  if (chain) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      e[k] = err0[k * C + c0 + lane];
      eb = max(eb, mag_bits(e[k]));
    }
  }
  for (int i = 0; i < handovers; ++i) {
    if (chain) {
#pragma unroll 1
      for (int g = 0; g < G; ++g) {
        const int n = N - (i * G + g) * U;
        if (n <= 0) break;
        const float d = __uint_as_float(sdm[i % B][lane][g]);
        const unsigned eb1 = max(eb, mag_bits(__fadd_rn(1.5f, d)));
        const bool fast =
            __fadd_rn(__fadd_rn(__uint_as_float(sxm[i % B][lane][g]), d),
                      __fmul_rn(s, __uint_as_float(eb1))) < kLimit;
        // the chunk into registers, 16 bytes a load, and its outputs
        // back the same way: the steps touch no memory
        float xa[U], na[U], ya[U];
        const float4* xn =
            reinterpret_cast<const float4*>(sxn[i % B][lane][g]);
#pragma unroll
        for (int j = 0; j < U / 2; ++j) {
          const float4 v = xn[j];
          xa[2 * j] = v.x;
          na[2 * j] = v.y;
          xa[2 * j + 1] = v.z;
          na[2 * j + 1] = v.w;
        }
        if (n >= U) {
          if (fast)
            chunk<K, true, true>(e, cf, xa, na, ya, n);
          else
            chunk<K, false, true>(e, cf, xa, na, ya, n);
        } else {
          if (fast)
            chunk<K, true, false>(e, cf, xa, na, ya, n);
          else
            chunk<K, false, false>(e, cf, xa, na, ya, n);
        }
        float4* yq = reinterpret_cast<float4*>(sy[i & 1][lane][g]);
#pragma unroll
        for (int j = 0; j < U / 4; ++j)
          yq[j] = make_float4(ya[4 * j], ya[4 * j + 1], ya[4 * j + 2],
                              ya[4 * j + 3]);
        if (fast) {
          eb = eb1;
        } else {
          eb = 0;
#pragma unroll
          for (int k = 0; k < K; ++k) eb = max(eb, mag_bits(e[k]));
        }
      }
    } else if (warp == 1) {
      if (i > 0) store(i - 1);
      load(i + B - 1);
      wait_all_but_newest();
      stats(i + 1);
    }
    __syncthreads();
  }
  if (warp == 1 && handovers > 0) store(handovers - 1);
  if (chain) {
#pragma unroll
    for (int k = 0; k < K; ++k) hist[k * C + c0 + lane] = e[k];
  }
}

}  // namespace

extern "C" int shape_scan(const void* x, const void* noise, const void* coefs,
                          const void* err0, void* y, void* hist, int K, int C,
                          int N, void* stream) {
  if (C <= 0) return 0;
  const int per = 64;
  const unsigned blocks = (unsigned)((C + CH - 1) / CH);
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
