// A run of S direct-form-II-transposed biquads over the samples of each
// channel, in one launch. Stage s computes
//
//   out  = b0*x + z1
//   z1'  = b1*x - a1*out + z2
//   z2'  = b2*x - a2*out
//
// and hands on x' = to_float(from_float(out)) in the run's sample format
// (codecs/pcm.py): what the filter graph hands from one biquad filter to
// the next. The last stage's x' is the run's output y, whose from_float
// is the last filter's output frame.
//
// Replaces librempeg_tpu/filters/biquads.py _df2t_scan (a lax.scan over
// samples, not a Pallas kernel), which the JAX package calls once per
// filter. x is [C, N] float32, z0 [S, C, 2] each stage's carried state
// (z1, z2); the kernel writes y [C, N] and the final states z [S, C, 2],
// which the next call takes as z0. The coefficients come by value, five
// float32 values a stage (b0, b1, b2 and a1, a2, already divided by the
// leading denominator coefficient).
//
// Float order. For a call with two or more channels XLA's CPU code for
// the scan computes out = fma(b0, x, z1), z1' = fma(b1, x, -(a1*out)) +
// z2 with the product a1*out rounded alone, and z2' = fma(b2, x,
// -(a2*out)) (tests/test_torch_biquads.py reads this off the JAX
// package); for a mono call it rounds b0*x before adding z1. The kernel
// takes the two-channel form for every channel count, written with
// intrinsics so that nvcc cannot contract it another way; the plain
// versions (kernels/biquad.py biquad_plain, biquad_cascade_plain)
// compute the same roundings from float64.
//
// The round trip in the format's integer units u (2^-15 for s16, 2^-31
// for s32, 2^-7 for u8 around 128; flt and dbl have none): X' =
// rint(clamp(out / u)), clamped to pcm's range (s32 to +2^31: pcm's
// int64 clamp to 2^31 - 1 comes back through float32 as 2^31), and x' =
// X' u. The clamp's bounds are integers, so clamping before the
// rounding gives pcm's clamp after it (NaN, +inf and values past 2^63,
// where pcm's float-to-int64 conversion is undefined, are outside the
// contract; tests/test_torch_biquad_cascade.py holds this form to pcm's
// on the CPU). The next stage takes X' itself, with its b coefficients
// times u: u is a power of two, so b u is exact and fma(b u, X', c) is
// fma(b, x', c), one rounding of the same real number (outside the
// contract: b below 2^-95 in magnitude, whose b u would lose bits). The
// rounding is the add and subtract of 1.5 * 2^23 (half to even, exact
// below 2^22, which the clamp keeps s16 and u8 under), rintf for s32.
//
// Bound on the H100: latency. From z1 back to z1 a step is FFMA (out),
// FMUL (a1*out), FFMA (b1*x - that), FADD (+ z2): four dependent
// operations at 4 cycles each (tools/dep_latency.py), 16 cycles a
// sample; z2' and the round trip hang off out beside the chain. A stage
// needs the stage before only through its outputs, so the stages run at
// the same time: lane (s, c) of the block's first warp walks stage s of
// channel c, four blocks of D steps behind lane (s - 1, c). A lane keeps
// a block's D round-tripped outputs in registers and writes them to its
// slot of a shared ring (two 16-byte stores) early in its next block;
// after the __syncwarp that ends each pair of blocks, the lane above
// loads them (two 16-byte loads) while it runs the block before the one
// that takes them. So a step is the chain's four operations, z2's two
// and the round trip's (up to five), with no select or shuffle, and a
// run of S stages over N samples takes N + 4 D (S - 1) steps of one
// chain (a few blocks more). The memory warp, the block's
// second, does all global traffic: it copies x H samples a handover
// into a ring of B shared buffers (cp.async, 4 bytes a lane, a commit
// group a handover) ahead of stage 0, and writes the last stage's
// outputs of the handover before back to y (times u), 128 coalesced
// bytes an instruction; one __syncthreads a handover passes the
// buffers over (the scheme of csrc/shape_scan.cu). A block takes up to
// CH channels, and no more than 32 / S, so that all its lanes share one
// warp.
#include <cuda_runtime.h>

namespace {

constexpr int SMAX = 32;       // stages a launch; a longer run is split
constexpr int CH = 8;          // channels a block, at most
constexpr int D = 8;           // steps a block
constexpr int LAG = 4 * D;     // steps a stage runs behind the one before
constexpr int H = 128;         // steps a handover
constexpr int B = 4;           // handovers in the input ring

struct Coefs {
  float c[SMAX][5];
};

struct Stage {
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

// every copy group but the newest has landed: the chain, at handover i,
// reads handovers i and i + 1
__device__ __forceinline__ void wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// the format's integer unit u (1 for flt and dbl)
template <int FMT>
__device__ __forceinline__ float unit() {
  return FMT == 1 ? 1.0f / 32768.0f
                  : FMT == 2 ? 1.0f / 2147483648.0f
                             : FMT == 3 ? 1.0f / 128.0f : 1.0f;
}

// X' of out: from_float(out) in integer units (u8: less 128), or out for
// flt and dbl (FMT 0 flt and dbl, 1 s16, 2 s32, 3 u8)
template <int FMT>
__device__ __forceinline__ float round_trip(float out) {
  constexpr float M = 12582912.0f;                   // 1.5 * 2^23
  if (FMT == 1) {
    const float v = fminf(fmaxf(__fmul_rn(out, 32768.0f), -32768.0f),
                          32767.0f);
    return __fsub_rn(__fadd_rn(v, M), M);
  }
  if (FMT == 2) {
    return rintf(fminf(fmaxf(__fmul_rn(out, 2147483648.0f), -2147483648.0f),
                       2147483648.0f));
  }
  if (FMT == 3) {
    // out * 128 is exact, so the fma rounds once, as pcm's add does
    const float v = fminf(fmaxf(__fmaf_rn(out, 128.0f, 128.0f), 0.0f),
                          255.0f);
    return __fsub_rn(__fadd_rn(v, M), M + 128.0f);
  }
  return out;
}

// a block's D values from shared memory, and back, 16 bytes an access
__device__ __forceinline__ void load_block(float (&v)[D], const float* p) {
#pragma unroll
  for (int j = 0; j < D / 4; ++j) {
    const float4 a = reinterpret_cast<const float4*>(p)[j];
    v[4 * j] = a.x;
    v[4 * j + 1] = a.y;
    v[4 * j + 2] = a.z;
    v[4 * j + 3] = a.w;
  }
}

__device__ __forceinline__ void store_block(float* p, const float (&v)[D]) {
#pragma unroll
  for (int j = 0; j < D / 4; ++j)
    reinterpret_cast<float4*>(p)[j] =
        make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
}

// One block of D steps of one lane over its inputs xv. Step j computes
// the round trip of the step before's output (prev): those of this
// block's steps 0-6 go to rv, the previous block's step 7's to rp, and
// after step 2 (when that one is ready) rp goes to dst. So the round
// trips never hold up the next block's first step. FULL: the lane
// starts from its state (zi1, zi2) at block `start`, and its last state
// is taken after step `cap` of block `end`; else the block starts no
// lane and a lane's last state is taken at the end of a block (cap is
// D - 1).
template <int FMT, bool FULL>
__device__ __forceinline__ void block(const Stage& k, const float (&xv)[D],
                                      float (&rv)[D], float (&rp)[D],
                                      float* dst, int blk, int start, float zi1,
                                      float zi2, int end, int cap, float& prev,
                                      float& z1, float& z2, float& zs1,
                                      float& zs2) {
  if (FULL && blk == start) {
    z1 = zi1;
    z2 = zi2;
  }
  const int at = FULL && blk == end ? cap : -1;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float x = xv[j];
    const float out = __fmaf_rn(k.b0, x, z1);
    z1 = __fadd_rn(__fmaf_rn(k.b1, x, -__fmul_rn(k.a1, out)), z2);
    z2 = __fmaf_rn(k.b2, x, -__fmul_rn(k.a2, out));
    (j ? rv[j - 1] : rp[D - 1]) = round_trip<FMT>(prev);
    prev = out;
    if (j == 2) store_block(dst, rp);
    if (FULL && j == at) {
      zs1 = z1;
      zs2 = z2;
    }
  }
  if (!FULL && blk == end) {
    zs1 = z1;
    zs2 = z2;
  }
}

template <int FMT>
__global__ void __launch_bounds__(64)
    biquad_kernel(const float* __restrict__ x, const float* __restrict__ z0,
                  float* __restrict__ y, float* __restrict__ zout, int C,
                  int N, int S, int chb, const __grid_constant__ Coefs cf) {
  // per channel: the input ring of B handovers, the output of 2; per
  // lane: its round trips of its last 4 blocks (padded: 16-byte
  // accesses of the lanes fall in distinct banks)
  __shared__ __align__(16) float sx[CH][B * H + 4];
  __shared__ __align__(16) float sy[CH][2 * H + 4];
  __shared__ __align__(16) float ring[32][4 * D + 4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * chb;
  const int cb = min(chb, C - c0);
  // lane (s, c) of warp 0; lanes past S * cb walk along unused
  const int s = lane / cb, c = lane % cb;
  const bool chain = warp == 0 && s < S;
  const size_t zi = ((size_t)s * C + c0 + c) * 2;
  if (N == 0) {
    if (chain) {
      zout[zi] = z0[zi];
      zout[zi + 1] = z0[zi + 1];
    }
    return;
  }
  // lane (s, c) takes sample n at step n + LAG s and stores its round
  // trip a block later: the last stage's output of sample n lands at
  // step n + lag
  const int lag = LAG * (S - 1) + D;
  // the walk: blocks of D steps, taken in pairs (a pair never straddles
  // a handover), one block past the last stage's last
  const int blocks = (N + D - 1) / D + LAG / D * (S - 1) + 1;
  const int pairs = (blocks + 1) / 2;
  const int handovers = (pairs * 2 * D + H - 1) / H;

  // the memory warp: copy handover i's input samples into their buffer
  // (zeros past N) ...
  auto load = [&](int i) {
    if (i * H < N) {
      for (int ch = 0; ch < cb; ++ch) {
        for (int k = lane; k < H; k += 32) {
          const int n = i * H + k;
          float* v = &sx[ch][i % B * H + k];
          if (n < N)
            copy4(v, x + (size_t)(c0 + ch) * N + n);
          else
            *v = 0.0f;
        }
      }
    }
    commit();
  };
  // ... and write the outputs the last stage stored in handover i back
  auto store = [&](int i) {
    for (int ch = 0; ch < cb; ++ch) {
      for (int k = lane; k < H; k += 32) {
        const int n = i * H + k - lag;
        if (n >= 0 && n < N)
          y[(size_t)(c0 + ch) * N + n] =
              __fmul_rn(sy[ch][(i & 1) * H + k], unit<FMT>());
      }
    }
  };

  if (warp == 1) {
    for (int i = 0; i < B - 1; ++i) load(i);
    wait_all_but_newest();
  }

  // stage 0 takes x, the others X' of the stage before: b times u
  Stage k{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float zi1 = 0.0f, zi2 = 0.0f;
  if (chain) {
    const float* p = cf.c[s];
    const float u = s > 0 ? unit<FMT>() : 1.0f;
    k = Stage{__fmul_rn(p[0], u), __fmul_rn(p[1], u), __fmul_rn(p[2], u),
              p[3], p[4]};
    zi1 = z0[zi];
    zi2 = z0[zi + 1];
  }
  __syncthreads();
  if (warp == 1) {
    for (int i = 0; i < handovers; ++i) {
      if (i > 0) store(i - 1);
      load(i + B - 1);
      wait_all_but_newest();
      __syncthreads();
    }
    store(handovers - 1);
    return;
  }

  const bool first = s == 0, last = chain && s == S - 1;
  const int start = LAG / D * s;             // the block a lane starts in
  const int end = start + (N - 1) / D;       // the block it ends in
  const int cap = (N - 1) % D;
  // the blocks that may start a lane, and those that end one
  const int head = LAG / D * (S - 1) + 1, tail = (N - 1) / D;
  float z1 = 0.0f, z2 = 0.0f, zs1 = 0.0f, zs2 = 0.0f, prev = 0.0f;
  float xa[D], xb[D], ra[D], rb[D];
  // The inputs of block blk: stage 0's samples blk D.. of the input ring;
  // the others' the lower lane's round trips of block blk - 4, which it
  // stored in block blk - 3 to ring slot blk & 3 (a pair's end, a
  // __syncwarp, lies between; its next store there, in block blk + 1,
  // comes after the end of the pair that loads them).
  const float* rbase = first ? &sx[c][0] : &ring[lane - cb][0];
  const int rmask = first ? B * H - 1 : 4 * D - 1;
  // Where block blk stores the round trips of block blk - 1: the lane's
  // ring slot blk - 1 & 3, the last stage the output buffer at the
  // storing block's step (the memory warp's lag counts that block).
  float* wbase = last ? &sy[c][0] : &ring[lane][0];
  const int wmask = last ? 2 * H - 1 : 4 * D - 1;
  const int wback = last ? 0 : 1;
  auto rd = [&](int blk) { return rbase + (blk * D & rmask); };
  auto wr = [&](int blk) { return wbase + ((blk - wback) * D & wmask); };

  load_block(xa, rd(0));
  for (int i = 0; i < handovers; ++i) {
    const int p0 = i * (H / D / 2), p1 = min(p0 + H / D / 2, pairs);
    if (2 * p0 >= head && (cap == D - 1 || 2 * p1 <= tail)) {
      // no block of this handover starts a lane or ends one mid-block
#pragma unroll 1
      for (int p = p0; p < p1; ++p) {
        const int b0 = 2 * p, b1 = b0 + 1;
        load_block(xb, rd(b1));
        block<FMT, false>(k, xa, ra, rb, wr(b0), b0, start, zi1, zi2, end,
                          cap, prev, z1, z2, zs1, zs2);
        load_block(xa, rd(b1 + 1));
        block<FMT, false>(k, xb, rb, ra, wr(b1), b1, start, zi1, zi2, end,
                          cap, prev, z1, z2, zs1, zs2);
        __syncwarp();
      }
    } else {
#pragma unroll 1
      for (int p = p0; p < p1; ++p) {
        const int b0 = 2 * p, b1 = b0 + 1;
        load_block(xb, rd(b1));
        block<FMT, true>(k, xa, ra, rb, wr(b0), b0, start, zi1, zi2, end,
                         cap, prev, z1, z2, zs1, zs2);
        load_block(xa, rd(b1 + 1));
        block<FMT, true>(k, xb, rb, ra, wr(b1), b1, start, zi1, zi2, end,
                         cap, prev, z1, z2, zs1, zs2);
        __syncwarp();
      }
    }
    __syncthreads();
  }
  if (chain) {
    zout[zi] = zs1;
    zout[zi + 1] = zs2;
  }
}

}  // namespace

// fmt: 0 flt or dbl, 1 s16, 2 s32, 3 u8; coefs: S x (b0, b1, b2, a1, a2)
// in host memory
extern "C" int biquad(const void* x, const void* z0, void* y, void* z, int C,
                      int N, int S, const float* coefs, int fmt,
                      void* stream) {
  if (C <= 0 || S <= 0) return 0;
  if (N < 0 || S > SMAX || fmt < 0 || fmt > 3)
    return (int)cudaErrorInvalidValue;
  Coefs cf{};
  for (int s = 0; s < S; ++s)
    for (int j = 0; j < 5; ++j) cf.c[s][j] = coefs[s * 5 + j];
  const int chb = min(CH, 32 / S);
  const unsigned blocks = (unsigned)((C + chb - 1) / chb);
  const cudaStream_t st = (cudaStream_t)stream;
  const float* xp = (const float*)x;
  const float* zp = (const float*)z0;
  float* yp = (float*)y;
  float* zo = (float*)z;
  switch (fmt) {
    case 0:
      biquad_kernel<0><<<blocks, 64, 0, st>>>(xp, zp, yp, zo, C, N, S, chb,
                                              cf);
      break;
    case 1:
      biquad_kernel<1><<<blocks, 64, 0, st>>>(xp, zp, yp, zo, C, N, S, chb,
                                              cf);
      break;
    case 2:
      biquad_kernel<2><<<blocks, 64, 0, st>>>(xp, zp, yp, zo, C, N, S, chb,
                                              cf);
      break;
    default:
      biquad_kernel<3><<<blocks, 64, 0, st>>>(xp, zp, yp, zo, C, N, S, chb,
                                              cf);
  }
  return (int)cudaGetLastError();
}
