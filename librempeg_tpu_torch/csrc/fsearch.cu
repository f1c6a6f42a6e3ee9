// Fused integer full search + motion compensation over +-r.
//
// Replaces the Pallas kernel of librempeg_tpu/ops/pallas/mesearch.py
// (full_search_mc -> _kernel) and holds the contract of
// ops.motion.full_search_mc_xla(cur, ref, r, 16, 1) in this package:
// current and reference planes rounded to bf16 (round to nearest even),
// the reference edge-clamped to the plane, |cur - ref| rounded to bf16
// and summed over the 16x16 block in float32, the (2r+1)^2 candidates in
// raster order c = dy*side + dx with the first minimum winning on
// strict <, mv = (c / side - r, c % side - r), and the winner's bf16
// reference pixels as the prediction.
//
// The TPU kernel cut the frame into tiles, but each tile's window came
// from the globally edge-padded reference, so the search is a
// whole-frame search with edge clamping; tiles play no part here.
//
// Design: one block per strip of K MBs of one MB row (the last strip of
// a row may be shorter): K = 16 for r <= 8, 8 above, where each thread's
// 2r+1 sums and its 16+2r window values would not fit beside 16 MBs'
// threads in the register file. The strip's (16+2r) x (16K+2r)
// reference window and its 16 x 16K current pixels go to shared memory
// once, rounded to bf16 and kept as floats; neighbouring MBs share all
// but 2r of the window's columns. Thread (j, dy) owns candidate row dy
// of MB j: its 2r+1 sums sit in registers. Per pixel row it loads the
// 16 current values and the 16+2r reference values once (float4 loads;
// the window pitch is 4 mod 8 floats, so the threads of consecutive dy
// hit distinct banks) and slides them over every dx. No shuffle and no
// shared-memory partial per candidate: each sum runs row-major over the
// block, one float32 add at a time, so a candidate's cost is the same
// on every run (exact, hence equal to the plain version, on integer
// inputs). Each thread keeps the first minimum of its row; one thread
// per MB then scans the rows in order (strict <), which keeps the first
// minimum in raster order. All threads write the winners' pixels.
// The r in 0..16 is a template parameter, so the sums and the row
// segments are register arrays (minterpolate's search_range reaches 16).
//
// Rounding: the two differences of a pixel pair go through one
// cvt.rn.bf16x2.f32 (__floats2bfloat162_rn) and are widened back with a
// shift or a mask. On the card it issued fewer instructions and ran
// faster than an integer round-to-nearest-even (add 0x7FFF + lsb, mask);
// the SASS counts and times are in PERF.md.
//
// Bound on the H100: operations. At the kernel leg's shape (8 x 720 x
// 1280, r = 4: 28800 MBs, 81 candidates) the search evaluates 597M
// pixel-candidates (a subtract, an absolute value and an add each:
// 1.8 GFLOP, 27 us at 67 TFLOP/s), against 89 MB of float32 moved (27
// us at 3.35 TB/s). The kernel issues about 3.5 instructions per
// pixel-candidate (subtract with |.|, half a bf16x2 convert, a widen,
// an add), so issue, not memory, sets its time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int BS = 16;
constexpr int MAX_R = 16;        // the encoders search +-4 and +-8,
                                 // minterpolate up to +-16

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// |a - b| and |c - d|, each float32 difference rounded to bf16 (nearest
// even), as floats.
__device__ __forceinline__ float2 absdiff_bf16x2(float a, float b, float c,
                                                 float d) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(fabsf(a - b), fabsf(c - d));
  return make_float2(__low2float(h), __high2float(h));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <int R>
struct Geo {
  // MBs per block (a strip of one MB row): 8 past r = 8, so that the
  // block's K * SIDE threads keep their 2r+1 sums and row segments in
  // registers
  static constexpr int K = R <= 8 ? 16 : 8;
  static constexpr int SIDE = 2 * R + 1;
  static constexpr int WS = BS + 2 * R;            // window rows
  static constexpr int WV = (WS + 3) / 4;          // float4 per row segment
  // window pitch in floats: room for the last MB's float4 reads, 4 mod 8
  static constexpr int PITCH = (BS * K + 2 * R + 7) / 8 * 8 + 4;
  static constexpr int CPITCH = BS * K;            // current-pixel pitch
  static constexpr int THREADS = (K * SIDE + 31) / 32 * 32;
  static constexpr int SMEM = (WS * PITCH + BS * CPITCH) * 4;
};

template <int R>
__global__ void __launch_bounds__(Geo<R>::THREADS)
    fsearch_kernel(const float* __restrict__ cur,
                   const float* __restrict__ ref, int H, int W,
                   int32_t* __restrict__ mv, float* __restrict__ cost,
                   float* __restrict__ pred) {
  using G = Geo<R>;
  extern __shared__ float4 smem[];
  float* const win = reinterpret_cast<float*>(smem);    // [WS][PITCH]
  float* const cs = win + G::WS * G::PITCH;             // [16][CPITCH]
  __shared__ float row_cost[G::K * G::SIDE];
  __shared__ int row_cand[G::K * G::SIDE];
  __shared__ int best[G::K];
  const int bw = W / BS, bh = H / BS, strips = (bw + G::K - 1) / G::K;
  const int s = blockIdx.x % strips;
  const int by = (blockIdx.x / strips) % bh;
  const int n = blockIdx.x / (strips * bh);
  const int j0 = s * G::K, kk = min(G::K, bw - j0);
  const int tid = threadIdx.x;
  const size_t plane = (size_t)n * H * W;
  const int oy = by * BS - R, ox = j0 * BS - R;
  const int wcols = BS * kk + 2 * R, ccols = BS * kk;

  for (int i = tid; i < G::WS * wcols; i += blockDim.x) {
    const int rr = i / wcols, cc = i - rr * wcols;
    win[rr * G::PITCH + cc] = bf16r(__ldg(
        ref + plane + (size_t)clampi(oy + rr, 0, H - 1) * W +
        clampi(ox + cc, 0, W - 1)));
  }
  for (int i = tid; i < BS * ccols; i += blockDim.x) {
    const int rr = i / ccols, cc = i - rr * ccols;
    cs[rr * G::CPITCH + cc] = bf16r(__ldg(
        cur + plane + (size_t)(by * BS + rr) * W + j0 * BS + cc));
  }
  __syncthreads();

  const int j = tid / G::SIDE, dy = tid - j * G::SIDE;
  if (j < kk) {
    float acc[G::SIDE];
#pragma unroll
    for (int d = 0; d < G::SIDE; ++d) acc[d] = 0.f;
    for (int py = 0; py < BS; ++py) {
      float c[BS], w[4 * G::WV];
      const float4* cp =
          reinterpret_cast<const float4*>(cs + py * G::CPITCH + BS * j);
      const float4* wp = reinterpret_cast<const float4*>(
          win + (py + dy) * G::PITCH + BS * j);
#pragma unroll
      for (int q = 0; q < BS / 4; ++q) {
        const float4 t = cp[q];
        c[4 * q] = t.x, c[4 * q + 1] = t.y, c[4 * q + 2] = t.z,
        c[4 * q + 3] = t.w;
      }
#pragma unroll
      for (int q = 0; q < G::WV; ++q) {
        const float4 t = wp[q];
        w[4 * q] = t.x, w[4 * q + 1] = t.y, w[4 * q + 2] = t.z,
        w[4 * q + 3] = t.w;
      }
#pragma unroll
      for (int px = 0; px < BS; px += 2) {
#pragma unroll
        for (int d = 0; d < G::SIDE; ++d) {
          const float2 a =
              absdiff_bf16x2(c[px], w[px + d], c[px + 1], w[px + 1 + d]);
          acc[d] += a.x;
          acc[d] += a.y;
        }
      }
    }
    float bc = acc[0];
    int bd = 0;
#pragma unroll
    for (int d = 1; d < G::SIDE; ++d)
      if (acc[d] < bc) { bc = acc[d]; bd = d; }
    row_cost[tid] = bc;
    row_cand[tid] = dy * G::SIDE + bd;
  }
  __syncthreads();
  if (tid < kk) {
    const int b0 = tid * G::SIDE;
    float bc = row_cost[b0];
    int bi = row_cand[b0];
    for (int d = 1; d < G::SIDE; ++d)
      if (row_cost[b0 + d] < bc) { bc = row_cost[b0 + d]; bi = row_cand[b0 + d]; }
    const size_t m = ((size_t)n * bh + by) * bw + j0 + tid;
    mv[m * 2 + 0] = bi / G::SIDE - R;
    mv[m * 2 + 1] = bi % G::SIDE - R;
    cost[m] = bc;
    best[tid] = bi;
  }
  __syncthreads();
  for (int i = tid; i < BS * ccols; i += blockDim.x) {
    const int rr = i / ccols, cc = i - rr * ccols, b = best[cc / BS];
    pred[plane + (size_t)(by * BS + rr) * W + j0 * BS + cc] =
        win[(rr + b / G::SIDE) * G::PITCH + cc + b % G::SIDE];
  }
}

template <int R>
int launch(const void* cur, const void* ref, int N, int H, int W, void* mv,
           void* cost, void* pred, cudaStream_t st) {
  using G = Geo<R>;
  // the shared-memory attribute holds for the process: set it once per
  // device (bit d of `ready`; devices past 63 set it on every call)
  static std::atomic<uint64_t> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(fsearch_kernel<R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::SMEM);
    if (err != cudaSuccess) return (int)err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  const long nblk = (long)N * (H / BS) * ((W / BS + G::K - 1) / G::K);
  if (nblk > 0) {
    fsearch_kernel<R><<<(unsigned)nblk, G::THREADS, G::SMEM, st>>>(
        (const float*)cur, (const float*)ref, H, W, (int32_t*)mv,
        (float*)cost, (float*)pred);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int full_search_mc(const void* cur, const void* ref, int N,
                              int H, int W, int r, void* mv, void* cost,
                              void* pred, void* stream) {
  if (r < 0 || r > MAX_R || H % BS || W % BS)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (r) {
    case 0: return launch<0>(cur, ref, N, H, W, mv, cost, pred, st);
    case 1: return launch<1>(cur, ref, N, H, W, mv, cost, pred, st);
    case 2: return launch<2>(cur, ref, N, H, W, mv, cost, pred, st);
    case 3: return launch<3>(cur, ref, N, H, W, mv, cost, pred, st);
    case 4: return launch<4>(cur, ref, N, H, W, mv, cost, pred, st);
    case 5: return launch<5>(cur, ref, N, H, W, mv, cost, pred, st);
    case 6: return launch<6>(cur, ref, N, H, W, mv, cost, pred, st);
    case 7: return launch<7>(cur, ref, N, H, W, mv, cost, pred, st);
    case 8: return launch<8>(cur, ref, N, H, W, mv, cost, pred, st);
    case 9: return launch<9>(cur, ref, N, H, W, mv, cost, pred, st);
    case 10: return launch<10>(cur, ref, N, H, W, mv, cost, pred, st);
    case 11: return launch<11>(cur, ref, N, H, W, mv, cost, pred, st);
    case 12: return launch<12>(cur, ref, N, H, W, mv, cost, pred, st);
    case 13: return launch<13>(cur, ref, N, H, W, mv, cost, pred, st);
    case 14: return launch<14>(cur, ref, N, H, W, mv, cost, pred, st);
    case 15: return launch<15>(cur, ref, N, H, W, mv, cost, pred, st);
    default: return launch<16>(cur, ref, N, H, W, mv, cost, pred, st);
  }
}
