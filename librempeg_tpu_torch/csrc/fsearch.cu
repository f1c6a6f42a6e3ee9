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
// Design: one block per (frame, 16x16 MB), 256 threads, one per pixel.
// The MB's current pixels and its (16+2r)^2 reference window go to
// shared memory once, rounded to bf16. For each candidate every thread
// takes its pixel's bf16 difference, the warp sums it with shuffles
// (a fixed order), and lane 0 stores the warp's partial. After the
// loop, one thread per candidate adds its 8 partials in warp order, so
// the float32 cost is the same on every run. Thread 0 scans the costs
// in candidate order; every thread writes its winning pixel.
//
// Bound on the H100: arithmetic and shuffles. At the kernel leg's shape
// (8 x 720 x 1280, r = 4: 28800 MBs, 81 candidates) the kernel reads
// each plane once (59 MB of float32 in, 30 MB out) but evaluates 597M
// pixel-candidates, each a subtract, two bf16 roundings and a 5-step
// warp reduction; the windows overlap, so L2 serves most reads.
// Measured on an H100 80GB HBM3 (700 W): 1.00 ms at that shape, against
// 7.1 ms for the plain version (chip_smoke.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BS = 16;
constexpr int MAX_R = 8;         // the encoders search +-4 and +-8
constexpr int MAX_WIN = BS + 2 * MAX_R;
constexpr int MAX_CAND = (2 * MAX_R + 1) * (2 * MAX_R + 1);
constexpr int WARPS = BS * BS / 32;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void fsearch_kernel(const float* __restrict__ cur,
                               const float* __restrict__ ref, int H, int W,
                               int r, int32_t* __restrict__ mv,
                               float* __restrict__ cost,
                               float* __restrict__ pred) {
  __shared__ float win[MAX_WIN * MAX_WIN];
  __shared__ float part[MAX_CAND * WARPS];
  __shared__ float csum[MAX_CAND];
  __shared__ int best;
  const int bw = W / BS, bh = H / BS;
  const int m = blockIdx.x;
  const int n = m / (bh * bw), bi = m % (bh * bw);
  const int by = bi / bw, bx = bi % bw;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int side = 2 * r + 1, ncand = side * side, ws = BS + 2 * r;
  const size_t plane = (size_t)n * H * W;
  const int oy = by * BS - r, ox = bx * BS - r;

  for (int k = tid; k < ws * ws; k += blockDim.x) {
    const int yy = clampi(oy + k / ws, 0, H - 1);
    const int xx = clampi(ox + k % ws, 0, W - 1);
    win[k] = bf16r(ref[plane + (size_t)yy * W + xx]);
  }
  const int py = tid >> 4, px = tid & 15;
  const float cv =
      bf16r(cur[plane + (size_t)(by * BS + py) * W + bx * BS + px]);
  __syncthreads();

  for (int c = 0; c < ncand; ++c) {
    const int dy = c / side, dx = c % side;
    float d = bf16r(fabsf(cv - win[(py + dy) * ws + px + dx]));
    for (int off = 16; off > 0; off >>= 1)
      d += __shfl_down_sync(0xffffffffu, d, off);
    if (lane == 0) part[c * WARPS + warp] = d;
  }
  __syncthreads();
  for (int c = tid; c < ncand; c += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += part[c * WARPS + w];
    csum[c] = s;
  }
  __syncthreads();
  if (tid == 0) {
    int bk = 0;
    float bc = csum[0];
    for (int c = 1; c < ncand; ++c)
      if (csum[c] < bc) { bc = csum[c]; bk = c; }
    best = bk;
    mv[(size_t)m * 2 + 0] = bk / side - r;
    mv[(size_t)m * 2 + 1] = bk % side - r;
    cost[m] = bc;
  }
  __syncthreads();
  const int dy = best / side, dx = best % side;
  pred[plane + (size_t)(by * BS + py) * W + bx * BS + px] =
      win[(py + dy) * ws + px + dx];
}

}  // namespace

extern "C" int full_search_mc(const void* cur, const void* ref, int N,
                              int H, int W, int r, void* mv, void* cost,
                              void* pred, void* stream) {
  if (r < 0 || r > MAX_R || H % BS || W % BS)
    return (int)cudaErrorInvalidValue;
  const int nblk = N * (H / BS) * (W / BS);
  if (nblk > 0) {
    fsearch_kernel<<<nblk, BS * BS, 0, (cudaStream_t)stream>>>(
        (const float*)cur, (const float*)ref, H, W, r, (int32_t*)mv,
        (float*)cost, (float*)pred);
  }
  return (int)cudaGetLastError();
}
