// MPEG-4 half-pel motion refinement + motion compensation, as two
// kernels: luma refinement + MC, then chroma MC at the derived MV.
//
// Replaces the Pallas kernels of librempeg_tpu/codecs/mpeg4/me_pallas.py:
// refine_luma_kernel the luma forms (_refine_mc_luma_group ->
// _refine_group_kernel on the encoder's path, and the per-MB
// _refine_mc_luma -> _refine_kernel), mc_chroma_kernel the chroma forms
// (_mc_chroma_group -> _chroma_group_kernel, and the per-MB _mc_chroma
// -> _chroma_kernel). Both hold the contract of ops.motion._hpel_refine
// + mc_hpel: the 25 half-pel candidates around each integer MV in
// row-major (dy, dx) order, strict-< SAD ties (the first best wins),
// decoder-exact (a+b+1-rnd)>>1 and (a+b+c+d+2-rnd)>>2 interpolation,
// then the chroma MV by the /2-with-sticky-half rule and 8x8 chroma MC.
//
// Inputs are the encoder's float32 planes; as in the JAX package they
// are truncated to bytes first (recon 2.9999998 becomes 2), and samples
// outside the plane take the nearest edge sample, which equals the JAX
// package's 16-pixel edge pad for the MV range the search produces. The
// TPU kernels read overlapping reference tiles picked by selector words;
// these read the planes at the MV.
//
// Design, luma: one block per 16x16 MB (3600 at 720p), 256 threads, one
// per pixel. The 19x19 luma window goes to shared memory once; every
// thread then evaluates its pixel for all 25 candidates, warp-reduces
// each |cur - pred|, and adds the warp sums into 25 shared integer SADs
// (integer atomics: exact and order-free). Thread 0 picks the winner in
// candidate order and writes the half-pel MV; every thread writes its
// winning pixel. Chroma: one block per MB, 128 threads, one per pixel of
// the two 8x8 predictions, reading the MV the luma kernel wrote.
//
// Bound on the H100: memory, lightly. Per frame the luma kernel reads
// the current and reference luma once (float32) and writes the luma
// prediction; the chroma kernel reads the reference chroma once and
// writes the chroma predictions. The 25 interpolations per luma pixel
// are a few hundred integer operations per thread; at 3600 MBs the
// wrapper and the launch cost more than either kernel's bytes. Measured
// on an H100 80GB HBM3 (700 W) per 1280x720 P-VOP: luma 0.093 ms against
// 5.41 ms for its plain version, chroma 0.035 ms against 1.40 ms
// (chip_smoke.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIN = 19;          // 16 + 2*2 - 1 half-pel window

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// float sample -> integer byte value, truncating like astype(uint8)
__device__ __forceinline__ int trunc8(float f) {
  return (int)(uint8_t)(int)f;
}

// half-pel interpolation of window pixel (r0, c0) with flags fy, fx
__device__ __forceinline__ int interp(int (*win)[WIN], int r0, int c0,
                                      int fy, int fx, int r1, int r2) {
  const int a = win[r0][c0];
  if (!fy && !fx) return a;
  if (!fy) return (a + win[r0][c0 + 1] + r1) >> 1;
  if (!fx) return (a + win[r0 + 1][c0] + r1) >> 1;
  return (a + win[r0][c0 + 1] + win[r0 + 1][c0] + win[r0 + 1][c0 + 1] + r2) >>
         2;
}

__global__ void refine_luma_kernel(const float* __restrict__ cur,
                                   const float* __restrict__ ref_y,
                                   const int32_t* __restrict__ mv_i, int H,
                                   int W, int rnd, int32_t* __restrict__ mv_h,
                                   float* __restrict__ pred_y) {
  __shared__ int win[WIN][WIN];
  __shared__ int sad[25];
  __shared__ int best;
  const int bw = W / 16;
  const int m = blockIdx.x;
  const int by = m / bw, bx = m % bw;
  const int tid = threadIdx.x;
  const int mvy = mv_i[m * 2 + 0], mvx = mv_i[m * 2 + 1];
  const int oy = by * 16 + mvy - 1, ox = bx * 16 + mvx - 1;

  for (int k = tid; k < WIN * WIN; k += blockDim.x) {
    const int r = k / WIN, c = k % WIN;
    const int yy = clampi(oy + r, 0, H - 1), xx = clampi(ox + c, 0, W - 1);
    win[r][c] = trunc8(ref_y[(size_t)yy * W + xx]);
  }
  if (tid < 25) sad[tid] = 0;
  __syncthreads();

  const int py = tid >> 4, px = tid & 15;
  const int cv = trunc8(cur[(size_t)(by * 16 + py) * W + bx * 16 + px]);
  const int r1 = 1 - rnd, r2 = 2 - rnd;
  int k = 0;
  for (int dy = -2; dy <= 2; ++dy) {
    for (int dx = -2; dx <= 2; ++dx, ++k) {
      const int p = interp(win, 1 + (dy >> 1) + py, 1 + (dx >> 1) + px,
                           dy & 1, dx & 1, r1, r2);
      int d = cv > p ? cv - p : p - cv;
      for (int off = 16; off > 0; off >>= 1)
        d += __shfl_down_sync(0xffffffffu, d, off);
      if ((tid & 31) == 0) atomicAdd(&sad[k], d);
    }
  }
  __syncthreads();
  if (tid == 0) {
    int bk = 0, bc = sad[0];
    for (int j = 1; j < 25; ++j)
      if (sad[j] < bc) { bc = sad[j]; bk = j; }
    best = bk;
    mv_h[m * 2 + 0] = 2 * mvy + (bk / 5 - 2);
    mv_h[m * 2 + 1] = 2 * mvx + (bk % 5 - 2);
  }
  __syncthreads();
  const int dy = best / 5 - 2, dx = best % 5 - 2;
  pred_y[(size_t)(by * 16 + py) * W + bx * 16 + px] = (float)interp(
      win, 1 + (dy >> 1) + py, 1 + (dx >> 1) + px, dy & 1, dx & 1, r1, r2);
}

__global__ void mc_chroma_kernel(const float* __restrict__ ref_u,
                                 const float* __restrict__ ref_v,
                                 const int32_t* __restrict__ mv_h, int H,
                                 int W, int rnd, float* __restrict__ pred_u,
                                 float* __restrict__ pred_v) {
  const int bw = W / 16;
  const int m = blockIdx.x;
  const int by = m / bw, bx = m % bw;
  const int tid = threadIdx.x;
  const int Hc = H / 2, Wc = W / 2;
  const int pl = tid >> 6, q = tid & 63;
  const int cy = q >> 3, cx = q & 7;
  const int r1 = 1 - rnd, r2 = 2 - rnd;
  const int hy = mv_h[m * 2 + 0], hx = mv_h[m * 2 + 1];
  // chroma MV: sign(v) * ((|v| >> 1) | (|v| & 1))
  const int ay = hy < 0 ? -hy : hy, ax = hx < 0 ? -hx : hx;
  const int cmy = (hy < 0 ? -1 : (hy > 0 ? 1 : 0)) * ((ay >> 1) | (ay & 1));
  const int cmx = (hx < 0 ? -1 : (hx > 0 ? 1 : 0)) * ((ax >> 1) | (ax & 1));
  const int fy = cmy & 1, fx = cmx & 1;
  const int y0 = by * 8 + (cmy >> 1) + cy, x0 = bx * 8 + (cmx >> 1) + cx;
  const float* src = pl ? ref_v : ref_u;
  const int ya = clampi(y0, 0, Hc - 1), yb = clampi(y0 + 1, 0, Hc - 1);
  const int xa = clampi(x0, 0, Wc - 1), xb = clampi(x0 + 1, 0, Wc - 1);
  const int a = trunc8(src[(size_t)ya * Wc + xa]);
  const int b = trunc8(src[(size_t)ya * Wc + xb]);
  const int c = trunc8(src[(size_t)yb * Wc + xa]);
  const int d = trunc8(src[(size_t)yb * Wc + xb]);
  int p;
  if (!fy) p = fx ? (a + b + r1) >> 1 : a;
  else p = fx ? (a + b + c + d + r2) >> 2 : (a + c + r1) >> 1;
  (pl ? pred_v : pred_u)[(size_t)(by * 8 + cy) * Wc + bx * 8 + cx] = (float)p;
}

}  // namespace

extern "C" int refine_mc_luma(const void* cur, const void* ref_y,
                              const void* mv_i, int H, int W, int rnd,
                              void* mv_h, void* pred_y, void* stream) {
  const int nmb = (H / 16) * (W / 16);
  if (nmb > 0) {
    refine_luma_kernel<<<nmb, 256, 0, (cudaStream_t)stream>>>(
        (const float*)cur, (const float*)ref_y, (const int32_t*)mv_i, H, W,
        rnd, (int32_t*)mv_h, (float*)pred_y);
  }
  return (int)cudaGetLastError();
}

extern "C" int mc_chroma(const void* ref_u, const void* ref_v,
                         const void* mv_h, int H, int W, int rnd,
                         void* pred_u, void* pred_v, void* stream) {
  const int nmb = (H / 16) * (W / 16);
  if (nmb > 0) {
    mc_chroma_kernel<<<nmb, 128, 0, (cudaStream_t)stream>>>(
        (const float*)ref_u, (const float*)ref_v, (const int32_t*)mv_h, H, W,
        rnd, (float*)pred_u, (float*)pred_v);
  }
  return (int)cudaGetLastError();
}
