// MPEG-4 half-pel motion refinement + motion compensation.
//
// Replaces the Pallas kernels of librempeg_tpu/codecs/mpeg4/me_pallas.py
// (hpel_refine_mc -> _refine_group_kernel, _chroma_group_kernel; and
// the per-MB forms _refine_kernel, _chroma_kernel, whose contract is the
// same) and holds the contract of ops.motion._hpel_refine + mc_hpel:
// the 25 half-pel candidates around each integer MV in row-major
// (dy, dx) order, strict-< SAD ties (the first best wins), decoder-exact
// (a+b+1-rnd)>>1 and (a+b+c+d+2-rnd)>>2 interpolation, then the chroma
// MV by the /2-with-sticky-half rule and 8x8 chroma MC.
//
// Inputs are the encoder's float32 planes; as in the JAX package they
// are truncated to bytes first (recon 2.9999998 becomes 2), and samples
// outside the plane take the nearest edge sample, which equals the JAX
// package's 16-pixel edge pad for the MV range the search produces.
//
// Design: one block per 16x16 MB (3600 at 720p), 256 threads, one per
// pixel. The 19x19 luma window goes to shared memory once; every thread
// then evaluates its pixel for all 25 candidates, warp-reduces each
// |cur - pred|, and adds the warp sums into 25 shared integer SADs
// (integer atomics: exact and order-free). Thread 0 picks the winner in
// candidate order; every thread writes its winning pixel. Threads
// 0..127 then do the two 8x8 chroma predictions.
//
// Bound on the H100: memory, lightly. Per frame it reads the current
// and reference luma and the reference chroma once (float32) and
// writes the three prediction planes; the 25 interpolations per pixel
// are a few hundred integer operations per thread. Measured on an H100
// 80GB HBM3 (700 W): 0.103 ms per 1280x720 P-VOP (3600 MBs), against
// 4.28 ms for the plain version (chip_smoke.py).
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

__global__ void hpel_kernel(const float* __restrict__ cur,
                            const float* __restrict__ ref_y,
                            const float* __restrict__ ref_u,
                            const float* __restrict__ ref_v,
                            const int32_t* __restrict__ mv_i, int H, int W,
                            int rnd, int32_t* __restrict__ mv_h,
                            float* __restrict__ pred_y,
                            float* __restrict__ pred_u,
                            float* __restrict__ pred_v) {
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
      const int r0 = 1 + (dy >> 1) + py, c0 = 1 + (dx >> 1) + px;
      const int fy = dy & 1, fx = dx & 1;
      const int a = win[r0][c0];
      int p;
      if (!fy && !fx) p = a;
      else if (!fy) p = (a + win[r0][c0 + 1] + r1) >> 1;
      else if (!fx) p = (a + win[r0 + 1][c0] + r1) >> 1;
      else
        p = (a + win[r0][c0 + 1] + win[r0 + 1][c0] + win[r0 + 1][c0 + 1] +
             r2) >> 2;
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

  {
    const int dy = best / 5 - 2, dx = best % 5 - 2;
    const int r0 = 1 + (dy >> 1) + py, c0 = 1 + (dx >> 1) + px;
    const int fy = dy & 1, fx = dx & 1;
    const int a = win[r0][c0];
    int p;
    if (!fy && !fx) p = a;
    else if (!fy) p = (a + win[r0][c0 + 1] + r1) >> 1;
    else if (!fx) p = (a + win[r0 + 1][c0] + r1) >> 1;
    else
      p = (a + win[r0][c0 + 1] + win[r0 + 1][c0] + win[r0 + 1][c0 + 1] + r2) >>
          2;
    pred_y[(size_t)(by * 16 + py) * W + bx * 16 + px] = (float)p;
  }

  if (tid < 128) {
    const int Hc = H / 2, Wc = W / 2;
    const int pl = tid >> 6, q = tid & 63;
    const int cy = q >> 3, cx = q & 7;
    const int dy = best / 5 - 2, dx = best % 5 - 2;
    const int hy = 2 * mvy + dy, hx = 2 * mvx + dx;
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
    (pl ? pred_v : pred_u)[(size_t)(by * 8 + cy) * Wc + bx * 8 + cx] =
        (float)p;
  }
}

}  // namespace

extern "C" int hpel_refine_mc(const void* cur, const void* ref_y,
                              const void* ref_u, const void* ref_v,
                              const void* mv_i, int H, int W, int rnd,
                              void* mv_h, void* pred_y, void* pred_u,
                              void* pred_v, void* stream) {
  const int nmb = (H / 16) * (W / 16);
  if (nmb > 0) {
    hpel_kernel<<<nmb, 256, 0, (cudaStream_t)stream>>>(
        (const float*)cur, (const float*)ref_y, (const float*)ref_u,
        (const float*)ref_v, (const int32_t*)mv_i, H, W, rnd,
        (int32_t*)mv_h, (float*)pred_y, (float*)pred_u, (float*)pred_v);
  }
  return (int)cudaGetLastError();
}
