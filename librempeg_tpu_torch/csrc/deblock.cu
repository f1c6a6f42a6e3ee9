// H.264 in-loop deblocking filter (§8.7) for P frames.
//
// Replaces the Pallas kernel of
// librempeg_tpu/codecs/h264/deblock_pallas.py (deblock_frame_pallas ->
// _deblock_kernel, _filt_luma_vals, _filt_chroma_vals) and holds the
// contract of device_recon.deblock_frame: per MB, the four vertical luma
// edges left to right, then the four horizontal ones top to bottom, each
// edge filtering pixels the previous edge already wrote; chroma the same
// with two edges per direction.
//
// Schedule: the TPU grid ran MBs in raster order on one core. Hopper
// blocks run in no order, so the order is made explicit: an MB reads
// pixels its left, top and top-right neighbours write, hence all MBs on
// one diagonal t = mx + 2*my are independent. The entry point launches
// one kernel per diagonal (mb_w + 2*mb_h - 2 launches, 254 at 1080p),
// one block per MB of that diagonal. A persistent kernel with per-row
// progress flags would remove the launch gaps; that is later work.
//
// Inside a block: threads 0..15 filter the 16 luma lines of the current
// edge, threads 32..39 and 64..71 the 8 lines of the U and V edge; one
// __syncthreads separates consecutive edges.
//
// Bound on the H100: launch latency and the serial edge chain. A
// diagonal holds at most mb_h MBs and each block runs 8 dependent edge
// steps, so bytes are not the limit; the 254 dependent launches are.
// Measured on an H100 80GB HBM3 (700 W): 1.45 ms per 1080p frame, about
// 5.7 us per diagonal (chip_smoke.py).
//
// The per-edge decisions (bS, alpha, beta, tc0) depend only on
// pre-deblock data and arrive precomputed and packed, one int32 per
// edge segment: bits 0..2 bS, 3..10 alpha, 11..15 beta, 16..20 tc0,
// laid out per MB as [8][16] (see deblock_pallas._pack_params).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int absi(int v) { return v < 0 ? -v : v; }

// One luma line across an edge: s[0..7] = p3 p2 p1 p0 q0 q1 q2 q3 at
// base + k * step.
__device__ void filt_luma(uint8_t* base, int step, int prm) {
  const int bs = prm & 7;
  if (bs == 0) return;
  const int alpha = (prm >> 3) & 255, beta = (prm >> 11) & 31;
  const int tc0 = (prm >> 16) & 31;
  const int p3 = base[0], p2 = base[step], p1 = base[2 * step],
            p0 = base[3 * step], q0 = base[4 * step], q1 = base[5 * step],
            q2 = base[6 * step], q3 = base[7 * step];
  if (!(absi(p0 - q0) < alpha && absi(p1 - p0) < beta &&
        absi(q1 - q0) < beta))
    return;
  const bool ap = absi(p2 - p0) < beta;
  const bool aq = absi(q2 - q0) < beta;
  if (bs < 4) {
    const int tc = tc0 + (ap ? 1 : 0) + (aq ? 1 : 0);
    const int delta = clampi((((q0 - p0) * 4) + (p1 - q1) + 4) >> 3, -tc, tc);
    base[3 * step] = (uint8_t)clampi(p0 + delta, 0, 255);
    base[4 * step] = (uint8_t)clampi(q0 - delta, 0, 255);
    if (ap)
      base[2 * step] = (uint8_t)(p1 + clampi(
          (p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1, -tc0, tc0));
    if (aq)
      base[5 * step] = (uint8_t)(q1 + clampi(
          (q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1, -tc0, tc0));
    return;
  }
  const bool close = absi(p0 - q0) < ((alpha >> 2) + 2);
  const bool sp = ap && close, sq = aq && close;
  if (sp) {
    base[3 * step] = (uint8_t)((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
    base[2 * step] = (uint8_t)((p2 + p1 + p0 + q0 + 2) >> 2);
    base[step] = (uint8_t)((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
  } else {
    base[3 * step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
  }
  if (sq) {
    base[4 * step] = (uint8_t)((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3);
    base[5 * step] = (uint8_t)((q2 + q1 + q0 + p0 + 2) >> 2);
    base[6 * step] = (uint8_t)((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
  } else {
    base[4 * step] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
  }
}

// One chroma line: s[0..3] = p1 p0 q0 q1.
__device__ void filt_chroma(uint8_t* base, int step, int prm) {
  const int bs = prm & 7;
  if (bs == 0) return;
  const int alpha = (prm >> 3) & 255, beta = (prm >> 11) & 31;
  const int tc0 = (prm >> 16) & 31;
  const int p1 = base[0], p0 = base[step], q0 = base[2 * step],
            q1 = base[3 * step];
  if (!(absi(p0 - q0) < alpha && absi(p1 - p0) < beta &&
        absi(q1 - q0) < beta))
    return;
  if (bs < 4) {
    const int tc = tc0 + 1;
    const int delta = clampi((((q0 - p0) * 4) + (p1 - q1) + 4) >> 3, -tc, tc);
    base[step] = (uint8_t)clampi(p0 + delta, 0, 255);
    base[2 * step] = (uint8_t)clampi(q0 - delta, 0, 255);
  } else {
    base[step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
    base[2 * step] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
  }
}

__global__ void deblock_diag_kernel(uint8_t* __restrict__ y,
                                    uint8_t* __restrict__ u,
                                    uint8_t* __restrict__ v,
                                    const int32_t* __restrict__ prm, int t,
                                    int mb_w, int mb_h) {
  const int my = blockIdx.x;
  const int mx = t - 2 * my;
  if (my >= mb_h || mx < 0 || mx >= mb_w) return;   // whole block exits
  const int W = mb_w * 16, Wc = mb_w * 8;
  const int32_t* P = prm + (size_t)(my * mb_w + mx) * 128;   // [8][16]
  const int tid = threadIdx.x;
  const int y0 = my * 16, x0 = mx * 16;
  const int cy0 = my * 8, cx0 = mx * 8;

  // steps 0..3: vertical edges, 4..7: horizontal edges (luma);
  // chroma runs its two vertical then two horizontal edges in steps 0..3
  for (int s = 0; s < 8; ++s) {
    if (tid < 16) {
      const int r = tid;
      if (s < 4) {             // vertical edge e = s, line = row r
        const int p = P[(r >> 2) * 16 + s];
        if ((p & 7) != 0)
          filt_luma(y + (size_t)(y0 + r) * W + x0 + 4 * s - 4, 1, p);
      } else {                 // horizontal edge e = s - 4, line = col r
        const int e = s - 4;
        const int p = P[(4 + e) * 16 + (r >> 2)];
        if ((p & 7) != 0)
          filt_luma(y + (size_t)(y0 + 4 * e - 4) * W + x0 + r, W, p);
      }
    } else if (s < 4 && ((tid >= 32 && tid < 40) || (tid >= 64 && tid < 72))) {
      uint8_t* c = tid < 64 ? u : v;
      const int r = tid & 7;
      if (s < 2) {             // vertical chroma edge e = s, line = row r
        const int p = P[(r >> 1) * 16 + 4 + s];
        if ((p & 7) != 0)
          filt_chroma(c + (size_t)(cy0 + r) * Wc + cx0 + 4 * s - 2, 1, p);
      } else {                 // horizontal chroma edge e = s - 2
        const int e = s - 2;
        const int p = P[(4 + e) * 16 + 4 + (r >> 1)];
        if ((p & 7) != 0)
          filt_chroma(c + (size_t)(cy0 + 4 * e - 2) * Wc + cx0 + r, Wc, p);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Deblocks y [16*mb_h, 16*mb_w], u/v [8*mb_h, 8*mb_w] in place.
extern "C" int deblock_frame(void* y, void* u, void* v, const void* params,
                             int mb_w, int mb_h, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nsteps = mb_w + 2 * mb_h - 2;
  for (int t = 0; t < nsteps; ++t) {
    deblock_diag_kernel<<<mb_h, 96, 0, st>>>(
        (uint8_t*)y, (uint8_t*)u, (uint8_t*)v, (const int32_t*)params, t,
        mb_w, mb_h);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
