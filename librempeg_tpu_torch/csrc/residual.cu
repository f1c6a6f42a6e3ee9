// H.264 residual expansion: compact dequantised 4x4 rows -> 4x4 inverse
// transform -> per-MB spatial residual.
//
// Replaces the Pallas kernel of librempeg_tpu/codecs/h264/residual_pallas.py
// (expand_residual -> _kernel). Input rows are [K, 24] int16: columns
// 0-15 one 4x4 block's dequantised levels in raster order, columns 16-17
// its block id mb*24 + blk split as id = c16 + 32768 * c17 (blk 0-15 luma
// raster, 16-19 chroma u, 20-23 chroma v). Ids of nmb*24 or more are
// padding and skipped; ids are unique (the packer sorts and dedups
// them). Output: [nstripes*120, 384] float32, luma 16x16 row-major in
// columns 0-255, chroma u 8x8 in 256-319, chroma v in 320-383, zero
// where no row lands; the caller zero-fills it.
//
// The TPU kernel expanded the rows through one-hot matmuls over a window
// of the sorted rows per 120-MB stripe, and ran the transform as exact
// f32 matmuls with a floor(x/2) basis. Here each thread owns one output
// pixel of one row and runs the spec's integer butterfly (8.5.12.2, as
// device_recon._inv4): it needs no window, so a stripe may hold any
// number of rows (the bench stream's P frames code chroma DC in almost
// every MB, more than the TPU packer's 512-row window allowed).
//
// Bound on the H100: memory. Each row is 48 bytes in and 64 bytes out;
// the transform is some 30 integer operations per pixel, recomputing
// the four row butterflies a column needs. Measured on an H100 80GB
// HBM3 (700 W) on the bench stream's first P frame (48283 rows, 8160
// MBs): 0.040 ms with the zero fill, against 0.80 ms for the plain
// version (chip_smoke.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void residual_kernel(const int16_t* __restrict__ packed, int K,
                                int nmb, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int row = (int)(t >> 4), pix = (int)(t & 15);
  if (row >= K) return;
  const int16_t* p = packed + (size_t)row * 24;
  const int id = (int)p[16] + 32768 * (int)p[17];
  if (id < 0 || id >= nmb * 24) return;
  const int mb = id / 24, blk = id % 24;
  const int r = pix >> 2, c = pix & 3;

  // first stage along each row i, keeping column c: h[i]
  int h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d0 = p[i * 4 + 0], d1 = p[i * 4 + 1];
    const int d2 = p[i * 4 + 2], d3 = p[i * 4 + 3];
    const int e0 = d0 + d2, e1 = d0 - d2;
    const int e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
    h[i] = c == 0 ? e0 + e3 : c == 1 ? e1 + e2 : c == 2 ? e1 - e2 : e0 - e3;
  }
  // second stage down column c, keeping row r
  const int e0 = h[0] + h[2], e1 = h[0] - h[2];
  const int e2 = (h[1] >> 1) - h[3], e3 = h[1] + (h[3] >> 1);
  const int v = r == 0 ? e0 + e3 : r == 1 ? e1 + e2 : r == 2 ? e1 - e2 : e0 - e3;
  const int res = (v + 32) >> 6;

  int col;
  if (blk < 16) {
    col = ((blk >> 2) * 4 + r) * 16 + (blk & 3) * 4 + c;
  } else {
    const int q = blk - 16, b = q & 3;
    col = 256 + 64 * (q >> 2) + ((b >> 1) * 4 + r) * 8 + (b & 1) * 4 + c;
  }
  out[(size_t)mb * 384 + col] = (float)res;
}

}  // namespace

extern "C" int expand_residual(const void* packed, int K, int nmb, void* out,
                               void* stream) {
  if (K > 0) {
    const long long threads = (long long)K * 16;
    const int per = 256;
    residual_kernel<<<(unsigned)((threads + per - 1) / per), per, 0,
                      (cudaStream_t)stream>>>((const int16_t*)packed, K, nmb,
                                              (float*)out);
  }
  return (int)cudaGetLastError();
}
