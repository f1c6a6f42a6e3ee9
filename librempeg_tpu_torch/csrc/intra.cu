// H.264 scattered intra-MB reconstruction inside P frames.
//
// Replaces the Pallas kernel of librempeg_tpu/codecs/h264/intra_pallas.py
// (intra_scan_pallas -> _intra_kernel) and holds the contract of
// device_recon._intra_scan: the listed intra MBs are rebuilt in raster
// order -- I4x4 (nine modes, sixteen sub-blocks in decode order), I16x16
// (four modes incl. plane) and chroma (four modes) -- from neighbours
// that are final (inter MBs, or intra MBs earlier in the list), with the
// residual added. Samples outside the frame read as 0, as in the
// zero-padded planes of both JAX versions.
//
// Predictions are affine in the neighbour samples, so each effective
// mode (availability already folded in by build_intra_scalars) is a row
// block of coefficient tables shared with the Pallas version:
//   pred[p] = (sum_c TAB[mode*stride + c][p] * n_c) >> shift
// with the plane modes' inner sums (H, V, a) in three extra columns.
//
// Design: one block of 256 threads walks the list; an I4x4 MB runs its
// 16 sub-blocks with a __syncthreads() between them (each reads the
// previous ones), an I16x16 MB is one step of 256 pixels, chroma one step
// of 2 x 64 pixels.
//
// Bound on the H100: latency, not bytes or arithmetic. The work is a
// chain of dependent steps (70 to 126 intra MBs per P frame of the
// bench clip, 2-17 barrier-separated steps each) executed by one block
// on one SM; each step is a few dependent global loads plus at most 34
// multiply-adds per thread. Measured on an H100 80GB HBM3 (700 W):
// 0.215 ms for the 91 intra MBs of the clip's first P frame
// (chip_smoke.py). Parallelising across MBs would need a dependency
// schedule like the deblock's; with ~1% intra MBs per frame that is
// not where the frame time goes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SCAL_W = 32;
constexpr int I4_STRIDE = 16, I4_NIN = 14;
constexpr int I16_STRIDE = 40, I16_NIN = 34;
constexpr int C_STRIDE = 24, C_NIN = 18;

// decode order of the 16 luma 4x4 blocks (device_recon._BLK4_DEC)
__constant__ int kBlkY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
__constant__ int kBlkX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int pix(const uint8_t* p, int H, int W, int yy,
                                   int xx) {
  return (yy < 0 || xx < 0 || yy >= H || xx >= W) ? 0 : p[yy * W + xx];
}

__global__ void intra_kernel(uint8_t* __restrict__ y, uint8_t* __restrict__ u,
                             uint8_t* __restrict__ v,
                             const int32_t* __restrict__ scal, int n,
                             const int32_t* __restrict__ t4, int t4w,
                             const int32_t* __restrict__ t16, int t16w,
                             const int32_t* __restrict__ tc, int tcw,
                             const int32_t* __restrict__ lres,
                             const int32_t* __restrict__ cres, int mb_w,
                             int mb_h) {
  const int tid = threadIdx.x;
  const int H = mb_h * 16, W = mb_w * 16, Hc = mb_h * 8, Wc = mb_w * 8;
  for (int i = 0; i < n; ++i) {
    const int32_t* S = scal + (size_t)i * SCAL_W;
    if (S[0] == 0) continue;                 // uniform across the block
    const int mi = S[1], my = S[2], mx = S[3], is_i4 = S[4];
    const int e16 = S[5], ecm = S[6], avtr = S[7];
    const int32_t* lr = lres + (size_t)mi * 256;

    if (is_i4) {
      for (int k = 0; k < 16; ++k) {
        if (tid < 16) {
          const int by = kBlkY[k], bx = kBlkX[k];
          const int Y = my * 16 + by * 4, X = mx * 16 + bx * 4;
          int nb[I4_NIN];
          nb[0] = pix(y, H, W, Y - 1, X - 1);
          for (int j = 0; j < 4; ++j) nb[1 + j] = pix(y, H, W, Y - 1, X + j);
          const bool tr = (avtr >> k) & 1;
          for (int j = 0; j < 4; ++j)
            nb[5 + j] = tr ? pix(y, H, W, Y - 1, X + 4 + j) : nb[4];
          for (int j = 0; j < 4; ++j) nb[9 + j] = pix(y, H, W, Y + j, X - 1);
          nb[13] = 1;
          const int32_t* T = t4 + (size_t)S[8 + k] * I4_STRIDE * t4w;
          int acc = 0;
          for (int c = 0; c < I4_NIN; ++c) acc += T[c * t4w + tid] * nb[c];
          const int py = tid >> 2, px = tid & 3;
          const int rec = clampi((acc >> 4) + lr[(by * 4 + py) * 16 + bx * 4 + px],
                                 0, 255);
          y[(Y + py) * W + X + px] = (uint8_t)rec;
        }
        __syncthreads();
      }
    } else {
      const int Y = my * 16, X = mx * 16;
      int nb[I16_NIN];
      nb[0] = pix(y, H, W, Y - 1, X - 1);
      for (int j = 0; j < 16; ++j) nb[1 + j] = pix(y, H, W, Y - 1, X + j);
      for (int j = 0; j < 16; ++j) nb[17 + j] = pix(y, H, W, Y + j, X - 1);
      nb[33] = 1;
      const int32_t* T = t16 + (size_t)e16 * I16_STRIDE * t16w;
      const int py = tid >> 4, px = tid & 15;
      int pred;
      if (e16 == 3) {                        // plane (§8.3.3.4)
        int hs = 0, vs = 0, a = 0;
        for (int c = 0; c < I16_NIN; ++c) {
          hs += T[c * t16w + 256] * nb[c];
          vs += T[c * t16w + 257] * nb[c];
          a += T[c * t16w + 258] * nb[c];
        }
        const int b = (5 * hs + 32) >> 6, cc = (5 * vs + 32) >> 6;
        pred = clampi((a + cc * (py - 7) + b * (px - 7) + 16) >> 5, 0, 255);
      } else {
        int acc = 0;
        for (int c = 0; c < I16_NIN; ++c) acc += T[c * t16w + tid] * nb[c];
        pred = acc >> 5;
      }
      __syncthreads();                       // all neighbours read
      y[(Y + py) * W + X + px] = (uint8_t)clampi(pred + lr[tid], 0, 255);
    }
    __syncthreads();

    if (tid < 128) {                         // chroma: U then V halves
      const int pl = tid >> 6, p = tid & 63;
      uint8_t* c = pl ? v : u;
      const int Y = my * 8, X = mx * 8;
      int nb[C_NIN];
      nb[0] = pix(c, Hc, Wc, Y - 1, X - 1);
      for (int j = 0; j < 8; ++j) nb[1 + j] = pix(c, Hc, Wc, Y - 1, X + j);
      for (int j = 0; j < 8; ++j) nb[9 + j] = pix(c, Hc, Wc, Y + j, X - 1);
      nb[17] = 1;
      const int32_t* T = tc + (size_t)ecm * C_STRIDE * tcw;
      const int py = p >> 3, px = p & 7;
      int pred;
      if (ecm == 6) {                        // plane (§8.3.4.4)
        int hs = 0, vs = 0, a = 0;
        for (int k = 0; k < C_NIN; ++k) {
          hs += T[k * tcw + 64] * nb[k];
          vs += T[k * tcw + 65] * nb[k];
          a += T[k * tcw + 66] * nb[k];
        }
        const int b = (17 * hs + 16) >> 5, cc = (17 * vs + 16) >> 5;
        pred = clampi((a + cc * (py - 3) + b * (px - 3) + 16) >> 5, 0, 255);
      } else {
        int acc = 0;
        for (int k = 0; k < C_NIN; ++k) acc += T[k * tcw + p] * nb[k];
        pred = acc >> 5;
      }
      const int r = cres[((size_t)mi * 2 + pl) * 64 + p];
      // neighbours lie outside this MB's 8x8, so the write cannot race
      c[(Y + py) * Wc + X + px] = (uint8_t)clampi(pred + r, 0, 255);
    }
    __syncthreads();
  }
}

}  // namespace

// Rebuilds the scal-listed intra MBs of y/u/v in place.
extern "C" int intra_scan(void* y, void* u, void* v, const void* scal, int n,
                          const void* t4, int t4w, const void* t16, int t16w,
                          const void* tc, int tcw, const void* lres,
                          const void* cres, int mb_w, int mb_h, void* stream) {
  if (n > 0) {
    intra_kernel<<<1, 256, 0, (cudaStream_t)stream>>>(
        (uint8_t*)y, (uint8_t*)u, (uint8_t*)v, (const int32_t*)scal, n,
        (const int32_t*)t4, t4w, (const int32_t*)t16, t16w,
        (const int32_t*)tc, tcw, (const int32_t*)lres, (const int32_t*)cres,
        mb_w, mb_h);
  }
  return (int)cudaGetLastError();
}
