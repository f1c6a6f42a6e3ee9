// H.264 P-frame inter prediction (quarter-pel luma, eighth-pel chroma).
//
// Replaces the Pallas kernels of librempeg_tpu/codecs/h264/mc_pallas.py
// (mc_predict -> _mc_mb_group_kernel / _mc_mb16_kernel) and holds the
// contract of device_recon._mc: luma quarter-pel is the rounded mean of
// two of the four refpack planes (full, h, v, centre 6-tap) chosen by
// _QM, chroma is bilinear (... + 32) >> 6, with the same coordinate
// clamps (luma clip(., 3, hp - 8), chroma clip(., 0, hc - 4)).
//
// Design: one thread per luma 4x4 block (16 threads per MB, 16 MBs per
// block of 256 threads), so a 1080p P frame (8160 MBs) is 130,560
// threads, one wave on the card. A thread loads its MV as one 32-bit
// word (the int16 (x, y) pair) and its 8x8 partition's ref from the MB's
// four refs (one word), then issues all of its reference loads before it
// uses any: for each of the 4 luma rows and both planes of the quarter-
// pel pair, two aligned 32-bit words, funnel-shifted to the 4 bytes at
// the block's column; for U and V, the 3x3 bilinear source as two words
// per row. The rounded mean of two planes is __vavgu4 (per byte
// (a + b + 1) >> 1, the contract's luma arithmetic) and one aligned
// 32-bit store per row; each chroma sample is one __dp4a of its 2x2
// source bytes with the four bilinear weights, stored as 2-byte pairs.
// The plane pair comes from two 64-bit immediates (one byte per
// quarter-pel phase), not a __constant__ table: neighbouring blocks have
// different phases, and a constant-cache read with divergent addresses
// is serialised. Offsets inside a plane are 32-bit; only the plane base
// is 64-bit.
//
// Alignment: wp = W + 64 and wc = W/2 + 32 are multiples of 4 (W is a
// multiple of 16), so each plane and each row starts on a word. A luma
// row read starts at column ix + dx >= 3 and ends at ix + dx + 3 <=
// (wp - 8) + 1 + 3 = wp - 4, so the aligned words (ix + dx) & ~3 .. + 7
// stay inside the row. A chroma row read covers columns cix .. cix + 2
// with cix <= wc - 4; its second word may run up to 3 bytes past the
// row's end into the next row, which exists, since the rows read are at
// most ciy + 2 <= hc - 2.
//
// Bound on the H100: memory latency, not bandwidth. The reference
// samples the motion field reads (each once) and the predictions are
// about 8 MB per 1080p P frame, 2.4 us at 3.35 TB/s; the planes stay in
// L2 across the frame. Every thread is resident at once, so the time is
// the launch plus two dependent loads per thread (the MV, then the
// samples at the MV) and the stores: loading only the words that hold
// bytes of non-zero weight (fewer requests) was no faster, nor were
// other block sizes (tools/kernel_variants.py; times in PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PAD = 32;
constexpr int PADC = 16;
constexpr int MBS = 16;                 // MBs per block of 16 * MBS threads

// device_recon._QM: (p1, d1y, d1x, p2, d2y, d2x) indexed (mvy&3)*4+(mvx&3)
constexpr int kQM[16][6] = {
    {0, 0, 0, 0, 0, 0}, {0, 0, 0, 1, 0, 0}, {1, 0, 0, 1, 0, 0},
    {1, 0, 0, 0, 0, 1}, {0, 0, 0, 2, 0, 0}, {1, 0, 0, 2, 0, 0},
    {1, 0, 0, 3, 0, 0}, {1, 0, 0, 2, 0, 1}, {2, 0, 0, 2, 0, 0},
    {2, 0, 0, 3, 0, 0}, {3, 0, 0, 3, 0, 0}, {3, 0, 0, 2, 0, 1},
    {2, 0, 0, 0, 1, 0}, {2, 0, 0, 1, 1, 0}, {3, 0, 0, 1, 1, 0},
    {2, 0, 1, 1, 1, 0}};

// kQM rows 8*half .. 8*half+7, one byte each: p1 | d1y << 2 | d1x << 3 |
// p2 << 4 | d2y << 6 | d2x << 7
constexpr uint64_t qm_pack(int half) {
  uint64_t w = 0;
  for (int i = 0; i < 8; ++i) {
    const int* e = kQM[8 * half + i];
    const uint64_t b = e[0] | e[1] << 2 | e[2] << 3 | e[3] << 4 | e[4] << 6 |
                       e[5] << 7;
    w |= b << (8 * i);
  }
  return w;
}
constexpr uint64_t kQMLo = qm_pack(0), kQMHi = qm_pack(1);

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// the 4 bytes at column c of a word-aligned row
__device__ __forceinline__ uint32_t bytes4(const uint8_t* row, int c) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row + (c & ~3));
  return __funnelshift_r(__ldg(w), __ldg(w + 1), 8 * (c & 3));
}

__global__ void __launch_bounds__(MBS * 16)
    mc_kernel(const uint8_t* __restrict__ luma4,
              const uint8_t* __restrict__ upad,
              const uint8_t* __restrict__ vpad,
              const uint32_t* __restrict__ mv,
              const uint32_t* __restrict__ ref, int nref, int nmb, int mb_w,
              int hp, int wp, int hc, int wc, uint8_t* __restrict__ pred_y,
              uint8_t* __restrict__ pred_u, uint8_t* __restrict__ pred_v) {
  const int m = blockIdx.x * MBS + (threadIdx.x >> 4);
  const int b = threadIdx.x & 15;               // 4x4 block, raster in MB
  if (m >= nmb) return;
  const uint32_t mvw = __ldg(mv + m * 16 + b);  // (x, y) int16 pair
  const uint32_t refw = __ldg(ref + m);         // the MB's 4 int8 refs
  const int mvx = (int)(int16_t)(mvw & 0xffff), mvy = (int)mvw >> 16;
  const int r = clampi((int)(int8_t)(refw >> (8 * ((b >> 3) * 2 +
                                                   ((b & 3) >> 1)))),
                       0, nref - 1);
  const int by = b >> 2, bx = b & 3;
  const int ys = (m / mb_w) * 16 + by * 4, xs = (m % mb_w) * 16 + bx * 4;

  // ---- loads: luma rows of both planes, then the chroma 3x3 sources ----
  const int key = (mvy & 3) * 4 + (mvx & 3);
  const int q = (int)(((key & 8) ? kQMHi : kQMLo) >> (8 * (key & 7))) & 0xff;
  const int iy = clampi(ys + (mvy >> 2) + PAD, 3, hp - 8);
  const int ix = clampi(xs + (mvx >> 2) + PAD, 3, wp - 8);
  const uint8_t* pa = luma4 + (size_t)(r * 4 + (q & 3)) * hp * wp +
                      (iy + ((q >> 2) & 1)) * wp;
  const uint8_t* pc = luma4 + (size_t)(r * 4 + ((q >> 4) & 3)) * hp * wp +
                      (iy + ((q >> 6) & 1)) * wp;
  const int ca = ix + ((q >> 3) & 1), cc = ix + (q >> 7);
  uint32_t la[4], lc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    la[k] = bytes4(pa + k * wp, ca);
    lc[k] = bytes4(pc + k * wp, cc);
  }
  const int ciy = clampi(ys / 2 + (mvy >> 3) + PADC, 0, hc - 4);
  const int cix = clampi(xs / 2 + (mvx >> 3) + PADC, 0, wc - 4);
  const uint8_t* cu = upad + (size_t)r * hc * wc + ciy * wc;
  const uint8_t* cv = vpad + (size_t)r * hc * wc + ciy * wc;
  uint32_t su[3], sv[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    su[j] = bytes4(cu + j * wc, cix);
    sv[j] = bytes4(cv + j * wc, cix);
  }

  // ---- luma: the rounded mean of the two planes, 4 bytes a row ----
  uint8_t* oy = pred_y + (size_t)m * 256 + by * 64 + bx * 4;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    *reinterpret_cast<uint32_t*>(oy + k * 16) = __vavgu4(la[k], lc[k]);

  // ---- chroma: each sample one dot product of its 2x2 source bytes
  // (p00, p01, p10, p11) with the weights, (dot + 32) >> 6 ----
  const uint32_t dx = mvx & 7, dy = mvy & 7;
  const uint32_t wts = (8 - dx) * (8 - dy) | dx * (8 - dy) << 8 |
                       (8 - dx) * dy << 16 | dx * dy << 24;
  const int co = m * 64 + by * 16 + bx * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t ou = 0, ov = 0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      // bytes k, k+1 of row i, then of row i+1
      const uint32_t sel = k | (k + 1) << 4 | (k + 4) << 8 | (k + 5) << 12;
      ou |= (__dp4a(__byte_perm(su[i], su[i + 1], sel), wts, 32u) >> 6)
            << (8 * k);
      ov |= (__dp4a(__byte_perm(sv[i], sv[i + 1], sel), wts, 32u) >> 6)
            << (8 * k);
    }
    *reinterpret_cast<uint16_t*>(pred_u + co + i * 8) = (uint16_t)ou;
    *reinterpret_cast<uint16_t*>(pred_v + co + i * 8) = (uint16_t)ov;
  }
}

}  // namespace

extern "C" int mc_predict(const void* luma4, const void* upad,
                          const void* vpad, const void* mv, const void* ref,
                          int nref, int mb_w, int mb_h, int hp, int wp,
                          int hc, int wc, void* pred_y, void* pred_u,
                          void* pred_v, void* stream) {
  const int nmb = mb_w * mb_h;
  if (nmb > 0) {
    mc_kernel<<<(nmb + MBS - 1) / MBS, MBS * 16, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)luma4, (const uint8_t*)upad, (const uint8_t*)vpad,
        (const uint32_t*)mv, (const uint32_t*)ref, nref, nmb, mb_w, hp, wp,
        hc, wc, (uint8_t*)pred_y, (uint8_t*)pred_u, (uint8_t*)pred_v);
  }
  return (int)cudaGetLastError();
}
