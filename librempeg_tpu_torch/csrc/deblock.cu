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
// Schedule: one launch per frame. Each thread block (two warps) takes
// whole MB rows, in increasing order, from an atomic ticket, and walks
// each row left to right. Per MB x of row y it runs the horizontal
// edges of MB x, then the vertical edges of MB x+1 (which change the
// right three columns of MB x); MB x is then final for row y and goes
// out. The vertical edges need nothing from other blocks: they touch
// only the row's own 16 pixel rows. The horizontal edges of MB x read
// and change the four rows above MB x, which row y-1 makes final with
// its horizontal edges of MB x and its vertical edges of MB x+1; so
// MB x of row y waits for exactly that. tests/test_torch_deblock_order.py
// runs the plain version in the schedules this wait allows (equal to
// the diagonal order) and without its top-right part (not equal). A
// block waits only on a row whose ticket was taken earlier, by a block
// already running, so any grid size is free of deadlock; the wrapper
// passes min(mb_h, co-resident blocks).
//
// Handoff: row y hands row y+1 the 24 words (4 bytes each) that row
// y+1 reads above MB x (the last 4 luma rows and last 2 chroma rows of
// MB x) through a mailbox in device memory, each word stored with the
// call's epoch in its high half as one 64-bit relaxed store. The
// receiving lanes spin on their own word with 64-bit relaxed loads
// until it carries this call's epoch, so a word arrives whole, flag and
// data in one L2 round trip, and no fence or release/acquire pair is
// needed. The epoch also spares the caller a fill per call: words of
// earlier calls carry earlier epochs, and the row ticket counts on from
// where the previous call left it (each call takes mb_h + grid tickets).
// The global write-back is split so
// that each pixel is written by one block only: row y writes the rows
// above MB x that its top edge changes and its own rows but the last 3
// luma rows and the last chroma row, which row y+1's top edge changes
// and row y+1 writes (the last row writes all its rows). So no write of
// one block must be ordered before another's; the kernel's end makes
// them all visible.
//
// Shared memory: a luma tile of 20 rows (4 above the MB, 16 of the MB)
// by two 16-column MB slots used as a ring (column gx lives at
// gx & 31), so the vertical edges of MB x+1 read MB x's last four
// columns where the previous step left them; chroma the same with 2
// rows above and two 8-column slots. Row pitches of 9 and 5 words keep
// the lanes of a vertical pass (one row each) on distinct banks. Each
// lane filters a whole line in registers with the filters' arithmetic
// as the spec writes it: warp 0 lanes 0..15 one luma row (vertical
// edges) or column (horizontal edges), warp 1 lanes 0..15 one U or V
// line, so luma and chroma run side by side and one MB costs two edge
// passes and three __syncthreads. MB x+2's own pixels and the next
// passes' packed parameters load while step x runs; no other block
// writes them before this one does.
//
// Bound on the H100: the dependence chain, not bytes or operations. The
// y/u/v planes (6.3 MB at 1080p) are read and written once and the
// packed parameters (4.2 MB) read once, about 3 us at 3.35 TB/s. Within
// a row each MB costs 8 dependent luma edge filters (4 horizontal, then
// 4 vertical of the next MB), each a serial chain of integer operations
// on one lane; a row waits for the row above one MB step plus a
// mailbox round trip per row. The frame takes about mb_w + mb_h MB
// steps plus mb_h handoffs (tools/deblock_steps.py measures both).
//
// The per-edge decisions (bS, alpha, beta, tc0) depend only on
// pre-deblock data and arrive precomputed and packed, one int32 per
// edge segment: bits 0..2 bS, 3..10 alpha, 11..15 beta, 16..20 tc0,
// laid out per MB as [8][16] (see deblock_pallas._pack_params).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LT = 32;   // luma tile columns: two 16-column MB slots
constexpr int CT = 16;   // chroma tile columns: two 8-column MB slots
// row pitches (bytes): 9 and 5 words, so the lanes of a vertical pass,
// one row each, hit distinct banks
constexpr int LP = LT + 4;
constexpr int CP = CT + 4;
constexpr int MBOX = 24;  // words handed to the next row per MB
constexpr int LR = 20;   // luma tile rows: 4 above the MB, 16 of it
constexpr int CR = 10;   // chroma tile rows: 2 above the MB, 8 of it

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int absi(int v) { return v < 0 ? -v : v; }

// One luma line across an edge, in registers: s[0..7] = p3 p2 p1 p0 q0
// q1 q2 q3.
__device__ __forceinline__ void filt_luma(int* s, int prm) {
  const int bs = prm & 7;
  if (bs == 0) return;
  const int alpha = (prm >> 3) & 255, beta = (prm >> 11) & 31;
  const int tc0 = (prm >> 16) & 31;
  const int p3 = s[0], p2 = s[1], p1 = s[2], p0 = s[3], q0 = s[4],
            q1 = s[5], q2 = s[6], q3 = s[7];
  if (!(absi(p0 - q0) < alpha && absi(p1 - p0) < beta &&
        absi(q1 - q0) < beta))
    return;
  const bool ap = absi(p2 - p0) < beta;
  const bool aq = absi(q2 - q0) < beta;
  if (bs < 4) {
    const int tc = tc0 + (ap ? 1 : 0) + (aq ? 1 : 0);
    const int delta = clampi((((q0 - p0) * 4) + (p1 - q1) + 4) >> 3, -tc, tc);
    s[3] = (uint8_t)clampi(p0 + delta, 0, 255);
    s[4] = (uint8_t)clampi(q0 - delta, 0, 255);
    if (ap)
      s[2] = (uint8_t)(p1 + clampi(
          (p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1, -tc0, tc0));
    if (aq)
      s[5] = (uint8_t)(q1 + clampi(
          (q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1, -tc0, tc0));
    return;
  }
  const bool close = absi(p0 - q0) < ((alpha >> 2) + 2);
  const bool sp = ap && close, sq = aq && close;
  if (sp) {
    s[3] = (uint8_t)((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
    s[2] = (uint8_t)((p2 + p1 + p0 + q0 + 2) >> 2);
    s[1] = (uint8_t)((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
  } else {
    s[3] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
  }
  if (sq) {
    s[4] = (uint8_t)((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3);
    s[5] = (uint8_t)((q2 + q1 + q0 + p0 + 2) >> 2);
    s[6] = (uint8_t)((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
  } else {
    s[4] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
  }
}

// One chroma line: s[0..3] = p1 p0 q0 q1.
__device__ __forceinline__ void filt_chroma(int* s, int prm) {
  const int bs = prm & 7;
  if (bs == 0) return;
  const int alpha = (prm >> 3) & 255, beta = (prm >> 11) & 31;
  const int tc0 = (prm >> 16) & 31;
  const int p1 = s[0], p0 = s[1], q0 = s[2], q1 = s[3];
  if (!(absi(p0 - q0) < alpha && absi(p1 - p0) < beta &&
        absi(q1 - q0) < beta))
    return;
  if (bs < 4) {
    const int tc = tc0 + 1;
    const int delta = clampi((((q0 - p0) * 4) + (p1 - q1) + 4) >> 3, -tc, tc);
    s[1] = (uint8_t)clampi(p0 + delta, 0, 255);
    s[2] = (uint8_t)clampi(q0 - delta, 0, 255);
  } else {
    s[1] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
    s[2] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
  }
}

__device__ __forceinline__ uint64_t ld_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

struct Frame {
  uint8_t* y;
  uint8_t* u;
  uint8_t* v;
  const int32_t* prm;
  int mb_w, mb_h, W, Wc;
};

struct Tiles {
  uint8_t l[LR][LP];
  uint8_t c[2][CR][CP];
};

// The packed parameters a lane needs for one pass of MB m: vertical
// edges (luma row or chroma row) or horizontal edges (luma column or
// chroma column) of its line.
__device__ __forceinline__ void load_params(const Frame& f, int m, int lane,
                                            bool vertical, int* p) {
  const int32_t* P = f.prm + (size_t)m * 128;
  if (lane < 16) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[e] = __ldg(vertical ? P + (lane >> 2) * 16 + e
                            : P + (4 + e) * 16 + (lane >> 2));
  } else {
    const int i = lane & 7;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      p[e] = __ldg(vertical ? P + (i >> 1) * 16 + 4 + e
                            : P + (4 + e) * 16 + 4 + (i >> 1));
  }
}

// MB x of row my, own (pre-deblock) pixels as three words per lane:
// two of luma (16 rows x 4 words), one of chroma (2 planes x 8 rows x
// 2 words).
__device__ __forceinline__ void load_own(const Frame& f, int my, int x,
                                         int lane, uint32_t* w) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = lane + 32 * k, r = i >> 2, q = i & 3;
    w[k] = __ldcg(reinterpret_cast<const uint32_t*>(
        f.y + (size_t)(16 * my + r) * f.W + 16 * x + 4 * q));
  }
  const int r = (lane >> 1) & 7, q = lane & 1;
  const uint8_t* c = lane < 16 ? f.u : f.v;
  w[2] = __ldcg(reinterpret_cast<const uint32_t*>(
      c + (size_t)(8 * my + r) * f.Wc + 8 * x + 4 * q));
}

__device__ __forceinline__ void store_own(Tiles& t, int x, int lane,
                                          const uint32_t* w) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = lane + 32 * k, r = i >> 2, q = i & 3;
    *reinterpret_cast<uint32_t*>(&t.l[4 + r][(16 * x) % LT + 4 * q]) = w[k];
  }
  const int r = (lane >> 1) & 7, q = lane & 1;
  *reinterpret_cast<uint32_t*>(&t.c[lane >> 4][2 + r][(8 * x) % CT + 4 * q]) =
      w[2];
}

// Word w (0..23) of MB x's bottom rows in the tile, which the row below
// reads above its MB x: luma rows 12..15 (w < 16), else chroma rows 6..7
// of U then V.
__device__ __forceinline__ uint32_t* bottom_word(Tiles& t, int x, int w) {
  if (w < 16)
    return reinterpret_cast<uint32_t*>(
        &t.l[4 + 12 + (w >> 2)][(16 * x) % LT + 4 * (w & 3)]);
  const int i = w - 16;
  return reinterpret_cast<uint32_t*>(
      &t.c[i >> 2][2 + 6 + ((i >> 1) & 1)][(8 * x) % CT + 4 * (i & 1)]);
}

// Where word w goes as a row above MB x in the tile (4 rows of luma, 2
// of each chroma plane).
__device__ __forceinline__ uint32_t* above_word(Tiles& t, int x, int w) {
  if (w < 16)
    return reinterpret_cast<uint32_t*>(
        &t.l[w >> 2][(16 * x) % LT + 4 * (w & 3)]);
  const int i = w - 16;
  return reinterpret_cast<uint32_t*>(
      &t.c[i >> 2][(i >> 1) & 1][(8 * x) % CT + 4 * (i & 1)]);
}

// Vertical edges of MB x: lane < 16 luma row `lane` (columns -4..15 of
// the MB), else chroma row lane & 7 of plane (lane >> 3) & 1 (columns
// -2..5).
__device__ __forceinline__ void pass_v(Tiles& t, int x, int lane,
                                       const int* p) {
  if (lane < 16) {
    uint8_t* row = t.l[4 + lane];
    int s[20];
#pragma unroll
    for (int k = 0; k < 20; ++k) s[k] = row[(16 * x - 4 + k) & (LT - 1)];
#pragma unroll
    for (int e = 0; e < 4; ++e) filt_luma(s + 4 * e, p[e]);
#pragma unroll
    for (int k = 1; k < 19; ++k) row[(16 * x - 4 + k) & (LT - 1)] = s[k];
  } else {
    uint8_t* row = t.c[(lane >> 3) & 1][2 + (lane & 7)];
    int s[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = row[(8 * x - 2 + k) & (CT - 1)];
#pragma unroll
    for (int e = 0; e < 2; ++e) filt_chroma(s + 4 * e, p[e]);
#pragma unroll
    for (int k = 1; k < 7; ++k) row[(8 * x - 2 + k) & (CT - 1)] = s[k];
  }
}

// Horizontal edges of MB x: lane < 16 luma column `lane` (rows -4..15),
// else chroma column lane & 7 (rows -2..5).
__device__ __forceinline__ void pass_h(Tiles& t, int x, int lane,
                                       const int* p) {
  if (lane < 16) {
    const int col = (16 * x + lane) & (LT - 1);
    int s[20];
#pragma unroll
    for (int k = 0; k < 20; ++k) s[k] = t.l[k][col];
#pragma unroll
    for (int e = 0; e < 4; ++e) filt_luma(s + 4 * e, p[e]);
#pragma unroll
    for (int k = 1; k < 19; ++k) t.l[k][col] = s[k];
  } else {
    const int pl = (lane >> 3) & 1, col = (8 * x + (lane & 7)) & (CT - 1);
    int s[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = t.c[pl][k][col];
#pragma unroll
    for (int e = 0; e < 2; ++e) filt_chroma(s + 4 * e, p[e]);
#pragma unroll
    for (int k = 1; k < 7; ++k) t.c[pl][k][col] = s[k];
  }
}

// Writes MB x back: the rows above it that its top edge changes (3
// luma, 1 chroma; none in the first row) and its own rows but those the
// next row's top edge changes (the last 3 luma rows and the last chroma
// row), which the next row writes; the last row writes all its rows.
// So each pixel is written by one block only, and no write of one
// block has to be ordered before a write of another.
__device__ __forceinline__ void write_back(const Frame& f, const Tiles& t,
                                           int my, int x, int lane) {
  const bool last = my == f.mb_h - 1;
  const int l0 = my > 0 ? 1 : 4, c0 = my > 0 ? 1 : 2;
  const int l1 = last ? LR : LR - 3, c1 = last ? CR : CR - 1;
  const int nl = (l1 - l0) * 4, ncp = (c1 - c0) * 2;
  for (int i = lane; i < nl + 2 * ncp; i += 32) {
    if (i < nl) {
      const int r = l0 + (i >> 2), q = i & 3;
      *reinterpret_cast<uint32_t*>(
          f.y + (size_t)(16 * my - 4 + r) * f.W + 16 * x + 4 * q) =
          *reinterpret_cast<const uint32_t*>(&t.l[r][(16 * x) % LT + 4 * q]);
    } else {
      const int k = i - nl, p = k / ncp, r = c0 + ((k % ncp) >> 1),
                q = k & 1;
      *reinterpret_cast<uint32_t*>(
          (p ? f.v : f.u) + (size_t)(8 * my - 2 + r) * f.Wc + 8 * x +
          4 * q) =
          *reinterpret_cast<const uint32_t*>(&t.c[p][r][(8 * x) % CT + 4 * q]);
    }
  }
}

__global__ void __launch_bounds__(64)
    deblock_rows_kernel(Frame f, unsigned* __restrict__ ticket,
                        unsigned ticket_base, uint64_t* __restrict__ mbox,
                        uint32_t epoch) {
  __shared__ __align__(16) Tiles t;
  __shared__ int ticket_row;
  // warp 0 lanes 0..15: luma lines; warp 1 lanes 0..15: chroma lines;
  // `lane` below is the line's role 0..31 (16.. chroma), as in the
  // helpers
  const int tid = threadIdx.x;
  const bool active = (tid & 31) < 16;
  const int lane = (tid >> 5) * 16 + (tid & 15);
  for (;;) {
    // unsigned difference: the ticket may wrap between calls
    if (tid == 0) ticket_row = (int)(atomicAdd(ticket, 1u) - ticket_base);
    __syncthreads();
    const int my = ticket_row;
    if (my >= f.mb_h) return;
    const int row0 = my * f.mb_w;
    const uint64_t* const inbox =
        mbox + (size_t)(my > 0 ? row0 - f.mb_w : 0) * MBOX;
    uint64_t* const outbox = mbox + (size_t)row0 * MBOX;
    // own pixels and parameters run two MBs ahead of their use: those
    // of MB x+2 (vertical pass) and MB x+1 (horizontal pass) load while
    // step x runs
    uint32_t own[3], own_next[3];
    int pv[4], pv_next[4], ph[4], ph_next[4];
    if (active) {
      load_own(f, my, 0, lane, own_next);
      load_params(f, row0, lane, true, pv_next);
      load_params(f, row0, lane, false, ph);
      if (f.mb_w > 1) {
        load_own(f, my, 1, lane, own);
        load_params(f, row0 + 1, lane, true, pv);
      }
      store_own(t, 0, lane, own_next);
    }
    __syncthreads();
    if (active) pass_v(t, 0, lane, pv_next);
    __syncthreads();
    for (int x = 0; x < f.mb_w; ++x) {
      const bool more = x + 1 < f.mb_w;
      if (active) {
        if (x + 2 < f.mb_w) {
          load_own(f, my, x + 2, lane, own_next);
          load_params(f, row0 + x + 2, lane, true, pv_next);
        }
        if (more) load_params(f, row0 + x + 1, lane, false, ph_next);
        if (my > 0 && lane < MBOX) {
          // the word carries its own flag (the epoch, high half), so it
          // arrives whole or not at all
          uint64_t w;
          do {
            w = ld_relaxed(inbox + (size_t)x * MBOX + lane);
          } while ((uint32_t)(w >> 32) != epoch);
          *above_word(t, x, lane) = (uint32_t)w;
        }
      }
      __syncthreads();
      if (active) {
        pass_h(t, x, lane, ph);
        if (more) store_own(t, x + 1, lane, own);
      }
      __syncthreads();
      if (more) {
        if (active) pass_v(t, x + 1, lane, pv);
        __syncthreads();
      }
      if (active) {
        if (my + 1 < f.mb_h && lane < MBOX)
          st_relaxed(outbox + (size_t)x * MBOX + lane,
                     ((uint64_t)epoch << 32) | *bottom_word(t, x, lane));
        write_back(f, t, my, x, lane);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        pv[k] = pv_next[k];
        ph[k] = ph_next[k];
        if (k < 3) own[k] = own_next[k];
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Blocks of the deblock kernel that fit on the current device at once.
extern "C" int deblock_coresident(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, deblock_rows_kernel, 64, 0);
  *blocks = sms * per_sm;
  return (int)err;
}

// Deblocks y [16*mb_h, 16*mb_w], u/v [8*mb_h, 8*mb_w] in place, with
// `grid` blocks. scratch: 8 * (1 + 24 * mb_w * mb_h) bytes (the row
// ticket, then each MB's words for the row below), zero before its
// first call and owned by one stream: its calls run in order. Each call
// on it passes an epoch that no earlier call since the zeroing used
// (never 0), and as ticket_base the sum of (mb_h + grid) over those
// calls, modulo 2^32.
extern "C" int deblock_frame(void* y, void* u, void* v, const void* params,
                             int mb_w, int mb_h, int grid, void* scratch,
                             unsigned ticket_base, unsigned epoch,
                             void* stream) {
  if (mb_w < 1 || mb_h < 1 || grid < 1 || epoch == 0)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)y | (uintptr_t)u | (uintptr_t)v) & 3)
    return (int)cudaErrorMisalignedAddress;
  const Frame f{(uint8_t*)y, (uint8_t*)u, (uint8_t*)v,
                (const int32_t*)params, mb_w, mb_h, 16 * mb_w, 8 * mb_w};
  deblock_rows_kernel<<<grid, 64, 0, (cudaStream_t)stream>>>(
      f, (unsigned*)scratch, ticket_base, (uint64_t*)scratch + 1, epoch);
  return (int)cudaGetLastError();
}
