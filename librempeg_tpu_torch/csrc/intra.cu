// H.264 scattered intra-MB reconstruction inside P frames.
//
// Replaces the Pallas kernel of librempeg_tpu/codecs/h264/intra_pallas.py
// (intra_scan_pallas -> _intra_kernel) and holds the contract of
// device_recon._intra_scan: the listed intra MBs are rebuilt -- I4x4
// (nine modes, sixteen sub-blocks in decode order), I16x16 (four modes
// incl. plane) and chroma (four modes) -- from neighbours that are final
// (inter MBs, or intra MBs the spec decodes earlier), with the residual
// added. Samples outside the frame read as 0, as in the zero-padded
// planes of both JAX versions. Availability is folded into the effective
// modes by build_intra_scalars.
//
// Bound on the H100: latency along the dependency chain, not bytes or
// arithmetic. An intra MB reads the bottom row and right column of its
// left, top-left, top and top-right neighbours, so intra MBs that touch
// form chains (31-52 dependent steps per P frame of the bench clip, for
// 69-126 intra MBs, at most 10 MBs in one step; tools/intra_chains.py);
// each step is a few shared-memory round trips, a few shuffles and a
// few hundred integer operations on one warp. Waiting warps poll their
// neighbours' flags with a short __nanosleep between polls: polling
// without it, or with 32 warps instead of 16, took issue slots from the
// warps on the chain and was slower on the card (PERF.md).
//
// Design: one block of 16 warps, one warp per list entry.
// - Warps take entries in list (raster) order from a ticket in shared
//   memory. An entry waits only for its intra neighbours among L, TL, T
//   and TR (TR when it lies in the frame); all have smaller raster
//   indices, so a warp of this block already holds or finished them: no
//   deadlock, no handoff between SMs.
// - Shared memory holds one int per MB (-1: not in the list, else its
//   list position << 1, plus 1 once rebuilt), set at kernel start, so
//   there is no scratch and no fill.
// - Before the wait a warp loads everything no other entry writes: its
//   scal row, its 256 + 128 residuals, and the neighbour samples of
//   inter MBs (final before the launch). After the wait it reads only the
//   bottom row and right column (16 + 16 luma, 8 + 8 per chroma plane)
//   that each finished entry publishes to a ring of RING shared-memory
//   slots (slot = list position mod RING, RING >= mb_w + 2). Publisher
//   and readers order through the flag: __threadfence_block() before the
//   flag is set, after it is seen. Before an entry overwrites its slot it
//   waits for the readers of the slot's previous entry (that entry's
//   right, below-left, below and below-right MBs, all earlier in the
//   list since RING >= mb_w + 2).
// - Predictors are evaluated directly (device_recon._pred16, _pred8c,
//   _pred4): lane l owns 8 luma samples (row l/2) and 4 chroma samples;
//   the DC and plane sums are warp shuffles. I4x4 walks its 16 sub-blocks
//   on 16 lanes in a per-warp tile that starts as the residual and ends as
//   the reconstruction.
//
// Precondition (build_intra_scalars from an ascending list, padding
// last, as both packages make it): valid rows have strictly ascending MB
// indices and come before every padding row (valid = 0).
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int SCAL_W = 32;
constexpr int WARPS = 16;
constexpr int TILE = 256;        // per-warp I4x4 tile (int32)
constexpr int NB = 72;           // per-warp neighbour samples (int32)
// neighbour sample layout inside NB: luma top row x = X-1 .. X+19, luma
// left column, then per chroma plane its top row x = Xc-1 .. Xc+7 and
// left column
constexpr int NB_YT = 0, NB_YL = 21, NB_UT = 37, NB_VT = 54;
// published ring entry (bytes): luma bottom row, luma right column, U
// bottom, U right, V bottom, V right
constexpr int RING_B = 64;
// dynamic shared memory the kernel may take (the H100's 227 KB per block,
// less room for the static ticket)
constexpr int MAX_SMEM = 232448 - 1024;

// decode order of the 16 luma 4x4 blocks (device_recon._BLK4_DEC)
__constant__ int kBlkY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
__constant__ int kBlkX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int c3(int i) { return clampi(i, 0, 3); }
__device__ __forceinline__ int c7(int i) { return i > 7 ? 7 : i; }

struct Smem {
  int* st;        // [nmb]
  uint8_t* ring;  // [ring][RING_B]
  int* tile;      // [WARPS][TILE]
  int* nb;        // [WARPS][NB]
};

__host__ __device__ inline size_t smem_bytes(int nmb, int ring) {
  return (size_t)nmb * 4 + (size_t)WARPS * (TILE + NB) * 4 +
         (size_t)ring * RING_B;
}

__device__ __forceinline__ Smem carve(unsigned char* base, int nmb) {
  Smem s;
  s.tile = reinterpret_cast<int*>(base);
  s.nb = s.tile + WARPS * TILE;
  s.st = s.nb + WARPS * NB;
  s.ring = reinterpret_cast<uint8_t*>(s.st + nmb);
  return s;
}

__device__ __forceinline__ void spin_done(const int* st, int m) {
  const volatile int* p = st + m;
  while (!(*p & 1)) __nanosleep(16);   // leave the issue slots to the
                                       // warps that work
}

// Where neighbour sample k (0..70) of MB (mx, my) lives: its plane
// coordinates, the neighbour MB that owns it (-1: outside the frame, the
// sample reads 0) and its byte in that MB's published ring entry.
struct Src {
  int plane, yy, xx, owner, roff;
};

__device__ __forceinline__ Src locate(int k, int mx, int my, int mb_w) {
  Src s;
  int dx, dy, n, base;  // offset from the MB's corner, MB size, ring base
  if (k < NB_YL) {
    s.plane = 0, n = 16, base = 0, dy = -1, dx = k - 1;
  } else if (k < NB_UT) {
    s.plane = 0, n = 16, base = 0, dy = k - NB_YL, dx = -1;
  } else {
    const int kc = k < NB_VT ? k - NB_UT : k - NB_VT;
    s.plane = k < NB_VT ? 1 : 2, n = 8, base = k < NB_VT ? 32 : 48;
    if (kc < 9) dy = -1, dx = kc - 1;
    else dy = kc - 9, dx = -1;
  }
  s.yy = my * n + dy, s.xx = mx * n + dx;
  const int nmx = mx + (dx < 0 ? -1 : dx / n), nmy = my + (dy < 0 ? -1 : 0);
  if (s.yy < 0 || s.xx < 0 || nmx >= mb_w) s.owner = -1;
  else s.owner = nmy * mb_w + nmx;
  // a row above reads the owner's bottom row, a column left its right
  // column
  s.roff = dy < 0 ? base + (dx < 0 ? n - 1 : dx % n) : base + n + dy;
  return s;
}

// Intra_4x4 prediction of pixel (x, y) of one sub-block (device_recon.
// _pred4, effective modes 9/10/11: DC from the top only / left only /
// 128).
__device__ int pred4(int mode, int x, int y, const int* t, const int* l,
                     int lt, const int* tt) {
  switch (mode) {
    case 0: return t[x];
    case 1: return l[y];
    case 2: return (t[0] + t[1] + t[2] + t[3] + l[0] + l[1] + l[2] + l[3] +
                    4) >> 3;
    case 9: return (t[0] + t[1] + t[2] + t[3] + 2) >> 2;
    case 10: return (l[0] + l[1] + l[2] + l[3] + 2) >> 2;
    case 11: return 128;
    case 3: {
      if (x == 3 && y == 3) return (tt[6] + 3 * tt[7] + 2) >> 2;
      const int s = x + y;
      return (tt[s] + 2 * tt[c7(s + 1)] + tt[c7(s + 2)] + 2) >> 2;
    }
    case 4: {
      const int z = x - y;
      if (z > 0)
        return (t[z] + 2 * t[z - 1] + (z >= 2 ? t[z - 2] : lt) + 2) >> 2;
      if (z < 0) {
        const int a = -z;
        return (l[a] + 2 * l[a - 1] + (a >= 2 ? l[a - 2] : lt) + 2) >> 2;
      }
      return (t[0] + 2 * lt + l[0] + 2) >> 2;
    }
    case 5:
    case 6: {
      // vertical-right; horizontal-down is its transpose-mirror
      const int* p = mode == 5 ? t : l;
      const int* q = mode == 5 ? l : t;
      const int u = mode == 5 ? x : y, v = mode == 5 ? y : x;
      const int z = 2 * u - v, i = u - (v >> 1);
      if (z >= 0) {
        const int b = i >= 1 ? p[c3(i - 1)] : lt;
        if ((z & 1) == 0) return (b + p[c3(i)] + 1) >> 1;
        const int a = i >= 2 ? p[c3(i - 2)] : (i == 1 ? lt : q[0]);
        return (a + 2 * b + p[c3(i)] + 2) >> 2;
      }
      if (z == -1) return (q[0] + 2 * lt + p[0] + 2) >> 2;
      return (q[c3(v - 1)] + 2 * q[c3(v - 2)] + (v >= 3 ? q[c3(v - 3)] : lt) +
              2) >> 2;
    }
    case 7: {
      const int i = x + (y >> 1);
      if ((y & 1) == 0) return (tt[c7(i)] + tt[c7(i + 1)] + 1) >> 1;
      return (tt[c7(i)] + 2 * tt[c7(i + 1)] + tt[c7(i + 2)] + 2) >> 2;
    }
    default: {  // 8: horizontal-up
      const int z = x + 2 * y, i = y + (x >> 1);
      if (z > 5) return l[3];
      if (z == 5) return (l[2] + 3 * l[3] + 2) >> 2;
      if ((z & 1) == 0) return (l[c3(i)] + l[c3(i + 1)] + 1) >> 1;
      return (l[c3(i)] + 2 * l[c3(i + 1)] + l[c3(i + 2)] + 2) >> 2;
    }
  }
}

__device__ __forceinline__ int xsum(int v, int lo) {
  for (int off = lo; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(WARPS * 32, 1)
    intra_kernel(uint8_t* y, uint8_t* u, uint8_t* v,
                 const int32_t* __restrict__ scal, int n,
                 const int32_t* __restrict__ lres,
                 const int32_t* __restrict__ cres, int mb_w, int mb_h,
                 int ring) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int ticket;
  const int nmb = mb_w * mb_h;
  const Smem S = carve(smem_raw, nmb);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = mb_w * 16, Wc = mb_w * 8;

  for (int m = tid; m < nmb; m += blockDim.x) S.st[m] = -1;
  if (tid == 0) ticket = 0;
  __syncthreads();
  for (int i = tid; i < n; i += blockDim.x) {
    const int* row = scal + (size_t)i * SCAL_W;
    if (row[0]) S.st[row[1]] = i << 1;
  }
  __syncthreads();

  int* const tile = S.tile + warp * TILE;
  int* const nb = S.nb + warp * NB;
  // lane's luma samples: row lr, columns lc .. lc+7; chroma: plane cpl,
  // row cr, columns cc .. cc+3
  const int lr = lane >> 1, lc = (lane & 1) * 8;
  const int cpl = lane >> 4, cr = (lane & 15) >> 1, cc = (lane & 1) * 4;
  const int rmask = ring - 1;

  for (;;) {
    int e = 0;
    if (lane == 0) e = atomicAdd(&ticket, 1);
    e = __shfl_sync(0xffffffffu, e, 0);
    if (e >= n) break;
    // lane k holds column k of the entry's scal row
    const int sv = scal[(size_t)e * SCAL_W + lane];
    auto col = [&](int k) { return __shfl_sync(0xffffffffu, sv, k); };
    if (!col(0)) continue;
    const int mi = col(1), my = col(2), mx = col(3), is_i4 = col(4);
    const int e16 = col(5), ecm = col(6), avtr = col(7);
    // the previous occupant of this entry's ring slot (read before the
    // wait; its readers are checked after the reconstruction)
    const int prev = e - ring;
    const int pm = prev >= 0 ? scal[(size_t)prev * SCAL_W + 1] : -1;

    // residuals: 8 luma, 4 chroma per lane
    int res[8], cres4[4];
    {
      const int4* lp = reinterpret_cast<const int4*>(
          lres + (size_t)mi * 256 + lr * 16 + lc);
      const int4 a = lp[0], b = lp[1];
      res[0] = a.x, res[1] = a.y, res[2] = a.z, res[3] = a.w;
      res[4] = b.x, res[5] = b.y, res[6] = b.z, res[7] = b.w;
      const int4 c = *reinterpret_cast<const int4*>(
          cres + ((size_t)mi * 2 + cpl) * 64 + cr * 8 + cc);
      cres4[0] = c.x, cres4[1] = c.y, cres4[2] = c.z, cres4[3] = c.w;
    }

    // neighbour samples: inter or outside-frame owners now, intra owners
    // after the wait
    Src src[3];
    bool late[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int k = lane + 32 * j;
      late[j] = false;
      if (k >= 71) continue;
      src[j] = locate(k, mx, my, mb_w);
      if (src[j].owner >= 0 && S.st[src[j].owner] >= 0) {
        late[j] = true;
      } else if (src[j].owner < 0) {
        nb[k] = 0;
      } else {
        const uint8_t* p = src[j].plane == 0 ? y : (src[j].plane == 1 ? u : v);
        const int pw = src[j].plane == 0 ? W : Wc;
        nb[k] = p[(size_t)src[j].yy * pw + src[j].xx];
      }
    }

    // the wait: lanes 0..3 watch L, TL, T, TR
    if (lane < 4) {
      int nm = -1;
      if (lane == 0 && mx > 0) nm = mi - 1;
      if (lane == 1 && mx > 0 && my > 0) nm = mi - mb_w - 1;
      if (lane == 2 && my > 0) nm = mi - mb_w;
      if (lane == 3 && my > 0 && mx + 1 < mb_w) nm = mi - mb_w + 1;
      if (nm >= 0 && S.st[nm] >= 0) spin_done(S.st, nm);
    }
    __syncwarp();
    __threadfence_block();
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (!late[j]) continue;
      const int pos = S.st[src[j].owner] >> 1;
      nb[lane + 32 * j] =
          S.ring[(size_t)(pos & rmask) * RING_B + src[j].roff];
    }
    __syncwarp();

    // ---- luma
    int rec[8];
    if (is_i4) {
#pragma unroll
      for (int j = 0; j < 8; ++j) tile[lr * 16 + lc + j] = res[j];
      __syncwarp();
      for (int k = 0; k < 16; ++k) {
        const int mode = col(8 + k);
        if (lane < 16) {
          const int by = kBlkY[k] * 4, bx = kBlkX[k] * 4;
          // sample at MB-relative (yy, xx), yy in -1..15, xx in -1..19
          auto at = [&](int yy, int xx) {
            if (yy < 0) return nb[NB_YT + 1 + xx];
            if (xx < 0) return nb[NB_YL + yy];
            return tile[yy * 16 + xx];
          };
          int t[4], l[4], tt[8];
          for (int j = 0; j < 4; ++j) {
            t[j] = at(by - 1, bx + j);
            l[j] = at(by + j, bx - 1);
          }
          const bool tr = (avtr >> k) & 1;
          for (int j = 0; j < 4; ++j) {
            tt[j] = t[j];
            tt[4 + j] = tr ? at(by - 1, bx + 4 + j) : t[3];
          }
          const int lt = at(by - 1, bx - 1);
          const int px = lane & 3, py = lane >> 2;
          const int p = pred4(mode, px, py, t, l, lt, tt);
          int* o = tile + (by + py) * 16 + bx + px;
          *o = clampi(p + *o, 0, 255);
        }
        __syncwarp();
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) rec[j] = tile[lr * 16 + lc + j];
      __syncwarp();
    } else {
      const int* top = nb + NB_YT + 1;
      const int* left = nb + NB_YL;
      int pv[8];
      if (e16 == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) pv[j] = top[lc + j];
      } else if (e16 == 1) {
#pragma unroll
        for (int j = 0; j < 8; ++j) pv[j] = left[lr];
      } else if (e16 == 3) {  // plane (§8.3.3.4)
        const int k = lane & 15;
        const int* s = lane < 16 ? top : left;
        int term = 0;
        if (k < 8) term = (k + 1) * (s[8 + k] - (k < 7 ? s[6 - k] : nb[NB_YT]));
        term = xsum(term, 4);
        const int hs = __shfl_sync(0xffffffffu, term, 0);
        const int vs = __shfl_sync(0xffffffffu, term, 16);
        const int a = 16 * (left[15] + top[15]);
        const int b = (5 * hs + 32) >> 6, c = (5 * vs + 32) >> 6;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          pv[j] = clampi((a + b * (lc + j - 7) + c * (lr - 7) + 16) >> 5, 0,
                         255);
      } else {  // DC: 2 both, 4 top only, 5 left only, 6 neither
        int s = lane < 16 ? top[lane] : left[lane - 16];
        s = xsum(s, 8);
        const int st = __shfl_sync(0xffffffffu, s, 0);
        const int sl = __shfl_sync(0xffffffffu, s, 16);
        const int d = e16 == 2 ? (st + sl + 16) >> 5
                      : e16 == 4 ? (st + 8) >> 4
                      : e16 == 5 ? (sl + 8) >> 4 : 128;
#pragma unroll
        for (int j = 0; j < 8; ++j) pv[j] = d;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) rec[j] = clampi(pv[j] + res[j], 0, 255);
    }

    // ---- chroma: lanes 0-15 U, 16-31 V
    int crec[4];
    {
      const int* cb = nb + (cpl ? NB_VT : NB_UT);
      const int* top = cb + 1;
      const int* left = cb + 9;
      const int k = lane & 15;
      int pv[4];
      if (ecm == 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) pv[j] = left[cr];
      } else if (ecm == 5) {
#pragma unroll
        for (int j = 0; j < 4; ++j) pv[j] = top[cc + j];
      } else if (ecm == 6) {  // plane (§8.3.4.4)
        int term = 0;
        if (k < 4) term = (k + 1) * (top[4 + k] - (k < 3 ? top[2 - k] : cb[0]));
        else if (k >= 8 && k < 12)
          term = (k - 7) * (left[k - 4] - (k < 11 ? left[10 - k] : cb[0]));
        term = xsum(term, 4);
        const int hs = __shfl_sync(0xffffffffu, term, lane & 16);
        const int vs = __shfl_sync(0xffffffffu, term, (lane & 16) + 8);
        const int a = 16 * (left[7] + top[7]);
        const int b = (17 * hs + 16) >> 5, c = (17 * vs + 16) >> 5;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pv[j] = clampi((a + b * (cc + j - 3) + c * (cr - 3) + 16) >> 5, 0,
                         255);
      } else {  // DC per 4x4 quadrant: 0 both, 1 top only, 2 left, 3 none
        int s = k < 8 ? top[k] : left[k - 8];
        s = xsum(s, 2);
        const int qx = cc >> 2, qy = cr >> 2;
        const int ts = __shfl_sync(0xffffffffu, s, (lane & 16) + qx * 4);
        const int ls = __shfl_sync(0xffffffffu, s, (lane & 16) + 8 + qy * 4);
        const int both = (ts + ls + 4) >> 3, tonly = (ts + 2) >> 2,
                  lonly = (ls + 2) >> 2;
        int d;
        if (ecm == 0) d = qx == qy ? both : (qy == 0 ? tonly : lonly);
        else d = ecm == 1 ? tonly : (ecm == 2 ? lonly : 128);
#pragma unroll
        for (int j = 0; j < 4; ++j) pv[j] = d;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) crec[j] = clampi(pv[j] + cres4[j], 0, 255);
    }

    // ---- write the planes (8-byte luma and 4-byte chroma stores)
    {
      uint32_t w0 = 0, w1 = 0, wc = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w0 |= (uint32_t)rec[j] << (8 * j);
        w1 |= (uint32_t)rec[4 + j] << (8 * j);
        wc |= (uint32_t)crec[j] << (8 * j);
      }
      *reinterpret_cast<uint2*>(y + (size_t)(my * 16 + lr) * W + mx * 16 +
                                lc) = make_uint2(w0, w1);
      *reinterpret_cast<uint32_t*>((cpl ? v : u) +
                                   (size_t)(my * 8 + cr) * Wc + mx * 8 +
                                   cc) = wc;
    }

    // ---- publish: wait for the readers of the slot's previous entry,
    // then write the bottom row and right column, then set the flag
    if (pm >= 0 && lane < 4) {
      const int px = pm % mb_w, py = pm / mb_w;
      int r = -1;
      if (lane == 0 && px + 1 < mb_w) r = pm + 1;
      if (py + 1 < mb_h) {
        if (lane == 1 && px > 0) r = pm + mb_w - 1;
        if (lane == 2) r = pm + mb_w;
        if (lane == 3 && px + 1 < mb_w) r = pm + mb_w + 1;
      }
      if (r >= 0 && S.st[r] >= 0) spin_done(S.st, r);
    }
    __syncwarp();
    __threadfence_block();
    uint8_t* slot = S.ring + (size_t)(e & rmask) * RING_B;
    if (lr == 15) {
#pragma unroll
      for (int j = 0; j < 8; ++j) slot[lc + j] = (uint8_t)rec[j];
    }
    if (lane & 1) slot[16 + lr] = (uint8_t)rec[7];
    if (cr == 7) {
#pragma unroll
      for (int j = 0; j < 4; ++j) slot[32 + 16 * cpl + cc + j] = (uint8_t)crec[j];
    }
    if (lane & 1) slot[32 + 16 * cpl + 8 + cr] = (uint8_t)crec[3];
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      *reinterpret_cast<volatile int*>(S.st + mi) = (e << 1) | 1;
    }
    __syncwarp();
  }
}

}  // namespace

// Shared memory the kernel needs for a frame of mb_w x mb_h MBs: one int
// per MB, the per-warp tiles and the ring (RING = the power of two >=
// mb_w + 2).
extern "C" int intra_ring(int mb_w) {
  int r = 1;
  while (r < mb_w + 2) r <<= 1;
  return r;
}

extern "C" long intra_smem(int mb_w, int mb_h) {
  return (long)smem_bytes(mb_w * mb_h, intra_ring(mb_w));
}

extern "C" long intra_smem_limit() { return MAX_SMEM; }

// Rebuilds the scal-listed intra MBs of y/u/v in place.
extern "C" int intra_scan(void* y, void* u, void* v, const void* scal, int n,
                          const void* lres, const void* cres, int mb_w,
                          int mb_h, void* stream) {
  // the shared-memory attribute holds for the process: set it once per
  // device (bit d of `ready`; devices past 63 set it on every call)
  static std::atomic<uint64_t> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  const int ring = intra_ring(mb_w);
  const size_t smem = smem_bytes(mb_w * mb_h, ring);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(intra_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  if (n > 0) {
    intra_kernel<<<1, WARPS * 32, smem, (cudaStream_t)stream>>>(
        (uint8_t*)y, (uint8_t*)u, (uint8_t*)v, (const int32_t*)scal, n,
        (const int32_t*)lres, (const int32_t*)cres, mb_w, mb_h, ring);
  }
  return (int)cudaGetLastError();
}
