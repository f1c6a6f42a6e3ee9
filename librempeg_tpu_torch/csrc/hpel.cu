// MPEG-4 half-pel motion refinement + motion compensation: the luma
// refinement and luma MC, and the chroma MC at the derived MV, fused in
// one kernel on the encoder's path, with each half also on its own.
//
// Replaces the Pallas kernels of librempeg_tpu/codecs/mpeg4/me_pallas.py:
// hpel_kernel<true> the group forms of the encoder's path
// (hpel_refine_mc: _refine_mc_luma_group -> _refine_group_kernel, then
// _mc_chroma_group -> _chroma_group_kernel), hpel_kernel<false> the
// per-MB luma form (_refine_mc_luma -> _refine_kernel), chroma_kernel
// the per-MB chroma form (_mc_chroma -> _chroma_kernel). They hold the
// contract of ops.motion._hpel_refine + mc_hpel: the 25 half-pel
// candidates around each integer MV in row-major (dy, dx) order,
// strict-< SAD ties (the first best wins), decoder-exact (a+b+1-rnd)>>1
// and (a+b+c+d+2-rnd)>>2 interpolation, then the chroma MV by the
// /2-with-sticky-half rule and 8x8 chroma MC.
//
// Inputs are the encoder's float32 planes; as in the JAX package they
// are truncated to bytes first (recon 2.9999998 becomes 2), and samples
// outside the plane take the nearest edge sample, which equals the JAX
// package's 16-pixel edge pad for the MV range the search produces. The
// TPU kernels read overlapping reference tiles picked by selector words;
// these read the planes at the MV.
//
// Design, luma: one warp per 16x16 MB, 4 MBs (a strip of one MB row)
// per block of 128 threads. Each MB has its own MV, so its 18x18 window
// (the half-pel candidates reach one sample before and one past the
// block in each direction, plus one for the taps) is its own: the warp
// loads it with 16-byte loads (6 float4 per row, an edge clamp per row),
// all issued before any is used, and truncates it to bytes on the way
// into shared memory; where a row would leave the plane it loads sample
// by sample with a clamp per column. No integer division per element.
// Lane l owns 8 pixels of row l/2 and keeps all 25 candidate SADs in
// registers: for each of the 5 half-pel rows of its span it
// interpolates the 19 half-pel samples once (the 25 candidates share
// them) and adds the 8 x 5 absolute differences with __sad (one
// instruction each, where |a - b| + s in plain integers took three). The
// warp then reduces the 25 sums once, by a transposing butterfly (31
// shuffles, after which lane c holds candidate c's SAD), and takes the
// first minimum in candidate order by a shuffle argmin, which leaves the
// winner in every lane's registers. Lane 0 writes the half-pel MV; each
// lane interpolates its 8 pixels at the winner and writes them with two
// 16-byte stores.
//
// Design, chroma: one warp per MB (chroma_warp). Lane l predicts 4
// samples of plane l >> 4, row (l >> 1) & 7, columns 4 * (l & 1) .. + 3
// from two source rows of 5 samples, and writes them as one float4
// (Wc = W/2 is a multiple of 8 and the columns start at a multiple of 4,
// so each row of 4 floats is 16-byte aligned). The samples come from a
// 10x10 window per plane in shared memory, edge-clamped and truncated to
// bytes as it is loaded: 20 lanes load a column each, so every load
// instruction reads two runs of 10 neighbouring floats (lanes reading
// their own 2x5 samples touched 16 rows per instruction, and the L1's
// requests, not the bytes, set the time). In the fused kernel the warp
// calls it right after the argmin, with the MV from its registers: the
// MV never goes through global memory. Its window was loaded at the
// start, beside the luma window: for each of the 25 candidates the
// chroma MV's integer part lies within (mv_i - 1) >> 1 .. (mv_i + 1) >>
// 1, so a 10x10 window per plane at ((mv_i - 1) >> 1) holds every sample
// the winner can need, and its loads overlap the luma loads. The
// standalone chroma kernel (4 MBs per block) reads the MV written by the
// luma kernel and loads its window at the chroma MV (chroma_mb).
//
// Bound on the H100: the bytes bound it on paper (the current and
// reference luma and the reference chroma read once as float32, the
// predictions written: 16 MB per 1280x720 P-VOP, 4.4 us at 3.35 TB/s);
// in practice the luma's instructions (about 1200 per warp, 3600 warps
// per P-VOP) and the latency of each warp's loads set its time. Packing
// four samples to a word (__vsadu4 on byte strings) issued no fewer
// instructions on the card than __sad and was no faster; the variants'
// times are in PERF.md (tools/kernel_variants.py). The chroma alone reads
// and writes 1/3 of the luma's bytes and does no search: its launch and
// one round of dependent loads are most of its cost, which the fused
// kernel does not pay.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MBS = 4;           // MBs per block (a strip of one MB row)
constexpr int WR = 18;           // window rows and columns used
constexpr int WP = 20;           // window pitch in ints (16-byte rows)
constexpr int CW = 10;           // chroma window rows and columns

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// float sample -> integer byte value, truncating like astype(uint8)
__device__ __forceinline__ int trunc8(float f) {
  return (int)(uint8_t)(int)f;
}

// luma half-pel MV component -> chroma half-pel: sign(v) * ((|v| >> 1) |
// (|v| & 1))
__device__ __forceinline__ int chroma_mv(int v) {
  const int a = v < 0 ? -v : v;
  const int c = (a >> 1) | (a & 1);
  return v < 0 ? -c : c;
}

// the chroma window of one warp: CW x CW samples of each plane from
// (oy, ox), edge-clamped. Lane < 2 * CW loads column lane % CW of plane
// lane / CW, so each load instruction reads two runs of CW neighbouring
// samples (one per plane).
__device__ __forceinline__ void window_load(float (&f)[CW], int lane,
                                            const float* ref_u,
                                            const float* ref_v, int oy,
                                            int ox, int hc, int wc) {
  const int pl = lane >= CW;
  const float* src = (pl ? ref_v : ref_u) +
                     clampi(ox + lane - pl * CW, 0, wc - 1);
#pragma unroll
  for (int r = 0; r < CW; ++r)
    f[r] = __ldg(src + clampi(oy + r, 0, hc - 1) * wc);
}

// ... into the warp's window in shared memory, truncated to bytes
__device__ __forceinline__ void window_store(int* cw, int lane,
                                             const float (&f)[CW]) {
#pragma unroll
  for (int r = 0; r < CW; ++r)
    cw[(lane / CW * CW + r) * CW + lane % CW] = trunc8(f[r]);
}

// One MB's two 8x8 chroma predictions at chroma MV (cmy, cmx), by one
// warp, from its window cw at (oy, ox): lane -> plane lane >> 4, row
// (lane >> 1) & 7, 4 columns from 4 * (lane & 1); two source rows of 5
// samples each, one float4 store.
__device__ __forceinline__ void chroma_warp(const int* cw, int oy, int ox,
                                            int lane, int cmy, int cmx,
                                            int by, int bx, int wc, int rnd,
                                            float* pred_u, float* pred_v) {
  const int pl = lane >> 4, row = (lane >> 1) & 7, c0 = (lane & 1) * 4;
  const int fy = cmy & 1, fx = cmx & 1;
  const int* s = cw + (pl * CW + by * 8 + (cmy >> 1) + row - oy) * CW +
                 bx * 8 + (cmx >> 1) + c0 - ox;
  int a[5], c[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) a[k] = s[k], c[k] = s[CW + k];
  const int r1 = 1 - rnd, r2 = 2 - rnd;
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int p;
    if (!fy) p = fx ? (a[k] + a[k + 1] + r1) >> 1 : a[k];
    else p = fx ? (a[k] + a[k + 1] + c[k] + c[k + 1] + r2) >> 2
                : (a[k] + c[k] + r1) >> 1;
    o[k] = (float)p;
  }
  *reinterpret_cast<float4*>((pl ? pred_v : pred_u) + (by * 8 + row) * wc +
                             bx * 8 + c0) = make_float4(o[0], o[1], o[2], o[3]);
}

// One MB's chroma from the planes: its window at the chroma MV, then the
// predictions (the standalone kernel)
__device__ __forceinline__ void chroma_mb(int* cw, const float* ref_u,
                                          const float* ref_v, int hc,
                                          int lane, int cmy, int cmx, int by,
                                          int bx, int wc, int rnd,
                                          float* pred_u, float* pred_v) {
  const int oy = by * 8 + (cmy >> 1), ox = bx * 8 + (cmx >> 1);
  if (lane < 2 * CW) {
    float f[CW];
    window_load(f, lane, ref_u, ref_v, oy, ox, hc, wc);
    window_store(cw, lane, f);
  }
  __syncwarp();
  chroma_warp(cw, oy, ox, lane, cmy, cmx, by, bx, wc, rnd, pred_u, pred_v);
}

// window row r, columns c0 .. c0+9 of a 16-byte aligned row
__device__ __forceinline__ void load_row(const int* w, int r, int c0,
                                         int (&o)[10]) {
  const int4* p = reinterpret_cast<const int4*>(w + r * WP + c0);
  const int4 a = p[0], b = p[1], c = p[2];
  o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w;
  o[4] = b.x, o[5] = b.y, o[6] = b.z, o[7] = b.w;
  o[8] = c.x, o[9] = c.y;
}

// SAD terms of one half-pel row: pixel q against half-pel samples
// 2q .. 2q+4 (the five dx candidates)
__device__ __forceinline__ void add_row(const int (&hp)[19],
                                        const int (&cv)[8], int* sad) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
#pragma unroll
    for (int d = 0; d < 5; ++d)
      sad[d] = (int)__sad(cv[q], hp[2 * q + d], (unsigned)sad[d]);
  }
}

// CHROMA: also predict both chroma planes at the winner (the fused
// kernel); otherwise the luma half alone.
template <bool CHROMA>
__global__ void __launch_bounds__(MBS * 32)
    hpel_kernel(const float* __restrict__ cur,
                const float* __restrict__ ref_y,
                const float* __restrict__ ref_u,
                const float* __restrict__ ref_v,
                const int32_t* __restrict__ mv_i, int H, int W, int rnd,
                int32_t* __restrict__ mv_h, float* __restrict__ pred_y,
                float* __restrict__ pred_u, float* __restrict__ pred_v) {
  __shared__ __align__(16) int win[MBS][WR * WP];
  __shared__ int cwin[CHROMA ? MBS : 1][2 * CW * CW];
  const int bw = W / 16, strips = (bw + MBS - 1) / MBS;
  const int by = blockIdx.x / strips, warp = threadIdx.x >> 5;
  const int bx = (blockIdx.x - by * strips) * MBS + warp;
  const int lane = threadIdx.x & 31;
  if (bx >= bw) return;                      // the ragged strip's spare warps
  const int m = by * bw + bx;
  const int mvy = mv_i[m * 2 + 0], mvx = mv_i[m * 2 + 1];
  const int oy = by * 16 + mvy - 1, ox = bx * 16 + mvx - 1;
  int* const w = win[warp];

  // chroma window (CHROMA) at the origin every candidate's MV covers
  const int hc = H / 2, wc = W / 2;
  const int oyc = by * 8 + ((mvy - 1) >> 1), oxc = bx * 8 + ((mvx - 1) >> 1);
  float cf[CW];
  if (CHROMA && lane < 2 * CW)
    window_load(cf, lane, ref_u, ref_v, oyc, oxc, hc, wc);

  // all loads first: the lane's 8 current pixels, then the window (rows
  // oy .., columns ox .., edge-clamped), truncated to bytes into shared
  // memory
  const int py = lane >> 1, c0 = (lane & 1) * 8;
  const float4* cp = reinterpret_cast<const float4*>(
      cur + (size_t)(by * 16 + py) * W + bx * 16 + c0);
  const float4 cur0 = __ldg(cp), cur1 = __ldg(cp + 1);
  const int a0 = ox & ~3;                    // 16-byte aligned column
  if (a0 >= 0 && a0 + 24 <= W) {
    if (lane < 30) {                         // lane: row phase, float4
      const int q = lane % 6, r0 = lane / 6;
      const int cb = a0 + 4 * q - ox;        // window column of .x
      float4 f[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int yy = clampi(oy + min(r0 + 5 * i, WR - 1), 0, H - 1);
        f[i] = __ldg(reinterpret_cast<const float4*>(
            ref_y + (size_t)yy * W + a0 + 4 * q));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + 5 * i;
        const float fv[4] = {f[i].x, f[i].y, f[i].z, f[i].w};
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (r < WR && cb + t >= 0 && cb + t < WP)
            w[r * WP + cb + t] = trunc8(fv[t]);
      }
    }
  } else if (lane < WP) {                    // near a side edge
    const int xx = clampi(ox + lane, 0, W - 1);
    float f[WR];
#pragma unroll
    for (int r = 0; r < WR; ++r)
      f[r] = __ldg(ref_y + (size_t)clampi(oy + r, 0, H - 1) * W + xx);
#pragma unroll
    for (int r = 0; r < WR; ++r) w[r * WP + lane] = trunc8(f[r]);
  }
  if (CHROMA && lane < 2 * CW) window_store(cwin[warp], lane, cf);
  const int cv[8] = {trunc8(cur0.x), trunc8(cur0.y), trunc8(cur0.z),
                     trunc8(cur0.w), trunc8(cur1.x), trunc8(cur1.y),
                     trunc8(cur1.z), trunc8(cur1.w)};
  __syncwarp();

  // half-pel row j = dy + 2 of pixel row py interpolates window rows
  // py + j/2 (and py + j/2 + 1 for odd j); half-pel column 2q + dx + 2 of
  // pixel q interpolates window columns c0 + q + (dx + 2)/2 (and the next
  // for odd dx)
  const int r1 = 1 - rnd, r2 = 2 - rnd;
  int sad[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) sad[k] = 0;
  int wa[10], wb[10], hp[19];
  load_row(w, py, c0, wa);
#pragma unroll
  for (int t = 0; t < 3; ++t) {
#pragma unroll
    for (int i = 0; i < 19; ++i)
      hp[i] = (i & 1) ? (wa[i >> 1] + wa[(i >> 1) + 1] + r1) >> 1 : wa[i >> 1];
    add_row(hp, cv, sad + 10 * t);
    if (t < 2) {
      load_row(w, py + t + 1, c0, wb);
#pragma unroll
      for (int i = 0; i < 19; ++i) {
        const int k = i >> 1;
        hp[i] = (i & 1) ? (wa[k] + wa[k + 1] + wb[k] + wb[k + 1] + r2) >> 2
                        : (wa[k] + wb[k] + r1) >> 1;
      }
      add_row(hp, cv, sad + 10 * t + 5);
#pragma unroll
      for (int i = 0; i < 10; ++i) wa[i] = wb[i];
    }
  }

  // transposing butterfly: after the step over lane bit b, a lane keeps
  // the half of its sums whose candidate bit b equals its own; lane c
  // ends with the warp's SAD of candidate c
  int v[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) v[k] = k < 25 ? sad[k] : 0;
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) {
    const bool up = lane & h;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const int send = up ? v[i] : v[i + h];
      const int keep = up ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, h);
    }
  }
  // first minimum in candidate order
  int bs = lane < 25 ? v[0] : 0x7fffffff, bk = lane;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int os = __shfl_xor_sync(0xffffffffu, bs, off);
    const int ok = __shfl_xor_sync(0xffffffffu, bk, off);
    if (os < bs || (os == bs && ok < bk)) bs = os, bk = ok;
  }
  const int dy = bk / 5 - 2, dx = bk % 5 - 2;
  if (lane == 0) {
    mv_h[m * 2 + 0] = 2 * mvy + dy;
    mv_h[m * 2 + 1] = 2 * mvx + dx;
  }
  const int fy = dy & 1, fx = dx & 1;
  const int* r0 = w + (1 + py + (dy >> 1)) * WP + 1 + c0 + (dx >> 1);
  const int* r1p = r0 + fy * WP;
  float out[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int a = r0[q], b = r0[q + fx], c = r1p[q], d = r1p[q + fx];
    out[q] = (float)(fy && fx ? (a + b + c + d + r2) >> 2
                              : (fy || fx ? (a + d + r1) >> 1 : a));
  }
  float4* op = reinterpret_cast<float4*>(
      pred_y + (size_t)(by * 16 + py) * W + bx * 16 + c0);
  op[0] = make_float4(out[0], out[1], out[2], out[3]);
  op[1] = make_float4(out[4], out[5], out[6], out[7]);

  if constexpr (CHROMA)
    chroma_warp(cwin[warp], oyc, oxc, lane, chroma_mv(2 * mvy + dy),
                chroma_mv(2 * mvx + dx), by, bx, wc, rnd, pred_u, pred_v);
}

// the chroma MC alone, at the luma half-pel MVs mv_h: one warp per MB
__global__ void __launch_bounds__(MBS * 32)
    chroma_kernel(const float* __restrict__ ref_u,
                  const float* __restrict__ ref_v,
                  const int32_t* __restrict__ mv_h, int H, int W, int rnd,
                  float* __restrict__ pred_u, float* __restrict__ pred_v) {
  __shared__ int cwin[MBS][2 * CW * CW];
  const int bw = W / 16, strips = (bw + MBS - 1) / MBS;
  const int by = blockIdx.x / strips, warp = threadIdx.x >> 5;
  const int bx = (blockIdx.x - by * strips) * MBS + warp;
  if (bx >= bw) return;
  const int2 mv = __ldg(reinterpret_cast<const int2*>(mv_h) + by * bw + bx);
  chroma_mb(cwin[warp], ref_u, ref_v, H / 2, threadIdx.x & 31,
            chroma_mv(mv.x), chroma_mv(mv.y), by, bx, W / 2, rnd, pred_u,
            pred_v);
}

int blocks(int H, int W) { return (H / 16) * ((W / 16 + MBS - 1) / MBS); }

}  // namespace

extern "C" int hpel_refine_mc(const void* cur, const void* ref_y,
                              const void* ref_u, const void* ref_v,
                              const void* mv_i, int H, int W, int rnd,
                              void* mv_h, void* pred_y, void* pred_u,
                              void* pred_v, void* stream) {
  if (blocks(H, W) > 0) {
    hpel_kernel<true><<<blocks(H, W), MBS * 32, 0, (cudaStream_t)stream>>>(
        (const float*)cur, (const float*)ref_y, (const float*)ref_u,
        (const float*)ref_v, (const int32_t*)mv_i, H, W, rnd,
        (int32_t*)mv_h, (float*)pred_y, (float*)pred_u, (float*)pred_v);
  }
  return (int)cudaGetLastError();
}

extern "C" int refine_mc_luma(const void* cur, const void* ref_y,
                              const void* mv_i, int H, int W, int rnd,
                              void* mv_h, void* pred_y, void* stream) {
  if (blocks(H, W) > 0) {
    hpel_kernel<false><<<blocks(H, W), MBS * 32, 0, (cudaStream_t)stream>>>(
        (const float*)cur, (const float*)ref_y, nullptr, nullptr,
        (const int32_t*)mv_i, H, W, rnd, (int32_t*)mv_h, (float*)pred_y,
        nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}

extern "C" int mc_chroma(const void* ref_u, const void* ref_v,
                         const void* mv_h, int H, int W, int rnd,
                         void* pred_u, void* pred_v, void* stream) {
  if (blocks(H, W) > 0) {
    chroma_kernel<<<blocks(H, W), MBS * 32, 0, (cudaStream_t)stream>>>(
        (const float*)ref_u, (const float*)ref_v, (const int32_t*)mv_h, H, W,
        rnd, (float*)pred_u, (float*)pred_v);
  }
  return (int)cudaGetLastError();
}
