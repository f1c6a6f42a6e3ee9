// MPEG-4 part 2 (Simple Profile) macroblock-layer VLC packer.
//
// Host-side serial bit packing for the TPU encoder: the device emits
// per-block zigzag levels + per-MB motion vectors; this walks MBs in
// raster order and writes the VOP macroblock layer (ISO/IEC 14496-2
// §6.3.6 + Tables B-6..B-17). Role analog of the reference's
// mpeg4videoenc.c mpeg4_encode_mb + put_bits.h, redesigned around flat
// array inputs instead of per-MB encode state.
//
// Behavior matches codecs/mpeg4/encoder.py's Python packer bit-for-bit
// (asserted in tests/test_mpeg4.py).

#include <stdint.h>
#include <string.h>

#include "mpeg4_tables.h"

namespace {

struct BW {
  uint8_t* buf;
  long cap;
  long nbytes;
  uint64_t acc;
  int nbits;
  bool overflow;

  void put(uint32_t value, int bits) {
    if (bits <= 0) return;
    acc = (acc << bits) | (value & ((bits >= 32) ? 0xffffffffu
                                                 : ((1u << bits) - 1)));
    nbits += bits;
    while (nbits >= 8) {
      nbits -= 8;
      if (nbytes >= cap) { overflow = true; return; }
      buf[nbytes++] = (uint8_t)((acc >> nbits) & 0xff);
    }
    acc &= (1u << nbits) - 1;
  }

  void align_stuffing() {
    // next_start_code(): one 0 then 1s to byte alignment; a full
    // '01111111' if already aligned.
    int n = nbits ? 8 - nbits : 8;
    put(0, 1);
    if (n > 1) put((1u << (n - 1)) - 1, n - 1);
  }
};

inline void put_pair(BW& b, const int32_t* tab, int idx) {
  b.put((uint32_t)tab[2 * idx], tab[2 * idx + 1]);
}

void put_dc(BW& b, int diff, bool chroma) {
  int ad = diff < 0 ? -diff : diff;
  int size = 0;
  while (ad >> size) size++;
  put_pair(b, chroma ? M4_DC_CHROM : M4_DC_LUM, size);
  if (size) {
    int v = diff > 0 ? diff : diff + (1 << size) - 1;
    b.put((uint32_t)v, size);
    if (size > 8) b.put(1, 1);
  }
}

// Encode one block's zigzag levels from index `first`.
void put_coeffs(BW& b, const int16_t* zz, int first, bool intra) {
  const int32_t* lut = intra ? M4_RL_INTRA : M4_RL_INTER;
  int prev = first - 1;
  // find last nonzero
  int lastnz = -1;
  for (int i = 63; i >= first; i--)
    if (zz[i]) { lastnz = i; break; }
  if (lastnz < 0) return;
  for (int pos = first; pos <= lastnz; pos++) {
    int level = zz[pos];
    if (!level) continue;
    int run = pos - prev - 1;
    prev = pos;
    int last = pos == lastnz ? 1 : 0;
    int alevel = level < 0 ? -level : level;
    int ent = (run < 64 && alevel < 32)
                  ? lut[(last * 64 + run) * 32 + alevel]
                  : 0;
    if (ent) {
      b.put((uint32_t)(ent >> 5), ent & 31);
      b.put(level < 0 ? 1 : 0, 1);
    } else {
      b.put(M4_ESCAPE_CODE, M4_ESCAPE_BITS);
      b.put(0b11, 2);              // escape type 3
      b.put(last, 1);
      b.put(run, 6);
      b.put(1, 1);                 // marker
      b.put((uint32_t)level & 0xfff, 12);
      b.put(1, 1);                 // marker
    }
  }
}

void put_mv(BW& b, int d) {
  if (d < -32) d += 64;
  else if (d > 31) d -= 64;
  int ad = d < 0 ? -d : d;
  put_pair(b, M4_MVTAB, ad);
  if (d) b.put(d < 0 ? 1 : 0, 1);
}

inline bool any16(const int16_t* p, int from) {
  for (int i = from; i < 64; i++)
    if (p[i]) return true;
  return false;
}

inline int med3(int a, int b, int c) {
  return a + b + c - (a > b ? (a > c ? a : c) : (b > c ? b : c))
       - (a < b ? (a < c ? a : c) : (b < c ? b : c));
}

}  // namespace

// Pack one VOP's macroblock layer after a header bit prefix.
//
// hdr/hdr_nbits: already-rendered VOP (+sequence) header bits, MSB-first
//   packed (the final partial byte's bits left-aligned... NO: packed
//   exactly as BitWriter bytes + `acc` low bits given separately).
// Returns total byte count written (stream is stuffing-aligned), or -1
// on overflow / bad args.
extern "C" long mpeg4_pack_frame(
    const uint8_t* hdr_bytes, int hdr_nbytes, uint32_t hdr_acc,
    int hdr_accbits,
    int is_i, int mb_w, int mb_h,
    const int32_t* dc_diff_y,  // [2*mb_h * 2*mb_w] (I only, else null ok)
    const int32_t* dc_diff_u,  // [mb_h * mb_w]
    const int32_t* dc_diff_v,
    const int16_t* zz_y,       // [(2*mb_h)*(2*mb_w) * 64] block raster
    const int16_t* zz_u,       // [mb_h*mb_w * 64]
    const int16_t* zz_v,
    const int32_t* mvh,        // [mb_h * mb_w * 2] (dy, dx) halfpel (P)
    uint8_t* out, long cap) {
  BW b{out, cap, 0, 0, 0, false};
  for (int i = 0; i < hdr_nbytes; i++) b.put(hdr_bytes[i], 8);
  if (hdr_accbits) b.put(hdr_acc, hdr_accbits);

  const int nbx = mb_w * 2;
  for (int my = 0; my < mb_h; my++) {
    for (int mx = 0; mx < mb_w; mx++) {
      const int mb = my * mb_w + mx;
      // luma blocks in raster order within MB
      const int lb[4] = {(2 * my) * nbx + 2 * mx,
                         (2 * my) * nbx + 2 * mx + 1,
                         (2 * my + 1) * nbx + 2 * mx,
                         (2 * my + 1) * nbx + 2 * mx + 1};
      const int16_t* ay[4] = {zz_y + 64l * lb[0], zz_y + 64l * lb[1],
                              zz_y + 64l * lb[2], zz_y + 64l * lb[3]};
      const int16_t* au = zz_u + 64l * mb;
      const int16_t* av = zz_v + 64l * mb;
      if (is_i) {
        int cbpy = 0;
        for (int i = 0; i < 4; i++)
          if (any16(ay[i], 1)) cbpy |= 8 >> i;
        int cbpc = (any16(au, 1) ? 2 : 0) | (any16(av, 1) ? 1 : 0);
        put_pair(b, M4_INTRA_MCBPC, cbpc);
        b.put(0, 1);  // ac_pred_flag
        put_pair(b, M4_CBPY, cbpy);
        for (int i = 0; i < 4; i++) {
          put_dc(b, dc_diff_y[lb[i]], false);
          if (cbpy & (8 >> i)) put_coeffs(b, ay[i], 1, true);
        }
        put_dc(b, dc_diff_u[mb], true);
        if (cbpc & 2) put_coeffs(b, au, 1, true);
        put_dc(b, dc_diff_v[mb], true);
        if (cbpc & 1) put_coeffs(b, av, 1, true);
      } else {
        int cbpy = 0;
        for (int i = 0; i < 4; i++)
          if (any16(ay[i], 0)) cbpy |= 8 >> i;
        int cbpc = (any16(au, 0) ? 2 : 0) | (any16(av, 0) ? 1 : 0);
        const int tdy = mvh[2 * mb], tdx = mvh[2 * mb + 1];
        if (!cbpy && !cbpc && !tdy && !tdx) {
          b.put(1, 1);  // not_coded (skip)
          continue;
        }
        b.put(0, 1);  // coded
        put_pair(b, M4_INTER_MCBPC, 0 * 4 + cbpc);
        put_pair(b, M4_CBPY, 15 - cbpy);
        // median MV predictor (§7.5.5, all-1MV frame): candidates
        // A=left, B=top, C=top-right; first row -> A (or 0)
        int px, py;
        {
          bool hasA = mx > 0, hasB = my > 0, hasC = my > 0 && mx + 1 < mb_w;
          int Ax = hasA ? mvh[2 * (mb - 1) + 1] : 0;
          int Ay = hasA ? mvh[2 * (mb - 1)] : 0;
          if (!hasB && !hasC) {
            px = Ax; py = Ay;
          } else {
            int Bx = hasB ? mvh[2 * (mb - mb_w) + 1] : 0;
            int By = hasB ? mvh[2 * (mb - mb_w)] : 0;
            int Cx = hasC ? mvh[2 * (mb - mb_w + 1) + 1] : 0;
            int Cy = hasC ? mvh[2 * (mb - mb_w + 1)] : 0;
            px = med3(Ax, Bx, Cx);
            py = med3(Ay, By, Cy);
          }
        }
        put_mv(b, tdx - px);
        put_mv(b, tdy - py);
        for (int i = 0; i < 4; i++)
          if (cbpy & (8 >> i)) put_coeffs(b, ay[i], 0, false);
        if (cbpc & 2) put_coeffs(b, au, 0, false);
        if (cbpc & 1) put_coeffs(b, av, 0, false);
      }
      if (b.overflow) return -1;
    }
  }
  b.align_stuffing();
  if (b.overflow) return -1;
  return b.nbytes;
}
