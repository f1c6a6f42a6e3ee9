// Host-side serial bitstream kernels.
//
// The TPU framework keeps entropy coding on the CPU (SURVEY.md §7 "hard
// parts": serial entropy coding) while all pixel math runs on device.
// This module implements the hot serial loops as C with a flat C ABI
// consumed via ctypes:
//
//   * JPEG baseline Huffman scan decode  (mjpegdec.c's role)
//   * JPEG baseline Huffman scan encode  (mjpegenc.c's role)
//   * PNG row unfilter / filter          (pngdec.c/pngenc.c predictors)
//   * bit reader utilities for container/codec parsing
//
// Design: batch interfaces — one call decodes a whole scan into a dense
// coefficient tensor ready for device upload; no per-block Python.

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// Bit reader over a byte-stuffed JPEG scan (0xFF 0x00 -> 0xFF)
// ---------------------------------------------------------------------------

struct BitReader {
    const uint8_t* data;
    int size;
    int pos;        // byte position
    uint32_t bitbuf;
    int bitcnt;
    int marker_hit; // stopped at a marker (0xFF non-stuff)
};

static void br_init(BitReader* br, const uint8_t* data, int size) {
    br->data = data;
    br->size = size;
    br->pos = 0;
    br->bitbuf = 0;
    br->bitcnt = 0;
    br->marker_hit = 0;
}

static inline void br_fill(BitReader* br) {
    while (br->bitcnt <= 24) {
        uint8_t b = 0;
        if (br->pos < br->size) {
            b = br->data[br->pos];
            if (b == 0xFF) {
                if (br->pos + 1 < br->size && br->data[br->pos + 1] == 0x00) {
                    br->pos += 2;          // stuffed 0xFF
                } else {
                    br->marker_hit = 1;    // real marker: feed zeros
                    b = 0;
                }
            } else {
                br->pos += 1;
            }
        }
        br->bitbuf = (br->bitbuf << 8) | b;
        br->bitcnt += 8;
    }
}

static inline int br_peek(BitReader* br, int n) {
    br_fill(br);
    return (br->bitbuf >> (br->bitcnt - n)) & ((1u << n) - 1);
}

static inline void br_skip(BitReader* br, int n) { br->bitcnt -= n; }

static inline int br_get(BitReader* br, int n) {
    if (n == 0) return 0;
    int v = br_peek(br, n);
    br_skip(br, n);
    return v;
}

// JPEG "receive and extend": n-bit magnitude -> signed value
static inline int jpeg_extend(int v, int n) {
    if (n == 0) return 0;
    return (v < (1 << (n - 1))) ? v - (1 << n) + 1 : v;
}

// ---------------------------------------------------------------------------
// Canonical Huffman decode tables (JPEG Annex C)
// ---------------------------------------------------------------------------

struct HuffTable {
    // two-level lookup: primary 9 bits -> (value, length) or escape to
    // linear search for long codes
    uint8_t  lut_val[512];
    uint8_t  lut_len[512];     // 0 => long code
    uint32_t maxcode[17];      // exclusive upper bound of codes per length
    uint32_t valoffset[17];
    uint8_t  values[256];
    int      ok;
};

// bits[1..16]: number of codes per length; values: concatenated HUFFVAL.
// Returns 0 and leaves t->ok = 0 if the table is malformed (more codes
// than fit in a length, or than values provided) — the data is
// file-controlled, so every index must be proven in-bounds here.
static int build_hufftable(HuffTable* t, const uint8_t* bits,
                           const uint8_t* values, int nvalues) {
    memset(t, 0, sizeof(*t));
    int total = 0;
    for (int len = 1; len <= 16; len++) total += bits[len - 1];
    if (total <= 0 || total > 256 || total > nvalues)
        return 0;
    memcpy(t->values, values, (size_t)total);
    uint32_t code = 0;
    int k = 0;
    for (int len = 1; len <= 16; len++) {
        t->valoffset[len] = (uint32_t)(k - (int)code);
        for (int i = 0; i < bits[len - 1]; i++) {
            // canonical codes must fit in `len` bits; a violation would
            // push the primary-LUT index past 512
            if (code >= (1u << len))
                return 0;
            if (len <= 9) {
                // fill primary LUT
                int shift = 9 - len;
                for (int f = 0; f < (1 << shift); f++) {
                    int idx = (int)((code << shift) | f);
                    t->lut_val[idx] = values[k];
                    t->lut_len[idx] = (uint8_t)len;
                }
            }
            code++;
            k++;
        }
        t->maxcode[len] = code;
        code <<= 1;
    }
    t->ok = 1;
    return 1;
}

static inline int huff_decode(BitReader* br, const HuffTable* t) {
    int look = br_peek(br, 9);
    int len = t->lut_len[look];
    if (len) {
        br_skip(br, len);
        return t->lut_val[look];
    }
    // long code: walk lengths 10..16
    uint32_t code = 0;
    br_fill(br);
    for (len = 1; len <= 16; len++) {
        code = (code << 1) | ((br->bitbuf >> (br->bitcnt - len)) & 1);
        if (code < t->maxcode[len]) {
            br_skip(br, len);
            return t->values[(int)(code + t->valoffset[len])];
        }
    }
    return -1; // invalid stream
}

// ---------------------------------------------------------------------------
// JPEG baseline scan decode
// ---------------------------------------------------------------------------
//
// Components are described by parallel arrays (up to 4):
//   comp_h/comp_v: sampling factors; comp_dc/comp_ac: table indices.
// Output: coeffs, int16, one 64-coeff zigzag block after another in MCU
// scan order (the natural entropy order); caller de-zigzags and places
// blocks on device. Returns number of MCUs decoded, or -1 on error.

int jpeg_decode_scan(
    const uint8_t* data, int size,
    int ncomp, const int* comp_h, const int* comp_v,
    const int* comp_dc_tbl, const int* comp_ac_tbl,
    const uint8_t* dc_bits, const uint8_t* dc_vals, const int* dc_nvals,
    const uint8_t* ac_bits, const uint8_t* ac_vals, const int* ac_nvals,
    int mcu_count, int restart_interval,
    int16_t* out_coeffs)
{
    if (ncomp < 1 || ncomp > 4) return -1;
    HuffTable dct[4], act[4];
    for (int i = 0; i < 4; i++) { dct[i].ok = act[i].ok = 0; }
    for (int c = 0; c < ncomp; c++) {
        int d = comp_dc_tbl[c], a = comp_ac_tbl[c];
        // all of these are file-controlled: reject out-of-range table
        // indices / sampling factors before they index the stack arrays
        if (d < 0 || d >= 4 || a < 0 || a >= 4) return -1;
        if (comp_h[c] < 1 || comp_h[c] > 4 ||
            comp_v[c] < 1 || comp_v[c] > 4) return -1;
        if (!dct[d].ok &&
            !build_hufftable(&dct[d], dc_bits + 16 * d, dc_vals + 256 * d,
                             dc_nvals[d]))
            return -1;
        if (!act[a].ok &&
            !build_hufftable(&act[a], ac_bits + 16 * a, ac_vals + 256 * a,
                             ac_nvals[a]))
            return -1;
    }

    BitReader br;
    br_init(&br, data, size);
    int pred[4] = {0, 0, 0, 0};
    int16_t* out = out_coeffs;
    int blocks_per_mcu = 0;
    for (int c = 0; c < ncomp; c++) blocks_per_mcu += comp_h[c] * comp_v[c];

    for (int mcu = 0; mcu < mcu_count; mcu++) {
        if (restart_interval && mcu && mcu % restart_interval == 0) {
            // align to byte, expect RSTn marker in raw stream
            br.bitcnt -= br.bitcnt % 8;
            // find marker: the unstuffed reader stopped feeding at 0xFF;
            // re-sync on raw bytes
            // locate current raw position: conservative rescan
            // (restart markers are rare; do a simple scan forward)
            while (br.pos + 1 < br.size &&
                   !(br.data[br.pos] == 0xFF &&
                     br.data[br.pos + 1] >= 0xD0 &&
                     br.data[br.pos + 1] <= 0xD7))
                br.pos++;
            if (br.pos + 1 < br.size) br.pos += 2;
            br.bitbuf = 0;
            br.bitcnt = 0;
            br.marker_hit = 0;
            pred[0] = pred[1] = pred[2] = pred[3] = 0;
        }
        for (int c = 0; c < ncomp; c++) {
            for (int b = 0; b < comp_h[c] * comp_v[c]; b++) {
                int16_t* blk = out;
                memset(blk, 0, 64 * sizeof(int16_t));
                int s = huff_decode(&br, &dct[comp_dc_tbl[c]]);
                if (s < 0 || s > 15) return -1;  // DC category is 0..15
                int diff = jpeg_extend(br_get(&br, s), s);
                pred[c] += diff;
                blk[0] = (int16_t)pred[c];
                int kk = 1;
                while (kk < 64) {
                    int rs = huff_decode(&br, &act[comp_ac_tbl[c]]);
                    if (rs < 0) return -1;
                    int run = rs >> 4, sz = rs & 15;
                    if (sz == 0) {
                        if (run == 15) { kk += 16; continue; } // ZRL
                        break;                                  // EOB
                    }
                    kk += run;
                    if (kk > 63) return -1;
                    blk[kk] = (int16_t)jpeg_extend(br_get(&br, sz), sz);
                    kk++;
                }
                out += 64;
            }
        }
    }
    return mcu_count;
}

// ---------------------------------------------------------------------------
// JPEG baseline scan encode
// ---------------------------------------------------------------------------

struct BitWriter {
    uint8_t* buf;
    int cap;
    int pos;
    uint64_t acc;
    int nbits;
    int overflow;
};

static inline void bw_put(BitWriter* bw, uint32_t code, int len) {
    bw->acc = (bw->acc << len) | (code & ((1u << len) - 1));
    bw->nbits += len;
    while (bw->nbits >= 8) {
        uint8_t b = (uint8_t)(bw->acc >> (bw->nbits - 8));
        if (bw->pos + 2 > bw->cap) { bw->overflow = 1; return; }
        bw->buf[bw->pos++] = b;
        if (b == 0xFF) bw->buf[bw->pos++] = 0x00; // byte stuffing
        bw->nbits -= 8;
    }
}

static void build_enc_table(const uint8_t* bits, const uint8_t* values,
                            int nvalues, uint16_t* codes, uint8_t* lens) {
    uint32_t code = 0;
    int k = 0;
    for (int len = 1; len <= 16; len++) {
        for (int i = 0; i < bits[len - 1]; i++) {
            codes[values[k]] = (uint16_t)code;
            lens[values[k]] = (uint8_t)len;
            code++;
            k++;
        }
        code <<= 1;
    }
    (void)nvalues;
}

static inline int bitlen(int v) {
    int a = v < 0 ? -v : v;
    int n = 0;
    while (a) { n++; a >>= 1; }
    return n;
}

// coeffs: zigzagged blocks (MCU order), blocks_per_mcu derived from comps.
// Returns bytes written or -1 on overflow/error.
int jpeg_encode_scan(
    const int16_t* coeffs, int mcu_count,
    int ncomp, const int* comp_h, const int* comp_v,
    const int* comp_dc_tbl, const int* comp_ac_tbl,
    const uint8_t* dc_bits, const uint8_t* dc_vals, const int* dc_nvals,
    const uint8_t* ac_bits, const uint8_t* ac_vals, const int* ac_nvals,
    uint8_t* out, int out_cap)
{
    uint16_t dc_codes[4][256], ac_codes[4][256];
    uint8_t dc_lens[4][256], ac_lens[4][256];
    memset(dc_lens, 0, sizeof dc_lens);
    memset(ac_lens, 0, sizeof ac_lens);
    for (int c = 0; c < ncomp; c++) {
        int d = comp_dc_tbl[c], a = comp_ac_tbl[c];
        build_enc_table(dc_bits + 16 * d, dc_vals + 256 * d, dc_nvals[d],
                        dc_codes[d], dc_lens[d]);
        build_enc_table(ac_bits + 16 * a, ac_vals + 256 * a, ac_nvals[a],
                        ac_codes[a], ac_lens[a]);
    }
    BitWriter bw = {out, out_cap, 0, 0, 0, 0};
    int pred[4] = {0, 0, 0, 0};
    const int16_t* blk = coeffs;
    for (int mcu = 0; mcu < mcu_count; mcu++) {
        for (int c = 0; c < ncomp; c++) {
            int d = comp_dc_tbl[c], a = comp_ac_tbl[c];
            for (int b = 0; b < comp_h[c] * comp_v[c]; b++) {
                int diff = blk[0] - pred[c];
                pred[c] = blk[0];
                int n = bitlen(diff);
                bw_put(&bw, dc_codes[d][n], dc_lens[d][n]);
                if (n)
                    bw_put(&bw, diff < 0 ? diff + (1 << n) - 1 : diff, n);
                int run = 0;
                for (int kk = 1; kk < 64; kk++) {
                    int v = blk[kk];
                    if (v == 0) { run++; continue; }
                    while (run >= 16) {
                        bw_put(&bw, ac_codes[a][0xF0], ac_lens[a][0xF0]);
                        run -= 16;
                    }
                    int sz = bitlen(v);
                    int rs = (run << 4) | sz;
                    bw_put(&bw, ac_codes[a][rs], ac_lens[a][rs]);
                    bw_put(&bw, v < 0 ? v + (1 << sz) - 1 : v, sz);
                    run = 0;
                }
                if (run)
                    bw_put(&bw, ac_codes[a][0x00], ac_lens[a][0x00]); // EOB
                blk += 64;
                if (bw.overflow) return -1;
            }
        }
    }
    // flush with 1-padding (JPEG convention)
    if (bw.nbits)
        bw_put(&bw, (1u << (8 - bw.nbits % 8)) - 1, (8 - bw.nbits % 8) % 8);
    if (bw.nbits) { // still unaligned means len 0 was passed; force flush
        bw.acc <<= (8 - bw.nbits);
        if (bw.pos + 2 > bw.cap) return -1;
        uint8_t b = (uint8_t)(bw.acc & 0xFF);
        bw.buf[bw.pos++] = b;
        if (b == 0xFF) bw.buf[bw.pos++] = 0x00;
        bw.nbits = 0;
    }
    return bw.overflow ? -1 : bw.pos;
}

// ---------------------------------------------------------------------------
// PNG row filters (RFC 2083 §6): unfilter in place, filter for encode
// ---------------------------------------------------------------------------

static inline int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = p > a ? p - a : a - p;
    int pb = p > b ? p - b : b - p;
    int pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return a;
    return (pb <= pc) ? b : c;
}

// rows: h rows of (1 filter byte + stride image bytes); out: h*stride
int png_unfilter(const uint8_t* rows, int h, int stride, int bpp,
                 uint8_t* out)
{
    const uint8_t* prev = 0;
    for (int y = 0; y < h; y++) {
        int ft = rows[(size_t)y * (stride + 1)];
        const uint8_t* in = rows + (size_t)y * (stride + 1) + 1;
        uint8_t* o = out + (size_t)y * stride;
        switch (ft) {
        case 0:
            memcpy(o, in, stride);
            break;
        case 1:
            for (int x = 0; x < stride; x++)
                o[x] = (uint8_t)(in[x] + (x >= bpp ? o[x - bpp] : 0));
            break;
        case 2:
            for (int x = 0; x < stride; x++)
                o[x] = (uint8_t)(in[x] + (prev ? prev[x] : 0));
            break;
        case 3:
            for (int x = 0; x < stride; x++) {
                int a = x >= bpp ? o[x - bpp] : 0;
                int b = prev ? prev[x] : 0;
                o[x] = (uint8_t)(in[x] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (int x = 0; x < stride; x++) {
                int a = x >= bpp ? o[x - bpp] : 0;
                int b = prev ? prev[x] : 0;
                int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
                o[x] = (uint8_t)(in[x] + paeth(a, b, c));
            }
            break;
        default:
            return -1;
        }
        prev = o;
    }
    return 0;
}

// filter with per-row heuristic (minimum sum of absolute differences,
// the pngenc "mixed" strategy); writes h*(stride+1) bytes
int png_filter(const uint8_t* img, int h, int stride, int bpp, uint8_t* out)
{
    const uint8_t* prev = 0;
    uint8_t* tmp = new uint8_t[stride * 5];
    for (int y = 0; y < h; y++) {
        const uint8_t* in = img + (size_t)y * stride;
        long best_sum = -1;
        int best_f = 0;
        for (int f = 0; f < 5; f++) {
            uint8_t* t = tmp + f * stride;
            long sum = 0;
            for (int x = 0; x < stride; x++) {
                int a = x >= bpp ? in[x - bpp] : 0;
                int b = prev ? prev[x] : 0;
                int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
                int v;
                switch (f) {
                case 0: v = in[x]; break;
                case 1: v = in[x] - a; break;
                case 2: v = in[x] - b; break;
                case 3: v = in[x] - ((a + b) >> 1); break;
                default: v = in[x] - paeth(a, b, c); break;
                }
                uint8_t u = (uint8_t)v;
                t[x] = u;
                sum += u < 128 ? u : 256 - u;
            }
            if (best_sum < 0 || sum < best_sum) { best_sum = sum; best_f = f; }
        }
        out[(size_t)y * (stride + 1)] = (uint8_t)best_f;
        memcpy(out + (size_t)y * (stride + 1) + 1, tmp + best_f * stride,
               stride);
        prev = in;
    }
    delete[] tmp;
    return 0;
}

} // extern "C"

// ---------------------------------------------------------------------------
// Biquad IIR (direct form II transposed) — serial host DSP for loudness
// metering (the role of the reference's ebur128 filter chain)
// ---------------------------------------------------------------------------

extern "C" int biquad(const double* b, const double* a,
                      const float* x, float* y, long n)
{
    double z1 = 0.0, z2 = 0.0;
    const double b0 = b[0], b1 = b[1], b2 = b[2];
    const double a1 = a[0], a2 = a[1];
    for (long i = 0; i < n; i++) {
        double in = x[i];
        double out = b0 * in + z1;
        z1 = b1 * in - a1 * out + z2;
        z2 = b2 * in - a2 * out;
        y[i] = (float)out;
    }
    return 0;
}
