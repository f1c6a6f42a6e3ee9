"""HEVC intra prediction + inverse transform/dequant (numpy, spec-exact).

ITU-T H.265 §8.4.4.2 (reference sample substitution/filtering, the 35
intra modes with boundary smoothing) and §8.6 (scaling, the integer
DCT-II 4..32 and the 4x4 DST-VII) — the transforms are exact integer
matrix definitions, so spec conformance equals bit-exactness against
the reference decoder (asserted in tests).

Behavioral reference: libavcodec/hevc/pred_template.c,
dsp_template.c (idct butterflies equal the matrix form used here).

A copy of librempeg_tpu/codecs/hevc/recon.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

import functools

import numpy as np

# §8.7.1 Table 8-10: intraPredAngle per mode 2..34
_ANGLE = (32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21,
          -26, -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13,
          17, 21, 26, 32)
# invAngle for modes 11..25 (angle -2..-32 range)
_INV_ANGLE = {-2: -4096, -5: -1638, -9: -910, -13: -630, -17: -482,
              -21: -390, -26: -315, -32: -256}

LEVEL_SCALE = (40, 45, 51, 57, 64, 72)         # §8.6.3


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """HEVC integer DCT-II [n, n]: every (32/n)-th row, first n
    columns of the normative 32-point matrix (§8.6.4.2 construction;
    the entries are NOT a pure cosine rounding — extracted data)."""
    from librempeg_tpu_torch.codecs.hevc.tables import T32

    t = np.array(T32, np.int64)
    return t[:: 32 // n, :n]


# DST-VII 4x4 (§8.6.4.1)
_DST4 = np.array([
    [29, 55, 74, 84],
    [74, 74, 0, -74],
    [84, -29, -74, 55],
    [55, -84, 74, -29]], np.int64)


def inverse_transform(coeffs: np.ndarray, use_dst: bool) -> np.ndarray:
    """§8.6.4: two-pass integer inverse transform of an [n, n] block
    of dequantized coefficients -> residual (int, bd 8)."""
    n = coeffs.shape[0]
    m = _DST4 if use_dst else dct_matrix(n)
    # first (vertical) pass: e[x][y] = sum_k M[k][x]? -- spec applies
    # the transpose: out = clip16((M^T @ coeffs + 64) >> 7) columnwise
    t = (m.T @ coeffs.astype(np.int64) + 64) >> 7
    t = np.clip(t, -32768, 32767)
    r = (t @ m + (1 << 11)) >> 12
    return np.clip(r, -32768, 32767).astype(np.int32)


def dequant(levels: np.ndarray, qp: int, log2: int) -> np.ndarray:
    """§8.6.3 scaling (flat 16 matrix, 8-bit)."""
    bd_shift = 8 + log2 - 5
    m = 16
    scale = LEVEL_SCALE[qp % 6] << (qp // 6)
    d = (levels.astype(np.int64) * m * scale
         + (1 << (bd_shift - 1))) >> bd_shift
    return np.clip(d, -32768, 32767)


def chroma_qp(qp_y: int, offset: int) -> int:
    """§8.6.1 chroma QP mapping (4:2:0 qPi -> Qp'c table)."""
    qpi = max(-12, min(57, qp_y + offset))
    if qpi < 30:
        return max(0, qpi)
    tab = {30: 29, 31: 30, 32: 31, 33: 32, 34: 33, 35: 33, 36: 34,
           37: 34, 38: 35, 39: 35, 40: 36, 41: 36, 42: 37, 43: 37}
    if qpi <= 43:
        return tab[qpi]
    return qpi - 6


# §8.5.3.3.3 fractional-sample interpolation (dsp.c:105/:94 tables,
# identical to spec Tables 8-11/8-12)
_QPEL = {1: (-1, 4, -10, 58, 17, -5, 1, 0),
         2: (-1, 4, -11, 40, 40, -11, 4, -1),
         3: (0, 1, -5, 17, 58, -10, 4, -1)}
_EPEL = {1: (-2, 58, 10, -2), 2: (-4, 54, 16, -2), 3: (-6, 46, 28, -4),
         4: (-4, 36, 36, -4), 5: (-4, 28, 46, -6), 6: (-2, 16, 54, -4),
         7: (-2, 10, 58, -2)}


def _gather(ref: np.ndarray, ys: np.ndarray, xs: np.ndarray):
    """Edge-replicated block fetch (out-of-picture MVs clamp per
    §8.5.3.3.2 Clip3 on the integer sample position)."""
    hh, ww = ref.shape
    ys = np.clip(ys, 0, hh - 1)
    xs = np.clip(xs, 0, ww - 1)
    return ref[ys[:, None], xs[None, :]].astype(np.int64)


def mc_luma_int(ref: np.ndarray, x0: int, y0: int, w: int, h: int,
                mvx: int, mvy: int) -> np.ndarray:
    """Luma MC intermediate at 14-bit scale (the pre-rounding value of
    §8.5.3.3.3; 8-tap DCTIF both passes).  Uni-prediction rounds it
    with (p + 32) >> 6, bi-prediction averages two of these with
    (p0 + p1 + 64) >> 7 (§8.5.3.3.4.2/3)."""
    ix, iy = mvx >> 2, mvy >> 2
    fx, fy = mvx & 3, mvy & 3
    ys = np.arange(y0 + iy - 3, y0 + iy + h + 4)
    xs = np.arange(x0 + ix - 3, x0 + ix + w + 4)
    blk = _gather(ref, ys, xs)                  # (h+7, w+7)
    if fx and fy:
        ch_, cv = _QPEL[fx], _QPEL[fy]
        t = sum(ch_[k] * blk[:, k:k + w] for k in range(8))
        p = sum(cv[k] * t[k:k + h, :] for k in range(8)) >> 6
    elif fx:
        c = _QPEL[fx]
        p = sum(c[k] * blk[3:3 + h, k:k + w] for k in range(8))
    elif fy:
        c = _QPEL[fy]
        p = sum(c[k] * blk[k:k + h, 3:3 + w] for k in range(8))
    else:
        p = blk[3:3 + h, 3:3 + w] << 6
    return p


def mc_luma(ref: np.ndarray, x0: int, y0: int, w: int, h: int,
            mvx: int, mvy: int) -> np.ndarray:
    """Uni-directional luma MC, quarter-pel MV -> uint8 block."""
    p = mc_luma_int(ref, x0, y0, w, h, mvx, mvy)
    return np.clip((p + 32) >> 6, 0, 255).astype(np.uint8)


def bi_avg(p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    """Default weighted bi-prediction of two 14-bit intermediates
    (§8.5.3.3.4.3, 8-bit: shift 7, offset 64)."""
    return np.clip((p0 + p1 + 64) >> 7, 0, 255).astype(np.uint8)


def mc_chroma_int(ref: np.ndarray, cx0: int, cy0: int, w: int, h: int,
                  mvx: int, mvy: int) -> np.ndarray:
    """Chroma MC 14-bit intermediate (4-tap filters, eighth-pel);
    cx0/cy0/w/h in chroma samples, MV in luma quarter-pel units."""
    ix, iy = mvx >> 3, mvy >> 3
    fx, fy = mvx & 7, mvy & 7
    ys = np.arange(cy0 + iy - 1, cy0 + iy + h + 2)
    xs = np.arange(cx0 + ix - 1, cx0 + ix + w + 2)
    blk = _gather(ref, ys, xs)                  # (h+3, w+3)
    if fx and fy:
        ch_, cv = _EPEL[fx], _EPEL[fy]
        t = sum(ch_[k] * blk[:, k:k + w] for k in range(4))
        p = sum(cv[k] * t[k:k + h, :] for k in range(4)) >> 6
    elif fx:
        c = _EPEL[fx]
        p = sum(c[k] * blk[1:1 + h, k:k + w] for k in range(4))
    elif fy:
        c = _EPEL[fy]
        p = sum(c[k] * blk[k:k + h, 1:1 + w] for k in range(4))
    else:
        p = blk[1:1 + h, 1:1 + w] << 6
    return p


def mc_chroma(ref: np.ndarray, cx0: int, cy0: int, w: int, h: int,
              mvx: int, mvy: int) -> np.ndarray:
    """Uni-directional chroma MC -> uint8 block."""
    p = mc_chroma_int(ref, cx0, cy0, w, h, mvx, mvy)
    return np.clip((p + 32) >> 6, 0, 255).astype(np.uint8)


class IntraPred:
    """Reference-sample machinery over the growing recon plane."""

    def __init__(self, plane: np.ndarray, strong_smoothing: bool):
        self.p = plane
        self.strong = strong_smoothing

    def _refs(self, x0, y0, size, avail_map):
        """Reference arrays left[2n], corner, top[2n] with §8.4.4.2.2
        substitution. avail_map(x, y) -> sample available?"""
        n = size
        p = self.p
        h, w = p.shape
        # gather raw candidates (None = unavailable)
        left = [None] * (2 * n)
        top = [None] * (2 * n)
        corner = None
        for i in range(2 * n):
            yy = y0 + i
            if x0 > 0 and yy < h and avail_map(x0 - 1, yy):
                left[i] = int(p[yy, x0 - 1])
            xx = x0 + i
            if y0 > 0 and xx < w and avail_map(xx, y0 - 1):
                top[i] = int(p[y0 - 1, xx])
        if x0 > 0 and y0 > 0 and avail_map(x0 - 1, y0 - 1):
            corner = int(p[y0 - 1, x0 - 1])
        # substitution (§8.4.4.2.2): search order bottom-left -> corner
        # -> top-right; if nothing available use 128
        seq = left[::-1] + [corner] + top
        if all(v is None for v in seq):
            seq = [128] * len(seq)
        else:
            # first available becomes the seed for leading gaps
            first = next(v for v in seq if v is not None)
            prev = first
            for i, v in enumerate(seq):
                if v is None:
                    seq[i] = prev
                else:
                    prev = v
        left = seq[:2 * n][::-1]
        corner = seq[2 * n]
        top = seq[2 * n + 1:]
        return (np.array(left, np.int32), corner,
                np.array(top, np.int32))

    def predict(self, x0, y0, size, mode, cidx, avail_map):
        left, corner, top = self._refs(x0, y0, size, avail_map)
        n = size
        # filtering (§8.4.4.2.3): luma only, size/mode dependent
        if cidx == 0 and n > 4:
            if mode == 0:
                filt = True
            elif mode == 1:
                filt = False
            else:
                dist = min(abs(mode - 26), abs(mode - 10))
                filt = (n == 8 and dist > 7) or \
                    (n == 16 and dist > 1) or (n == 32 and dist > 0)
            if filt:
                fl = left.copy()
                ft = top.copy()
                fc = (left[0] + 2 * corner + top[0] + 2) >> 2
                fl[0] = (corner + 2 * left[0] + left[1] + 2) >> 2
                fl[1:-1] = (left[:-2] + 2 * left[1:-1] + left[2:]
                            + 2) >> 2
                fl[-1] = left[-1]
                ft[0] = (corner + 2 * top[0] + top[1] + 2) >> 2
                ft[1:-1] = (top[:-2] + 2 * top[1:-1] + top[2:] + 2) >> 2
                ft[-1] = top[-1]
                left, corner, top = fl, fc, ft
        out = np.zeros((n, n), np.int32)
        if mode == 0:                           # planar (§8.4.4.2.4)
            x = np.arange(n)[None, :]
            y = np.arange(n)[:, None]
            out = ((n - 1 - x) * left[:n][:, None]
                   + (x + 1) * top[n]
                   + (n - 1 - y) * top[:n][None, :]
                   + (y + 1) * left[n]
                   + n) >> (int(np.log2(n)) + 1)
        elif mode == 1:                         # DC (§8.4.4.2.5)
            dc = (int(left[:n].sum()) + int(top[:n].sum()) + n) >> \
                (int(np.log2(n)) + 1)
            out[:] = dc
            if cidx == 0 and n < 32:
                out[0, 0] = (left[0] + 2 * dc + top[0] + 2) >> 2
                out[0, 1:] = (top[1:n] + 3 * dc + 2) >> 2
                out[1:, 0] = (left[1:n] + 3 * dc + 2) >> 2
        else:                                   # angular (§8.4.4.2.6)
            ang = _ANGLE[mode - 2]
            if mode >= 18:                      # vertical family
                ref = np.zeros(4 * n + 2, np.int32)
                ref[n:3 * n + 1] = np.concatenate(([corner],
                                                   top[:2 * n]))
                if ang < 0:
                    inv = _INV_ANGLE[ang]
                    lo = (n * ang) >> 5
                    for xx in range(-1, lo - 1, -1):
                        li = min(2 * n - 1,
                                 ((xx * inv + 128) >> 8) - 1)
                        ref[n + xx] = left[li] if li >= 0 else corner
                base = n                        # index of ref[0]
                y = np.arange(n)[:, None]
                x = np.arange(n)[None, :]
                pos = ((y + 1) * ang)
                ii = pos >> 5
                ff = pos & 31
                idx = base + 1 + x + ii
                a = ref[idx]
                b = ref[idx + 1]
                out = ((32 - ff) * a + ff * b + 16) >> 5
                if mode == 26 and cidx == 0 and n < 32:
                    col = top[0] + ((left[:n] - corner) >> 1)
                    out[:, 0] = np.clip(col, 0, 255)
            else:                               # horizontal family
                ref = np.zeros(4 * n + 2, np.int32)
                ref[n:3 * n + 1] = np.concatenate(([corner],
                                                   left[:2 * n]))
                if ang < 0:
                    inv = _INV_ANGLE[ang]
                    lo = (n * ang) >> 5
                    for xx in range(-1, lo - 1, -1):
                        ti = min(2 * n - 1,
                                 ((xx * inv + 128) >> 8) - 1)
                        ref[n + xx] = top[ti] if ti >= 0 else corner
                base = n
                y = np.arange(n)[:, None]
                x = np.arange(n)[None, :]
                pos = ((x + 1) * ang)
                ii = pos >> 5
                ff = pos & 31
                idx = base + 1 + y + ii
                a = ref[idx]
                b = ref[idx + 1]
                out = ((32 - ff) * a + ff * b + 16) >> 5
                if mode == 10 and cidx == 0 and n < 32:
                    row = left[0] + ((top[:n] - corner) >> 1)
                    out[0, :] = np.clip(row, 0, 255)
        return np.clip(out, 0, 255)
