"""H.264 frame reconstruction from per-MB entropy tensors.

The C++ layer (native/h264.cpp) walks the bitstream and emits flat
per-MB arrays; this module does the pixel math, array-at-a-time:
batched dequant + inverse transforms over every block in the frame,
quarter-pel inter prediction via frame-level half-pel planes (three
separable 6-tap FIR passes + per-fraction pairwise averaging — the
TPU-shaped formulation of §8.4.2.2), and the serial intra assembly
(the one neighbor-dependent pass, per 4x4 in spec scan order).

Spec: ISO/IEC 14496-10 §8.3 (intra), §8.4.2.2 (fractional MC),
§8.5 (transform/dequant). Behavioral reference:
libavcodec/h264pred_template.c, h264qpel_template.c,
h264_mb.c. Integer math mirrors codecs/h264/intra.py (bit-exact vs the
reference decoder in round-1 tests).
"""
from __future__ import annotations

import numpy as np

from librempeg_tpu_torch.codecs.h264 import intra as I
from librempeg_tpu_torch.codecs.h264.cavlc import ZIGZAG4
from librempeg_tpu_torch.core.errors import InvalidData

_IZZ = np.argsort(ZIGZAG4)          # out[j] = zz[_IZZ[j]] dezigzag gather
_POS = I._POS
_V = np.asarray(I._V, np.int64)     # [6][3]

# chroma QP mapping (Table 8-15, 8-bit)
CHROMA_QP = np.array(
    list(range(30)) + [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36,
                       37, 37, 37, 38, 38, 38, 39, 39, 39, 39], np.int32)


def qpc_of(qp, off: int):
    return CHROMA_QP[np.clip(qp + off, 0, 51)]


# ---------------------------------------------------------------------------
# batched integer transforms / dequant
# ---------------------------------------------------------------------------

def inv4_batch(w: np.ndarray) -> np.ndarray:
    """Inverse 4x4 core transform over [..., 4, 4] (§8.5.12.2). int32 is
    exact: dequantized levels are < 2^25 and the butterflies add 4 terms."""
    d = w.astype(np.int32)
    e0 = d[..., :, 0] + d[..., :, 2]
    e1 = d[..., :, 0] - d[..., :, 2]
    e2 = (d[..., :, 1] >> 1) - d[..., :, 3]
    e3 = d[..., :, 1] + (d[..., :, 3] >> 1)
    h = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-1)
    e0 = h[..., 0, :] + h[..., 2, :]
    e1 = h[..., 0, :] - h[..., 2, :]
    e2 = (h[..., 1, :] >> 1) - h[..., 3, :]
    e3 = h[..., 1, :] + (h[..., 3, :] >> 1)
    v = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-2)
    return (v + 32) >> 6


def dequant4_batch(lev: np.ndarray, qp: np.ndarray) -> np.ndarray:
    """lev [..., 4, 4] int, qp broadcastable [...] -> int32 (exact:
    |level| <= 2047, V <= 29, shift <= 8 -> < 2^25)."""
    qp = np.asarray(qp, np.int32)
    v = _V[qp % 6][..., _POS].astype(np.int32)     # [..., 4, 4]
    return (lev.astype(np.int32) * v) << (qp[..., None, None] // 6)


def luma_dc_dequant_batch(f: np.ndarray, qp: np.ndarray) -> np.ndarray:
    """f [..., 4, 4] (already inverse-Hadamard'd), qp [...] -> int64."""
    qp = np.asarray(qp, np.int64)[..., None, None]
    v = _V[(qp % 6)[..., 0, 0]][..., 0][..., None, None]
    hi = (f * v) << np.maximum(qp // 6 - 2, 0)
    lo_shift = np.maximum(2 - qp // 6, 0)
    lo = (f * v + (np.int64(1) << np.maximum(1 - qp // 6, 0))) >> lo_shift
    return np.where(qp >= 12, hi, lo)


def chroma_dc_dequant_batch(f: np.ndarray, qp: np.ndarray) -> np.ndarray:
    qp = np.asarray(qp, np.int64)[..., None, None]
    v = _V[(qp % 6)[..., 0, 0]][..., 0][..., None, None]
    return ((f * v) << (qp // 6)) >> 1


def dezigzag(blocks: np.ndarray) -> np.ndarray:
    """[..., 16] zigzag-order -> [..., 4, 4] raster."""
    return blocks[..., _IZZ].reshape(blocks.shape[:-1] + (4, 4))


# ---------------------------------------------------------------------------
# quarter-pel luma + eighth-pel chroma prediction (§8.4.2.2)
# ---------------------------------------------------------------------------

PAD = 32            # luma edge padding (== spec coordinate clipping for
                    # excursions up to PAD-3; our encoders bound MVs well
                    # inside this)


def _hfir6(e: np.ndarray) -> np.ndarray:
    """Unscaled 6-tap [1,-5,20,20,-5,1] between x and x+1 columns."""
    r = np.zeros_like(e)
    r[:, 2:-3] = (e[:, 0:-5] - 5 * e[:, 1:-4] + 20 * e[:, 2:-3]
                  + 20 * e[:, 3:-2] - 5 * e[:, 4:-1] + e[:, 5:])
    return r


def _vfir6(e: np.ndarray) -> np.ndarray:
    r = np.zeros_like(e)
    r[2:-3, :] = (e[0:-5, :] - 5 * e[1:-4, :] + 20 * e[2:-3, :]
                  + 20 * e[3:-2, :] - 5 * e[4:-1, :] + e[5:, :])
    return r


def qpel_planes(ref_y: np.ndarray) -> tuple:
    """Half-pel planes of a reference luma plane: (E, b, h, j), each
    padded by PAD with edge replication. Native FIR when available
    (the three 6-tap passes are the host decode hot spot)."""
    e = np.pad(np.asarray(ref_y, np.uint8), PAD, mode="edge")
    try:
        from librempeg_tpu_torch.native import build as native

        if native.available():
            b, h, j = native.h264_qpel_planes(e)
            return e, b, h, j
    except ImportError:
        pass
    ei = e.astype(np.int32)
    b1 = _hfir6(ei)
    b = np.clip((b1 + 16) >> 5, 0, 255)
    h1 = _vfir6(ei)
    h = np.clip((h1 + 16) >> 5, 0, 255)
    j1 = _vfir6(b1)
    j = np.clip((j1 + 512) >> 10, 0, 255)
    return e, b, h, j


# (fx, fy) -> (plane1, (dy1,dx1), plane2, (dy2,dx2)); planes 0=E 1=b 2=h 3=j
_QPEL_MAP = {
    (0, 0): (0, (0, 0), 0, (0, 0)),
    (1, 0): (0, (0, 0), 1, (0, 0)),
    (2, 0): (1, (0, 0), 1, (0, 0)),
    (3, 0): (1, (0, 0), 0, (0, 1)),
    (0, 1): (0, (0, 0), 2, (0, 0)),
    (1, 1): (1, (0, 0), 2, (0, 0)),
    (2, 1): (1, (0, 0), 3, (0, 0)),
    (3, 1): (1, (0, 0), 2, (0, 1)),
    (0, 2): (2, (0, 0), 2, (0, 0)),
    (1, 2): (2, (0, 0), 3, (0, 0)),
    (2, 2): (3, (0, 0), 3, (0, 0)),
    (3, 2): (3, (0, 0), 2, (0, 1)),
    (0, 3): (2, (0, 0), 0, (1, 0)),
    (1, 3): (2, (0, 0), 1, (1, 0)),
    (2, 3): (3, (0, 0), 1, (1, 0)),
    (3, 3): (2, (0, 1), 1, (1, 0)),
}


def mc_luma_blocks(planes: tuple, ys: np.ndarray, xs: np.ndarray,
                   mvx: np.ndarray, mvy: np.ndarray) -> np.ndarray:
    """Predict [n, 4, 4] luma blocks at integer frame coords (ys, xs)
    with qpel mvs (all arrays [n])."""
    n = len(ys)
    out = np.zeros((n, 4, 4), np.int64)
    ix = xs + (mvx >> 2)
    iy = ys + (mvy >> 2)
    fx = mvx & 3
    fy = mvy & 3
    hmax = planes[0].shape[0] - 8
    wmax = planes[0].shape[1] - 8
    ixc = np.clip(ix + PAD, 3, wmax)
    iyc = np.clip(iy + PAD, 3, hmax)
    key = fx * 4 + fy
    r4 = np.arange(4)
    for k in range(16):
        sel = np.nonzero(key == k)[0]
        if sel.size == 0:
            continue
        p1i, (d1y, d1x), p2i, (d2y, d2x) = _QPEL_MAP[(k // 4, k % 4)]
        p1, p2 = planes[p1i], planes[p2i]
        by = iyc[sel][:, None, None] + r4[None, :, None]
        bx = ixc[sel][:, None, None] + r4[None, None, :]
        a = p1[by + d1y, bx + d1x].astype(np.int64)
        bb = p2[by + d2y, bx + d2x].astype(np.int64)
        out[sel] = (a + bb + 1) >> 1
    return out


def mc_luma_block(planes: tuple, y: int, x: int, mvx: int, mvy: int,
                  bh: int = 16, bw: int = 16) -> np.ndarray:
    """Predict one bh x bw luma block (encoder-side helper)."""
    ix = x + (mvx >> 2)
    iy = y + (mvy >> 2)
    p1i, (d1y, d1x), p2i, (d2y, d2x) = _QPEL_MAP[(mvx & 3, mvy & 3)]
    iyc = int(np.clip(iy + PAD, 3, planes[0].shape[0] - bh - 4))
    ixc = int(np.clip(ix + PAD, 3, planes[0].shape[1] - bw - 4))
    a = planes[p1i][iyc + d1y:iyc + d1y + bh,
                    ixc + d1x:ixc + d1x + bw].astype(np.int64)
    b = planes[p2i][iyc + d2y:iyc + d2y + bh,
                    ixc + d2x:ixc + d2x + bw].astype(np.int64)
    return (a + b + 1) >> 1


def mc_chroma_block(cpad: np.ndarray, y: int, x: int, mvx: int, mvy: int,
                    bh: int = 8, bw: int = 8) -> np.ndarray:
    """Predict one bh x bw chroma block at chroma coords (encoder-side)."""
    ix = x + (mvx >> 3)
    iy = y + (mvy >> 3)
    dx, dy = mvx & 7, mvy & 7
    iyc = int(np.clip(iy + PADC, 0, cpad.shape[0] - bh - 2))
    ixc = int(np.clip(ix + PADC, 0, cpad.shape[1] - bw - 2))
    a = cpad[iyc:iyc + bh, ixc:ixc + bw].astype(np.int64)
    b = cpad[iyc:iyc + bh, ixc + 1:ixc + 1 + bw].astype(np.int64)
    c = cpad[iyc + 1:iyc + 1 + bh, ixc:ixc + bw].astype(np.int64)
    d = cpad[iyc + 1:iyc + 1 + bh, ixc + 1:ixc + 1 + bw].astype(np.int64)
    return ((8 - dx) * (8 - dy) * a + dx * (8 - dy) * b
            + (8 - dx) * dy * c + dx * dy * d + 32) >> 6


PADC = PAD // 2


def pad_chroma(ref_c: np.ndarray) -> np.ndarray:
    return np.pad(ref_c.astype(np.int32), PADC, mode="edge")


def mc_chroma_blocks(cpad: np.ndarray, ys: np.ndarray, xs: np.ndarray,
                     mvx: np.ndarray, mvy: np.ndarray) -> np.ndarray:
    """Predict [n, 2, 2] chroma blocks at chroma coords (ys, xs) with
    luma qpel mvs (eighth-pel in chroma units, §8.4.2.2.2)."""
    ix = xs + (mvx >> 3)
    iy = ys + (mvy >> 3)
    dx = (mvx & 7).astype(np.int64)[:, None, None]
    dy = (mvy & 7).astype(np.int64)[:, None, None]
    hmax = cpad.shape[0] - 4
    wmax = cpad.shape[1] - 4
    ixc = np.clip(ix + PADC, 0, wmax)
    iyc = np.clip(iy + PADC, 0, hmax)
    r2 = np.arange(2)
    by = iyc[:, None, None] + r2[None, :, None]
    bx = ixc[:, None, None] + r2[None, None, :]
    a = cpad[by, bx].astype(np.int64)
    b = cpad[by, bx + 1].astype(np.int64)
    c = cpad[by + 1, bx].astype(np.int64)
    d = cpad[by + 1, bx + 1].astype(np.int64)
    return ((8 - dx) * (8 - dy) * a + dx * (8 - dy) * b
            + (8 - dx) * dy * c + dx * dy * d + 32) >> 6


# ---------------------------------------------------------------------------
# Intra_4x4 prediction (§8.3.1.2; cf. h264pred_template.c pred4x4_*)
# ---------------------------------------------------------------------------

# decode-order index of each raster 4x4 position within an MB
_ORD4 = np.zeros(16, np.int32)
for _o, (_by, _bx) in enumerate(I._BLK4):
    _ORD4[_by * 4 + _bx] = _o


def _order(gy: int, gx: int, mb_w: int) -> int:
    return ((gy // 4) * mb_w + (gx // 4)) * 16 + _ORD4[(gy % 4) * 4 + gx % 4]


def pred4x4(rec: np.ndarray, gy: int, gx: int, mode: int,
            mb_w: int) -> np.ndarray:
    """Predict one 4x4 at block coords (gy, gx) on the 4x4 grid from the
    (pre-deblock) recon plane. Returns [4,4] int64."""
    y0, x0 = gy * 4, gx * 4
    h4 = rec.shape[0] // 4
    w4 = rec.shape[1] // 4
    avail_t = gy > 0
    avail_l = gx > 0
    avail_tl = avail_t and avail_l
    # top-right: in frame AND decoded before this block in scan order
    avail_tr = (gy > 0 and gx + 1 < w4
                and _order(gy - 1, gx + 1, mb_w) < _order(gy, gx, mb_w))
    del h4
    t = rec[y0 - 1, x0:x0 + 4].astype(np.int64) if avail_t else None
    left = rec[y0:y0 + 4, x0 - 1].astype(np.int64) if avail_l else None
    lt = int(rec[y0 - 1, x0 - 1]) if avail_tl else 0
    if avail_tr:
        tr = rec[y0 - 1, x0 + 4:x0 + 8].astype(np.int64)
    elif avail_t:
        tr = np.full(4, t[3], np.int64)       # replicate t3 (§8.3.1.2)
    else:
        tr = None

    p = np.zeros((4, 4), np.int64)
    if mode == 0:                              # vertical
        if t is None:
            raise InvalidData("i4x4 V without top")
        p[:] = t[None, :]
    elif mode == 1:                            # horizontal
        if left is None:
            raise InvalidData("i4x4 H without left")
        p[:] = left[:, None]
    elif mode == 2:                            # DC
        if t is not None and left is not None:
            p[:] = (int(t.sum() + left.sum()) + 4) >> 3
        elif t is not None:
            p[:] = (int(t.sum()) + 2) >> 2
        elif left is not None:
            p[:] = (int(left.sum()) + 2) >> 2
        else:
            p[:] = 128
    elif mode == 3:                            # diagonal down-left
        tt = np.concatenate([t, tr])
        for y in range(4):
            for x in range(4):
                if x == 3 and y == 3:
                    p[y, x] = (tt[6] + 3 * tt[7] + 2) >> 2
                else:
                    p[y, x] = (tt[x + y] + 2 * tt[x + y + 1]
                               + tt[x + y + 2] + 2) >> 2
    elif mode == 4:                            # diagonal down-right
        for y in range(4):
            for x in range(4):
                if x > y:
                    p[y, x] = (t[x - y - 2] + 2 * t[x - y - 1]
                               + t[x - y] + 2) >> 2 if x - y >= 2 else \
                        (lt + 2 * t[0] + t[1] + 2) >> 2
                elif x < y:
                    p[y, x] = (left[y - x] + 2 * left[y - x - 1]
                               + (left[y - x - 2] if y - x >= 2 else lt)
                               + 2) >> 2
                else:
                    p[y, x] = (t[0] + 2 * lt + left[0] + 2) >> 2
    elif mode == 5:                            # vertical-right
        for y in range(4):
            for x in range(4):
                z = 2 * x - y
                if z >= 0 and z % 2 == 0:
                    i = x - (y >> 1)
                    a = t[i - 1] if i >= 1 else lt
                    b = t[i]
                    p[y, x] = (a + b + 1) >> 1
                elif z >= 0:
                    i = x - (y >> 1)
                    a = t[i - 2] if i >= 2 else (lt if i == 1 else left[0])
                    b = t[i - 1] if i >= 1 else lt
                    c = t[i]
                    p[y, x] = (a + 2 * b + c + 2) >> 2
                elif z == -1:
                    p[y, x] = (left[0] + 2 * lt + t[0] + 2) >> 2
                else:
                    p[y, x] = (left[y - 1] + 2 * left[y - 2]
                               + (left[y - 3] if y - 3 >= 0 else lt)
                               + 2) >> 2
    elif mode == 6:                            # horizontal-down
        for y in range(4):
            for x in range(4):
                z = 2 * y - x
                if z >= 0 and z % 2 == 0:
                    i = y - (x >> 1)
                    a = left[i - 1] if i >= 1 else lt
                    p[y, x] = (a + left[i] + 1) >> 1
                elif z >= 0:
                    i = y - (x >> 1)
                    a = left[i - 2] if i >= 2 else (lt if i == 1 else t[0])
                    b = left[i - 1] if i >= 1 else lt
                    p[y, x] = (a + 2 * b + left[i] + 2) >> 2
                elif z == -1:
                    p[y, x] = (t[0] + 2 * lt + left[0] + 2) >> 2
                else:
                    p[y, x] = (t[x - 1] + 2 * t[x - 2]
                               + (t[x - 3] if x - 3 >= 0 else lt) + 2) >> 2
    elif mode == 7:                            # vertical-left
        tt = np.concatenate([t, tr])
        for y in range(4):
            for x in range(4):
                i = x + (y >> 1)
                if y % 2 == 0:
                    p[y, x] = (tt[i] + tt[i + 1] + 1) >> 1
                else:
                    p[y, x] = (tt[i] + 2 * tt[i + 1] + tt[i + 2] + 2) >> 2
    elif mode == 8:                            # horizontal-up
        for y in range(4):
            for x in range(4):
                z = x + 2 * y
                if z > 5:
                    p[y, x] = left[3]
                elif z == 5:
                    p[y, x] = (left[2] + 3 * left[3] + 2) >> 2
                elif z % 2 == 0:
                    i = y + (x >> 1)
                    p[y, x] = (left[i] + left[i + 1] + 1) >> 1
                else:
                    i = y + (x >> 1)
                    p[y, x] = (left[i] + 2 * left[i + 1]
                               + left[i + 2] + 2) >> 2
    else:
        raise InvalidData(f"i4x4 mode {mode}")
    return p


# ---------------------------------------------------------------------------
# frame reconstruction
# ---------------------------------------------------------------------------

class RefPack:
    """Padded MC planes for one reference frame (full-pel + the three
    half-pel FIR planes, §8.4.2.2.1; edge-padded chroma). Built once per
    DPB entry and reused by every frame that references it."""

    __slots__ = ("E", "B", "Hm", "J", "U", "V")

    def __init__(self, y, u, v):
        e, b, h, j = qpel_planes(np.asarray(y))
        self.E, self.B, self.Hm, self.J = e, b, h, j
        self.U = np.pad(np.asarray(u, np.uint8), PADC, mode="edge")
        self.V = np.pad(np.asarray(v, np.uint8), PADC, mode="edge")


def reconstruct_frame_native(res: dict, mb_w: int, mb_h: int,
                             chroma_qp_off: int, ref_packs: list,
                             ref_packs_l1: list | None = None,
                             qmul4=None, qmul8=None, cqp_off2=None,
                             weights=None, impw=None,
                             slice_id=None) -> tuple:
    """Host fast path: the whole reconstruction in one native call
    (dequant + IDCT + inter MC + intra assembly). Bit-identical to the
    array path below (asserted in tests/test_h264_inter.py).
    ref_packs_l1 carries the B-slice list-1 references (None for P).
    High-profile extras: scaling-matrix dequant tables (qmul4/qmul8),
    the Cr-plane qp offset, explicit/implicit prediction weights."""
    from librempeg_tpu_torch.native import build as native

    W, H = mb_w * 16, mb_h * 16
    kind = res["kind"]
    if np.any(kind > 5):
        raise InvalidData("h264: unsupported mb kind")
    if not ref_packs and np.any((kind == 0) | (kind == 1)):
        raise InvalidData("h264: P slice without reference frame")
    y = np.zeros((H, W), np.uint8)
    u = np.zeros((H // 2, W // 2), np.uint8)
    v = np.zeros((H // 2, W // 2), np.uint8)
    native.h264_recon_frame(y, u, v, res, mb_w, mb_h, chroma_qp_off,
                            ref_packs, ref_packs_l1,
                            qmul4=qmul4, qmul8=qmul8, cqp_off2=cqp_off2,
                            weights=weights, impw=impw,
                            slice_id=res.get("slice_id"))
    return y, u, v


def _copy_ipcm(res: dict, y, u, v, mb_w: int) -> None:
    """I_PCM macroblocks carry raw samples through the coeffs rows
    (384 bytes: 256 luma raster + 8x8 U + 8x8 V); overwrite the recon
    pixels directly (§8.3.5)."""
    for m in np.flatnonzero(res["kind"] == 4):
        my, mx = divmod(int(m), mb_w)
        raw = res["coeffs"][m].reshape(-1)[:384].astype(np.uint8)
        y[my * 16:my * 16 + 16, mx * 16:mx * 16 + 16] = \
            raw[:256].reshape(16, 16)
        u[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = \
            raw[256:320].reshape(8, 8)
        v[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = \
            raw[320:384].reshape(8, 8)


def reconstruct_frame(res: dict, mb_w: int, mb_h: int,
                      chroma_qp_off: int,
                      ref_list: list) -> tuple:
    """res = arrays from native h264_decode_slice_cavlc (possibly merged
    over several slices); ref_list = [(y,u,v) uint8 planes] in L0 order.
    Returns (y, u, v) uint8 pre-deblock reconstruction."""
    nmb = mb_w * mb_h
    W, H = mb_w * 16, mb_h * 16
    kind = res["kind"]
    info = res["info"]
    qp = res["qp"].astype(np.int64)
    coeffs = res["coeffs"]
    qpc = qpc_of(qp, chroma_qp_off).astype(np.int64)

    # ---- batched residuals ----
    luma_blk = dezigzag(coeffs[:, 1:17, :])            # [nMB,16,4,4] raster
    is_i16 = kind == 3
    # AC dequant for every block (per-MB qp)
    luma_deq = dequant4_batch(luma_blk, qp[:, None])
    if np.any(is_i16):
        sel = np.nonzero(is_i16)[0]
        dc = dezigzag(coeffs[sel, 0, :])               # [k,4,4]
        fdc = I._H4 @ dc.astype(np.int64) @ I._H4
        dcd = luma_dc_dequant_batch(fdc, qp[sel])      # [k,4,4]
        # scatter DC into block position (0,0): block (by,bx) index by*4+bx
        ld = luma_deq[sel].reshape(len(sel), 4, 4, 4, 4)
        ld[:, :, :, 0, 0] = dcd
        luma_deq[sel] = ld.reshape(len(sel), 16, 4, 4)
    luma_res = inv4_batch(luma_deq)                    # [nMB,16,4,4]

    cdc = dezigzag_chroma_dc(coeffs[:, 17:19, :])      # [nMB,2,2,2]
    fcdc = I._H2 @ cdc.astype(np.int64) @ I._H2
    cdcd = chroma_dc_dequant_batch(
        fcdc.reshape(nmb * 2, 2, 2), np.repeat(qpc, 2)).reshape(nmb, 2, 2, 2)
    cac = dezigzag(coeffs[:, 19:27, :]).reshape(nmb, 2, 2, 2, 4, 4)
    cdeq = dequant4_batch(cac, qpc[:, None, None, None])
    cdeq[:, :, :, :, 0, 0] = cdcd.reshape(nmb, 2, 2, 2)[
        :, :, :, :].reshape(nmb, 2, 2, 2)
    chroma_res = inv4_batch(cdeq)                      # [nMB,2,2,2,4,4]

    # assemble residual planes
    ry = luma_res.reshape(mb_h, mb_w, 4, 4, 4, 4) \
        .transpose(0, 2, 4, 1, 3, 5).reshape(H, W)
    rc = chroma_res.reshape(mb_h, mb_w, 2, 2, 2, 4, 4) \
        .transpose(2, 0, 3, 5, 1, 4, 6).reshape(2, H // 2, W // 2)

    rec_y = np.zeros((H, W), np.uint8)
    rec_u = np.zeros((H // 2, W // 2), np.uint8)
    rec_v = np.zeros((H // 2, W // 2), np.uint8)

    # ---- inter prediction (parallel over all inter/skip blocks) ----
    inter_mb = np.nonzero((kind == 0) | (kind == 1))[0]
    if inter_mb.size:
        if not ref_list:
            raise InvalidData("h264: P slice without reference frame")
        mv = res["mv"]
        ref = res["ref"]
        mby = inter_mb // mb_w
        mbx = inter_mb % mb_w
        # per-4x4 luma blocks
        bidx = np.arange(16)
        ys = (mby[:, None] * 16 + (bidx // 4)[None, :] * 4).ravel()
        xs = (mbx[:, None] * 16 + (bidx % 4)[None, :] * 4).ravel()
        mvx = mv[inter_mb, :, 0].ravel().astype(np.int64)
        mvy = mv[inter_mb, :, 1].ravel().astype(np.int64)
        # ref idx per 4x4 from per-8x8
        r8 = ref[inter_mb]                                  # [k,4]
        ridx = r8[:, ((bidx // 4) // 2) * 2 + (bidx % 4) // 2].ravel()
        pred_y = np.zeros((len(ys), 4, 4), np.int64)
        pred_u = np.zeros((len(ys), 2, 2), np.int64)
        pred_v = np.zeros((len(ys), 2, 2), np.int64)
        for r in np.unique(ridx):
            if r < 0 or r >= len(ref_list):
                raise InvalidData(f"h264: ref idx {r} out of range")
            sel = np.nonzero(ridx == r)[0]
            fy, fu, fv = ref_list[r]
            planes = qpel_planes(np.asarray(fy))
            pred_y[sel] = mc_luma_blocks(planes, ys[sel], xs[sel],
                                         mvx[sel], mvy[sel])
            up = pad_chroma(np.asarray(fu))
            vp = pad_chroma(np.asarray(fv))
            cys = ys[sel] // 2
            cxs = xs[sel] // 2
            pred_u[sel] = mc_chroma_blocks(up, cys, cxs, mvx[sel], mvy[sel])
            pred_v[sel] = mc_chroma_blocks(vp, cys, cxs, mvx[sel], mvy[sel])
        # scatter into recon planes (+ residual); blocks are disjoint so
        # vectorized fancy-index assignment is exact
        r4 = np.arange(4)
        yy = ys[:, None, None] + r4[None, :, None]
        xx = xs[:, None, None] + r4[None, None, :]
        rec_y[yy, xx] = np.clip(pred_y + ry[yy, xx], 0, 255)
        r2 = np.arange(2)
        cyy = (ys // 2)[:, None, None] + r2[None, :, None]
        cxx = (xs // 2)[:, None, None] + r2[None, None, :]
        rec_u[cyy, cxx] = np.clip(pred_u + rc[0][cyy, cxx], 0, 255)
        rec_v[cyy, cxx] = np.clip(pred_v + rc[1][cyy, cxx], 0, 255)

    # ---- intra assembly (serial, §8.3 dependency order; native) ----
    if np.any(kind > 4):
        raise InvalidData("h264: unsupported mb kind")
    # I_PCM pixels land BEFORE intra: neighbors predict from them
    _copy_ipcm(res, rec_y, rec_u, rec_v, mb_w)
    if np.any((kind >= 2) & (kind < 4)):
        from librempeg_tpu_torch.native import build as native

        # residuals to MB-raster layout for the native pass
        resid_y = luma_res.reshape(nmb, 4, 4, 4, 4) \
            .transpose(0, 1, 3, 2, 4).reshape(nmb, 256).astype(np.int16)
        resid_c = chroma_res.reshape(nmb, 2, 2, 2, 4, 4) \
            .transpose(0, 1, 2, 4, 3, 5).reshape(nmb, 2, 64) \
            .astype(np.int16)
        native.h264_intra_recon(rec_y, rec_u, rec_v, kind, info,
                                res["i4modes"], resid_y, resid_c,
                                mb_w, mb_h)

    return rec_y, rec_u, rec_v


def dezigzag_chroma_dc(blocks: np.ndarray) -> np.ndarray:
    """[..., 2, 16] chroma-DC coeffs (first 4 used, raster) -> [..., 2,2,2]."""
    return blocks[..., :4].reshape(blocks.shape[:-1] + (2, 2))
