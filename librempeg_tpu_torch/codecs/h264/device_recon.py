"""H.264 P-frame reconstruction + in-loop deblocking on tensors.

Port of librempeg_tpu/codecs/h264/device_recon.py as plain PyTorch.
These functions are the plain versions of three of the slice's CUDA
kernels (MC, intra scan, deblock) and run the decode on the CPU; on a
CUDA tensor the decoder calls the kernels instead (mc_pallas,
intra_pallas, deblock_pallas), which are held bit-exact to these.

Per P frame the host hands over only the entropy tensors (sparse
coefficients, motion field, MB kinds); dequant, inverse transform,
quarter-pel MC, the intra pass and the deblock run on tensors.

Deblocking follows the spec's MB raster order (§8.7: per MB, vertical
edges then horizontal ones). An MB's filtering reads pixels its left,
top and top-right neighbours have already filtered, so MBs on one
diagonal t = mx + 2*my are independent and the frame takes
mb_w + 2*mb_h - 2 wavefront steps by default; deblock_frame also takes
other schedules as data.

Behavioral reference: libavcodec/h264_loopfilter.c, h264qpel_template.c,
h264_mb.c (reimplemented); the integer math mirrors codecs/h264/recon.py
and native/h264.cpp.
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.codecs.h264 import recon as R

PAD = R.PAD            # 32
PADC = R.PADC          # 16

# dequant V table (§8.5.9) expanded to per-position [6][16]
_VPOS = np.array([[R._V[m][p] for p in
                   [0, 2, 0, 2, 2, 1, 2, 1, 0, 2, 0, 2, 2, 1, 2, 1]]
                  for m in range(6)], np.int32)
_IZZ = np.argsort(np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7,
                            11, 14, 15]))

# qpel plane-pair map (recon.py _QPEL_MAP) as arrays indexed fy*4+fx
_QM = np.zeros((16, 6), np.int32)      # p1, d1y, d1x, p2, d2y, d2x
for (fx, fy), (p1, (d1y, d1x), p2, (d2y, d2x)) in R._QPEL_MAP.items():
    _QM[fy * 4 + fx] = (p1, d1y, d1x, p2, d2y, d2x)

# deblock spec tables (8-16/8-17)
_ALPHA = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36,
    40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182, 203,
    226, 255, 255], np.int32)
_BETA = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11,
    11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18], np.int32)
_TC0 = np.array([
    [0, 0, 0]] * 17 + [[0, 0, 1]] * 4 + [[0, 1, 1], [0, 1, 1], [1, 1, 1],
    [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 2], [1, 1, 2], [1, 1, 2],
    [1, 1, 2], [1, 2, 3], [1, 2, 3], [2, 2, 3], [2, 2, 4], [2, 3, 4],
    [2, 3, 4], [3, 3, 5], [3, 4, 6], [3, 4, 6], [4, 5, 7], [4, 5, 8],
    [4, 6, 9], [5, 7, 10], [6, 8, 11], [6, 8, 13], [7, 10, 14],
    [8, 11, 16], [9, 12, 18], [10, 13, 20], [11, 15, 23], [13, 17, 25]],
    np.int32)
_CQP = np.array(list(range(30)) + [29, 30, 31, 32, 32, 33, 34, 34, 35,
                                   35, 36, 36, 37, 37, 37, 38, 38, 38,
                                   39, 39, 39, 39], np.int32)

_H4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1],
                [1, -1, 1, -1]], np.int32)
_H2 = np.array([[1, 1], [1, -1]], np.int32)


def _t(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """numpy table -> tensor on `like`'s device."""
    return torch.as_tensor(a, device=like.device)


def _imm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer matrix product over the last two axes (CUDA has no
    integer GEMM; the matrices here are 2x2 / 4x4)."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def dense_coeffs(coeff_idx: torch.Tensor, coeff_val: torch.Tensor,
                 nmb: int) -> torch.Tensor:
    """Sparse (flat zigzag index, level) pairs -> [nMB, 27, 16] int32.
    Indices >= nMB*27*16 are padding and dropped."""
    total = nmb * 27 * 16
    idx = coeff_idx.long()
    keep = idx < total
    out = torch.zeros(total, dtype=torch.int32, device=coeff_val.device)
    out[idx[keep]] = coeff_val[keep].to(torch.int32)
    return out.reshape(nmb, 27, 16)


# ---------------------------------------------------------------------------
# reference-plane preparation (once per DPB insertion)
# ---------------------------------------------------------------------------

def _edge_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Replicate-pad a [H, W] integer plane by p on every side."""
    h, w = x.shape
    iy = torch.arange(-p, h + p, device=x.device).clamp(0, h - 1)
    ix = torch.arange(-p, w + p, device=x.device).clamp(0, w - 1)
    return x[iy[:, None], ix[None, :]]


def make_refpack(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Padded full-pel plane + the three half-pel 6-tap FIR planes
    (§8.4.2.2.1) and padded chroma (analog of recon.RefPack).

    Returns (luma4 [4, hp, wp] uint8, u_pad, v_pad)."""
    e = _edge_pad(y.to(torch.uint8), PAD)
    ei = e.to(torch.int32)

    def hfir(a):
        r = torch.zeros_like(a)
        r[:, 2:-3] = (a[:, 0:-5] - 5 * a[:, 1:-4] + 20 * a[:, 2:-3]
                      + 20 * a[:, 3:-2] - 5 * a[:, 4:-1] + a[:, 5:])
        return r

    def vfir(a):
        r = torch.zeros_like(a)
        r[2:-3, :] = (a[0:-5, :] - 5 * a[1:-4, :] + 20 * a[2:-3, :]
                      + 20 * a[3:-2, :] - 5 * a[4:-1, :] + a[5:, :])
        return r

    b1 = hfir(ei)
    b = ((b1 + 16) >> 5).clamp(0, 255).to(torch.uint8)
    h = ((vfir(ei) + 16) >> 5).clamp(0, 255).to(torch.uint8)
    j = ((vfir(b1) + 512) >> 10).clamp(0, 255).to(torch.uint8)
    luma4 = torch.stack([e, b, h, j])
    up = _edge_pad(u.to(torch.uint8), PADC)
    vp = _edge_pad(v.to(torch.uint8), PADC)
    return luma4, up, vp


# ---------------------------------------------------------------------------
# residuals
# ---------------------------------------------------------------------------

def _inv4(d: torch.Tensor) -> torch.Tensor:
    """Inverse 4x4 core transform over [..., 4, 4] int32 (§8.5.12.2)."""
    e0 = d[..., :, 0] + d[..., :, 2]
    e1 = d[..., :, 0] - d[..., :, 2]
    e2 = (d[..., :, 1] >> 1) - d[..., :, 3]
    e3 = d[..., :, 1] + (d[..., :, 3] >> 1)
    h = torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-1)
    e0 = h[..., 0, :] + h[..., 2, :]
    e1 = h[..., 0, :] - h[..., 2, :]
    e2 = (h[..., 1, :] >> 1) - h[..., 3, :]
    e3 = h[..., 1, :] + (h[..., 3, :] >> 1)
    v = torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-2)
    return (v + 32) >> 6


def _residuals(coeffs, qp, chroma_qp_off, nmb, is_i16=None):
    """coeffs [nMB, 27, 16] int32 (zigzag), qp [nMB] -> (luma residual
    [nMB, 16, 4, 4], chroma residual [nMB, 2, 2, 2, 4, 4]) int32.
    is_i16 [nMB] bool folds the Intra_16x16 luma DC hadamard path
    (coeffs row 0) into block position (0, 0) pre-IDCT (§8.5.10)."""
    qp = qp.to(torch.int32)
    cqp = _t(_CQP, coeffs)
    qpc = cqp[(qp + chroma_qp_off).clamp(0, 51).long()]
    izz = _t(_IZZ, coeffs).long()
    vpos = _t(_VPOS, coeffs)

    luma = coeffs[:, 1:17, :][..., izz]                       # [n,16,16]
    lv = vpos[(qp % 6).long()][:, None, :]                    # [n,1,16]
    ldeq = (luma * lv) << (qp // 6)[:, None, None]
    if is_i16 is not None:
        dc = coeffs[:, 0, :][:, izz].reshape(nmb, 4, 4)
        h4 = _t(_H4, coeffs)
        fdc = _imm(_imm(h4, dc), h4)
        v0 = vpos[(qp % 6).long()][:, 0][:, None, None]
        hi = (fdc * v0) << torch.clamp(qp // 6 - 2, min=0)[:, None, None]
        one = torch.ones_like(qp)
        lo = (fdc * v0 + (one << torch.clamp(1 - qp // 6, min=0))
              [:, None, None]) >> torch.clamp(2 - qp // 6,
                                              min=0)[:, None, None]
        dcd = torch.where((qp >= 12)[:, None, None], hi, lo)   # [n,4,4]
        folded = ldeq.clone()
        folded[:, :, 0] = dcd.reshape(nmb, 16)
        ldeq = torch.where(is_i16[:, None, None], folded, ldeq)
    lres = _inv4(ldeq.reshape(nmb, 16, 4, 4))

    cdc = coeffs[:, 17:19, :4].reshape(nmb, 2, 2, 2)          # [n,pl,2,2]
    h2 = _t(_H2, coeffs)
    f = _imm(_imm(h2, cdc), h2)
    v0 = vpos[(qpc % 6).long()][:, 0]
    cdcd = ((f * v0[:, None, None, None])
            << (qpc // 6)[:, None, None, None]) >> 1
    cac = coeffs[:, 19:27, :][..., izz].reshape(nmb, 2, 4, 16)
    cv = vpos[(qpc % 6).long()][:, None, None, :]
    cdeq = (cac * cv) << (qpc // 6)[:, None, None, None]
    cdeq[..., 0] = cdcd.reshape(nmb, 2, 4)
    cres = _inv4(cdeq.reshape(nmb, 2, 4, 4, 4)).reshape(nmb, 2, 2, 2, 4, 4)
    return lres, cres


# ---------------------------------------------------------------------------
# inter prediction
# ---------------------------------------------------------------------------

def _mc(luma4, upad, vpad, mv, ref, mb_w, mb_h):
    """luma4 [R,4,hp,wp] uint8, upad/vpad [R,hc,wc]; mv [nMB,16,2]
    (x, y qpel); ref [nMB,4] -> (pred_y [nblk,4,4], pred_u [nblk,2,2],
    pred_v [nblk,2,2]) int32, blocks in MB-major 4x4-raster order."""
    dev = luma4.device
    nmb = mb_w * mb_h
    hp, wp = luma4.shape[2], luma4.shape[3]
    hc, wc = upad.shape[1], upad.shape[2]

    mb = torch.arange(nmb, device=dev)
    mby, mbx = mb // mb_w, mb % mb_w
    bidx = torch.arange(16, device=dev)
    ys = (mby[:, None] * 16 + (bidx // 4)[None, :] * 4).reshape(-1)
    xs = (mbx[:, None] * 16 + (bidx % 4)[None, :] * 4).reshape(-1)
    mvx = mv[:, :, 0].reshape(-1).long()
    mvy = mv[:, :, 1].reshape(-1).long()
    ridx = ref.long()[:, ((bidx // 4) // 2) * 2 + (bidx % 4) // 2]
    ridx = ridx.reshape(-1).clamp(0, luma4.shape[0] - 1)

    key = (mvy & 3) * 4 + (mvx & 3)
    qm = _t(_QM, luma4).long()[key]                        # [nblk, 6]
    iy = (ys + (mvy >> 2) + PAD).clamp(3, hp - 8)
    ix = (xs + (mvx >> 2) + PAD).clamp(3, wp - 8)
    r4 = torch.arange(4, device=dev)
    lall = luma4.reshape(-1, hp, wp)

    def lgather(pidx, dy, dx):
        p = (ridx * 4 + pidx)[:, None, None]
        by = (iy + dy)[:, None, None] + r4[None, :, None]
        bx = (ix + dx)[:, None, None] + r4[None, None, :]
        return lall[p, by, bx].to(torch.int32)

    a = lgather(qm[:, 0], qm[:, 1], qm[:, 2])
    b = lgather(qm[:, 3], qm[:, 4], qm[:, 5])
    pred_y = (a + b + 1) >> 1

    # chroma: eighth-pel bilinear, 2x2 per luma 4x4 (§8.4.2.2.2)
    cys = ys // 2 + (mvy >> 3)
    cxs = xs // 2 + (mvx >> 3)
    dy = (mvy & 7).to(torch.int32)[:, None, None]
    dx = (mvx & 7).to(torch.int32)[:, None, None]
    ciy = (cys + PADC).clamp(0, hc - 4)
    cix = (cxs + PADC).clamp(0, wc - 4)
    r3 = torch.arange(3, device=dev)
    by3 = ciy[:, None, None] + r3[None, :, None]
    bx3 = cix[:, None, None] + r3[None, None, :]

    def cgather(cpad):
        p = cpad[ridx[:, None, None], by3, bx3].to(torch.int32)
        p00 = p[:, 0:2, 0:2]
        p01 = p[:, 0:2, 1:3]
        p10 = p[:, 1:3, 0:2]
        p11 = p[:, 1:3, 1:3]
        return ((8 - dx) * (8 - dy) * p00 + dx * (8 - dy) * p01
                + (8 - dx) * dy * p10 + dx * dy * p11 + 32) >> 6

    return pred_y, cgather(upad), cgather(vpad)


# ---------------------------------------------------------------------------
# intra MB reconstruction (scattered intra-in-P), raster-order scan
# ---------------------------------------------------------------------------

# decode-order rank of the raster 4x4 positions within an MB (§6.4.3)
_ORD4 = np.array([0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15],
                 np.int32)
# decode-order list of (by, bx)
_BLK4_DEC = [divmod(int(np.flatnonzero(_ORD4 == o)[0]), 4)
             for o in range(16)]


def _pred16(mode, top, left, tl, avt, avl):
    """One Intra_16x16 luma mode (§8.3.3) from int32 neighbour vectors
    top[16], left[16] and the 0-dim tl."""
    dev = top.device
    if mode == 0:
        return top[None, :].expand(16, 16)
    if mode == 1:
        return left[:, None].expand(16, 16)
    if mode == 2:
        st, sl = top.sum(), left.sum()
        if avt and avl:
            d = (st + sl + 16) >> 5
        elif avt:
            d = (st + 8) >> 4
        elif avl:
            d = (sl + 8) >> 4
        else:
            d = torch.tensor(128, dtype=torch.int32, device=dev)
        return d.to(torch.int32).expand(16, 16)
    xs = torch.arange(16, device=dev, dtype=torch.int32)
    i = torch.arange(1, 9, device=dev)
    hb = torch.where(7 - i >= 0, top[torch.clamp(7 - i, min=0)], tl)
    hsum = (i * (top[7 + i] - hb)).sum()
    vb = torch.where(7 - i >= 0, left[torch.clamp(7 - i, min=0)], tl)
    vsum = (i * (left[7 + i] - vb)).sum()
    a = 16 * (left[15] + top[15])
    b = (5 * hsum + 32) >> 6
    c = (5 * vsum + 32) >> 6
    return ((a + b * (xs[None, :] - 7) + c * (xs[:, None] - 7) + 16)
            >> 5).clamp(0, 255).to(torch.int32)


def _pred4(mode, t, l, lt, tt):
    """One Intra_4x4 mode (§8.3.1.2; mirrors native/h264.cpp pred4).
    t[4], l[4], tt[8] int32 vectors, lt 0-dim. DC (mode 2) is the
    both-available form; the caller folds availability."""
    dev = t.device
    ys, xs = torch.meshgrid(torch.arange(4, device=dev),
                            torch.arange(4, device=dev), indexing="ij")

    def c3(i):
        return i.clamp(0, 3)

    if mode == 0:
        return t[None, :].expand(4, 4)
    if mode == 1:
        return l[:, None].expand(4, 4)
    if mode == 2:
        return ((t.sum() + l.sum() + 4) >> 3).expand(4, 4)
    if mode == 3:
        s = xs + ys
        gen = (tt[s] + 2 * tt[torch.clamp(s + 1, max=7)]
               + tt[torch.clamp(s + 2, max=7)] + 2) >> 2
        last = (tt[6] + 3 * tt[7] + 2) >> 2
        return torch.where((xs == 3) & (ys == 3), last, gen)
    if mode == 4:
        z = xs - ys
        za = z.abs()
        tz = (t[c3(z)] + 2 * t[c3(z - 1)]
              + torch.where(z >= 2, t[c3(z - 2)], lt) + 2) >> 2
        lz = (l[c3(za)] + 2 * l[c3(za - 1)]
              + torch.where(za >= 2, l[c3(za - 2)], lt) + 2) >> 2
        diag = (t[0] + 2 * lt + l[0] + 2) >> 2
        return torch.where(z > 0, tz, torch.where(z < 0, lz, diag))
    if mode in (5, 6):
        # vertical-right; horizontal-down is its transpose-mirror
        if mode == 5:
            p, q, u_, v_ = t, l, xs, ys
        else:
            p, q, u_, v_ = l, t, ys, xs
        z = 2 * u_ - v_
        i = u_ - (v_ >> 1)
        even = (torch.where(i >= 1, p[c3(i - 1)], lt) + p[c3(i)] + 1) >> 1
        a_od = torch.where(i >= 2, p[c3(i - 2)],
                           torch.where(i == 1, lt, q[0]))
        b_od = torch.where(i >= 1, p[c3(i - 1)], lt)
        odd = (a_od + 2 * b_od + p[c3(i)] + 2) >> 2
        zm1 = (q[0] + 2 * lt + p[0] + 2) >> 2
        rest = (q[c3(v_ - 1)] + 2 * q[c3(v_ - 2)]
                + torch.where(v_ - 3 >= 0, q[c3(v_ - 3)], lt) + 2) >> 2
        return torch.where(z >= 0, torch.where(z % 2 == 0, even, odd),
                           torch.where(z == -1, zm1, rest))
    if mode == 7:
        i = xs + (ys >> 1)
        even = (tt[i.clamp(0, 7)] + tt[(i + 1).clamp(0, 7)] + 1) >> 1
        odd = (tt[i.clamp(0, 7)] + 2 * tt[(i + 1).clamp(0, 7)]
               + tt[(i + 2).clamp(0, 7)] + 2) >> 2
        return torch.where(ys % 2 == 0, even, odd)
    z = xs + 2 * ys
    i = ys + (xs >> 1)
    even = (l[c3(i)] + l[c3(i + 1)] + 1) >> 1
    odd = (l[c3(i)] + 2 * l[c3(i + 1)] + l[c3(i + 2)] + 2) >> 2
    z5 = (l[2] + 3 * l[3] + 2) >> 2
    gen = torch.where(z % 2 == 0, even, odd)
    return torch.where(z > 5, l[3], torch.where(z == 5, z5, gen))


def _pred8c(ctile, cmode, avt, avl):
    """Chroma 8x8 prediction from the 9x9 context tile (row/col 0 are
    the neighbours). Mirrors native/h264.cpp pred8c."""
    top = ctile[0, 1:9]
    left = ctile[1:9, 0]
    tl = ctile[0, 0]
    dev = ctile.device
    if cmode == 0:
        out = torch.zeros(8, 8, dtype=torch.int32, device=dev)
        for qy in range(2):
            for qx in range(2):
                ts = top[qx * 4:qx * 4 + 4].sum()
                ls = left[qy * 4:qy * 4 + 4].sum()
                both = (ts + ls + 4) >> 3
                tonly = (ts + 2) >> 2
                lonly = (ls + 2) >> 2
                if qy == 0 and qx == 1:
                    val = tonly if avt else (lonly if avl else 128)
                elif qy == 1 and qx == 0:
                    val = lonly if avl else (tonly if avt else 128)
                else:
                    val = both if (avt and avl) else (
                        tonly if avt else (lonly if avl else 128))
                out[qy * 4:qy * 4 + 4, qx * 4:qx * 4 + 4] = val
        return out
    if cmode == 1:
        return left[:, None].expand(8, 8)
    if cmode == 2:
        return top[None, :].expand(8, 8)
    xs = torch.arange(8, device=dev, dtype=torch.int32)
    i = torch.arange(1, 5, device=dev)
    hb = torch.where(3 - i >= 0, top[torch.clamp(3 - i, min=0)], tl)
    hsum = (i * (top[3 + i] - hb)).sum()
    vb = torch.where(3 - i >= 0, left[torch.clamp(3 - i, min=0)], tl)
    vsum = (i * (left[3 + i] - vb)).sum()
    a = 16 * (left[7] + top[7])
    b = (17 * hsum + 16) >> 5
    c = (17 * vsum + 16) >> 5
    return ((a + b * (xs[None, :] - 3) + c * (xs[:, None] - 3) + 16)
            >> 5).clamp(0, 255).to(torch.int32)


def _intra_mb(yp, up, vp, mi, k, inf, m4, lres, cres, mb_w):
    """The reconstruction of one intra MB from the planes as they stand
    (padded as _intra_scan's): its luma 16x16 and two chroma 8x8 tiles,
    not yet written."""
    my, mx = divmod(mi, mb_w)
    y0, x0 = my * 16 + 1, mx * 16 + 1
    avt, avl = my > 0, mx > 0
    tile = yp[y0 - 1:y0 + 16, x0 - 1:x0 + 24].to(torch.int32)
    lr = lres[mi]                          # [16, 4, 4] raster blocks
    if k == 2:
        for by, bx in _BLK4_DEC:
            ly, lx = 1 + by * 4, 1 + bx * 4
            t = tile[ly - 1, lx:lx + 4]
            l = tile[ly:ly + 4, lx - 1]
            lt = tile[ly - 1, lx - 1]
            # top-right availability (decode order, §8.3.1)
            if by > 0 and bx < 3:
                av_tr = bool(_ORD4[(by - 1) * 4 + bx + 1]
                             < _ORD4[by * 4 + bx])
            elif by > 0:
                av_tr = False
            elif bx < 3:
                av_tr = avt
            else:
                av_tr = avt and mx + 1 < mb_w
            tr = tile[ly - 1, lx + 4:lx + 8] if av_tr \
                else t[3].expand(4)
            tt = torch.cat([t, tr])
            mode = min(max(int(m4[by * 4 + bx]), 0), 8)
            avt_b = True if by > 0 else avt
            avl_b = True if bx > 0 else avl
            if mode == 2 and not (avt_b and avl_b):
                if avt_b:
                    pred = ((t.sum() + 2) >> 2).expand(4, 4)
                elif avl_b:
                    pred = ((l.sum() + 2) >> 2).expand(4, 4)
                else:
                    pred = torch.full((4, 4), 128, dtype=torch.int32,
                                      device=tile.device)
            else:
                pred = _pred4(mode, t, l, lt, tt)
            tile[ly:ly + 4, lx:lx + 4] = (
                pred + lr[by * 4 + bx]).clamp(0, 255)
    else:
        top = tile[0, 1:17]
        left = tile[1:17, 0]
        pred = _pred16(min(max(inf & 15, 0), 3), top, left, tile[0, 0],
                       avt, avl)
        res16 = lr.reshape(4, 4, 4, 4).permute(0, 2, 1, 3) \
            .reshape(16, 16)
        tile[1:17, 1:17] = (pred + res16).clamp(0, 255)
    out = [tile[1:17, 1:17].to(yp.dtype)]

    cy0, cx0 = my * 8 + 1, mx * 8 + 1
    cmode = min(max((inf >> 4) & 15, 0), 3)
    cr = cres[mi]                          # [2, 2, 2, 4, 4]
    for pl, cp in ((0, up), (1, vp)):
        ctile = cp[cy0 - 1:cy0 + 8, cx0 - 1:cx0 + 8].to(torch.int32)
        pred = _pred8c(ctile, cmode, avt, avl)
        res8 = cr[pl].permute(0, 2, 1, 3).reshape(8, 8)
        out.append((pred + res8).clamp(0, 255).to(cp.dtype))
    return out


def _intra_scan(yp, up, vp, intra_list, kind, info, i4modes, lres, cres,
                mb_w, mb_h, order=None):
    """Reconstruct the listed intra MBs over planes padded by 1
    (top/left) and 8 (bottom/right) with zeros; updates the planes in
    place and returns them. intra_list: ascending MB indices (-1 entries
    are skipped). Mirrors native/h264.cpp h264_intra_recon.

    order: the schedule, a list of groups of MB indices that together
    cover the listed MBs once; every MB of a group is rebuilt from the
    planes as they stood before the group, then the group is written (MBs
    that run at the same time). Default: one MB per group in list order,
    the spec's raster order.

    The per-MB metadata is read to the host once; the pixel work stays
    on the planes' device."""
    mbs = [int(m) for m in torch.as_tensor(intra_list).tolist() if m >= 0]
    if not mbs:
        return yp, up, vp
    sel = torch.as_tensor(mbs, device=kind.device)
    meta = dict(zip(mbs, zip(kind[sel].tolist(), info[sel].tolist(),
                             i4modes[sel].tolist())))
    if order is None:
        order = [[m] for m in mbs]
    for group in order:
        done = [(m, _intra_mb(yp, up, vp, m, *meta[m], lres, cres, mb_w))
                for m in group]
        for m, (ty, tu, tv) in done:
            my, mx = divmod(m, mb_w)
            yp[my * 16 + 1:my * 16 + 17, mx * 16 + 1:mx * 16 + 17] = ty
            up[my * 8 + 1:my * 8 + 9, mx * 8 + 1:mx * 8 + 9] = tu
            vp[my * 8 + 1:my * 8 + 9, mx * 8 + 1:mx * 8 + 9] = tv
    return yp, up, vp


def recon_p_frame_pred_noscan(pred_y, pred_u, pred_v, coeff_idx,
                              coeff_val, qp, kind, mb_w: int, mb_h: int,
                              chroma_qp_off: int, fold_i16: bool):
    """Residual add over the MB-tile inter prediction (pred_y
    [nMB, 16, 16], pred_u/v [nMB, 8, 8] uint8 -- the mc_predict output),
    without the intra pass: returns the pre-intra planes plus the
    MB-tile residual tensors (lres_t [nMB, 16, 16], cres_t
    [nMB, 2, 8, 8]) for intra_pallas.intra_scan_pallas."""
    nmb = mb_w * mb_h
    W, H = mb_w * 16, mb_h * 16
    coeffs = dense_coeffs(coeff_idx, coeff_val, nmb)
    lres, cres = _residuals(coeffs, qp, chroma_qp_off, nmb,
                            is_i16=(kind == 3) if fold_i16 else None)

    lres_t = lres.reshape(nmb, 4, 4, 4, 4).permute(0, 1, 3, 2, 4) \
        .reshape(nmb, 16, 16)
    rec_y = (pred_y.to(torch.int32) + lres_t).clamp(0, 255)
    y = rec_y.reshape(mb_h, mb_w, 16, 16).permute(0, 2, 1, 3) \
        .reshape(H, W).to(torch.uint8)

    cres_t = cres.permute(0, 1, 2, 4, 3, 5).reshape(nmb, 2, 8, 8)

    def cplane(pred, res):
        rec = (pred.to(torch.int32) + res).clamp(0, 255)
        return rec.reshape(mb_h, mb_w, 8, 8).permute(0, 2, 1, 3) \
            .reshape(H // 2, W // 2).to(torch.uint8)

    u = cplane(pred_u, cres_t[:, 0])
    v = cplane(pred_v, cres_t[:, 1])
    return y, u, v, lres_t, cres_t


# ---------------------------------------------------------------------------
# in-loop deblocking (§8.7) as an MB wavefront
# ---------------------------------------------------------------------------

def _bs_maps(coeffs, mv, ref, kind, mb_w, mb_h):
    """Per-4x4 boundary strengths. Returns (bs_v, bs_h) [H4, W4] where
    bs_v[gy, gx] is the edge LEFT of block (gy, gx) and bs_h the edge
    ABOVE it. Intra MBs force bS = 4 on MB-boundary edges and 3 inside
    (§8.7.2.1); otherwise nnz / ref / mv rules. Mirrors native/h264.cpp
    edge_bs."""
    dev = coeffs.device
    H4, W4 = mb_h * 4, mb_w * 4
    nz = (coeffs[:, 1:17, :] != 0).any(dim=-1)            # [nMB, 16]
    nz = nz.reshape(mb_h, mb_w, 4, 4).permute(0, 2, 1, 3).reshape(H4, W4)
    bidx = torch.arange(16, device=dev)
    r16 = ref[:, ((bidx // 4) // 2) * 2 + (bidx % 4) // 2]
    rmap = r16.reshape(mb_h, mb_w, 4, 4).permute(0, 2, 1, 3) \
        .reshape(H4, W4).to(torch.int32)
    mvm = mv.to(torch.int32).reshape(mb_h, mb_w, 4, 4, 2) \
        .permute(0, 2, 1, 3, 4).reshape(H4, W4, 2)
    isin = (kind >= 2).reshape(mb_h, mb_w) \
        .repeat_interleave(4, 0).repeat_interleave(4, 1)

    def bs_dir(nzp, nzq, rp, rq, mp, mq, inp, inq, mb_edge):
        mvbig = ((mp - mq).abs() >= 4).any(dim=-1)
        inter_bs = torch.where(nzp | nzq, 2,
                               torch.where((rp != rq) | mvbig, 1, 0))
        return torch.where(inp | inq, torch.where(mb_edge, 4, 3),
                           inter_bs).to(torch.int32)

    mbe_v = (torch.arange(1, W4, device=dev) % 4 == 0)[None, :]
    mbe_h = (torch.arange(1, H4, device=dev) % 4 == 0)[:, None]
    bs_v = torch.zeros((H4, W4), dtype=torch.int32, device=dev)
    bs_v[:, 1:] = bs_dir(nz[:, :-1], nz[:, 1:], rmap[:, :-1], rmap[:, 1:],
                         mvm[:, :-1], mvm[:, 1:], isin[:, :-1],
                         isin[:, 1:], mbe_v)
    bs_h = torch.zeros((H4, W4), dtype=torch.int32, device=dev)
    bs_h[1:, :] = bs_dir(nz[:-1, :], nz[1:, :], rmap[:-1, :], rmap[1:, :],
                         mvm[:-1, :], mvm[1:, :], isin[:-1, :],
                         isin[1:, :], mbe_h)
    return bs_v, bs_h


def _edge_params(qp, mb_w, mb_h, chroma_qp_off, alpha_off, beta_off):
    """Per-4x4-edge alpha/beta table-index maps for both directions,
    luma and chroma, qp-averaged across MB boundaries. qp [nMB].
    Returns a dict of [H4, W4] int32 maps."""
    dev = qp.device
    H4, W4 = mb_h * 4, mb_w * 4
    qpm = qp.to(torch.int32).reshape(mb_h, mb_w)
    cqm = _t(_CQP, qp)[(qpm + chroma_qp_off).clamp(0, 51).long()]

    def maps(qmb):
        q = qmb.repeat_interleave(4, 0).repeat_interleave(4, 1)
        ql = torch.cat([q[:, :4], q[:, :-4]], dim=1)
        gx = torch.arange(W4, device=dev)[None, :]
        qv = torch.where(gx % 4 == 0, (ql + q + 1) >> 1, q)
        qt = torch.cat([q[:4, :], q[:-4, :]], dim=0)
        gy = torch.arange(H4, device=dev)[:, None]
        qh = torch.where(gy % 4 == 0, (qt + q + 1) >> 1, q)
        return ((qv + alpha_off).clamp(0, 51), (qv + beta_off).clamp(0, 51),
                (qh + alpha_off).clamp(0, 51), (qh + beta_off).clamp(0, 51))

    lav, lbv, lah, lbh = maps(qpm)
    cav, cbv, cah, cbh = maps(cqm)
    return {"lav": lav, "lbv": lbv, "lah": lah, "lbh": lbh,
            "cav": cav, "cbv": cbv, "cah": cah, "cbh": cbh}


def _filt_luma(patch, bs, ia, ib):
    """Filter one luma edge: patch [..., 8] = (p3 p2 p1 p0 q0 q1 q2 q3)
    int32, bS in {0..4} (normal + strong filters), alpha/beta table
    indices broadcastable to patch[..., 0]. Returns patch'."""
    alpha = _t(_ALPHA, patch)[ia.long()]
    beta = _t(_BETA, patch)[ib.long()]
    tc0 = _t(_TC0, patch)[ia.long(), (bs - 1).clamp(0, 2).long()]
    p3, p2, p1, p0 = (patch[..., i] for i in range(4))
    q0, q1, q2, q3 = (patch[..., i] for i in range(4, 8))
    fmask = ((bs > 0) & ((p0 - q0).abs() < alpha)
             & ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta))
    ap = (p2 - p0).abs() < beta
    aq = (q2 - q0).abs() < beta
    # normal filter (bS < 4)
    tc = tc0 + ap.to(torch.int32) + aq.to(torch.int32)
    delta = torch.maximum(torch.minimum(
        (((q0 - p0) * 4) + (p1 - q1) + 4) >> 3, tc), -tc)
    p0n = (p0 + delta).clamp(0, 255)
    q0n = (q0 - delta).clamp(0, 255)
    p1n = p1 + torch.maximum(torch.minimum(
        (p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1, tc0), -tc0)
    q1n = q1 + torch.maximum(torch.minimum(
        (q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1, tc0), -tc0)
    # strong filter (bS == 4, §8.7.2.4)
    close = (p0 - q0).abs() < ((alpha >> 2) + 2)
    sp = ap & close
    sq = aq & close
    p0s = torch.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                      (2 * p1 + p0 + q1 + 2) >> 2)
    p1s = (p2 + p1 + p0 + q0 + 2) >> 2
    p2s = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3
    q0s = torch.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                      (2 * q1 + q0 + p1 + 2) >> 2)
    q1s = (q2 + q1 + q0 + p0 + 2) >> 2
    q2s = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3
    bs4 = bs == 4
    out = patch.clone()
    out[..., 3] = torch.where(fmask, torch.where(bs4, p0s, p0n), p0)
    out[..., 4] = torch.where(fmask, torch.where(bs4, q0s, q0n), q0)
    out[..., 2] = torch.where(
        fmask, torch.where(bs4, torch.where(sp, p1s, p1),
                           torch.where(ap, p1n, p1)), p1)
    out[..., 5] = torch.where(
        fmask, torch.where(bs4, torch.where(sq, q1s, q1),
                           torch.where(aq, q1n, q1)), q1)
    out[..., 1] = torch.where(fmask & bs4 & sp, p2s, p2)
    out[..., 6] = torch.where(fmask & bs4 & sq, q2s, q2)
    return out


def _filt_chroma(patch, bs, ia, ib):
    """patch [..., 4] = (p1 p0 q0 q1) int32; chroma filter incl. the
    bS == 4 strong form."""
    alpha = _t(_ALPHA, patch)[ia.long()]
    beta = _t(_BETA, patch)[ib.long()]
    tc0 = _t(_TC0, patch)[ia.long(), (bs - 1).clamp(0, 2).long()]
    p1, p0, q0, q1 = (patch[..., i] for i in range(4))
    fmask = ((bs > 0) & ((p0 - q0).abs() < alpha)
             & ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta))
    tc = tc0 + 1
    delta = torch.maximum(torch.minimum(
        (((q0 - p0) * 4) + (p1 - q1) + 4) >> 3, tc), -tc)
    p0n = (p0 + delta).clamp(0, 255)
    q0n = (q0 - delta).clamp(0, 255)
    p0s = (2 * p1 + p0 + q1 + 2) >> 2
    q0s = (2 * q1 + q0 + p1 + 2) >> 2
    bs4 = bs == 4
    out = patch.clone()
    out[..., 1] = torch.where(fmask, torch.where(bs4, p0s, p0n), p0)
    out[..., 2] = torch.where(fmask, torch.where(bs4, q0s, q0n), q0)
    return out


def wavefront_order(mb_w: int, mb_h: int):
    """deblock_frame's default schedule: the MB diagonals t = mx + 2*my
    in order, each as its vertical pass then its horizontal pass."""
    out = []
    for t in range(mb_w + 2 * mb_h - 2):
        mbs = [my * mb_w + t - 2 * my for my in range(mb_h)
               if 0 <= t - 2 * my < mb_w]
        out += [("v", mbs), ("h", mbs)]
    return out


def deblock_frame(y, u, v, coeff_idx, coeff_val, mv, ref, qp, kind,
                  mb_w: int, mb_h: int, chroma_qp_off: int = 0,
                  alpha_off: int = 0, beta_off: int = 0, order=None):
    """In-loop deblock of a P frame in a given schedule of MB groups.

    Spec order is MB raster with vertical edges before horizontal
    (§8.7). `order` is a sequence of (pass, MB raster indices): pass "v"
    filters the luma and chroma vertical edges of those MBs at once,
    "h" their horizontal edges. The default, wavefront_order, runs the
    diagonals t = mx + 2*my: an MB depends on its left, top and
    top-right neighbours' filtered output, so one diagonal's MBs are
    independent. Any schedule that runs each MB's passes after the
    passes of the spec order that touch the same pixels gives the same
    planes (tests/test_torch_deblock_order.py)."""
    dev = y.device
    nmb = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    coeffs = dense_coeffs(coeff_idx, coeff_val, nmb)
    bs_v, bs_h = _bs_maps(coeffs, mv, ref, kind, mb_w, mb_h)
    ep = _edge_params(qp, mb_w, mb_h, chroma_qp_off, alpha_off, beta_off)
    y, u, v = y.clone(), u.clone(), v.clone()

    r16 = torch.arange(16, device=dev)
    r8 = torch.arange(8, device=dev)
    r4 = torch.arange(4, device=dev)

    def rep(a, k):
        return a.repeat_interleave(k, dim=1)

    if order is None:
        order = wavefront_order(mb_w, mb_h)
    for pas, mbs in order:
        m = torch.as_tensor(mbs, dtype=torch.int64, device=dev)
        mx, my = m % mb_w, m // mb_w
        gy4 = (my * 4)[:, None] + r4[None, :]
        gx4r = (mx * 4)[:, None] + r4[None, :]
        if pas == "v":
            # ---- luma vertical edges e = 0..3 (sequential) ----
            rows = (my * 16)[:, None] + r16[None, :]        # [nd, 16]
            for e in range(4):
                gx4 = mx * 4 + e
                cols = ((gx4 * 4 - 4)[:, None] + r8[None, :]) \
                    .clamp(0, W - 1)
                ri, ci = rows[:, :, None], cols[:, None, :]
                patch = y[ri, ci].to(torch.int32)           # [nd,16,8]
                gi = (gy4, gx4[:, None])
                newp = _filt_luma(patch, rep(bs_v[gi], 4),
                                  rep(ep["lav"][gi], 4),
                                  rep(ep["lbv"][gi], 4))
                y[ri, ci] = newp.to(torch.uint8)
            # ---- chroma vertical edges, block cols 0 and 2 ----
            crows = (my * 8)[:, None] + r8[None, :]
            for c in (u, v):
                for e in range(2):
                    gx4 = mx * 4 + 2 * e
                    cls = ((gx4 * 2 - 2)[:, None] + r4[None, :]) \
                        .clamp(0, W // 2 - 1)
                    ri, ci = crows[:, :, None], cls[:, None, :]
                    patch = c[ri, ci].to(torch.int32)        # [nd,8,4]
                    gi = (gy4, gx4[:, None])
                    newp = _filt_chroma(patch, rep(bs_v[gi], 2),
                                        rep(ep["cav"][gi], 2),
                                        rep(ep["cbv"][gi], 2))
                    c[ri, ci] = newp.to(torch.uint8)
            continue
        # ---- luma horizontal edges ----
        cols = (mx * 16)[:, None] + r16[None, :]
        for e in range(4):
            gy4e = my * 4 + e
            rws = ((gy4e * 4 - 4)[:, None] + r8[None, :]).clamp(0, H - 1)
            ri, ci = rws[:, :, None], cols[:, None, :]
            patch = y[ri, ci].transpose(1, 2).to(torch.int32)  # [nd,16,8]
            gi = (gy4e[:, None], gx4r)
            newp = _filt_luma(patch, rep(bs_h[gi], 4),
                              rep(ep["lah"][gi], 4), rep(ep["lbh"][gi], 4))
            y[ri, ci] = newp.transpose(1, 2).to(torch.uint8)
        # ---- chroma horizontal edges, block rows 0 and 2 ----
        ccols = (mx * 8)[:, None] + r8[None, :]
        for c in (u, v):
            for e in range(2):
                gy4e = my * 4 + 2 * e
                rws = ((gy4e * 2 - 2)[:, None] + r4[None, :]) \
                    .clamp(0, H // 2 - 1)
                ri, ci = rws[:, :, None], ccols[:, None, :]
                patch = c[ri, ci].transpose(1, 2).to(torch.int32)
                gi = (gy4e[:, None], gx4r)
                newp = _filt_chroma(patch, rep(bs_h[gi], 2),
                                    rep(ep["cah"][gi], 2),
                                    rep(ep["cbh"][gi], 2))
                c[ri, ci] = newp.transpose(1, 2).to(torch.uint8)
    return y, u, v
