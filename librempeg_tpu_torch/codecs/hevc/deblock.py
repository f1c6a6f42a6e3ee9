"""HEVC in-loop deblocking filter (§8.7.2), 8-bit 4:2:0.

Unlike H.264's per-macroblock interleaved order, HEVC deblocking is
picture-separable by construction: every vertical edge of the picture
is filtered first, then every horizontal edge, and edges on the 8x8
grid touch at most +/-3 samples while reading +/-4 — adjacent edges
never overlap, so each pass vectorizes over ALL edges at once (the
design reason HEVC moved to an 8x8 grid; maps directly onto the TPU
vector unit later).

Inputs are the per-4x4-luma-cell maps the CTU walk records (intra,
luma cbf, TB/PB edge flags, MVs).  Behavioral reference:
libavcodec/hevc/filter.c (hevc_deblock, bS derivation
at ff_hevc_deblocking_boundary_strengths) — reimplemented from the
spec, validated bit-exactly against the reference decoder in
tests/test_hevc.py.

A copy of librempeg_tpu/codecs/hevc/deblock.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

import numpy as np

from librempeg_tpu_torch.codecs.hevc import recon as R

# §8.7.2.5.2 tables 8-12
_BETA = np.array([0] * 16 + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
                             17, 18, 20, 22, 24, 26, 28, 30, 32, 34,
                             36, 38, 40, 42, 44, 46, 48, 50, 52, 54,
                             56, 58, 60, 62, 64], np.int32)
_TC = np.array([0] * 18 + [1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3,
                           3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10,
                           11, 13, 14, 16, 18, 20, 22, 24], np.int32)


def compute_bs(maps, vertical: bool) -> np.ndarray:
    """Boundary strength per 4x4 luma cell for the given direction.

    maps: dict with [h4, w4] arrays: intra, cbf (luma), tuedge_v/h,
    pbedge_v/h (TB/PB left-or-top boundary flags of the cell), mv
    [h4, w4, 2, 2] per-list quarter-pel MVs, pflag [h4, w4, 2]
    per-list use flags, refpoc (pocL0, pocL1) — slice-constant with
    one reference per list — and inter (bool).
    Returns bs [h4, w4]; bs[gy, gx] describes the edge on the LEFT
    (vertical) or TOP (horizontal) side of the cell, 0 where no edge.
    """
    intra = maps["intra"]
    cbf = maps["cbf"]
    mv = maps["mv"]
    pf = maps["pflag"]
    poc0, poc1 = maps.get("refpoc", (None, None))
    inter = maps["inter"]
    h4, w4 = intra.shape
    bs = np.zeros((h4, w4), np.int32)
    if vertical:
        edge = maps["tuedge_v"] | maps["pbedge_v"]
        edge = edge & (np.arange(w4)[None, :] % 2 == 0)  # 8x8 grid
        edge[:, 0] = False                               # pic boundary
        P = lambda a: np.roll(a, 1, axis=1)
        tued = maps["tuedge_v"]
    else:
        edge = maps["tuedge_h"] | maps["pbedge_h"]
        edge = edge & (np.arange(h4)[:, None] % 2 == 0)
        edge[0, :] = False
        P = lambda a: np.roll(a, 1, axis=0)
        tued = maps["tuedge_h"]
    any_intra = intra | P(intra)
    cbf_cond = tued & (cbf | P(cbf))
    both_inter = inter & P(inter)
    # MV condition (§8.7.2.4): per-picture the reference set is
    # {refpoc[L] for used L}; with one ref per list this reduces to
    # per-cell pflags. bS 1 when the two sides use different MV counts,
    # different reference pictures, or any matched-pair component
    # differs by >= 1 integer pel.
    pfp = P(pf)
    mvp = P(mv)
    n_cur = pf[..., 0].astype(np.int32) + pf[..., 1]
    n_prv = pfp[..., 0].astype(np.int32) + pfp[..., 1]
    d_list = np.abs(mv - mvp).max(axis=3)        # [h4, w4, 2]
    d_cross0 = np.abs(mv[..., 0, :] - mvp[..., 1, :]).max(axis=2)
    d_cross1 = np.abs(mv[..., 1, :] - mvp[..., 0, :]).max(axis=2)
    # uni/uni: selected list per side (0 when pf0 else 1)
    lc = np.where(pf[..., 0], 0, 1)
    lp = np.where(pfp[..., 0], 0, 1)
    pocs = np.array([poc0 if poc0 is not None else -1,
                     poc1 if poc1 is not None else -1], np.int64)
    same_ref_uni = pocs[lc] == pocs[lp]
    d_uni = np.where(lc[..., None] == 0, mv[..., 0, :],
                     mv[..., 1, :]) \
        - np.where(lp[..., None] == 0, mvp[..., 0, :], mvp[..., 1, :])
    uni_bad = (~same_ref_uni) | (np.abs(d_uni).max(axis=2) >= 4)
    # bi/bi: both sides use both refs; straight pairing always valid,
    # cross pairing only when both lists reference the same picture
    straight_bad = d_list.max(axis=2) >= 4
    cross_bad = np.maximum(d_cross0, d_cross1) >= 4
    same_pic_pair = (poc0 is not None and poc0 == poc1)
    bi_bad = straight_bad & (cross_bad | (not same_pic_pair))
    mv_bad = np.where(n_cur != n_prv, True,
                      np.where(n_cur == 2, bi_bad, uni_bad))
    mv_cond = both_inter & mv_bad
    bs1 = (cbf_cond | mv_cond).astype(np.int32)
    bs[edge] = np.where(any_intra, 2, bs1)[edge]
    return bs


def _filter_luma_dir(y: np.ndarray, bs: np.ndarray, qp: int,
                     beta_off2: int, tc_off2: int) -> np.ndarray:
    """One direction's luma pass over the (possibly transposed) plane:
    edges are COLUMNS at x = 8k with per-4-row segments.  bs is the
    matching per-cell map ([h4, w4], edge on the cell's left)."""
    H, W = y.shape
    h4, w4 = bs.shape
    # segment list: all (gy, gx) cells with bs > 0 on an 8-aligned col
    gys, gxs = np.nonzero(bs)
    if not len(gys):
        return y
    seg_bs = bs[gys, gxs]
    x = gxs * 4                      # edge column
    rows = gys[:, None] * 4 + np.arange(4)[None, :]      # [N, 4]
    cols = x[:, None] + np.arange(-4, 4)[None, :]        # [N, 8]
    s = y[rows[:, :, None], cols[:, None, :]].astype(np.int32)
    # s: [N, 4, 8] — rows of the segment x p3 p2 p1 p0 q0 q1 q2 q3
    p3, p2, p1, p0 = s[:, :, 0], s[:, :, 1], s[:, :, 2], s[:, :, 3]
    q0, q1, q2, q3 = s[:, :, 4], s[:, :, 5], s[:, :, 6], s[:, :, 7]

    qB = np.clip(qp + (beta_off2 << 1), 0, 51)
    beta = int(_BETA[qB])
    qT = np.clip(qp + 2 * (seg_bs - 1) + (tc_off2 << 1), 0, 53)
    tc = _TC[qT]                                        # [N]

    dp = np.abs(p2 - 2 * p1 + p0)                       # [N, 4]
    dq = np.abs(q2 - 2 * q1 + q0)
    d0 = dp[:, 0] + dq[:, 0]
    d3 = dp[:, 3] + dq[:, 3]
    d = d0 + d3
    on = d < beta                                       # [N]

    def dsam(i):
        return ((2 * (dp[:, i] + dq[:, i]) < (beta >> 2))
                & (np.abs(p3[:, i] - p0[:, i])
                   + np.abs(q0[:, i] - q3[:, i]) < (beta >> 3))
                & (np.abs(p0[:, i] - q0[:, i])
                   < ((5 * tc + 1) >> 1)))

    strong = on & dsam(0) & dsam(3)                     # [N]
    weak = on & ~strong
    tcv = tc[:, None]                                   # broadcast rows

    # strong filter (§8.7.2.5.7)
    sp0 = np.clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                  p0 - 2 * tcv, p0 + 2 * tcv)
    sp1 = np.clip((p2 + p1 + p0 + q0 + 2) >> 2,
                  p1 - 2 * tcv, p1 + 2 * tcv)
    sp2 = np.clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                  p2 - 2 * tcv, p2 + 2 * tcv)
    sq0 = np.clip((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                  q0 - 2 * tcv, q0 + 2 * tcv)
    sq1 = np.clip((q2 + q1 + q0 + p0 + 2) >> 2,
                  q1 - 2 * tcv, q1 + 2 * tcv)
    sq2 = np.clip((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3,
                  q2 - 2 * tcv, q2 + 2 * tcv)

    # weak filter (§8.7.2.5.7 second half)
    dEp = (dp[:, 0] + dp[:, 3]) < ((beta + (beta >> 1)) >> 3)
    dEq = (dq[:, 0] + dq[:, 3]) < ((beta + (beta >> 1)) >> 3)
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wok = np.abs(delta) < 10 * tcv
    dlt = np.clip(delta, -tcv, tcv)
    wp0 = np.clip(p0 + dlt, 0, 255)
    wq0 = np.clip(q0 - dlt, 0, 255)
    tc2 = tcv >> 1
    dp1 = np.clip((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1, -tc2, tc2)
    wp1 = np.clip(p1 + dp1, 0, 255)
    dq1 = np.clip((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1, -tc2, tc2)
    wq1 = np.clip(q1 + dq1, 0, 255)

    sm = strong[:, None]
    wm = weak[:, None] & wok
    out = s.copy()
    out[:, :, 1] = np.where(sm, sp2, p2)
    out[:, :, 2] = np.where(sm, sp1, np.where(wm & dEp[:, None],
                                              wp1, p1))
    out[:, :, 3] = np.where(sm, sp0, np.where(wm, wp0, p0))
    out[:, :, 4] = np.where(sm, sq0, np.where(wm, wq0, q0))
    out[:, :, 5] = np.where(sm, sq1, np.where(wm & dEq[:, None],
                                              wq1, q1))
    out[:, :, 6] = np.where(sm, sq2, q2)
    # strong filter outputs are not clipped to [0,255] by the clip3
    # above alone (tc clamp can exceed range only via inputs in range:
    # means results stay in [0,255] already); write back
    y = y.copy()
    y[rows[:, :, None], cols[:, None, :]] = \
        np.clip(out, 0, 255).astype(y.dtype)
    return y


def _filter_chroma_dir(c: np.ndarray, bs2: np.ndarray, qpc: int,
                       tc_off2: int) -> np.ndarray:
    """Chroma pass (bS==2 edges only): bs2 [h4c?, .] is a per-4-chroma
    -row/8-chroma-col cell bool map aligned like the luma one; edges
    are chroma columns at 8k."""
    gys, gxs = np.nonzero(bs2)
    if not len(gys):
        return c
    qT = np.clip(qpc + 2 + (tc_off2 << 1), 0, 53)
    tc = int(_TC[qT])
    rows = gys[:, None] * 4 + np.arange(4)[None, :]
    x = gxs * 8
    cols = x[:, None] + np.arange(-2, 2)[None, :]        # p1 p0 q0 q1
    s = c[rows[:, :, None], cols[:, None, :]].astype(np.int32)
    p1, p0, q0, q1 = s[:, :, 0], s[:, :, 1], s[:, :, 2], s[:, :, 3]
    delta = np.clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc)
    out = s.copy()
    out[:, :, 1] = np.clip(p0 + delta, 0, 255)
    out[:, :, 2] = np.clip(q0 - delta, 0, 255)
    c = c.copy()
    c[rows[:, :, None], cols[:, None, :]] = out.astype(c.dtype)
    return c


def deblock_picture(pic, sps, pps, sh) -> None:
    """Filter pic.y/u/v in place (both directions, §8.7.2 order:
    every vertical edge of the picture, then every horizontal one)."""
    maps = pic.deblock_maps()
    qp = pic.qp
    bo, to = pps.beta_offset // 2, pps.tc_offset // 2

    bs_v = compute_bs(maps, vertical=True)
    pic.y = _filter_luma_dir(pic.y, bs_v, qp, bo, to)
    # chroma: bS==2 edges on the chroma 8-grid (16 luma); cell row
    # pairs collapse 2:1 (sample the even luma cell, exact because
    # intra CUs are >= 8 luma wide)
    c_v = (bs_v[::2, ::4] == 2)
    qpcb = R.chroma_qp(qp, pps.cb_qp_offset)
    qpcr = R.chroma_qp(qp, pps.cr_qp_offset)
    pic.u = _filter_chroma_dir(pic.u, c_v, qpcb, to)
    pic.v = _filter_chroma_dir(pic.v, c_v, qpcr, to)

    bs_h = compute_bs(maps, vertical=False)
    pic.y = _filter_luma_dir(pic.y.T, bs_h.T, qp, bo, to).T
    c_h = (bs_h[::4, ::2] == 2)
    pic.u = _filter_chroma_dir(pic.u.T, c_h.T, qpcb, to).T
    pic.v = _filter_chroma_dir(pic.v.T, c_h.T, qpcr, to).T
