"""H.264 scattered-intra reconstruction: the intra kernel's wrapper.

Port of librempeg_tpu/codecs/h264/intra_pallas.py. The intra MBs of a
P frame are rebuilt in raster order (the spec's dependency order) by
csrc/intra.cu, one block walking the list. Every intra predictor is
affine in its neighbour samples, so each *effective* mode (availability
folded in by build_intra_scalars) is a table of coefficient rows and a
predicted sample is one dot product over the neighbour vector. The
tables below are the JAX package's, copied as numpy; the plain version
(intra_scan_plain) does not use them: it decodes the per-MB rows back
into modes and runs device_recon._intra_scan, the direct evaluation of
the predictors.
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.codecs.h264 import device_recon as DR
from librempeg_tpu_torch.kernels import intra as K

# neighbor vector component indices of device_recon's matrix layout
_J_T = 0      # t0..3
_J_TR = 4     # tr0..3
_J_L = 8      # l0..3
_J_LT = 12
_J_ONE = 13

_SCAL_W = 32                # scalar-prefetch row width per step


def _tt(i):
    """tt[i] of the spec (top extended by top-right)."""
    return _J_T + i if i < 4 else _J_TR + (i - 4)


def _build_i4_matrices() -> np.ndarray:
    """[12, 16, 14] int32: effective mode -> (pixel y*4+x) -> coeff over
    the 14-component neighbor vector, such that pred = (M[e] @ n) >> 4
    exactly reproduces §8.3.1.2 (mirrors device_recon._pred4_branches).
    Effective modes 0..8 = spec modes (DC = both-available); 9 = DC
    top-only, 10 = DC left-only, 11 = DC neither (128)."""
    M = np.zeros((12, 16, 14), np.int32)
    T, L, LT, ONE = (lambda i: _J_T + i), (lambda i: _J_L + i), \
        _J_LT, _J_ONE
    for y in range(4):
        for x in range(4):
            p = y * 4 + x
            # 0: vertical
            M[0, p, T(x)] = 16
            # 1: horizontal
            M[1, p, L(y)] = 16
            # 2: DC (both) / 9: top / 10: left / 11: 128
            for i in range(4):
                M[2, p, T(i)] += 2
                M[2, p, L(i)] += 2
                M[9, p, T(i)] += 4
                M[10, p, L(i)] += 4
            M[2, p, ONE] = 8
            M[9, p, ONE] = 8
            M[10, p, ONE] = 8
            M[11, p, ONE] = 128 * 16
            # 3: diagonal down-left
            s = x + y
            if x == 3 and y == 3:
                M[3, p, _tt(6)] += 4
                M[3, p, _tt(7)] += 12
            else:
                M[3, p, _tt(s)] += 4
                M[3, p, _tt(min(s + 1, 7))] += 8
                M[3, p, _tt(min(s + 2, 7))] += 4
            M[3, p, ONE] = 8
            # 4: diagonal down-right
            z = x - y
            if z > 0:
                M[4, p, T(z)] += 4
                M[4, p, T(z - 1)] += 8
                M[4, p, T(z - 2) if z >= 2 else LT] += 4
            elif z < 0:
                za = -z
                M[4, p, L(za)] += 4
                M[4, p, L(za - 1)] += 8
                M[4, p, L(za - 2) if za >= 2 else LT] += 4
            else:
                M[4, p, T(0)] += 4
                M[4, p, LT] += 8
                M[4, p, L(0)] += 4
            M[4, p, ONE] = 8
            # 5: vertical-right
            z = 2 * x - y
            i_ = x - (y >> 1)
            if z >= 0 and z % 2 == 0:
                M[5, p, T(i_ - 1) if i_ >= 1 else LT] += 8
                M[5, p, T(i_)] += 8
            elif z >= 0:
                a = (T(i_ - 2) if i_ >= 2 else (LT if i_ == 1 else L(0)))
                M[5, p, a] += 4
                M[5, p, T(i_ - 1) if i_ >= 1 else LT] += 8
                M[5, p, T(i_)] += 4
            elif z == -1:
                M[5, p, L(0)] += 4
                M[5, p, LT] += 8
                M[5, p, T(0)] += 4
            else:
                M[5, p, L(min(max(y - 1, 0), 3))] += 4
                M[5, p, L(min(max(y - 2, 0), 3))] += 8
                M[5, p, L(y - 3) if y - 3 >= 0 else LT] += 4
            M[5, p, ONE] = 8
            # 6: horizontal-down (VR mirrored)
            z = 2 * y - x
            i_ = y - (x >> 1)
            if z >= 0 and z % 2 == 0:
                M[6, p, L(i_ - 1) if i_ >= 1 else LT] += 8
                M[6, p, L(i_)] += 8
            elif z >= 0:
                a = (L(i_ - 2) if i_ >= 2 else (LT if i_ == 1 else T(0)))
                M[6, p, a] += 4
                M[6, p, L(i_ - 1) if i_ >= 1 else LT] += 8
                M[6, p, L(i_)] += 4
            elif z == -1:
                M[6, p, T(0)] += 4
                M[6, p, LT] += 8
                M[6, p, L(0)] += 4
            else:
                M[6, p, T(min(max(x - 1, 0), 3))] += 4
                M[6, p, T(min(max(x - 2, 0), 3))] += 8
                M[6, p, T(x - 3) if x - 3 >= 0 else LT] += 4
            M[6, p, ONE] = 8
            # 7: vertical-left
            i_ = x + (y >> 1)
            if y % 2 == 0:
                M[7, p, _tt(min(i_, 7))] += 8
                M[7, p, _tt(min(i_ + 1, 7))] += 8
            else:
                M[7, p, _tt(min(i_, 7))] += 4
                M[7, p, _tt(min(i_ + 1, 7))] += 8
                M[7, p, _tt(min(i_ + 2, 7))] += 4
            M[7, p, ONE] = 8
            # 8: horizontal-up
            z = x + 2 * y
            i_ = y + (x >> 1)
            if z > 5:
                M[8, p, L(3)] += 16
            elif z == 5:
                M[8, p, L(2)] += 4
                M[8, p, L(3)] += 12
                M[8, p, ONE] = 8
            elif z % 2 == 0:
                M[8, p, L(min(i_, 3))] += 8
                M[8, p, L(min(i_ + 1, 3))] += 8
                M[8, p, ONE] = 8
            else:
                M[8, p, L(min(i_, 3))] += 4
                M[8, p, L(min(i_ + 1, 3))] += 8
                M[8, p, L(min(i_ + 2, 3))] += 4
                M[8, p, ONE] = 8
    return M


# ---------------------------------------------------------------------------
# coefficient-row tables: row index = mode * stride + input index,
# lanes = output pixels (+ aux outputs); kernel does one madd per input
# ---------------------------------------------------------------------------
# Intra_4x4: inputs (kernel madd index c) 0 = lt, 1..4 = t0..3,
# 5..8 = tr0..3, 9..12 = l0..3, 13 = bias; output lanes 0..15 = y*4+x.
_I4_NIN = 14
_I4_STRIDE = 16


def _build_t4_tab() -> np.ndarray:
    M = _build_i4_matrices()                     # [12, 16, 14]
    tab = np.zeros((12 * _I4_STRIDE, 256), np.int32)
    jmap = {0: _J_LT, 13: _J_ONE}
    for i in range(4):
        jmap[1 + i] = _J_T + i
        jmap[5 + i] = _J_TR + i
        jmap[9 + i] = _J_L + i
    for e in range(12):
        for c in range(_I4_NIN):
            tab[e * _I4_STRIDE + c, 0:16] = M[e, :, jmap[c]]
    return tab


# Intra_16x16: inputs 0 = lt, 1..16 = t0..15, 17..32 = l0..15,
# 33 = bias; output lanes 0..255 = y*16+x (pred, >>5), aux lanes
# 256 = H, 257 = V, 258 = corner-a (raw, plane mode §8.3.3.4).
# Effective modes: 0 = V, 1 = H, 2 = DC both, 3 = plane (aux only),
# 4 = DC top, 5 = DC left, 6 = DC none.
_I16_NIN = 34
_I16_STRIDE = 40


def _build_t16_tab() -> np.ndarray:
    tab = np.zeros((7 * _I16_STRIDE, 384), np.int32)
    for e in range(7):
        base = e * _I16_STRIDE
        for y in range(16):
            for x in range(16):
                p = y * 16 + x
                if e == 0:
                    tab[base + 1 + x, p] = 32
                elif e == 1:
                    tab[base + 17 + y, p] = 32
                elif e == 2:
                    for i in range(16):
                        tab[base + 1 + i, p] += 1
                        tab[base + 17 + i, p] += 1
                    tab[base + _I16_NIN - 1, p] = 16
                elif e == 4:
                    for i in range(16):
                        tab[base + 1 + i, p] += 2
                    tab[base + _I16_NIN - 1, p] = 16
                elif e == 5:
                    for i in range(16):
                        tab[base + 17 + i, p] += 2
                    tab[base + _I16_NIN - 1, p] = 16
                elif e == 6:
                    tab[base + _I16_NIN - 1, p] = 128 * 32
        # aux (all modes): H at 256, V at 257, a at 258
        for x in range(16):
            tab[base + 1 + x, 256] = x - 7
            tab[base + 17 + x, 257] = x - 7
        tab[base + 0, 256] = -8
        tab[base + 0, 257] = -8
        tab[base + 1 + 15, 258] = 16
        tab[base + 17 + 15, 258] = 16
    return tab


# Chroma 8x8: inputs 0 = lt, 1..8 = t0..7, 9..16 = l0..7, 17 = bias;
# output lanes 0..63 = y*8+x (pred, >>5), aux 64 = H, 65 = V, 66 = a.
# Effective modes: 0 = DC both, 1 = DC top, 2 = DC left, 3 = DC none,
# 4 = H, 5 = V, 6 = plane (aux only). DC quadrant preferences of
# §8.3.4.1-3 are folded per variant.
_C_NIN = 18
_C_STRIDE = 24


def _build_c_tab() -> np.ndarray:
    tab = np.zeros((7 * _C_STRIDE, 256), np.int32)

    def add_quad(base, qy, qx, kind, half_t, half_l):
        # kind: 'b' = (ts+ls+4)>>3, 't' = (ts+2)>>2, 'l' = (ls+2)>>2,
        # 'n' = 128; all expressed at >>5 scale
        for y in range(4 * qy, 4 * qy + 4):
            for x in range(4 * qx, 4 * qx + 4):
                p = y * 8 + x
                if kind == "b":
                    for i in range(4):
                        tab[base + 1 + 4 * half_t + i, p] += 4
                        tab[base + 9 + 4 * half_l + i, p] += 4
                    tab[base + _C_NIN - 1, p] += 16
                elif kind == "t":
                    for i in range(4):
                        tab[base + 1 + 4 * half_t + i, p] += 8
                    tab[base + _C_NIN - 1, p] += 16
                elif kind == "l":
                    for i in range(4):
                        tab[base + 9 + 4 * half_l + i, p] += 8
                    tab[base + _C_NIN - 1, p] += 16
                else:
                    tab[base + _C_NIN - 1, p] += 128 * 32

    for e in range(7):
        base = e * _C_STRIDE
        if e == 0:                                 # DC, both available
            add_quad(base, 0, 0, "b", 0, 0)
            add_quad(base, 0, 1, "t", 1, 0)
            add_quad(base, 1, 0, "l", 0, 1)
            add_quad(base, 1, 1, "b", 1, 1)
        elif e == 1:                               # DC, top only
            add_quad(base, 0, 0, "t", 0, 0)
            add_quad(base, 0, 1, "t", 1, 0)
            add_quad(base, 1, 0, "t", 0, 1)
            add_quad(base, 1, 1, "t", 1, 1)
        elif e == 2:                               # DC, left only
            add_quad(base, 0, 0, "l", 0, 0)
            add_quad(base, 0, 1, "l", 0, 0)
            add_quad(base, 1, 0, "l", 0, 1)
            add_quad(base, 1, 1, "l", 0, 1)
        elif e == 3:                               # DC, none
            for q in ((0, 0), (0, 1), (1, 0), (1, 1)):
                add_quad(base, q[0], q[1], "n", 0, 0)
        elif e == 4:                               # horizontal
            for y in range(8):
                for x in range(8):
                    tab[base + 9 + y, y * 8 + x] = 32
        elif e == 5:                               # vertical
            for y in range(8):
                for x in range(8):
                    tab[base + 1 + x, y * 8 + x] = 32
        # aux (all modes)
        for x in range(8):
            tab[base + 1 + x, 64] = x - 3
            tab[base + 9 + x, 65] = x - 3
        tab[base + 0, 64] = -4
        tab[base + 0, 65] = -4
        tab[base + 1 + 7, 66] = 16
        tab[base + 9 + 7, 66] = 16
    return tab


_T4TAB = _build_t4_tab()
_T16TAB = _build_t16_tab()
_CTAB = _build_c_tab()

# decode order of the 16 4x4 blocks and top-right availability class
_BLK4_DEC = DR._BLK4_DEC
_ORD4 = DR._ORD4


def build_intra_scalars(ilist, kind, info, i4modes, mb_w: int, mb_h: int):
    """[n, _SCAL_W] int32 per-MB rows for the listed intra MBs.

    Row: [valid, mi, my, mx, is_i4, e16, ecm, avtr_bits, emode4[k] for
    decode-order k = 0..15, pad...]. Availability is folded into the
    effective mode indices here, so the kernel never branches on it.
    ilist: MB indices ascending, -1 entries are padding."""
    m = ilist.to(torch.int32)
    valid = (m >= 0).to(torch.int32)
    mi = m.clamp(min=0)
    mil = mi.long()
    my = mi // mb_w
    mx = mi % mb_w
    avt = (my > 0).to(torch.int32)
    avl = (mx > 0).to(torch.int32)
    kindm = kind[mil].to(torch.int32)
    infom = info[mil].to(torch.int32)
    is_i4 = (kindm == 2).to(torch.int32)

    def pick(mode, dc, e_both, e_top, e_left, e_none, t, lf):
        """Replace spec DC `dc` by its availability variant."""
        var = torch.where((t & lf) == 1, e_both,
                          torch.where(t == 1, e_top,
                                      torch.where(lf == 1, e_left, e_none)))
        return torch.where(mode == dc, var.to(mode.dtype), mode)

    m16 = (infom & 15).clamp(0, 3)
    e16 = pick(m16, 2, 2, 4, 5, 6, avt, avl)
    # chroma effective mode: DC -> availability variant; H->4 V->5
    # plane->6 (raw cmode: 0=DC 1=H 2=V 3=plane, §8.3.4)
    cmode = ((infom >> 4) & 15).clamp(0, 3)
    ecm = torch.where(cmode == 0, pick(cmode, 0, 0, 1, 2, 3, avt, avl),
                      cmode + 3)
    cols = [valid, mi, my, mx, is_i4, e16, ecm]
    avtr_bits = torch.zeros_like(mi)
    emodes = []
    one = torch.ones_like(avt)
    for k, (by, bx) in enumerate(_BLK4_DEC):
        if by > 0 and bx < 3:
            tr_ok = bool(_ORD4[(by - 1) * 4 + bx + 1] < _ORD4[by * 4 + bx])
            av_tr = torch.full_like(mi, int(tr_ok))
        elif by > 0:
            av_tr = torch.zeros_like(mi)
        elif bx < 3:
            av_tr = avt
        else:
            av_tr = avt & (mx + 1 < mb_w).to(torch.int32)
        avtr_bits = avtr_bits | (av_tr << k)
        avt_b = one if by > 0 else avt
        avl_b = one if bx > 0 else avl
        mode = i4modes[mil, by * 4 + bx].to(torch.int32).clamp(0, 8)
        emodes.append(pick(mode, 2, 2, 9, 10, 11, avt_b, avl_b))
    rows = torch.stack(cols + [avtr_bits] + emodes, dim=1)   # [n, 24]
    return torch.nn.functional.pad(rows, (0, _SCAL_W - rows.shape[1]))


# effective mode -> spec mode, for the plain version
_E4_MODE = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 2, 2, 2], np.int32)
_E16_MODE = np.array([0, 1, 2, 3, 2, 2, 2], np.int32)
_ECM_MODE = np.array([0, 0, 0, 0, 1, 2, 3], np.int32)


def intra_scan_plain(y, u, v, scal, lres_t, cres_t, mb_w: int, mb_h: int):
    """Plain version of the kernel: decode the scalar rows back into
    spec modes and run device_recon._intra_scan over zero-padded
    planes. Returns new (y, u, v)."""
    H, W = mb_h * 16, mb_w * 16
    nmb = mb_w * mb_h
    dev = y.device
    rows = scal.cpu().numpy()
    rows = rows[rows[:, 0] == 1]
    mis = rows[:, 1].astype(np.int64)
    kind = np.zeros(nmb, np.int32)
    info = np.zeros(nmb, np.int32)
    i4modes = np.zeros((nmb, 16), np.int32)
    kind[mis] = np.where(rows[:, 4] == 1, 2, 3)
    info[mis] = _E16_MODE[rows[:, 5]] | (_ECM_MODE[rows[:, 6]] << 4)
    raster = [by * 4 + bx for by, bx in _BLK4_DEC]
    i4modes[mis[:, None], np.array(raster)[None, :]] = \
        _E4_MODE[rows[:, 8:24]]
    lres = lres_t.reshape(nmb, 4, 4, 4, 4).permute(0, 1, 3, 2, 4) \
        .reshape(nmb, 16, 4, 4)
    cres = cres_t.reshape(nmb, 2, 2, 4, 2, 4).permute(0, 1, 2, 4, 3, 5)
    pad = (1, 8, 1, 8)
    yp = torch.nn.functional.pad(y, pad)
    up = torch.nn.functional.pad(u, pad)
    vp = torch.nn.functional.pad(v, pad)

    def t(a):
        return torch.as_tensor(a, device=dev)

    DR._intra_scan(yp, up, vp, t(mis), t(kind), t(info), t(i4modes), lres,
                   cres, mb_w, mb_h)
    return (yp[1:H + 1, 1:W + 1].contiguous(),
            up[1:H // 2 + 1, 1:W // 2 + 1].contiguous(),
            vp[1:H // 2 + 1, 1:W // 2 + 1].contiguous())


_TABLES: dict = {}


def _tables(dev):
    key = str(dev)
    if key not in _TABLES:
        _TABLES[key] = tuple(torch.as_tensor(a, device=dev)
                             for a in (_T4TAB, _T16TAB, _CTAB))
    return _TABLES[key]


def intra_scan_pallas(y, u, v, scal, lres_t, cres_t, mb_w: int, mb_h: int):
    """Reconstruct the MBs listed in `scal` (build_intra_scalars) over
    the pre-deblock planes y/u/v uint8. lres_t [nmb, 16, 16] MB-tile luma
    residuals (I16 DC folded), cres_t [nmb, 2, 8, 8] chroma residuals.

    CPU tensors take the plain version and get new planes back; CUDA
    tensors launch the kernel, which rebuilds the MBs IN PLACE and
    returns the same tensors."""
    if y.device.type == "cpu":
        return intra_scan_plain(y, u, v, scal, lres_t, cres_t, mb_w, mb_h)
    t4, t16, tc = _tables(y.device)
    K.launch(y, u, v, scal.to(torch.int32).contiguous(), t4, t16, tc,
             lres_t.to(torch.int32).contiguous(),
             cres_t.to(torch.int32).contiguous(), mb_w, mb_h)
    return y, u, v
