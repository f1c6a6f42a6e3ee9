"""H.264 scattered-intra reconstruction: the intra kernel's wrapper.

Port of librempeg_tpu/codecs/h264/intra_pallas.py. The intra MBs of a
P frame are rebuilt by csrc/intra.cu, one warp per listed MB, each MB
waiting only for its intra neighbours (left, top-left, top, top-right),
which gives the planes of the spec's raster order. build_intra_scalars
folds availability into *effective* modes per MB; the kernel evaluates
the predictors directly, as the plain version (intra_scan_plain) does:
it decodes the per-MB rows back into modes and runs
device_recon._intra_scan.
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.codecs.h264 import device_recon as DR
from librempeg_tpu_torch.kernels import intra as K

_SCAL_W = 32                # scalar-prefetch row width per step

# decode order of the 16 4x4 blocks and top-right availability class
_BLK4_DEC = DR._BLK4_DEC
_ORD4 = DR._ORD4


def build_intra_scalars(ilist, kind, info, i4modes, mb_w: int, mb_h: int):
    """[n, _SCAL_W] int32 per-MB rows for the listed intra MBs.

    Row: [valid, mi, my, mx, is_i4, e16, ecm, avtr_bits, emode4[k] for
    decode-order k = 0..15, pad...]. Availability is folded into the
    effective mode indices here, so the kernel never branches on it.
    ilist: MB indices ascending, -1 entries are padding after them (the
    kernel takes the rows in this order: valid rows with strictly
    ascending MB indices, then padding)."""
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


def wait_neighbours(mi: int, mb_w: int) -> list[int]:
    """The MBs whose reconstruction the kernel lets MB `mi` wait for,
    where they are intra: left, top-left, top and top-right (top-right
    when it lies in the frame)."""
    my, mx = divmod(mi, mb_w)
    out = []
    if mx > 0:
        out.append(mi - 1)
    if my > 0:
        if mx > 0:
            out.append(mi - mb_w - 1)
        out.append(mi - mb_w)
        if mx + 1 < mb_w:
            out.append(mi - mb_w + 1)
    return out


def dependent_levels(ilist, mb_w: int) -> dict[int, int]:
    """{MB: its step} of the listed MBs under the kernel's wait: each MB
    one step after its latest intra neighbour, the first step 1. ilist:
    the listed MB indices (-1 padding is skipped)."""
    level: dict[int, int] = {}
    for m in sorted(int(x) for x in ilist if int(x) >= 0):
        level[m] = 1 + max((level[n] for n in wait_neighbours(m, mb_w)
                            if n in level), default=0)
    return level


def dependent_steps(ilist, mb_w: int) -> int:
    """The dependent steps of one intra call: the longest chain of intra
    MBs under the kernel's wait."""
    return max(dependent_levels(ilist, mb_w).values(), default=0)


def random_intra_frame(mb_w: int, mb_h: int, seed: int = 0,
                       p_intra: float = 0.4, every_mode: bool = False):
    """A random P frame before its intra pass, for tests and timing, as
    numpy: ((y, u, v) uint8, (ilist int32, kind int32, info int32,
    i4modes [nmb,16] int8, lres_t [nmb,16,16] int32, cres_t [nmb,2,8,8]
    int32)). A share p_intra of the MBs is intra, half I4x4 and half
    I16x16, with random modes; every_mode makes every MB intra, I4x4 and
    I16x16 in turn, with the luma and chroma modes cycling through all
    their values (and the 4x4 modes through all nine), so every
    predictor meets every availability case."""
    rng = np.random.default_rng(seed)
    nmb, h, w = mb_w * mb_h, mb_h * 16, mb_w * 16
    y = rng.integers(0, 256, (h, w)).astype(np.uint8)
    u = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    if every_mode:
        m = np.arange(nmb)
        kind = np.where(m % 2 == 0, 2, 3)
        info = (m // 2 % 4) | ((m // 8 % 4) << 4)
        i4modes = (np.arange(16)[None, :] + m[:, None]) % 9
    else:
        kind = np.where(rng.random(nmb) < p_intra,
                        np.where(rng.random(nmb) < 0.5, 2, 3), 0)
        info = rng.integers(0, 4, nmb) | (rng.integers(0, 4, nmb) << 4)
        i4modes = rng.integers(0, 9, (nmb, 16))
    lres = rng.integers(-30, 31, (nmb, 16, 16)).astype(np.int32)
    cres = rng.integers(-30, 31, (nmb, 2, 8, 8)).astype(np.int32)
    return (y, u, v), (np.flatnonzero(kind >= 2).astype(np.int32),
                       kind.astype(np.int32), info.astype(np.int32),
                       i4modes.astype(np.int8), lres, cres)


# effective mode -> spec mode, for the plain version
_E4_MODE = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 2, 2, 2], np.int32)
_E16_MODE = np.array([0, 1, 2, 3, 2, 2, 2], np.int32)
_ECM_MODE = np.array([0, 0, 0, 0, 1, 2, 3], np.int32)


def intra_scan_plain(y, u, v, scal, lres_t, cres_t, mb_w: int, mb_h: int,
                     order=None):
    """Plain version of the kernel: decode the scalar rows back into
    spec modes and run device_recon._intra_scan over zero-padded
    planes. Returns new (y, u, v). `order`: the schedule, as
    device_recon._intra_scan takes it (default: the list order)."""
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
                   cres, mb_w, mb_h, order=order)
    return (yp[1:H + 1, 1:W + 1].contiguous(),
            up[1:H // 2 + 1, 1:W // 2 + 1].contiguous(),
            vp[1:H // 2 + 1, 1:W // 2 + 1].contiguous())


def intra_scan_pallas(y, u, v, scal, lres_t, cres_t, mb_w: int, mb_h: int):
    """Reconstruct the MBs listed in `scal` (build_intra_scalars) over
    the pre-deblock planes y/u/v uint8. lres_t [nmb, 16, 16] MB-tile luma
    residuals (I16 DC folded), cres_t [nmb, 2, 8, 8] chroma residuals.

    CPU tensors take the plain version and get new planes back; CUDA
    tensors launch the kernel, which rebuilds the MBs IN PLACE and
    returns the same tensors."""
    if y.device.type == "cpu":
        return intra_scan_plain(y, u, v, scal, lres_t, cres_t, mb_w, mb_h)
    K.launch(y, u, v, scal.to(torch.int32).contiguous(),
             lres_t.to(torch.int32).contiguous(),
             cres_t.to(torch.int32).contiguous(), mb_w, mb_h)
    return y, u, v
