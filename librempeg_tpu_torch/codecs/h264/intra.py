"""H.264 I_16x16 intra codec: minimal valid encoder + matching decoder.

Analog of the reference's h264 I-slice path (h264dec.c + h264_cavlc.c +
h264_mb.c) at the round-1 feature point: IDR I-slices, all macroblocks
I_16x16 with DC luma prediction and DC chroma prediction, CAVLC, fixed
QP, deblocking signalled off. The point of the pair: our encoder's
streams are decodable by the REFERENCE h264 decoder (validated in
tests), giving the H.264 layer a cross-checked foundation to grow on
(more pred modes, P slices, CABAC are additive).

Transforms follow ISO 14496-10 §8.5 (4x4 integer core + luma 4x4 / chroma
2x2 Hadamard DC), quantization §8.5.9 with the standard MF/V tables.
"""
from __future__ import annotations

import numpy as np

from librempeg_tpu_torch.codecs.flac.bitio import BitReaderMSB, BitWriterMSB
from librempeg_tpu_torch.codecs.h264.cavlc import ZIGZAG4, read_residual, write_residual
from librempeg_tpu_torch.core.errors import InvalidData, Unsupported

# quant multiplier/rescale tables (§8.5.9, positions a/b/c by parity)
_MF = [[13107, 5243, 8066], [11916, 4660, 7490], [10082, 4194, 6554],
       [9362, 3647, 5825], [8192, 3355, 5243], [7282, 2893, 4559]]
_V = [[10, 16, 13], [11, 18, 14], [13, 20, 16], [14, 23, 18],
      [16, 25, 20], [18, 29, 23]]


def _pos_class() -> np.ndarray:
    p = np.zeros((4, 4), np.int32)
    for i in range(4):
        for j in range(4):
            if i % 2 == 0 and j % 2 == 0:
                p[i, j] = 0
            elif i % 2 == 1 and j % 2 == 1:
                p[i, j] = 1
            else:
                p[i, j] = 2
    return p


_POS = _pos_class()

# chroma QP mapping (Table 8-15, 8-bit depth)
CHROMA_QP = (list(range(30))
             + [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37,
                37, 38, 38, 38, 39, 39, 39, 39])


def chroma_qp_of(qp: int, off: int = 0) -> int:
    return CHROMA_QP[min(51, max(0, qp + off))]
_CF = np.array([[1, 1, 1, 1], [2, 1, -1, -2], [1, -1, -1, 1],
                [1, -2, 2, -1]], np.int64)
_H4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1],
                [1, -1, 1, -1]], np.int64)
_H2 = np.array([[1, 1], [1, -1]], np.int64)

# block index -> (row4, col4) within the MB (§6.4.3 4x4 scan)
_BLK4 = [(0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (0, 3), (1, 2), (1, 3),
         (2, 0), (2, 1), (3, 0), (3, 1), (2, 2), (2, 3), (3, 2), (3, 3)]


def fwd4(x: np.ndarray) -> np.ndarray:
    return _CF @ x @ _CF.T


def inv4(w: np.ndarray) -> np.ndarray:
    """Inverse core transform (§8.5.12.2 butterflies), includes +32>>6."""
    d = w.astype(np.int64)
    # horizontal
    e0 = d[:, 0] + d[:, 2]
    e1 = d[:, 0] - d[:, 2]
    e2 = (d[:, 1] >> 1) - d[:, 3]
    e3 = d[:, 1] + (d[:, 3] >> 1)
    h = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=1)
    # vertical
    e0 = h[0] + h[2]
    e1 = h[0] - h[2]
    e2 = (h[1] >> 1) - h[3]
    e3 = h[1] + (h[3] >> 1)
    v = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=0)
    return (v + 32) >> 6


def quant4(w: np.ndarray, qp: int, intra: bool = True) -> np.ndarray:
    qbits = 15 + qp // 6
    f = (1 << qbits) // 3 if intra else (1 << qbits) // 6
    mf = np.array(_MF[qp % 6])[_POS]
    return (np.sign(w) * ((np.abs(w) * mf + f) >> qbits)).astype(np.int64)


def dequant4_ac(lev: np.ndarray, qp: int) -> np.ndarray:
    v = np.array(_V[qp % 6])[_POS]
    return (lev.astype(np.int64) * v) << (qp // 6)


def quant_dc(wdc: np.ndarray, qp: int) -> np.ndarray:
    qbits = 15 + qp // 6
    f = (1 << qbits) // 3
    mf = _MF[qp % 6][0]
    return (np.sign(wdc) * ((np.abs(wdc) * mf + 2 * f) >> (qbits + 1))
            ).astype(np.int64)


def dequant_luma_dc(f: np.ndarray, qp: int) -> np.ndarray:
    """Luma-DC rescale (§8.5.10; calibrated against the reference
    decoder together with the forward Hadamard's //2)."""
    v = _V[qp % 6][0]
    if qp >= 12:
        return (f * v) << (qp // 6 - 2)
    return (f * v + (1 << (1 - qp // 6))) >> (2 - qp // 6)


def dequant_chroma_dc(f: np.ndarray, qp: int) -> np.ndarray:
    v = _V[qp % 6][0]
    return ((f * v) << (qp // 6)) >> 1


class _NcCtx:
    """total_coeff context grid for nC computation (§9.2.1)."""

    def __init__(self, bh: int, bw: int):
        self.t = np.full((bh, bw), -1, np.int32)  # -1 = unavailable

    def nc(self, by: int, bx: int) -> int:
        na = self.t[by, bx - 1] if bx > 0 else -1
        nb = self.t[by - 1, bx] if by > 0 else -1
        if na >= 0 and nb >= 0:
            return (na + nb + 1) >> 1
        if na >= 0:
            return int(na)
        if nb >= 0:
            return int(nb)
        return 0

    def set(self, by: int, bx: int, total: int) -> None:
        self.t[by, bx] = total


def _write_ue(bw: BitWriterMSB, v: int):
    k = v + 1
    n = k.bit_length()
    bw.write(0, n - 1)
    bw.write(k, n)


def _write_se(bw: BitWriterMSB, v: int):
    _write_ue(bw, 2 * v - 1 if v > 0 else -2 * v)


def _rbsp_to_nal(rbsp: bytes, nal_type: int, ref_idc: int) -> bytes:
    """Add emulation prevention + NAL header + start code."""
    out = bytearray([0, 0, 0, 1, (ref_idc << 5) | nal_type])
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def build_sps(mb_w: int, mb_h: int, reorder: int = 0,
              crop_r: int = 0, crop_b: int = 0) -> bytes:
    """reorder > 0 (B frames) switches to main profile and signals
    max_num_reorder_frames through the VUI bitstream restriction.
    crop_r/crop_b: right/bottom crop in luma samples (even; 4:2:0 crop
    units are 2) for non-16-aligned display sizes (§7.4.2.1.1)."""
    bw = BitWriterMSB()
    bw.write(77 if reorder else 66, 8)   # main / baseline
    bw.write(0, 8)
    bw.write(30, 8)      # level 3.0
    _write_ue(bw, 0)     # sps id
    _write_ue(bw, 0)     # log2_max_frame_num - 4
    _write_ue(bw, 0)     # poc type 0
    _write_ue(bw, 4)     # log2_max_poc_lsb - 4  (= 8 bits)
    _write_ue(bw, 2 if reorder else 1)   # max refs
    bw.write(0, 1)
    _write_ue(bw, mb_w - 1)
    _write_ue(bw, mb_h - 1)
    bw.write(1, 1)       # frame_mbs_only
    bw.write(1, 1)       # direct_8x8
    if crop_r or crop_b:
        bw.write(1, 1)   # frame_cropping
        _write_ue(bw, 0)             # left
        _write_ue(bw, crop_r // 2)   # right (crop unit 2 in 4:2:0)
        _write_ue(bw, 0)             # top
        _write_ue(bw, crop_b // 2)   # bottom
    else:
        bw.write(0, 1)   # no crop
    if reorder:
        bw.write(1, 1)   # vui present
        bw.write(0, 1)   # aspect_ratio_info
        bw.write(0, 1)   # overscan
        bw.write(0, 1)   # video_signal_type
        bw.write(0, 1)   # chroma_loc
        bw.write(0, 1)   # timing_info
        bw.write(0, 1)   # nal_hrd
        bw.write(0, 1)   # vcl_hrd
        bw.write(0, 1)   # pic_struct
        bw.write(1, 1)   # bitstream_restriction
        bw.write(1, 1)   # motion_vectors_over_pic_boundaries
        _write_ue(bw, 0)
        _write_ue(bw, 0)
        _write_ue(bw, 16)
        _write_ue(bw, 16)
        _write_ue(bw, reorder)           # max_num_reorder_frames
        _write_ue(bw, reorder + 1)       # max_dec_frame_buffering
    else:
        bw.write(0, 1)   # no vui
    bw.write(1, 1)       # rbsp stop
    bw.align()
    return _rbsp_to_nal(bw.bytes(), 7, 3)


def build_pps() -> bytes:
    bw = BitWriterMSB()
    _write_ue(bw, 0)
    _write_ue(bw, 0)
    bw.write(0, 1)       # cavlc
    bw.write(0, 1)       # no pic_order_present
    _write_ue(bw, 0)     # 1 slice group
    _write_ue(bw, 0)
    _write_ue(bw, 0)
    bw.write(0, 1)
    bw.write(0, 2)
    _write_se(bw, 0)     # pic_init_qp = 26
    _write_se(bw, 0)
    _write_se(bw, 0)     # chroma_qp_offset
    bw.write(1, 1)       # deblocking_filter_control_present
    bw.write(0, 1)
    bw.write(0, 1)
    bw.write(1, 1)       # stop
    bw.align()
    return _rbsp_to_nal(bw.bytes(), 8, 3)


def encode_idr(y: np.ndarray, u: np.ndarray, v: np.ndarray, qp: int = 26,
               frame_idx: int = 0, deblock: bool = False,
               return_recon: bool = False):
    """One IDR slice NAL (I_16x16 / CAVLC), 16-aligned planes."""
    h, w = y.shape
    mb_h, mb_w = h // 16, w // 16
    bw = BitWriterMSB()
    # slice header
    _write_ue(bw, 0)                 # first_mb
    _write_ue(bw, 7)                 # slice_type I (all)
    _write_ue(bw, 0)                 # pps id
    bw.write(0, 4)                   # frame_num
    _write_ue(bw, frame_idx % 16)    # idr_pic_id
    bw.write(0, 8)                   # poc lsb (8-bit per build_sps)
    bw.write(0, 1)                   # no_output_of_prior_pics
    bw.write(0, 1)                   # long_term_reference
    _write_se(bw, qp - 26)           # slice_qp_delta
    if deblock:
        _write_ue(bw, 0)             # disable_deblocking_filter_idc = 0
        _write_se(bw, 0)             # alpha offset
        _write_se(bw, 0)             # beta offset
    else:
        _write_ue(bw, 1)             # deblocking off

    recon_y = np.zeros_like(y, np.int64)
    recon_u = np.zeros_like(u, np.int64)
    recon_v = np.zeros_like(v, np.int64)
    ncY = _NcCtx(mb_h * 4, mb_w * 4)
    ncU = _NcCtx(mb_h * 2, mb_w * 2)
    ncV = _NcCtx(mb_h * 2, mb_w * 2)

    for my in range(mb_h):
        for mx in range(mb_w):
            _encode_mb(bw, y, u, v, recon_y, recon_u, recon_v,
                       my, mx, qp, ncY, ncU, ncV)
    bw.write(1, 1)                   # rbsp stop
    bw.align()
    nal = _rbsp_to_nal(bw.bytes(), 5, 3)
    recon = (recon_y.astype(np.uint8), recon_u.astype(np.uint8),
             recon_v.astype(np.uint8))
    return (nal, recon) if return_recon else nal


def _dc_pred16(recon, my, mx):
    top = recon[my * 16 - 1, mx * 16:mx * 16 + 16] if my > 0 else None
    left = recon[my * 16:my * 16 + 16, mx * 16 - 1] if mx > 0 else None
    if top is not None and left is not None:
        return int((top.sum() + left.sum() + 16) >> 5)
    if top is not None:
        return int((top.sum() + 8) >> 4)
    if left is not None:
        return int((left.sum() + 8) >> 4)
    return 128


def _pred16(recon, my, mx, mode):
    """Full-MB Intra_16x16 prediction (§8.3.3): 0=V, 1=H, 2=DC, 3=Plane.
    Returns a [16,16] int64 array; caller checks availability."""
    top = recon[my * 16 - 1, mx * 16:mx * 16 + 16].astype(np.int64) \
        if my > 0 else None
    left = recon[my * 16:my * 16 + 16, mx * 16 - 1].astype(np.int64) \
        if mx > 0 else None
    if mode == 0:                                       # vertical
        return np.broadcast_to(top, (16, 16)).copy()
    if mode == 1:                                       # horizontal
        return np.broadcast_to(left[:, None], (16, 16)).copy()
    if mode == 2:                                       # DC
        return np.full((16, 16), _dc_pred16(recon, my, mx), np.int64)
    # plane: needs top, left AND top-left
    tl = int(recon[my * 16 - 1, mx * 16 - 1])
    i = np.arange(1, 9, dtype=np.int64)
    hsum = int(np.sum(i * (top[7 + i]
                           - np.where(7 - i >= 0, top[np.maximum(7 - i, 0)],
                                      tl))))
    vsum = int(np.sum(i * (left[7 + i]
                           - np.where(7 - i >= 0, left[np.maximum(7 - i, 0)],
                                      tl))))
    a = 16 * (int(left[15]) + int(top[15]))
    b = (5 * hsum + 32) >> 6
    c = (5 * vsum + 32) >> 6
    x = np.arange(16, dtype=np.int64)
    y = np.arange(16, dtype=np.int64)
    out = (a + b * (x[None, :] - 7) + c * (y[:, None] - 7) + 16) >> 5
    return np.clip(out, 0, 255)


def _modes16_available(my, mx):
    """Candidate Intra_16x16 modes given neighbor availability."""
    modes = [2]                     # DC always
    if my > 0:
        modes.append(0)             # vertical
    if mx > 0:
        modes.append(1)             # horizontal
    if my > 0 and mx > 0:
        modes.append(3)             # plane
    return modes


def _dc_pred8(recon, my, mx):
    """Chroma DC prediction per 4x4 quadrant (§8.3.4.1, mode DC)."""
    base_y, base_x = my * 8, mx * 8
    pred = np.zeros((8, 8), np.int64)
    top = recon[base_y - 1, base_x:base_x + 8] if my > 0 else None
    left = recon[base_y:base_y + 8, base_x - 1] if mx > 0 else None
    for qy in range(2):
        for qx in range(2):
            t = top[qx * 4:qx * 4 + 4] if top is not None else None
            l_ = left[qy * 4:qy * 4 + 4] if left is not None else None
            if qy == 0 and qx == 1:      # prefers its own top
                if t is not None:
                    val = (t.sum() + 2) >> 2
                elif l_ is not None:
                    val = (l_.sum() + 2) >> 2
                else:
                    val = 128
            elif qy == 1 and qx == 0:    # prefers its own left
                if l_ is not None:
                    val = (l_.sum() + 2) >> 2
                elif t is not None:
                    val = (t.sum() + 2) >> 2
                else:
                    val = 128
            else:
                if t is not None and l_ is not None:
                    val = (t.sum() + l_.sum() + 4) >> 3
                elif t is not None:
                    val = (t.sum() + 2) >> 2
                elif l_ is not None:
                    val = (l_.sum() + 2) >> 2
                else:
                    val = 128
            pred[qy * 4:qy * 4 + 4, qx * 4:qx * 4 + 4] = val
    return pred


def _pred8(recon, my, mx, mode):
    """8x8 chroma intra prediction (§8.3.4): 0=DC(quadrant), 1=H, 2=V,
    3=Plane — note the chroma mode numbering differs from luma."""
    if mode == 0:
        return _dc_pred8(recon, my, mx)
    top = recon[my * 8 - 1, mx * 8:mx * 8 + 8].astype(np.int64) \
        if my > 0 else None
    left = recon[my * 8:my * 8 + 8, mx * 8 - 1].astype(np.int64) \
        if mx > 0 else None
    if mode == 1:                                   # horizontal
        return np.broadcast_to(left[:, None], (8, 8)).copy()
    if mode == 2:                                   # vertical
        return np.broadcast_to(top, (8, 8)).copy()
    tl = int(recon[my * 8 - 1, mx * 8 - 1])         # plane
    i = np.arange(1, 5, dtype=np.int64)
    hsum = int(np.sum(i * (top[3 + i]
                           - np.where(3 - i >= 0, top[np.maximum(3 - i, 0)],
                                      tl))))
    vsum = int(np.sum(i * (left[3 + i]
                           - np.where(3 - i >= 0, left[np.maximum(3 - i, 0)],
                                      tl))))
    a = 16 * (int(left[7]) + int(top[7]))
    b = (17 * hsum + 16) >> 5
    c = (17 * vsum + 16) >> 5
    x = np.arange(8, dtype=np.int64)
    y = np.arange(8, dtype=np.int64)
    out = (a + b * (x[None, :] - 3) + c * (y[:, None] - 3) + 16) >> 5
    return np.clip(out, 0, 255)


def _modes8_available(my, mx):
    modes = [0]                     # DC always
    if mx > 0:
        modes.append(1)             # horizontal
    if my > 0:
        modes.append(2)             # vertical
    if my > 0 and mx > 0:
        modes.append(3)             # plane
    return modes


def _encode_mb(bw, y, u, v, ry, ru, rv, my, mx, qp, ncY, ncU, ncV,
               mb_type_offset=0, chroma_qp=None):
    cqp = chroma_qp if chroma_qp is not None else chroma_qp_of(qp)
    # ---- luma: pick the lowest-SAD Intra_16x16 mode (V/H/DC/Plane)
    src = y[my * 16:(my + 1) * 16, mx * 16:(mx + 1) * 16].astype(np.int64)
    best_mode, pred, best_sad = 2, None, None
    for mode in _modes16_available(my, mx):
        p = _pred16(ry, my, mx, mode)
        sad = int(np.abs(src - p).sum())
        if best_sad is None or sad < best_sad:
            best_mode, pred, best_sad = mode, p, sad
    resid = src - pred
    w16 = np.zeros((4, 4, 4, 4), np.int64)       # [by][bx][4][4]
    for by in range(4):
        for bx in range(4):
            w16[by, bx] = fwd4(resid[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4])
    wdc = w16[:, :, 0, 0]
    ydc = (_H4 @ wdc @ _H4) // 2     # forward luma DC hadamard is scaled
    dc_lev = quant_dc(ydc, qp)
    ac_lev = np.zeros((4, 4, 4, 4), np.int64)
    for by in range(4):
        for bx in range(4):
            ac_lev[by, bx] = quant4(w16[by, bx], qp)
            ac_lev[by, bx, 0, 0] = 0
    cbp_luma = 15 if np.any(ac_lev) else 0

    # ---- chroma: one shared mode for u+v, picked by joint SAD
    src_c = {n: p[my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8].astype(np.int64)
             for n, p in (("u", u), ("v", v))}
    best_cmode, best_csad = 0, None
    for mode in _modes8_available(my, mx):
        sad = int(np.abs(src_c["u"] - _pred8(ru, my, mx, mode)).sum()
                  + np.abs(src_c["v"] - _pred8(rv, my, mx, mode)).sum())
        if best_csad is None or sad < best_csad:
            best_cmode, best_csad = mode, sad
    cp = {}
    c_lev = {}
    c_dc = {}
    for name, plane, rec in (("u", u, ru), ("v", v, rv)):
        predc = _pred8(rec, my, mx, best_cmode)
        srcc = src_c[name]
        residc = srcc - predc
        wc = np.zeros((2, 2, 4, 4), np.int64)
        for by in range(2):
            for bx in range(2):
                wc[by, bx] = fwd4(residc[by * 4:by * 4 + 4,
                                         bx * 4:bx * 4 + 4])
        cdc = _H2 @ wc[:, :, 0, 0] @ _H2
        c_dc[name] = quant_dc(cdc, cqp)
        lev = np.zeros((2, 2, 4, 4), np.int64)
        for by in range(2):
            for bx in range(2):
                lev[by, bx] = quant4(wc[by, bx], cqp)
                lev[by, bx, 0, 0] = 0
        c_lev[name] = lev
        cp[name] = predc
    has_cdc = np.any(c_dc["u"]) or np.any(c_dc["v"])
    has_cac = np.any(c_lev["u"]) or np.any(c_lev["v"])
    cbp_chroma = 2 if has_cac else (1 if has_cdc else 0)

    # ---- mb_type: I_16x16 with the chosen prediction mode
    mb_type = 1 + best_mode + 4 * cbp_chroma + 12 * (1 if cbp_luma else 0)
    _write_ue(bw, mb_type_offset + mb_type)
    _write_ue(bw, best_cmode)        # intra_chroma_pred_mode
    _write_se(bw, 0)                 # mb_qp_delta

    # ---- residuals: luma DC (16 coeffs, zigzag over the 4x4 DC grid)
    nc0 = ncY.nc(my * 4, mx * 4)
    dc_zz = dc_lev.reshape(-1)[ZIGZAG4]
    write_residual(bw, dc_zz, nc0)
    # luma AC blocks in §6.4.3 order (15 coeffs each, skipping DC)
    if cbp_luma:
        for blk in range(16):
            by, bx = _BLK4[blk]
            gy, gx = my * 4 + by, mx * 4 + bx
            nc = ncY.nc(gy, gx)
            zz = ac_lev[by, bx].reshape(-1)[ZIGZAG4][1:]
            t = write_residual(bw, zz, nc)
            ncY.set(gy, gx, t)
    else:
        for blk in range(16):
            by, bx = _BLK4[blk]
            ncY.set(my * 4 + by, mx * 4 + bx, 0)
    # chroma DC (Cb then Cr), chroma-DC table
    if cbp_chroma:
        for name in ("u", "v"):
            zz = c_dc[name].reshape(-1)[[0, 1, 2, 3]]
            write_residual(bw, zz, -1)
    # chroma AC
    for name, ctx in (("u", ncU), ("v", ncV)):
        for blk in range(4):
            by, bx = blk // 2, blk % 2
            gy, gx = my * 2 + by, mx * 2 + bx
            if cbp_chroma == 2:
                nc = ctx.nc(gy, gx)
                zz = c_lev[name][by, bx].reshape(-1)[ZIGZAG4][1:]
                t = write_residual(bw, zz, nc)
                ctx.set(gy, gx, t)
            else:
                ctx.set(gy, gx, 0)

    # ---- reconstruction (what the decoder computes)
    fdc = _H4 @ dc_lev @ _H4
    dcd = dequant_luma_dc(fdc, qp)
    out = np.zeros((16, 16), np.int64)
    for by in range(4):
        for bx in range(4):
            wq = dequant4_ac(ac_lev[by, bx], qp)
            wq[0, 0] = dcd[by, bx]
            out[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = inv4(wq)
    ry[my * 16:(my + 1) * 16, mx * 16:(mx + 1) * 16] = \
        np.clip(out + pred, 0, 255)
    for name, rec in (("u", ru), ("v", rv)):
        fc = _H2 @ c_dc[name] @ _H2
        dccd = dequant_chroma_dc(fc, cqp)
        outc = np.zeros((8, 8), np.int64)
        for by in range(2):
            for bx in range(2):
                wq = dequant4_ac(c_lev[name][by, bx], cqp)
                wq[0, 0] = dccd[by, bx]
                outc[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = inv4(wq)
        rec[my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8] = \
            np.clip(outc + cp[name], 0, 255)
