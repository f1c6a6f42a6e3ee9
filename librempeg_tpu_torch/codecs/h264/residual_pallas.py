"""H.264 residual reconstruction from compact rows: the residual
kernel's wrapper and its host packer.

Port of librempeg_tpu/codecs/h264/residual_pallas.py. The host emits
one compact row per coded 4x4 block: its global block id mb*24 + blk
(luma 0-15 raster, chroma u 16-19, chroma v 20-23) and its 16
dequantised coefficients in raster order, int16 (chroma DC and
Intra_16x16 luma DC already folded in). expand_residual turns the rows
into per-MB spatial residuals [nMB, 384] (luma 16x16 row-major in
columns 0-255, chroma u 8x8 in 256-319, chroma v in 320-383).

The TPU kernel saw the sorted rows through one 512-row window per
120-MB stripe, so pack_residual_host reports ok=False when a stripe
holds more (every P frame of the bench stream does: chroma DC is coded
in almost every MB). That window is a VMEM layout, not part of the
contract: csrc/residual.cu takes the rows in any number, and
compact_rows + pack_rows give them without a window. No decode step
calls this module; the decoder computes its residuals in
device_recon._residuals.
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.codecs.h264 import device_recon as DR
from librempeg_tpu_torch.kernels import residual as K

MBS_PER_STRIPE = 120       # one 1080p MB row; other widths pad
WIN = 512                  # compact entries the TPU kernel saw per stripe
PAD_ID = 32767 + 32768 * 7  # the id of a padding row: matches no block

_IZZ = DR._IZZ                       # zigzag -> raster permutation


def _placement() -> np.ndarray:
    """[24, 16] per-MB output column of each block's raster pixel."""
    place = np.zeros((24, 16), np.int64)
    for b in range(24):
        for p in range(16):
            r, c = p // 4, p % 4
            if b < 16:
                place[b, p] = ((b // 4) * 4 + r) * 16 + (b % 4) * 4 + c
            else:
                q = b - 16
                place[b, p] = (256 + 64 * (q // 4) + ((q % 4) // 2 * 4 + r)
                               * 8 + (q % 2) * 4 + c)
    return place


_PLACE = _placement()


def out_rows(nmb: int) -> int:
    """Rows of expand_residual's output: nmb rounded up to stripes."""
    return -(-nmb // MBS_PER_STRIPE) * MBS_PER_STRIPE


def compact_rows(coeffs: np.ndarray, qp: np.ndarray, kind,
                 chroma_qp_off: int, mb_w: int, mb_h: int):
    """coeffs [nMB,27,16] int16/32 zigzag levels (native layout), qp
    [nMB] -> (ids [K] i32 sorted, levels [K,16] i16 dequantised raster)
    for every 4x4 block with a non-zero coefficient."""
    nmb = mb_w * mb_h
    co = coeffs.astype(np.int32)
    qp = qp.astype(np.int32)
    qpc = DR._CQP[np.clip(qp + chroma_qp_off, 0, 51)]
    vl = DR._VPOS[qp % 6] << (qp // 6)[:, None]          # [nMB,16] luma
    vc = DR._VPOS[qpc % 6] << (qpc // 6)[:, None]

    # dequant AC in zigzag domain (VPOS is raster; gather to raster 1st)
    lum = co[:, 1:17, :][..., _IZZ]                      # [nMB,16,16]
    lum = lum * vl[:, None, :]
    cac = co[:, 19:27, :][..., _IZZ]
    cac = cac * vc[:, None, :]

    # chroma DC (8.5.10): 2x2 hadamard, ((f*v0)<<(qpc//6))>>1
    cdc = co[:, 17:19, :4].reshape(nmb, 2, 2, 2)
    h2 = np.array([[1, 1], [1, -1]], np.int32)
    f = np.einsum("ij,npjk,kl->npil", h2, cdc, h2)
    v0c = DR._VPOS[qpc % 6][:, 0]
    cdcd = ((f * v0c[:, None, None, None]) << (qpc // 6)[:, None, None,
                                               None]) >> 1
    cac[..., 0] = cdcd.reshape(nmb, 2, 4).reshape(nmb, 8)

    # Intra_16x16 luma DC (8.5.10/8.5.12): 4x4 hadamard + scaled dequant
    is_i16 = np.asarray(kind) == 3
    if np.any(is_i16):
        h4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1],
                       [1, -1, 1, -1]], np.int32)
        dc = co[:, 0, :][:, _IZZ].reshape(nmb, 4, 4)
        fdc = np.einsum("ij,njk,kl->nil", h4, dc, h4)
        v0 = DR._VPOS[qp % 6][:, 0][:, None, None]
        hi = (fdc * v0) << np.maximum(qp // 6 - 2, 0)[:, None, None]
        lo = (fdc * v0 + (1 << np.maximum(1 - qp // 6, 0))[:, None, None]
              ) >> np.maximum(2 - qp // 6, 0)[:, None, None]
        dcd = np.where((qp >= 12)[:, None, None], hi, lo)
        lum[is_i16, :, 0] = dcd.reshape(nmb, 16)[is_i16]

    # compact per-block rows in blk24 order
    all_rows = np.concatenate(
        [lum, cac.reshape(nmb, 8, 16)], axis=1)          # [nMB,24,16]
    nz = all_rows.any(axis=2)                            # [nMB,24]
    ids = np.flatnonzero(nz).astype(np.int32)            # sorted
    levels = all_rows.reshape(-1, 16)[ids].astype(np.int16)
    return ids, levels


def pack_rows(ids: np.ndarray, levels: np.ndarray,
              rows: int | None = None) -> np.ndarray:
    """Compact rows -> packed [rows, 24] i16 (cols 0-15 levels, 16-17
    the split block id); rows past len(ids) are padding (PAD_ID)."""
    k = len(ids)
    packed = np.zeros((k if rows is None else rows, 24), np.int16)
    packed[:, 16] = PAD_ID & 0x7FFF
    packed[:, 17] = PAD_ID >> 15
    packed[:k, :16] = levels
    packed[:k, 16] = (ids & 0x7FFF).astype(np.int16)
    packed[:k, 17] = (ids >> 15).astype(np.int16)
    return packed


def pack_residual_host(coeffs: np.ndarray, qp: np.ndarray, kind,
                       chroma_qp_off: int, mb_w: int, mb_h: int):
    """The JAX package's packer: (packed [K,24] i16 with K a multiple of
    WIN and a >= 2*WIN pad tail, offw [nstripes] i32 window starts in
    WIN units, ok). ok=False (and None, None) when a stripe holds more
    than WIN rows, as the TPU kernel required."""
    ids, levels = compact_rows(coeffs, qp, kind, chroma_qp_off, mb_w, mb_h)
    nstripes = out_rows(mb_w * mb_h) // MBS_PER_STRIPE
    stripe_of = ids // (24 * MBS_PER_STRIPE)
    counts = np.bincount(stripe_of, minlength=nstripes)
    if counts.max(initial=0) > WIN:
        return None, None, False
    first = np.searchsorted(stripe_of, np.arange(nstripes))
    offw = (first // WIN).astype(np.int32)
    cap = ((len(ids) + WIN - 1) // WIN + 2) * WIN        # + tail window
    return pack_rows(ids, levels, cap), offw, True


def expand_residual_plain(packed: torch.Tensor, nmb: int) -> torch.Tensor:
    """Plain version of the kernel (same contract as expand_residual)."""
    pk = packed.to(torch.int32)
    ids = pk[:, 16] + 32768 * pk[:, 17]
    keep = (ids >= 0) & (ids < nmb * 24)
    ids = ids[keep].long()
    res = DR._inv4(pk[keep, :16].reshape(-1, 4, 4)).reshape(-1, 16)
    place = torch.as_tensor(_PLACE, device=packed.device)
    flat = (ids // 24)[:, None] * 384 + place[ids % 24]
    out = torch.zeros(out_rows(nmb) * 384, dtype=torch.float32,
                      device=packed.device)
    out[flat.reshape(-1)] = res.reshape(-1).to(torch.float32)
    return out.reshape(-1, 384)


def expand_residual(packed: torch.Tensor, offw, nmb: int) -> torch.Tensor:
    """packed [K,24] i16 compact rows -> [out_rows(nmb), 384] f32
    spatial residual. The ids ascend, each at most once, and the pad
    rows (an id of nmb*24 or more) come last: compact_rows returns
    np.flatnonzero order and pack_rows appends PAD_ID rows, and the
    kernel finds each block's rows by a search of the ids. offw, the
    TPU kernel's window starts, is accepted and not needed. CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if packed.device.type == "cpu":
        return expand_residual_plain(packed, nmb)
    return K.launch(packed.contiguous(), nmb, out_rows(nmb))


def spatial_from_residuals(lres: torch.Tensor,
                           cres: torch.Tensor) -> torch.Tensor:
    """device_recon._residuals' output (lres [nMB,16,4,4], cres
    [nMB,2,2,2,4,4]) in expand_residual's per-MB layout [nMB, 384]."""
    nmb = lres.shape[0]
    rows = torch.cat([lres.reshape(nmb, 16, 16), cres.reshape(nmb, 8, 16)],
                     dim=1)
    out = torch.zeros((nmb, 384), dtype=rows.dtype, device=rows.device)
    out[:, torch.as_tensor(_PLACE.reshape(-1), device=rows.device)] = \
        rows.reshape(nmb, 384)
    return out
