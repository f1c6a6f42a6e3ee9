"""H.264 in-loop deblocking: the deblock kernel's wrapper.

Port of librempeg_tpu/codecs/h264/deblock_pallas.py. The edge decisions
(bS, alpha, beta, tc0) depend only on pre-deblock data, so they are
computed here with plain tensor code and packed one int32 per edge
segment (bits 0..2 bS, 3..10 alpha, 11..15 beta, 16..20 tc0), laid out
per MB as an [8, 16] block; csrc/deblock.cu filters the planes in one
launch, its blocks walking MB rows behind each other's progress. The
plain version is device_recon.deblock_frame.
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.codecs.h264 import device_recon as DR
from librempeg_tpu_torch.kernels import deblock as K


def _pack_params(bs, ia, ib):
    """bs/ia/ib [H4, W4] table-index maps -> packed int32 value map."""
    alpha = DR._t(DR._ALPHA, bs)[ia.long()]
    beta = DR._t(DR._BETA, bs)[ib.long()]
    tc0 = DR._t(DR._TC0, bs)[ia.long(), (bs - 1).clamp(0, 2).long()]
    return (bs | (alpha << 3) | (beta << 11) | (tc0 << 16)).to(torch.int32)


def _mbize(m, mb_w, mb_h):
    """[H4, W4] per-block-edge map -> [nmb, 4, 4] (mb, row, col)."""
    return m.reshape(mb_h, 4, mb_w, 4).permute(0, 2, 1, 3) \
        .reshape(mb_h * mb_w, 4, 4)


def deblock_params(coeff_idx, coeff_val, mv, ref, qp, kind, mb_w: int,
                   mb_h: int, chroma_qp_off: int = 0, alpha_off: int = 0,
                   beta_off: int = 0):
    """Per-MB [nmb, 8, 16] int32 packed edge parameters: rows 0..3 luma
    vertical [row, edge], rows 4..7 luma horizontal [edge, col]; columns
    4..5 chroma vertical [row, e], rows 4..5 x columns 4..7 chroma
    horizontal [e, col]."""
    nmb = mb_w * mb_h
    coeffs = DR.dense_coeffs(coeff_idx, coeff_val, nmb)
    bs_v, bs_h = DR._bs_maps(coeffs, mv, ref, kind, mb_w, mb_h)
    ep = DR._edge_params(qp, mb_w, mb_h, chroma_qp_off, alpha_off,
                         beta_off)
    vl = _mbize(_pack_params(bs_v, ep["lav"], ep["lbv"]), mb_w, mb_h)
    hl = _mbize(_pack_params(bs_h, ep["lah"], ep["lbh"]), mb_w, mb_h)
    vc = _mbize(_pack_params(bs_v, ep["cav"], ep["cbv"]), mb_w, mb_h)
    hc = _mbize(_pack_params(bs_h, ep["cah"], ep["cbh"]), mb_w, mb_h)
    P = torch.zeros((nmb, 8, 16), dtype=torch.int32, device=coeffs.device)
    P[:, 0:4, 0:4] = vl
    P[:, 4:8, 0:4] = hl
    P[:, 0:4, 4:6] = vc[:, :, 0::2]
    P[:, 4:6, 4:8] = hc[:, 0::2, :]
    return P


def deblock_frame_pallas(y, u, v, coeff_idx, coeff_val, mv, ref, qp, kind,
                         mb_w: int, mb_h: int, chroma_qp_off: int = 0,
                         alpha_off: int = 0, beta_off: int = 0):
    """Deblock y [16*mb_h, 16*mb_w], u/v [8*mb_h, 8*mb_w] uint8; same
    contract as device_recon.deblock_frame.

    CPU tensors take the plain version and get new planes back; CUDA
    tensors launch the kernel, which filters IN PLACE (the decoder owns
    the freshly reconstructed planes) and returns the same tensors."""
    if y.device.type == "cpu":
        return DR.deblock_frame(y, u, v, coeff_idx, coeff_val, mv, ref, qp,
                                kind, mb_w, mb_h, chroma_qp_off, alpha_off,
                                beta_off)
    P = deblock_params(coeff_idx, coeff_val, mv, ref, qp, kind, mb_w, mb_h,
                       chroma_qp_off, alpha_off, beta_off)
    K.launch(y, u, v, P, mb_w, mb_h)
    return y, u, v


def random_p_frame(mb_w: int, mb_h: int, seed: int = 0,
                   sparse: bool = False):
    """A random P frame before its deblock, for tests and timing, in the
    arguments of device_recon.deblock_frame as numpy: ((y, u, v) uint8,
    (idx int32, vals int16, mv [nmb,16,2] int16, ref [nmb,4] int8, qp
    int32, kind int32)). The planes are smooth with noise, so the
    filters' gates open. Dense (the default): 30% intra MBs (bS 3 and
    4), a coefficient in one of 12 positions, qp 24..45, so most edges
    filter; sparse: 1% intra MBs, one in 200, qp 26..32, closer to a
    real P frame."""
    rng = np.random.default_rng(seed)
    nmb, h, w = mb_w * mb_h, mb_h * 16, mb_w * 16
    gy, gx = np.mgrid[0:h, 0:w]
    y = np.clip(128 + 40 * np.sin(gx / 7.0) + 30 * np.cos(gy / 9.0)
                + rng.integers(-6, 7, (h, w)), 0, 255).astype(np.uint8)
    u = y[::2, ::2].copy()
    v = (255 - y[::2, ::2]).astype(np.uint8)
    total = nmb * 27 * 16
    idx = np.sort(rng.choice(total, size=total // (200 if sparse else 12),
                             replace=False))
    kind = np.where(rng.random(nmb) < (0.01 if sparse else 0.3),
                    rng.choice([2, 3], nmb), 0)
    vals = rng.integers(-40, 41, idx.size).astype(np.int16)
    mv = rng.integers(-300, 301, (nmb, 16, 2)).astype(np.int16)
    ref = rng.integers(0, 2, (nmb, 4)).astype(np.int8)
    qp = (rng.integers(26, 33, nmb) if sparse
          else rng.integers(24, 46, nmb)).astype(np.int32)
    return (y, u, v), (idx.astype(np.int32), vals, mv, ref, qp,
                       kind.astype(np.int32))
