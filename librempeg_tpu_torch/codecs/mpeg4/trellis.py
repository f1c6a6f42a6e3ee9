"""Rate-distortion (trellis) quantization for the MPEG-4/H.263 coder.

Port of librempeg_tpu/codecs/mpeg4/trellis.py. Chooses quantized levels
per 8x8 block that minimize ``distortion + lambda * bits``, where bits
are the exact run/level/last VLC lengths (escape events cost the fixed
30-bit type-3 form the packer emits). Mirrors the reference trellis
quantizer (mpegvideo_enc.c:3923 dct_quantize_trellis_c): candidate
levels {L, L-1} (or +/-1 below the quantization threshold), exact bit
costs, squared error in ISO-DCT coefficient space, and an optimal choice
of the final coded coefficient. The lattice itself lives in
ops/trellis.py.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from librempeg_tpu_torch.codecs.mpeg4 import tables as T
from librempeg_tpu_torch.ops.fdiv import fdiv
from librempeg_tpu_torch.ops.trellis import viterbi_rl

_ESC_BITS = 30          # escape type 3: 7+2+1+6+1+12+1


@functools.lru_cache(maxsize=None)
def _bits_tables(intra: bool):
    """(bits_notlast, bits_last) int32 arrays [64 runs, 64 levels];
    level index 0 is unused, absent events cost the 30-bit escape."""
    idx = T.INTRA_RL_INDEX if intra else T.INTER_RL_INDEX
    b0 = np.full((64, 64), _ESC_BITS, np.int32)
    b1 = np.full((64, 64), _ESC_BITS, np.int32)
    for (last, run, alevel), (_, bits) in idx.items():
        if alevel < 64:
            (b1 if last else b0)[run, alevel] = bits + 1   # +sign bit
    return b0, b1


_TABS: dict = {}


def _tables_on(intra: bool, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """The bit tables as float32 on `dev`, uploaded once."""
    key = (intra, str(dev))
    hit = _TABS.get(key)
    if hit is None:
        hit = _TABS[key] = tuple(torch.as_tensor(t.astype(np.float32),
                                                 device=dev)
                                 for t in _bits_tables(intra))
    return hit


def _dequant_mag(alevel, qscale: int):
    """H.263 dequant magnitude for alevel >= 1 (ISO coefficient units,
    mpeg4videodec `(2*level+1)*qscale - (qscale&1 ? 0 : 1)`)."""
    even = 1 - (qscale & 1)
    return (2 * alevel + 1) * qscale - even


def _base_levels(mag: torch.Tensor, qscale: int) -> torch.Tensor:
    """trunc(|c| / 2q), the lattice's first candidate level, clamped to
    the escape range."""
    return torch.trunc(fdiv(mag, 2.0 * qscale)).to(torch.int32).clamp(0, 2047)


def quantize_rd(zz: torch.Tensor, qscale: int, intra: bool, first: int):
    """RD-quantize zigzag-ordered DCT coefficients.

    zz      [nblk, 64] float32 ISO-DCT coefficients in zigzag order
    qscale  int quantiser
    intra   selects the RL table (DC at zz[0] is ignored when first == 1
            and must be handled by the caller)
    first   first AC position (1 intra, 0 inter)

    Returns int32 [nblk, 64] levels (positions < first are zero).
    """
    qscale = int(qscale)
    qf = np.float32(qscale)
    # reference lambda (mpegvideo_enc.c:3947): lambda2 >> (SHIFT-6) with
    # distortion in (8*ISO)^2 units; ours is ISO^2, so divide by 64:
    # (118*q)^2 / 128 / 2 / 64 ~= 0.85 * q^2 (float32, as the JAX package
    # computes it)
    lam = np.float32(np.float32(0.85) * qf) * qf

    b0_tab, b1_tab = _tables_on(intra, zz.device)
    mag = zz.abs()
    l0 = _base_levels(mag, qscale)
    # candidates: {L, L-1} when L >= 2, {1} when L <= 1 (coding a below-
    # threshold coefficient as +/-1 is allowed when RD-favorable)
    cands = torch.stack([l0.clamp(min=1), (l0 - 1).clamp(min=1)],
                        dim=-1)                                # [nblk, 64, 2]
    dqm = _dequant_mag(cands, qscale).to(torch.float32)
    dist_c = (dqm - mag[..., None]) ** 2                       # [nblk, 64, 2]
    bidx = cands.clamp(max=63)                                 # escape past 63
    return viterbi_rl(zz, cands, dist_c, bidx, b0_tab, b1_tab, lam, first)
