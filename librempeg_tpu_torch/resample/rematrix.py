"""Channel mixing (rematrix).

Port of librempeg_tpu/resample/rematrix.py: build_matrix is a host
copy; apply_matrix is one float32 torch.matmul on the samples' device
(TF32 off, as the JAX package runs it at HIGHEST precision).

Analog of libswresample/rematrix.c:584 (swri_rematrix and the
auto-built mixing matrices): an [out_ch, in_ch] float matrix from the
channel layouts with the standard downmix coefficients
(center/surround/LFE mix levels).
"""
from __future__ import annotations

import numpy as np
import torch

import librempeg_tpu_torch.device  # noqa: F401  (TF32 off)
from librempeg_tpu_torch.core.samplefmt import (
    CH_BACK_CENTER,
    CH_BACK_LEFT,
    CH_BACK_RIGHT,
    CH_FRONT_CENTER,
    CH_FRONT_LEFT,
    CH_FRONT_RIGHT,
    CH_LOW_FREQUENCY,
    CH_SIDE_LEFT,
    CH_SIDE_RIGHT,
    ChannelLayout,
)

SQRT1_2 = float(np.sqrt(0.5))

# default mix levels (swresample defaults: center/surround 1/sqrt(2), lfe 0)
CENTER_MIX_LEVEL = SQRT1_2
SURROUND_MIX_LEVEL = SQRT1_2
LFE_MIX_LEVEL = 0.0


def build_matrix(in_layout: ChannelLayout, out_layout: ChannelLayout,
                 center_mix: float = CENTER_MIX_LEVEL,
                 surround_mix: float = SURROUND_MIX_LEVEL,
                 lfe_mix: float = LFE_MIX_LEVEL,
                 normalize: bool = True) -> np.ndarray:
    """[out_ch, in_ch] mixing matrix."""
    in_ch = in_layout.channels()
    out_ch = out_layout.channels()
    m = np.zeros((len(out_ch), len(in_ch)))

    def pos(chs, bit):
        try:
            return chs.index(_bit_index(bit))
        except ValueError:
            return -1

    def _bit_index(bit):
        return bit.bit_length() - 1

    # direct copies
    for oi, oc in enumerate(out_ch):
        for ii, ic in enumerate(in_ch):
            if oc == ic:
                m[oi, ii] = 1.0

    in_bits = in_layout.mask
    out_bits = out_layout.mask
    if in_bits and out_bits:
        iFL = pos(in_ch, CH_FRONT_LEFT)
        iFR = pos(in_ch, CH_FRONT_RIGHT)
        iFC = pos(in_ch, CH_FRONT_CENTER)
        iLFE = pos(in_ch, CH_LOW_FREQUENCY)
        iBL = pos(in_ch, CH_BACK_LEFT)
        iBR = pos(in_ch, CH_BACK_RIGHT)
        iBC = pos(in_ch, CH_BACK_CENTER)
        iSL = pos(in_ch, CH_SIDE_LEFT)
        iSR = pos(in_ch, CH_SIDE_RIGHT)
        oFL = pos(out_ch, CH_FRONT_LEFT)
        oFR = pos(out_ch, CH_FRONT_RIGHT)
        oFC = pos(out_ch, CH_FRONT_CENTER)

        # center -> L/R
        if iFC >= 0 and not out_bits & CH_FRONT_CENTER:
            if oFL >= 0:
                m[oFL, iFC] += center_mix
            if oFR >= 0:
                m[oFR, iFC] += center_mix
        # L/R -> mono center
        if oFC >= 0 and not (out_bits & CH_FRONT_LEFT):
            if iFL >= 0:
                m[oFC, iFL] += SQRT1_2
            if iFR >= 0:
                m[oFC, iFR] += SQRT1_2
        # surrounds -> front L/R
        for iS, oF in ((iBL, oFL), (iBR, oFR), (iSL, oFL), (iSR, oFR)):
            if iS >= 0 and oF >= 0 and not _has(out_bits, in_ch[iS]):
                m[oF, iS] += surround_mix
        # back center -> L/R
        if iBC >= 0 and not out_bits & CH_BACK_CENTER:
            if oFL >= 0:
                m[oFL, iBC] += surround_mix * SQRT1_2
            if oFR >= 0:
                m[oFR, iBC] += surround_mix * SQRT1_2
        # lfe
        if iLFE >= 0 and not out_bits & CH_LOW_FREQUENCY:
            if oFL >= 0:
                m[oFL, iLFE] += lfe_mix
            if oFR >= 0:
                m[oFR, iLFE] += lfe_mix
            if oFC >= 0 and oFL < 0:
                m[oFC, iLFE] += lfe_mix
    elif len(out_ch) == 1 and len(in_ch) == 2:
        m[0, :] = SQRT1_2
    elif len(out_ch) == 2 and len(in_ch) == 1:
        m[:, 0] = 1.0

    if normalize:
        # keep peak gain <= 1 per output channel (swr rematrix_maxval=1)
        g = np.abs(m).sum(axis=1)
        g = np.maximum(g, 1.0)
        m = m / g[:, None]
    return m.astype(np.float32)


def _has(bits: int, ch_index: int) -> bool:
    return bool(bits >> ch_index & 1)


def apply_matrix(samples: torch.Tensor, matrix) -> torch.Tensor:
    """[in_ch, n] x [out_ch, in_ch] -> [out_ch, n], float32 on the
    samples' device."""
    m = torch.as_tensor(matrix, dtype=torch.float32, device=samples.device)
    return torch.matmul(m, samples.to(torch.float32))
