"""H.264 P-frame inter prediction: the MC kernel's wrapper.

Port of librempeg_tpu/codecs/h264/mc_pallas.py. The TPU version read
overlapping 32x256 reference tiles chosen by host-built selectors; the
CUDA kernel (csrc/mc.cu) reads the padded refpack planes directly by MV,
so there are no tiles and no selectors here. The plain version is
device_recon._mc, regrouped into MB tiles.
"""
from __future__ import annotations

import torch

from librempeg_tpu_torch.codecs.h264 import device_recon as DR
from librempeg_tpu_torch.kernels import mc as K


def mc_predict_plain(luma4, upad, vpad, mv, ref, mb_w: int, mb_h: int):
    """device_recon._mc with its 4x4-block output regrouped into MB
    tiles: (pred_y [nmb, 16, 16], pred_u/v [nmb, 8, 8]) uint8."""
    nmb = mb_w * mb_h
    py, pu, pv = DR._mc(luma4, upad, vpad, mv, ref, mb_w, mb_h)

    def tiles(p, s):
        return p.reshape(nmb, 4, 4, s, s).permute(0, 1, 3, 2, 4) \
            .reshape(nmb, 4 * s, 4 * s).to(torch.uint8)

    return tiles(py, 4), tiles(pu, 2), tiles(pv, 2)


def mc_predict(luma4, upad, vpad, mv, ref, mb_w: int, mb_h: int):
    """Quarter-pel luma / eighth-pel chroma prediction of every MB.

    luma4 [R, 4, hp, wp] uint8 refpacks, upad/vpad [R, hc, wc] uint8,
    mv [nmb, 16, 2] int16 (x, y quarter-pel per 4x4 block), ref [nmb, 4]
    int8 (per 8x8). Returns (pred_y [nmb, 16, 16], pred_u/v [nmb, 8, 8])
    uint8. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if luma4.device.type == "cpu":
        return mc_predict_plain(luma4, upad, vpad, mv, ref, mb_w, mb_h)
    return K.launch(luma4, upad, vpad, mv, ref, mb_w, mb_h)
