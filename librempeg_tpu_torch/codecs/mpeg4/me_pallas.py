"""MPEG-4 half-pel refinement + motion compensation: the half-pel
kernel's wrapper.

Port of librempeg_tpu/codecs/mpeg4/me_pallas.py. The TPU version DMA'd
overlapping reference tiles per MB; csrc/hpel.cu loads each MB's 19x19
luma window straight from the plane with an edge clamp, which equals the
JAX package's 16-pixel edge pad for every window the search can ask for.
The plain version is ops.motion._hpel_refine + mc_hpel over planes
padded by that same 16 pixels.
"""
from __future__ import annotations

import torch

from librempeg_tpu_torch.kernels import hpel as K
from librempeg_tpu_torch.ops import motion

PAD = 16          # edge padding of the JAX package's tiles


def _chroma_mv(mv_h):
    """Luma half-pel MV -> chroma half-pel MV (spec /2 with sticky
    half, per component)."""
    a = mv_h.abs()
    return torch.sign(mv_h) * ((a >> 1) | (a & 1))


def hpel_refine_mc_plain(cur_y, ref_y, ref_u, ref_v, mv_i, rnd: int = 0):
    """Plain version of the kernel (same contract as hpel_refine_mc)."""
    ref_pad = motion._edge_pad(ref_y.to(torch.float32)[None], PAD, PAD) \
        .to(torch.uint8)
    mv_h, _, pred_y = motion._hpel_refine(cur_y.to(torch.uint8)[None],
                                          ref_pad, PAD, PAD, mv_i[None],
                                          rnd, 16)
    mv_c = _chroma_mv(mv_h)
    pred_u = motion.mc_hpel(ref_u.to(torch.uint8)[None], mv_c, 8, PAD,
                            rnd)[0]
    pred_v = motion.mc_hpel(ref_v.to(torch.uint8)[None], mv_c, 8, PAD,
                            rnd)[0]
    return mv_h[0], pred_y[0], pred_u, pred_v


def hpel_refine_mc(cur_y, ref_y, ref_u, ref_v, mv_i, rnd: int = 0):
    """Half-pel refinement around integer MVs + MC of all planes.

    cur_y [H, W] f32; ref_* the encoder's recon planes (f32, 0..255;
    truncated to bytes as the JAX package does); mv_i [bh, bw, 2] int32
    pixel units from the integer search. Returns (mv_h [bh, bw, 2] int32
    half-pel, pred_y [H, W], pred_u, pred_v f32). CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if cur_y.device.type == "cpu":
        return hpel_refine_mc_plain(cur_y, ref_y, ref_u, ref_v, mv_i, rnd)
    f32 = torch.float32
    return K.launch(cur_y.to(f32).contiguous(), ref_y.to(f32).contiguous(),
                    ref_u.to(f32).contiguous(), ref_v.to(f32).contiguous(),
                    mv_i.to(torch.int32).contiguous(), rnd)
