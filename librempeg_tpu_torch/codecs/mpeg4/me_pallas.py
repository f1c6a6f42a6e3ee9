"""MPEG-4 half-pel refinement + motion compensation: the wrappers of the
half-pel kernels.

Port of librempeg_tpu/codecs/mpeg4/me_pallas.py. The TPU version DMA'd
overlapping reference tiles per MB, picked by selector words, in a
per-MB form (_refine_mc_luma, _mc_chroma) and a lane-packed group form
(_refine_mc_luma_group, _mc_chroma_group) with one contract.
csrc/hpel.cu reads each MB's windows straight from the planes with an
edge clamp, which equals the JAX package's 16-pixel edge pad for every
window the search can ask for. hpel_refine_mc (the encoder's path) is
one fused kernel: each warp refines its MB's luma MV, predicts its luma
and then its chroma at the chroma MV derived from the winner.
refine_mc_luma and mc_chroma are the two halves on their own (the
per-MB forms). The plain versions are ops.motion._hpel_refine (luma) and
mc_hpel (chroma) over planes padded by that same 16 pixels.
"""
from __future__ import annotations

import torch

from librempeg_tpu_torch.kernels import hpel as KH
from librempeg_tpu_torch.kernels import hpel_chroma as KC
from librempeg_tpu_torch.kernels import hpel_luma as KL
from librempeg_tpu_torch.ops import motion

PAD = 16          # edge padding of the JAX package's tiles


def _chroma_mv(mv_h):
    """Luma half-pel MV -> chroma half-pel MV (spec /2 with sticky
    half, per component)."""
    a = mv_h.abs()
    return torch.sign(mv_h) * ((a >> 1) | (a & 1))


def refine_mc_luma_plain(cur_y, ref_y, mv_i, rnd: int = 0):
    """Plain version of the luma kernel (same contract as
    refine_mc_luma)."""
    ref_pad = motion._edge_pad(ref_y.to(torch.float32)[None], PAD, PAD) \
        .to(torch.uint8)
    mv_h, _, pred_y = motion._hpel_refine(cur_y.to(torch.uint8)[None],
                                          ref_pad, PAD, PAD, mv_i[None],
                                          rnd, 16)
    return mv_h[0], pred_y[0]


def mc_chroma_plain(ref_u, ref_v, mv_h, rnd: int = 0):
    """Plain version of the chroma kernel (same contract as
    mc_chroma)."""
    mv_c = _chroma_mv(mv_h)[None]
    return tuple(motion.mc_hpel(p.to(torch.uint8)[None], mv_c, 8, PAD,
                                rnd)[0] for p in (ref_u, ref_v))


def refine_mc_luma(cur_y, ref_y, mv_i, rnd: int = 0):
    """Half-pel refinement of the luma around integer MVs + luma MC.

    cur_y [H, W] f32; ref_y the encoder's reference luma (f32, integers
    0..255: the picture its decoder rebuilds, so the kernels' byte
    conversion is exact); mv_i [bh, bw, 2] int32
    pixel units from the integer search. Returns (mv_h [bh, bw, 2] int32
    half-pel, pred_y [H, W] f32). CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if cur_y.device.type == "cpu":
        return refine_mc_luma_plain(cur_y, ref_y, mv_i, rnd)
    f32 = torch.float32
    return KL.launch(cur_y.to(f32).contiguous(), ref_y.to(f32).contiguous(),
                     mv_i.to(torch.int32).contiguous(), rnd)


def mc_chroma(ref_u, ref_v, mv_h, rnd: int = 0):
    """Chroma MC of both planes at the chroma MVs of luma half-pel MVs.

    ref_u/ref_v [H/2, W/2] the encoder's reference chroma (f32, integers
    0..255); mv_h [bh, bw, 2] int32 luma half-pel MVs.
    Returns (pred_u, pred_v) [H/2, W/2] f32. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if ref_u.device.type == "cpu":
        return mc_chroma_plain(ref_u, ref_v, mv_h, rnd)
    f32 = torch.float32
    return KC.launch(ref_u.to(f32).contiguous(), ref_v.to(f32).contiguous(),
                     mv_h.to(torch.int32).contiguous(), rnd)


def hpel_refine_mc_plain(cur_y, ref_y, ref_u, ref_v, mv_i, rnd: int = 0):
    """Plain version of hpel_refine_mc."""
    mv_h, pred_y = refine_mc_luma_plain(cur_y, ref_y, mv_i, rnd)
    return (mv_h, pred_y) + mc_chroma_plain(ref_u, ref_v, mv_h, rnd)


def hpel_refine_mc(cur_y, ref_y, ref_u, ref_v, mv_i, rnd: int = 0):
    """Half-pel refinement around integer MVs + MC of all planes: the
    contract of refine_mc_luma, then mc_chroma at its MVs. Returns (mv_h
    [bh, bw, 2] int32 half-pel, pred_y [H, W], pred_u, pred_v f32). CPU
    tensors take the plain version; CUDA tensors launch the fused
    kernel."""
    if cur_y.device.type == "cpu":
        return hpel_refine_mc_plain(cur_y, ref_y, ref_u, ref_v, mv_i, rnd)
    f32 = torch.float32
    return KH.launch(*(p.to(f32).contiguous()
                       for p in (cur_y, ref_y, ref_u, ref_v)),
                     mv_i.to(torch.int32).contiguous(), rnd)
