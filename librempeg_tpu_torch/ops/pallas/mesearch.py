"""Fused integer motion search + motion compensation: the full-search
kernel's wrapper.

Port of librempeg_tpu/ops/pallas/mesearch.py. The TPU kernel cut the
frame into tiles and DMA'd each tile's search window into VMEM, but it
cut every window from the globally edge-padded reference (its docstring
calls the search slice-local; the code is not), so interior tiles see
their neighbours' pixels and the result is a whole-frame search with
edge clamping. csrc/fsearch.cu runs that search one MB per block; the
tile arguments only keep the JAX package's precondition (minterpolate,
whose frames no 144x256 tile divides, passes the frame as one tile). The plain
version is ops.motion.full_search_mc_xla(cur, ref, r, 16, 1), which
sums the bf16 differences in float32 as the kernel does.
"""
from __future__ import annotations

import torch

from librempeg_tpu_torch.kernels import fsearch as K
from librempeg_tpu_torch.ops import motion

BS = 16  # macroblock size


def full_search_mc_plain(cur, ref, search_range: int = 4):
    """Plain version of the kernel (same contract as full_search_mc)."""
    return motion.full_search_mc_xla(cur, ref, search_range, BS, 1)


def full_search_mc(cur, ref, search_range: int = 4, tile_h: int = 144,
                   tile_w: int = 256):
    """Fused exhaustive search over [-r, r]^2 + prediction.

    cur/ref: [N, H, W] float (H % tile_h == 0, W % tile_w == 0 after
    clamping the tile to the frame, as in the JAX package). Returns
    (mv [N, bh, bw, 2] int32 (dy, dx), cost [N, bh, bw] f32, pred
    [N, H, W] f32). CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    n, h, w = cur.shape
    th, tw = min(tile_h, h), min(tile_w, w)
    if h % th or w % tw:
        raise ValueError(f"full_search_mc: tiles {th}x{tw} do not divide "
                         f"the {h}x{w} frame")
    if cur.device.type == "cpu":
        return full_search_mc_plain(cur, ref, search_range)
    return K.launch(cur.to(torch.float32).contiguous(),
                    ref.to(torch.float32).contiguous(), search_range)
