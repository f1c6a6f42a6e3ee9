"""Error concealment: repair corrupt macroblocks from valid neighbours.

Port of librempeg_tpu/ops/conceal.py (the DC-interpolation class of
libavcodec/error_resilience.c): corrupt blocks are filled by Jacobi
diffusion of block means from valid neighbours, then upsampled to
pixels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def conceal_blocks(frame: torch.Tensor, bad_mask: torch.Tensor,
                   block_size: int = 16, iters: int = 8) -> torch.Tensor:
    """frame: [N, H, W] float; bad_mask: [N, H//bs, W//bs] bool.

    Returns the frame with corrupt blocks replaced by smooth fills
    propagated from valid neighbours."""
    n, h, w = frame.shape
    bs = block_size
    bh, bw = h // bs, w // bs
    means = frame.reshape(n, bh, bs, bw, bs).mean(dim=(2, 4))
    good = ~bad_mask
    vals = torch.where(good, means, torch.zeros_like(means))
    weight = good.to(torch.float32)
    for _ in range(iters):
        vp = F.pad(vals, (1, 1, 1, 1))
        wp = F.pad(weight, (1, 1, 1, 1))
        acc = (vp[:, :-2, 1:-1] + vp[:, 2:, 1:-1]
               + vp[:, 1:-1, :-2] + vp[:, 1:-1, 2:])
        cnt = (wp[:, :-2, 1:-1] + wp[:, 2:, 1:-1]
               + wp[:, 1:-1, :-2] + wp[:, 1:-1, 2:])
        vals = torch.where(weight > 0, vals,
                           torch.where(cnt > 0, acc / cnt.clamp(min=1),
                                       vals))
        weight = torch.where(weight > 0, weight,
                             (cnt > 0).to(torch.float32))
    fill = vals.repeat_interleave(bs, 1).repeat_interleave(bs, 2)
    mask_pix = bad_mask.repeat_interleave(bs, 1).repeat_interleave(bs, 2)
    return torch.where(mask_pix, fill, frame)
