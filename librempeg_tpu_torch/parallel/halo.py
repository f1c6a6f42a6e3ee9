"""Row-sharded stencils with halo exchange.

Port of librempeg_tpu/parallel/halo.py: each shard holds a contiguous
row band of the frame, neighbours exchange `halo` edge rows (the JAX
package's ppermute over ICI, here copies between shards, mesh.to_shard),
then the stencil runs on each shard. The JAX body is a per-shard closure
with the collective inside; here the exchange is written over the list
of shards (see mesh.py's device model).
"""
from __future__ import annotations

from typing import Callable

import torch

from librempeg_tpu_torch.parallel.mesh import (Mesh, Shard, from_shard,
                                               to_shard)


def exchange_row_halo(blocks: list, halo: int, shards: list[Shard]
                      ) -> list:
    """blocks[i] [.., rows, W] on shards[i] -> [.., rows + 2*halo, W] on
    the same shard, with its neighbours' rows (edge-replicated at the
    global top and bottom)."""
    n = len(blocks)
    out = []
    for i, (x, sh) in enumerate(zip(blocks, shards)):
        if i:
            top = to_shard(blocks[i - 1][..., -halo:, :], sh, shards[i - 1])
        if i < n - 1:
            bot = to_shard(blocks[i + 1][..., :halo, :], sh, shards[i + 1])
        with sh.ctx():
            edge = x.shape[:-2] + (halo, x.shape[-1])
            if not i:
                top = x[..., :1, :].expand(edge)
            if i == n - 1:
                bot = x[..., -1:, :].expand(edge)
            out.append(torch.cat([top, x, bot], dim=-2))
    return out


def row_sharded_stencil(fn: Callable[[torch.Tensor], torch.Tensor],
                        halo: int, mesh: Mesh, axis_name: str = "spatial"):
    """Wrap `fn` (a stencil needing `halo` valid rows above and below; it
    gets [.., rows+2*halo, W] and must return [.., rows, W]) into an op
    over [N, H, W]: the batch split over 'data' (when the mesh has it),
    the rows over `axis_name`. The result lands on the input's device."""
    n_data = mesh.shape.get("data", 1)
    n_rows = mesh.shape[axis_name]

    def sharded(x: torch.Tensor) -> torch.Tensor:
        nb, h = x.shape[0], x.shape[-2]
        if nb % n_data or h % n_rows:
            raise ValueError(f"{tuple(x.shape)} does not split over "
                             f"data={n_data}, {axis_name}={n_rows}")
        kb, kr = nb // n_data, h // n_rows
        if kr < halo:
            raise ValueError(f"a band of {kr} rows is thinner than the "
                             f"halo of {halo}")
        outs = []
        for d in range(n_data):
            shards = mesh.along(axis_name, data=d) if "data" in \
                mesh.axis_names else mesh.along(axis_name)
            blocks = [to_shard(x[d * kb:(d + 1) * kb, ..., s * kr:
                                 (s + 1) * kr, :], sh)
                      for s, sh in enumerate(shards)]
            xh = exchange_row_halo(blocks, halo, shards)
            for sh, b in zip(shards, xh):
                with sh.ctx():
                    y = fn(b)
                outs.append((d, from_shard(y, sh, x.device)))
        rows = [torch.cat([y for dd, y in outs if dd == d], dim=-2)
                for d in range(n_data)]
        return torch.cat(rows, dim=0)

    return sharded


def vblur3(xh: torch.Tensor) -> torch.Tensor:
    """Example 3-tap vertical stencil ([.., R+2, W] -> [.., R, W])."""
    return (xh[..., :-2, :] + 2.0 * xh[..., 1:-1, :] + xh[..., 2:, :]) * 0.25


def vfir6_halfpel(xh: torch.Tensor) -> torch.Tensor:
    """H.264 §8.4.2.2 vertical half-pel 6-tap [1,-5,20,20,-5,1] with
    (+16)>>5 rounding: [.., R+5, W] -> [.., R, W], the half-pel sample
    between each row r and r+1. Integer-exact on int32 inputs (the host
    decoder's native half-pel planes bit for bit)."""
    v = (xh[..., 0:-5, :] - 5 * xh[..., 1:-4, :] + 20 * xh[..., 2:-3, :]
         + 20 * xh[..., 3:-2, :] - 5 * xh[..., 4:-1, :] + xh[..., 5:, :])
    return ((v + 16) >> 5).clamp(0, 255)


def halfpel_plane(y: torch.Tensor) -> torch.Tensor:
    """The single-device form of the sharded half-pel stencil: [.., H, W]
    int32 edge-padded by 2 rows above and 3 below, then vfir6_halfpel."""
    pad = torch.cat([y[..., :1, :].expand(*y.shape[:-2], 2, y.shape[-1]),
                     y,
                     y[..., -1:, :].expand(*y.shape[:-2], 3, y.shape[-1])],
                    dim=-2)
    return vfir6_halfpel(pad)

