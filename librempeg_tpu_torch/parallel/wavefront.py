"""Wavefront (anti-diagonal) dependency scheduling on the device.

Port of librempeg_tpu/parallel/wavefront.py: the recurrence
    out[i, j] = f(grid[i, j], out[i-1, j], out[i, j-1])
over the trailing [H, W] axes (out-of-range neighbours read `init`) runs
one anti-diagonal at a time: every cell of a diagonal depends only on
earlier diagonals, so each step is one vectorised pass over a
diagonal's cells. The JAX package's lax.scan over the h + w - 1
diagonals is a Python loop of eager tensor ops here (a lax.scan, not a
Pallas kernel, in the JAX package).
"""
from __future__ import annotations

from typing import Callable

import torch


def _gather_cols(x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """x[..., i, cols[i]] for each row i -> [..., H]."""
    idx = cols[:, None].expand(*x.shape[:-2], x.shape[-2], 1)
    return torch.gather(x, -1, idx)[..., 0]


def _scatter_cols(x, cols, vals, valid) -> torch.Tensor:
    """Write vals[i] into x[..., i, cols[i]] where valid[i]."""
    newv = torch.where(valid, vals, _gather_cols(x, cols))
    idx = cols[:, None].expand(*x.shape[:-2], x.shape[-2], 1)
    return x.scatter(-1, idx, newv[..., None])


def _neighbor_up(out, cols, init) -> torch.Tensor:
    shifted = torch.cat([torch.full_like(out[..., :1, :], init),
                         out[..., :-1, :]], dim=-2)
    return _gather_cols(shifted, cols)


def _neighbor_left(out, cols, init) -> torch.Tensor:
    shifted = torch.cat([torch.full_like(out[..., :, :1], init),
                         out[..., :, :-1]], dim=-1)
    return _gather_cols(shifted, cols)


def wavefront_scan(f: Callable, grid: torch.Tensor, init: float = 0.0
                   ) -> torch.Tensor:
    """out[i,j] = f(grid[i,j], out[i-1,j], out[i,j-1]), vectorised per
    anti-diagonal."""
    h, w = grid.shape[-2:]
    rows = torch.arange(h, device=grid.device)
    out = torch.zeros_like(grid)
    for d in range(h + w - 1):
        cols = d - rows                        # diagonal d's columns
        valid = (cols >= 0) & (cols < w)
        cc = cols.clamp(0, w - 1)
        newvals = f(_gather_cols(grid, cc), _neighbor_up(out, cc, init),
                    _neighbor_left(out, cc, init))
        out = _scatter_cols(out, cc, newvals, valid)
    return out
