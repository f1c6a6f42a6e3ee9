"""8x8 block DCT/IDCT (float32 orthonormal path).

Port of the float path of librempeg_tpu/ops/dct8x8.py: blocks are
batched [B, 8, 8] and each separable transform is two small matrix
products, C @ x @ C^T. The basis is the same numpy code as the JAX
package's.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _ortho_basis() -> np.ndarray:
    """8x8 orthonormal DCT-II basis C: C @ x gives 1D DCT, C.T inverse."""
    c = np.zeros((8, 8))
    for k in range(8):
        for j in range(8):
            c[k, j] = np.cos(np.pi * k * (2 * j + 1) / 16)
    c *= np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    return c


_BASES: dict = {}


def _basis(like: torch.Tensor) -> torch.Tensor:
    """The basis in `like`'s dtype on its device, uploaded once."""
    key = (like.dtype, str(like.device))
    c = _BASES.get(key)
    if c is None:
        c = _BASES[key] = torch.as_tensor(_ortho_basis(), dtype=like.dtype,
                                          device=like.device)
    return c


def fdct(blocks: torch.Tensor) -> torch.Tensor:
    """Forward orthonormal 8x8 DCT over [..., 8, 8] blocks (float)."""
    c = _basis(blocks)
    return c @ blocks @ c.T


def idct(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse orthonormal 8x8 DCT over [..., 8, 8] blocks (float)."""
    c = _basis(coeffs)
    return c.T @ coeffs @ c


def to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [..., H//8 * W//8, 8, 8] row-major block order."""
    *lead, h, w = plane.shape
    x = plane.reshape(*lead, h // 8, 8, w // 8, 8).transpose(-3, -2)
    return x.reshape(*lead, (h // 8) * (w // 8), 8, 8)


def from_blocks(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of to_blocks."""
    *lead, _, _, _ = blocks.shape
    x = blocks.reshape(*lead, h // 8, w // 8, 8, 8).transpose(-3, -2)
    return x.reshape(*lead, h, w)
