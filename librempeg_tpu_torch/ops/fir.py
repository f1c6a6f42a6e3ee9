"""Separable polyphase FIR resize as float32 GEMMs.

Port of librempeg_tpu/ops/fir.py: an axis resize is a banded linear map
src -> dst, materialised as a dense [dst, src] matrix, and a plane
resize is out = M_v @ X @ M_h^T. The JAX package leaves the products to
XLA at HIGHEST precision; here they are torch.matmul in float32 with
TF32 off (see device.py). resize_matrix is the same numpy code as the
JAX package's, so both packages resize with identical matrices.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from librempeg_tpu_torch.ops.firdesign import clamp_filter_edges, scale_filter


@functools.lru_cache(maxsize=256)
def resize_matrix(src: int, dst: int, kernel: str = "bicubic") -> np.ndarray:
    """[dst, src] dense resize matrix with replicate edge handling."""
    taps, index = scale_filter(src, dst, kernel)
    taps, index = clamp_filter_edges(taps, index, src)
    m = np.zeros((dst, src), np.float32)
    n_taps = taps.shape[1]
    for d in range(dst):
        m[d, index[d]:index[d] + n_taps] += taps[d]
    return m


_DEV_MATS: dict = {}


def _mat(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """The resize matrix on `like`'s device, uploaded once."""
    key = (id(m), str(like.device))
    hit = _DEV_MATS.get(key)
    if hit is None:            # the entry keeps m alive, so id(m) holds
        hit = _DEV_MATS[key] = (m, torch.as_tensor(m, device=like.device))
    return hit[1]


def resize_v(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """Resize the second-to-last axis: [..., H, W] with m [H', H]."""
    return torch.matmul(_mat(m, x), x)


def resize_h(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """Resize the last axis: [..., H, W] with m [W', W]."""
    return torch.matmul(x, _mat(m, x).T)


def resize_plane(x: torch.Tensor, dst_h: int, dst_w: int,
                 kernel: str = "bicubic") -> torch.Tensor:
    """Full separable resize of [..., H, W] float32 tensors."""
    *_, h, w = x.shape
    if h != dst_h:
        x = resize_v(x, resize_matrix(h, dst_h, kernel))
    if w != dst_w:
        x = resize_h(x, resize_matrix(w, dst_w, kernel))
    return x
