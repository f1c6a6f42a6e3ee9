"""Colour-space math: YUV<->RGB matrices and range conversion.

Port of librempeg_tpu/ops/colorspace.py. The matrices are the same
float64 numpy code as the JAX package's, so both packages convert with
identical coefficients. The conversion is one 3x3 float32 matmul plus an
offset over [..., 3] pixels; the JAX package runs it at HIGHEST
precision, and here torch.matmul runs it in float32 with TF32 off
(device.py).

Coefficient sets follow the standard Kr/Kb definitions (BT.601, BT.709,
BT.2020); ranges follow MPEG (Y 16..235, C 16..240) vs JPEG (full).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_KR_KB = {
    "bt601": (0.299, 0.114),
    "bt709": (0.2126, 0.0722),
    "bt2020": (0.2627, 0.0593),
    "smpte240m": (0.212, 0.087),
    "fcc": (0.30, 0.11),
}


@functools.lru_cache(maxsize=None)
def rgb_to_yuv_matrix(csp: str = "bt601", full_range: bool = False
                      ) -> tuple[np.ndarray, np.ndarray]:
    """(M, offset): yuv = M @ rgb + offset, all in 0..255 domain."""
    kr, kb = _KR_KB[csp]
    kg = 1.0 - kr - kb
    # analog matrix: Ey in [0,1], Pb/Pr in [-.5,.5]
    m = np.array([
        [kr, kg, kb],
        [-0.5 * kr / (1 - kb), -0.5 * kg / (1 - kb), 0.5],
        [0.5, -0.5 * kg / (1 - kr), -0.5 * kb / (1 - kr)],
    ])
    if full_range:
        scale = np.diag([1.0, 1.0, 1.0])
        off = np.array([0.0, 128.0, 128.0])
    else:
        scale = np.diag([219.0 / 255.0, 224.0 / 255.0, 224.0 / 255.0])
        off = np.array([16.0, 128.0, 128.0])
    return (scale @ m).astype(np.float64), off


@functools.lru_cache(maxsize=None)
def yuv_to_rgb_matrix(csp: str = "bt601", full_range: bool = False
                      ) -> tuple[np.ndarray, np.ndarray]:
    """(M, offset): rgb = M @ (yuv + offset) -- offset applied pre-matrix."""
    m, off = rgb_to_yuv_matrix(csp, full_range)
    inv = np.linalg.inv(m)
    return inv, -off


def _mat_t(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """m.T cast to float32 as the JAX package casts it, on like's
    device."""
    return torch.as_tensor(m.T.astype(np.float32), device=like.device)


def yuv_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
               csp: str = "bt601", full_range: bool = False) -> torch.Tensor:
    """Full-res float32 planes [..., H, W] -> [..., H, W, 3] float RGB
    0..255."""
    m, off = yuv_to_rgb_matrix(csp, full_range)
    # the offsets are float64 scalars added to float32 planes: float32
    # results, as in the JAX package
    yuv = torch.stack([y + float(off[0]), u + float(off[1]),
                       v + float(off[2])], dim=-1)
    return torch.matmul(yuv, _mat_t(m, yuv))


def rgb_to_yuv(rgb: torch.Tensor, csp: str = "bt601",
               full_range: bool = False):
    """[..., H, W, 3] float32 RGB 0..255 -> (y, u, v) full-res float
    planes."""
    m, off = rgb_to_yuv_matrix(csp, full_range)
    yuv = torch.matmul(rgb, _mat_t(m, rgb))
    yuv = yuv + torch.as_tensor(off.astype(np.float32), device=rgb.device)
    return yuv[..., 0], yuv[..., 1], yuv[..., 2]


def range_convert(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  src_full: bool, dst_full: bool):
    """Limited<->full range luma/chroma rescale (swscale's range
    vectors)."""
    if src_full == dst_full:
        return y, u, v
    if src_full:  # full -> limited
        return (y * (219.0 / 255.0) + 16.0,
                (u - 128.0) * (224.0 / 255.0) + 128.0,
                (v - 128.0) * (224.0 / 255.0) + 128.0)
    # limited -> full
    return ((y - 16.0) * (255.0 / 219.0),
            (u - 128.0) * (255.0 / 224.0) + 128.0,
            (v - 128.0) * (255.0 / 224.0) + 128.0)
