"""8x8 block DCT/IDCT: the float32 orthonormal path and the integer
simple_idct path.

Port of librempeg_tpu/ops/dct8x8.py: blocks are batched [B, 8, 8]. Each
separable float transform is two small matrix products, C @ x @ C^T;
the basis is the same numpy code as the JAX package's.

The integer path keeps the JAX package's int32 arithmetic (two int32
einsums there): PyTorch has no integer matmul on CUDA, so each pass is a
broadcast multiply and a sum over the 8 taps in int64, which is exact,
brought back to int32 by wrapping before each shift. Since wrapping
commutes with + and *, the result equals the int32 arithmetic even
where a hostile stream overflows it.
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


# -- integer fixed-point path (simple_idct 8-bit numeric contract) -----------

ROW_SHIFT = 11
COL_SHIFT = 20

_W = [0,
      22725,  # round(2^14 * sqrt(2) * cos(1*pi/16))
      21407,  # round(2^14 * sqrt(2) * cos(2*pi/16))
      19266,  # round(2^14 * sqrt(2) * cos(3*pi/16))
      16383,  # 2^14 * sqrt(2) * cos(4*pi/16) = 16384, held at 16383 for headroom
      12873,  # round(2^14 * sqrt(2) * cos(5*pi/16))
      8867,   # round(2^14 * sqrt(2) * cos(6*pi/16))
      4520]   # round(2^14 * sqrt(2) * cos(7*pi/16))


@functools.lru_cache(maxsize=None)
def _int_idct_matrix() -> np.ndarray:
    """The 8x8 integer matrix M with out = M @ in for one IDCT pass
    (before rounding/shift). Rows follow the even/odd butterfly:

      even a_j from in[0,2,4,6], odd b_j from in[1,3,5,7]
      out[j] = a_j + b_j, out[7-j] = a_j - b_j  (j = 0..3)
    """
    W = _W
    a = np.zeros((4, 8), np.int64)
    b = np.zeros((4, 8), np.int64)
    a[0, 0], a[0, 2], a[0, 4], a[0, 6] = W[4], W[2], W[4], W[6]
    a[1, 0], a[1, 2], a[1, 4], a[1, 6] = W[4], W[6], -W[4], -W[2]
    a[2, 0], a[2, 2], a[2, 4], a[2, 6] = W[4], -W[6], -W[4], W[2]
    a[3, 0], a[3, 2], a[3, 4], a[3, 6] = W[4], -W[2], W[4], -W[6]
    b[0, 1], b[0, 3], b[0, 5], b[0, 7] = W[1], W[3], W[5], W[7]
    b[1, 1], b[1, 3], b[1, 5], b[1, 7] = W[3], -W[7], -W[1], -W[5]
    b[2, 1], b[2, 3], b[2, 5], b[2, 7] = W[5], -W[1], W[7], W[3]
    b[3, 1], b[3, 3], b[3, 5], b[3, 7] = W[7], -W[5], W[3], -W[1]
    m = np.zeros((8, 8), np.int64)
    for j in range(4):
        m[j] = a[j] + b[j]
        m[7 - j] = a[j] - b[j]
    return m


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor's values wrapped to int32's range (still int64)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def idct_int(coeffs: torch.Tensor) -> torch.Tensor:
    """Fixed-point 8x8 IDCT over [..., 8, 8] integer blocks -> int32.

    Numeric contract of the reference's simple_idct (8-bit template):
    row pass rounder 1<<10 then >>11; column pass folds its rounder into
    the DC coefficient as (1<<19)//W4 = 32, then >>20. Output is the
    un-clamped residual; callers add prediction and clamp.
    """
    key = (torch.int64, str(coeffs.device))
    m = _BASES.get(key)
    if m is None:
        m = _BASES[key] = torch.as_tensor(_int_idct_matrix(),
                                          device=coeffs.device)
    x = coeffs.to(torch.int32).to(torch.int64)
    # row pass: rows[..., i, k] = sum_j m[k, j] x[..., i, j]
    rows = (x.unsqueeze(-2) * m).sum(-1)
    rows = _wrap32(rows + (1 << (ROW_SHIFT - 1))) >> ROW_SHIFT
    rows[..., 0, :] += (1 << (COL_SHIFT - 1)) // _W[4]
    # column pass: cols[..., k, j] = sum_i m[k, i] rows[..., i, j]
    cols = (m.unsqueeze(-1) * rows.unsqueeze(-3)).sum(-2)
    return (_wrap32(cols) >> COL_SHIFT).to(torch.int32)


def idct_int_put(coeffs: torch.Tensor) -> torch.Tensor:
    """IDCT + clamp to uint8 (idct_put semantics for intra blocks)."""
    return idct_int(coeffs).clamp(0, 255).to(torch.uint8)


def idct_int_add(coeffs: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """IDCT + add prediction + clamp (idct_add semantics for inter
    blocks)."""
    r = idct_int(coeffs) + pred.to(torch.int32)
    return r.clamp(0, 255).to(torch.uint8)
