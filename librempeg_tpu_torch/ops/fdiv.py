"""Division by a constant, rounded once on every device.

PyTorch's CUDA `tensor / number` (and a division by a 0-dim CPU tensor,
which it treats as the same CPU scalar) multiplies by the number's
reciprocal, rounded to the tensor's type first: two roundings, where
the CPU and XLA divide with one. Where the divisor is not a power of
two the quotient can then land one ulp off, and a quantiser that
truncates or rounds it can pick another level. fdiv divides by a 0-dim
tensor on the dividend's device, which every backend divides elementwise.
The divisor tensors are made once per (value, type, device) and kept,
so a call after the first makes no copy to the card.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=4096)
def _divisor(d: float, dtype: torch.dtype, device: torch.device):
    return torch.tensor(d, dtype=dtype, device=device)


def fdiv(a: torch.Tensor, d: float) -> torch.Tensor:
    """a / d rounded once, on a's device (d a Python number; an integer
    tensor divides into the default float type, as `a / d` does)."""
    dtype = a.dtype if a.is_floating_point() else torch.get_default_dtype()
    return a / _divisor(float(d), dtype, a.device)
