"""Transform library: FFT / RDFT / MDCT / DCT-II/III/IV / DST-I.

Port of librempeg_tpu/ops/tx.py (the av_tx analog). Every transform
works on the last axis of a tensor of any batch shape, on the tensor's
device, and keeps the JAX package's conventions (FFT unscaled, DCT-II
with factor 2, MDCT forward scaled by 1 and inverse by 2/N).

As in the JAX package, the short transforms (N <= _MATMUL_MAX_N: the
MDCT 2048/256 of AAC, the DCTs of image codecs) are one float32 product
with a basis built once in float64 on the host; DCT-II/III and the MDCT
pair take FFT forms above that length. The product is torch.matmul with
TF32 off (device.py), as the JAX package runs it at HIGHEST precision.
The float32 basis is uploaded once per device and cached.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

import librempeg_tpu_torch.device  # noqa: F401  (TF32 off)
from librempeg_tpu_torch.ops.fdiv import fdiv

# Above this length the FFT forms replace the O(N^2) product.
_MATMUL_MAX_N = 4096


# ---------------------------------------------------------------------------
# Basis matrices (host, float64, cached; cast and uploaded at use)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dct2_basis(n: int) -> np.ndarray:
    """DCT-II basis: X[k] = 2 * sum_j x[j] cos(pi k (2j+1) / (2N))."""
    j = np.arange(n)
    k = np.arange(n)[:, None]
    return 2.0 * np.cos(np.pi * k * (2 * j + 1) / (2 * n))


@functools.lru_cache(maxsize=None)
def _dct3_basis(n: int) -> np.ndarray:
    """DCT-III basis: X[k] = x[0] + 2 * sum_j x[j] cos(pi j (2k+1) / (2N))."""
    j = np.arange(n)[None, :]
    k = np.arange(n)[:, None]
    m = 2.0 * np.cos(np.pi * j * (2 * k + 1) / (2 * n))
    m[:, 0] = 1.0
    return m


@functools.lru_cache(maxsize=None)
def _dct4_basis(n: int) -> np.ndarray:
    """DCT-IV basis: X[k] = 2 * sum_j x[j] cos(pi (2j+1)(2k+1) / (4N))."""
    j = np.arange(n)[None, :]
    k = np.arange(n)[:, None]
    return 2.0 * np.cos(np.pi * (2 * j + 1) * (2 * k + 1) / (4 * n))


@functools.lru_cache(maxsize=None)
def _dst1_basis(n: int) -> np.ndarray:
    """DST-I basis: X[k] = 2 * sum_j x[j] sin(pi (j+1)(k+1) / (N+1))."""
    j = np.arange(n)[None, :]
    k = np.arange(n)[:, None]
    return 2.0 * np.sin(np.pi * (j + 1) * (k + 1) / (n + 1))


@functools.lru_cache(maxsize=None)
def _mdct_fwd_basis(n: int) -> np.ndarray:
    """Forward MDCT: 2N inputs -> N outputs.

    X[k] = sum_{j=0}^{2N-1} x[j] cos(pi/N (j + 1/2 + N/2) (k + 1/2))
    """
    j = np.arange(2 * n)[None, :]
    k = np.arange(n)[:, None]
    return np.cos(np.pi / n * (j + 0.5 + n / 2) * (k + 0.5))


@functools.lru_cache(maxsize=None)
def _mdct_inv_basis(n: int) -> np.ndarray:
    """Inverse MDCT: N inputs -> 2N outputs (scaled by 2/N for perfect
    reconstruction after windowed 50% overlap-add)."""
    return _mdct_fwd_basis(n).T * (2.0 / n)


@functools.lru_cache(maxsize=32)
def _basis_t(kind, n: int, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """basis(n).T as `dtype` on `device` (uploaded once)."""
    return torch.from_numpy(np.ascontiguousarray(kind(n).T)).to(
        device=device, dtype=dtype)


def _contract(x: torch.Tensor, kind, n: int) -> torch.Tensor:
    """out[..., k] = sum_j x[..., j] B[k, j] for B = kind(n), computed
    as x @ B.T in x's dtype (float32 on the path)."""
    return torch.matmul(x, _basis_t(kind, n, x.dtype, x.device))


# ---------------------------------------------------------------------------
# Public transforms
# ---------------------------------------------------------------------------


def fft(x: torch.Tensor) -> torch.Tensor:
    """Complex FFT along the last axis (unscaled, like av_tx FFT)."""
    return torch.fft.fft(x)


def ifft(x: torch.Tensor) -> torch.Tensor:
    """Scaled inverse complex FFT: ifft(fft(x)) == x."""
    return torch.fft.ifft(x)


def rdft(x: torch.Tensor) -> torch.Tensor:
    """Real-input FFT along the last axis -> N//2+1 complex bins."""
    return torch.fft.rfft(x)


def irdft(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.fft.irfft(x, n=n)


def dct_ii(x: torch.Tensor) -> torch.Tensor:
    """DCT-II (the 'DCT'), unnormalized (factor 2): the reference's
    AV_TX_FLOAT_DCT forward convention."""
    if x.shape[-1] <= _MATMUL_MAX_N:
        return _contract(x, _dct2_basis, x.shape[-1])
    return _dct2_fft(x)


def dct_iii(x: torch.Tensor) -> torch.Tensor:
    """DCT-III (inverse DCT). dct_iii(dct_ii(x)) == 2*N*x."""
    if x.shape[-1] <= _MATMUL_MAX_N:
        return _contract(x, _dct3_basis, x.shape[-1])
    return _dct3_fft(x)


def dct_iv(x: torch.Tensor) -> torch.Tensor:
    """DCT-IV, unnormalized (factor 2). Self-inverse up to 2N scale."""
    return _contract(x, _dct4_basis, x.shape[-1])


def dst_i(x: torch.Tensor) -> torch.Tensor:
    """DST-I, unnormalized (factor 2)."""
    return _contract(x, _dst1_basis, x.shape[-1])


def mdct(x: torch.Tensor) -> torch.Tensor:
    """Forward MDCT: [..., 2N] windowed samples -> [..., N] coefficients."""
    n2 = x.shape[-1]
    if n2 % 2:
        raise ValueError(f"mdct: odd input length {n2}")
    if n2 // 2 <= _MATMUL_MAX_N:
        return _contract(x, _mdct_fwd_basis, n2 // 2)
    return _mdct_fft(x)


def imdct(x: torch.Tensor) -> torch.Tensor:
    """Inverse MDCT: [..., N] coefficients -> [..., 2N] time samples.

    imdct(mdct(x)) reproduces x after windowing + 50% overlap-add with a
    Princen-Bradley window (sin or KBD).
    """
    if x.shape[-1] <= _MATMUL_MAX_N:
        return _contract(x, _mdct_inv_basis, x.shape[-1])
    return _imdct_fft(x)


# ---------------------------------------------------------------------------
# FFT forms of the long transforms
# ---------------------------------------------------------------------------


def _twiddle(n: int, sign: float, like: torch.Tensor) -> torch.Tensor:
    """exp(sign * 1j * pi * k / (2n)), k < n, complex of x's width."""
    k = np.arange(n)
    tw = np.exp(sign * 1j * np.pi * k / (2 * n))
    cdt = torch.complex64 if like.dtype == torch.float32 else torch.complex128
    return torch.from_numpy(tw).to(device=like.device, dtype=cdt)


def _dct2_fft(x: torch.Tensor) -> torch.Tensor:
    """DCT-II via a 2N real FFT of the even-symmetric extension."""
    n = x.shape[-1]
    ext = torch.cat([x, x.flip(-1)], dim=-1)
    spec = torch.fft.rfft(ext)[..., :n]
    return torch.real(spec * _twiddle(n, -1.0, x)).to(x.dtype)


def _dct3_fft(x: torch.Tensor) -> torch.Tensor:
    """DCT-III via the inverse of the even-extension rFFT of _dct2_fft
    (2N times the functional inverse of DCT-II)."""
    n = x.shape[-1]
    tw = _twiddle(n, 1.0, x)
    spec = torch.zeros(x.shape[:-1] + (n + 1,), dtype=tw.dtype,
                       device=x.device)
    spec[..., :n] = x.to(tw.dtype) * tw
    ext = torch.fft.irfft(spec, n=2 * n)
    return (2 * n * ext[..., :n]).to(x.dtype)


def _mdct_fft(x: torch.Tensor) -> torch.Tensor:
    """MDCT via DCT-IV: fold the 2N window into N, then DCT-IV."""
    n = x.shape[-1] // 2
    h = n // 2
    a, b, c, d = (x[..., :h], x[..., h:n], x[..., n:n + h], x[..., n + h:])
    folded = torch.cat([-c.flip(-1) - d, a - b.flip(-1)], dim=-1)
    # MDCT(x)[k] = DCT-IV(folded)[k] / 2 with the factor-2 dct_iv
    return dct_iv(folded) / 2


def _imdct_fft(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    h = n // 2
    y = fdiv(dct_iv(x), n)  # DCT-IV self-inverse (up to 2N); 2/N output scale
    u, v = y[..., :h], y[..., h:]
    # unfold: [v, -v_r, -u_r, -u]
    return torch.cat([v, -v.flip(-1), -u.flip(-1), -u], dim=-1)


# ---------------------------------------------------------------------------
# Windows (host numpy, float64)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def sine_window(n: int) -> np.ndarray:
    """Princen-Bradley sine window of length n (half of a 2N MDCT frame)."""
    return np.sin(np.pi / n * (np.arange(n) + 0.5))


@functools.lru_cache(maxsize=None)
def kbd_window(n: int, alpha: float = 4.0) -> np.ndarray:
    """Kaiser-Bessel derived window (AAC uses alpha=4 long, 6 short)."""
    from librempeg_tpu_torch.ops.firdesign import i0

    v = np.array([i0(np.pi * alpha * math.sqrt(1 - (2 * i / n - 1) ** 2))
                  for i in range(n + 1)])
    return np.sqrt(np.cumsum(v)[:n] / v.sum())
