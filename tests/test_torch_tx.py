"""The port's transforms (librempeg_tpu_torch/ops/tx.py) against the JAX
package's (librempeg_tpu/ops/tx.py) on the CPU.

Both compute the same float32 products (or FFT forms) from the same
float64 bases, summed in another order: each transform must agree
within 1e-5 of its output's scale (the largest magnitude), at a small
length and at one above _MATMUL_MAX_N, where DCT-II/III and the MDCT
pair switch to their FFT forms. The MDCT pair must also reconstruct
its input by windowed overlap-add (TDAC).
"""
import numpy as np
import pytest
import torch

from librempeg_tpu.ops import tx as J
from librempeg_tpu_torch.ops import tx as T

TOL = 1e-5
BIG = J._MATMUL_MAX_N + 8      # above the product form's limit


def _close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    print(f"{what}: max |err| / scale = {err:.2e}")
    assert err <= TOL, what


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("n", [16, 1024, BIG])
@pytest.mark.parametrize("name", ["dct_ii", "dct_iii", "dct_iv", "dst_i"])
def test_real_transforms_match_jax(name, n):
    x = _x((2, n), n)
    _close(getattr(T, name)(torch.from_numpy(x)),
           getattr(J, name)(x), f"{name} n={n}")


@pytest.mark.parametrize("n", [8, 1024, BIG])
def test_mdct_pair_matches_jax(n):
    x = _x((2, 2 * n), n)
    _close(T.mdct(torch.from_numpy(x)), J.mdct(x), f"mdct n={n}")
    c = _x((2, n), n + 1)
    _close(T.imdct(torch.from_numpy(c)), J.imdct(c), f"imdct n={n}")


@pytest.mark.parametrize("n", [64, 4100])
def test_fft_family_matches_jax(n):
    x = _x((3, n), n)
    z = (x + 1j * _x((3, n), n + 1)).astype(np.complex64)
    _close(T.fft(torch.from_numpy(z)), J.fft(z), f"fft n={n}")
    _close(T.ifft(torch.from_numpy(z)), J.ifft(z), f"ifft n={n}")
    r = T.rdft(torch.from_numpy(x))
    _close(r, J.rdft(x), f"rdft n={n}")
    _close(T.irdft(r, n), x, f"irdft(rdft) n={n}")


@pytest.mark.parametrize("n", [256, 1024])
def test_mdct_tdac(n):
    """Sine-windowed MDCT, IMDCT and 50% overlap-add give the input back
    away from the two ends."""
    x = _x((1, 6 * n), 7)
    w = torch.from_numpy(T.sine_window(2 * n).astype(np.float32))
    xt = torch.from_numpy(x)
    out = torch.zeros_like(xt)
    for s in range(0, 5 * n, n):
        seg = xt[:, s:s + 2 * n] * w
        out[:, s:s + 2 * n] += T.imdct(T.mdct(seg)) * w
    err = float((out[:, n:5 * n] - xt[:, n:5 * n]).abs().max())
    assert err <= 1e-4, err


def test_windows_match_jax():
    assert np.array_equal(T.sine_window(2048), J.sine_window(2048))
    assert np.array_equal(T.kbd_window(256, 6.0), J.kbd_window(256, 6.0))
