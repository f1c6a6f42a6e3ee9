"""The noise shaper kernel's fast rounding, on the CPU (no card needed).

csrc/shape_scan.cu rounds t to an integer as (t + 1.5*2^23) - 1.5*2^23
where a per-chunk range test proves |t| < 2^22, and by rintf elsewhere.
These tests hold the arithmetic that design rests on, in numpy float32
and through the plain scan (resample/dither.shape_scan_plain):

- the fast form equals np.rint by value on every half-integer and its
  neighbouring floats up to 2^22, both signs, and differs from it above;
- the kernel's range test, computed here from _SHAPER_COEFS chunk by
  chunk as the kernel computes it, passes on the dithered audio path's
  inputs and covers every |t| the plain scan meets there, and each
  chunk's errors stay within the bound carried to the next chunk;
- a history of -0.0 and one of +0.0 give equal outputs by value (the
  fast form's only difference from rintf is a zero's sign).
"""
import os
import re

import numpy as np
import pytest
import torch

from librempeg_tpu_torch.resample import dither as RD
from librempeg_tpu_torch.resample.resampler import Resampler
from librempeg_tpu_torch.utils import testgen

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "librempeg_tpu_torch", "csrc", "shape_scan.cu")
MAGIC = np.float32(1.5 * 2 ** 23)
LIMIT = 2.0 ** 21          # the range test's limit (kLimit)
CHUNK = 32                 # samples per chunk (U)


def _fast(t: np.ndarray) -> np.ndarray:
    t = np.asarray(t, np.float32)
    return (t + MAGIC) - MAGIC


def test_source_constants():
    """The constants these tests assume are the kernel's."""
    src = open(SRC).read()
    consts = dict(re.findall(r"constexpr \w+ (\w+) = ([\d.]+)f?;", src))
    assert float(consts["kMagic"].rstrip("f")) == float(MAGIC)
    assert float(consts["kLimit"].rstrip("f")) == LIMIT
    assert int(consts["U"]) == CHUNK


@pytest.mark.parametrize("sign", [1, -1])
def test_fast_rounding_equals_rint_up_to_2_22(sign):
    """Every half-integer k + 0.5 below 2^22 and the floats on either
    side of it, and every integer: the fast form equals np.rint by value
    (ties to even)."""
    for lo in range(0, 2 ** 22, 2 ** 20):
        k = np.arange(lo, lo + 2 ** 20, dtype=np.float32)
        half = k + np.float32(0.5)
        t = np.concatenate([k, half, np.nextafter(half, np.float32(0)),
                            np.nextafter(half, np.float32(np.inf))])
        t = np.float32(sign) * t
        got, want = _fast(t), np.rint(t)
        bad = np.flatnonzero(got != want)
        assert bad.size == 0, (t[bad[:5]], got[bad[:5]], want[bad[:5]])
    t = np.float32(sign * 2.0 ** 22)
    assert _fast(t) == np.rint(t)


def test_fast_rounding_differs_above_2_22():
    """Above 2^22 the addition rounds to multiples of 2 (or 1/2 below
    -2^22), so the fast form is wrong for some t: why the range test
    exists."""
    t = np.arange(2 ** 22, 2 ** 22 + 64, 0.5, dtype=np.float32)
    t = np.concatenate([t, -t])
    bad = t[_fast(t) != np.rint(t)]
    assert bad.size > 0
    assert np.all(np.abs(bad) > 2 ** 22)
    # the first one: 2^22 + 1 -> 2^24 + 1 rounds to the even 2^24
    assert float(bad[0]) == 2 ** 22 + 1 and _fast(bad[0]) == 2 ** 22


def _path_inputs(n: int = 2240):
    """Two converts of the dithered audio path: testgen.audio_mix
    resampled from 44.1 to 48 kHz in LSB units and the lipshitz
    ditherer's noise, [2, n] float32."""
    x = torch.from_numpy(testgen.audio_mix(44100, 2 * n)).float()
    r = Resampler(44100, 48000, 2, device="cpu")
    xl = (r.process(x) * 32768.0)[:, :n].contiguous()
    noise = torch.from_numpy(RD.Ditherer("lipshitz")._noise((2, n)))
    return xl, noise


@pytest.mark.parametrize("method", sorted(RD._SHAPER_COEFS))
def test_range_bound_covers_the_path(method):
    """The kernel's test X + D + S * E' < 2^21 (E' = max(E, 1.5 + D),
    the bound E carried from chunk to chunk) passes on every chunk of
    the path's inputs, covers every |t| the plain scan meets (|t| <=
    |y| + 0.5, as y = rint(t)), and the chunk's errors, which become
    the next chunk's history, stay within E'."""
    xl, noise = _path_inputs()
    cs = RD._SHAPER_COEFS[method]
    coefs = torch.tensor(cs, dtype=torch.float32)
    s = sum(abs(c) for c in cs)
    hist = torch.zeros((len(cs), 2), dtype=torch.float32)
    e = np.zeros(2)
    for base in range(0, xl.shape[1], CHUNK):
        x, d = xl[:, base:base + CHUNK], noise[:, base:base + CHUNK]
        xm = x.abs().max(1).values.double().numpy()
        dm = d.abs().max(1).values.double().numpy()
        e1 = np.maximum(e, 1.5 + dm)
        bound = xm + dm + s * e1
        assert np.all(bound < LIMIT), (base, bound)
        y, hist = RD.shape_scan_plain(x, d, coefs, hist)
        assert np.all(y.abs().max(1).values.double().numpy() + 0.5 <= bound)
        assert np.all(hist.abs().max(0).values.double().numpy() <= e1)
        e = e1
    # the path's samples are far inside the limit
    assert float(xl.abs().max()) < 2 ** 16


@pytest.mark.parametrize("k", [3, 5])
def test_zero_sign_of_the_history(k):
    """err0 of -0.0 and of +0.0 give y equal by value and equal later
    outputs: a zero's sign never reaches a later value."""
    rng = np.random.default_rng(k)
    n = 200
    x = rng.integers(-3, 4, (3, n)).astype(np.float32)
    x[0] = 0.0
    x[1, ::2] = -0.0
    noise = np.where(rng.random((3, n)) < 0.5, 0.0,
                     rng.random((3, n)) - rng.random((3, n)))
    noise = noise.astype(np.float32)
    noise[0] = -0.0
    method = {3: "f_weighted", 5: "lipshitz"}[k]
    coefs = torch.tensor(RD._SHAPER_COEFS[method], dtype=torch.float32)
    xt, nt = torch.from_numpy(x), torch.from_numpy(noise)
    outs = [RD.shape_scan_plain(xt, nt, coefs,
                                torch.full((k, 3), z, dtype=torch.float32))
            for z in (-0.0, 0.0)]
    (ym, hm), (yp, hp) = outs
    assert torch.equal(ym, yp) and torch.equal(hm, hp)
    # and the calls that follow, from each history
    assert torch.equal(RD.shape_scan_plain(xt, nt, coefs, hm)[0],
                       RD.shape_scan_plain(xt, nt, coefs, hp)[0])
