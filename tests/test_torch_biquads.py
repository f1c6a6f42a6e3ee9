"""The port's biquad filters (filters/biquads.py) against the JAX
package's, on the CPU, and the plain recurrence's float form.

Every RBJ kind and `biquad` runs through both packages' GraphRunner at
1, 2 and 6 channels, s16 and fltp, in frames cut at uneven lengths so
that the state carried between frames is tested. The outputs are equal
by value (the float contract's tolerance is 0): the plain version takes
the two-or-more-channel form of XLA's scan (csrc/biquad.cu says which).
For one channel the JAX scan rounds b0 * x before adding z1, so a mono
graph is held to the JAX package's _df2t_scan called on the channel
duplicated into two (ROADMAP section 3).

The plain version computes each fused multiply-add as a float64 sum
rounded once to float32; test_plain_form_is_single_rounded holds it to
a correctly rounded fmaf (exact rational arithmetic) on every step of
two filters, which a double rounding would break.
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from librempeg_tpu.core.frame import AudioFrame as JFrame
from librempeg_tpu.core.rational import Rational as JR
from librempeg_tpu.core.samplefmt import ChannelLayout as JL
from librempeg_tpu.filters import GraphRunner as JGraph
from librempeg_tpu.filters import StreamProps as JProps
from librempeg_tpu.filters.biquads import _df2t_scan
from librempeg_tpu_torch.core.frame import AudioFrame as TFrame
from librempeg_tpu_torch.core.rational import Rational as TR
from librempeg_tpu_torch.core.samplefmt import ChannelLayout as TL
from librempeg_tpu_torch.filters import GraphRunner as TGraph
from librempeg_tpu_torch.filters import StreamProps as TProps
from librempeg_tpu_torch.kernels.biquad import biquad_plain

RATE = 44100
CUTS = (1023, 517, 64, 1, 300, 2048)        # uneven frame lengths

FILTERS = [
    "lowpass=f=500",
    "lowpass=f=12000",
    "highpass=f=80",
    "bandpass=f=3000:w=2",
    "bandreject=f=1000:w=1",
    "allpass=f=1000",
    "equalizer=f=3000:g=3:w=1",
    "equalizer=f=1000:g=-6:w=0.5",
    "bass=g=-2",
    "bass=f=120:g=6",
    "treble=g=5",
    "biquad=b0=0.2:b1=0.3:b2=0.1:a0=1:a1=-0.5:a2=0.2",
]


def _signal(ch, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / RATE
    x = 0.4 * np.sin(2 * np.pi * 220 * t)[None] \
        + 0.2 * rng.standard_normal((ch, n))
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def _frames(ch, fmt):
    x = _signal(ch, sum(CUTS))
    if fmt == "s16p":
        x = np.round(x * 32767).astype(np.int16)
    out, pos = [], 0
    for n in CUTS:
        out.append((x[:, pos:pos + n], pos))
        pos += n
    return out


def _run(P, R, L, Frame, Graph, desc, ch, fmt, to_data):
    props = P(media="audio", sample_rate=RATE, sample_fmt=fmt,
              layout=L.default(ch), time_base=R(1, RATE))
    g = Graph(desc, props)
    out = []
    for data, pts in _frames(ch, fmt):
        out += g.push(Frame(data=to_data(data), sample_rate=RATE,
                            sample_fmt=fmt, layout=L.default(ch), pts=pts,
                            time_base=R(1, RATE)))
    out += g.finish()
    return out


def _jax_out(desc, ch, fmt):
    return _run(JProps, JR, JL, JFrame, JGraph, desc, ch, fmt,
                lambda d: d)


def _port_out(desc, ch, fmt):
    return _run(TProps, TR, TL, TFrame, TGraph, desc, ch, fmt,
                torch.from_numpy)


def _cat(frames):
    return np.concatenate([np.asarray(f.data) if not isinstance(
        f.data, torch.Tensor) else f.data.numpy() for f in frames], 1)


@pytest.mark.parametrize("fmt", ["fltp", "s16p"])
@pytest.mark.parametrize("ch", [2, 6])
@pytest.mark.parametrize("desc", FILTERS)
def test_biquad_matches_jax(desc, ch, fmt):
    jo, to = _jax_out(desc, ch, fmt), _port_out(desc, ch, fmt)
    assert [f.pts for f in jo] == [f.pts for f in to]
    a, b = _cat(jo), _cat(to)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _coefs(desc):
    """The float32 (b, a) the filter `desc` runs with at RATE."""
    from librempeg_tpu_torch.filters import find_filter

    f = find_filter(desc.split("=")[0])(desc.partition("=")[2])
    b, a = f._coeffs(RATE)
    return (np.asarray([c / a[0] for c in b], np.float32),
            np.asarray([a[1] / a[0], a[2] / a[0]], np.float32))


@pytest.mark.parametrize("fmt", ["fltp", "s16p"])
@pytest.mark.parametrize("desc", FILTERS)
def test_mono_matches_the_duplicated_scan(desc, fmt):
    """Mono: the port's output is the JAX scan's on the channel
    duplicated into two, frame by frame with the state carried."""
    from librempeg_tpu.codecs.pcm import from_float, to_float

    b, a = _coefs(desc)
    z = jnp.zeros((2, 2), jnp.float32)
    want = []
    for data, _ in _frames(1, fmt):
        x = to_float(np.asarray(data), fmt)
        y, z = _df2t_scan(jnp.asarray(b), jnp.asarray(a),
                          jnp.asarray(np.concatenate([x, x]), jnp.float32),
                          z)
        want.append(from_float(np.asarray(y)[:1], fmt))
    got = _cat(_port_out(desc, 1, fmt))
    np.testing.assert_array_equal(got, np.concatenate(want, 1))


def test_mono_scan_differs_from_the_duplicated_scan():
    """The deviation the port takes: the JAX scan on one channel rounds
    b0 * x before the add and reads differently."""
    b, a = _coefs("lowpass=f=500")
    x = _signal(1, 4000)
    z = np.zeros((1, 2), np.float32)
    y1, _ = _df2t_scan(jnp.asarray(b), jnp.asarray(a), jnp.asarray(x),
                       jnp.asarray(z))
    y2, _ = _df2t_scan(jnp.asarray(b), jnp.asarray(a),
                       jnp.asarray(np.concatenate([x, x])),
                       jnp.asarray(np.concatenate([z, z])))
    assert np.count_nonzero(np.asarray(y1) != np.asarray(y2)[:1]) > 100


def _f32_round(q: Fraction) -> float:
    """The float32 nearest to the rational q, ties to even."""
    f = float(np.float32(float(q)))
    lo = float(np.nextafter(np.float32(f), np.float32(-np.inf)))
    hi = float(np.nextafter(np.float32(f), np.float32(np.inf)))
    best = min((abs(Fraction(c) - q), c) for c in (lo, f, hi))
    ties = [c for c in (lo, f, hi) if abs(Fraction(c) - q) == best[0]]
    if len(ties) > 1:
        return next(c for c in ties
                    if int(np.float32(c).view(np.int32)) % 2 == 0)
    return best[1]


def _fmaf(a, b, c) -> float:
    return _f32_round(Fraction(a) * Fraction(b) + Fraction(c))


@pytest.mark.parametrize("desc", ["highpass=f=80",
                                  "equalizer=f=3000:g=3:w=1"])
def test_plain_form_is_single_rounded(desc):
    b, a = _coefs(desc)
    x = _signal(2, 600, seed=3)
    z0 = np.array([[0.01, -0.02], [0.0, 0.003]], np.float32)
    y, z = biquad_plain(torch.from_numpy(x), b, a, torch.from_numpy(z0))
    b0, b1, b2 = (float(v) for v in b)
    a1, a2 = (float(v) for v in a)
    for c in range(2):
        z1, z2 = float(z0[c, 0]), float(z0[c, 1])
        for i in range(x.shape[1]):
            xi = float(x[c, i])
            out = _fmaf(b0, xi, z1)
            p1 = float(np.float32(a1 * out))
            p2 = float(np.float32(a2 * out))
            z1 = float(np.float32(_fmaf(b1, xi, -p1) + z2))
            z2 = _fmaf(b2, xi, -p2)
            assert float(y[c, i]) == out, (c, i)
        assert (float(z[c, 0]), float(z[c, 1])) == (z1, z2)
