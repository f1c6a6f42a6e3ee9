"""Runs of biquad filters in the port (filters/biquads.py mark_runs and
cascade, kernels/biquad.py biquad_cascade_plain) against the JAX
package, on the CPU.

The port runs each maximal run of biquad filters as one cascade: the
run's first filter computes every stage, with the sample format's round
trip between stages, and the others pass the frame on. The JAX
package's GraphRunner applies the same filters one by one. Runs of
four (F3's), two and eight mixed kinds, and a run broken by `volume`,
go through both packages at 1, 2 and 6 channels, fltp and s16p, in
frames cut at uneven lengths (tests/test_torch_biquads.py's CUTS), and
must be equal (tolerance 0, as for one filter). Mono is held to the JAX
package's graph on the channel duplicated into two, whose scans take
the fused form the port takes at every channel count
(test_torch_biquads.py says why).

csrc/biquad.cu computes the round trip in float32 as clamp, then
rounding, in the format's integer units; test_kernel_round_trip_form_is_pcms
holds that form, written out in numpy, to codecs/pcm.py's conversions
on the values where they could part (ties, clip edges, signed zeros),
and test_integer_units_stage_is_the_float_stage holds a stage run on
integer values with its b coefficients times the unit to the stage on
the floats.
"""
import numpy as np
import pytest
import torch

from librempeg_tpu.core.frame import AudioFrame as JFrame
from librempeg_tpu.core.rational import Rational as JR
from librempeg_tpu.core.samplefmt import ChannelLayout as JL
from librempeg_tpu.filters import GraphRunner as JGraph
from librempeg_tpu.filters import StreamProps as JProps
from librempeg_tpu_torch.codecs.pcm import from_float, to_float
from librempeg_tpu_torch.core.frame import AudioFrame as TFrame
from librempeg_tpu_torch.core.rational import Rational as TR
from librempeg_tpu_torch.core.samplefmt import ChannelLayout as TL
from librempeg_tpu_torch.filters import GraphRunner as TGraph
from librempeg_tpu_torch.filters import StreamProps as TProps
from librempeg_tpu_torch.filters import biquads as BQ
from librempeg_tpu_torch.kernels.biquad import (biquad_cascade_plain,
                                                biquad_plain)

RATE = 44100
CUTS = (1023, 517, 64, 1, 300, 2048)        # uneven frame lengths

RUNS = {
    "f3": "highpass=f=80,lowpass=f=12000,equalizer=f=3000:g=3:w=1,"
          "bass=g=-2",
    "two": "bass=f=120:g=6,lowpass=f=500",
    "eight": "lowpass=f=12000,highpass=f=80,bandpass=f=3000:w=2,"
             "bandreject=f=1000:w=1,allpass=f=1000,"
             "equalizer=f=1000:g=-6:w=0.5,treble=g=5,"
             "biquad=b0=0.2:b1=0.3:b2=0.1:a0=1:a1=-0.5:a2=0.2",
    "broken": "highpass=f=80,lowpass=f=12000,volume=0.5,"
              "equalizer=f=3000:g=3:w=1,bass=g=-2",
}


def _signal(ch, n, seed=0):
    """A tone and noise near full scale, so that the boosting stages
    clip in the integer formats."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / RATE
    x = 0.6 * np.sin(2 * np.pi * 110 * t)[None] \
        + 0.25 * rng.standard_normal((ch, n))
    return np.clip(x, -0.999, 0.999).astype(np.float32)


def _frames(x, fmt):
    if fmt == "s16p":
        x = np.round(x * 32767).astype(np.int16)
    out, pos = [], 0
    for n in CUTS:
        out.append((x[:, pos:pos + n], pos))
        pos += n
    return out


def _run(P, R, L, Frame, Graph, desc, x, fmt, to_data):
    ch = x.shape[0]
    props = P(media="audio", sample_rate=RATE, sample_fmt=fmt,
              layout=L.default(ch), time_base=R(1, RATE))
    g = Graph(desc, props)
    out = []
    for data, pts in _frames(x, fmt):
        out += g.push(Frame(data=to_data(data), sample_rate=RATE,
                            sample_fmt=fmt, layout=L.default(ch), pts=pts,
                            time_base=R(1, RATE)))
    return out + g.finish(), g


def _cat(frames):
    return np.concatenate([f.data.numpy() if isinstance(
        f.data, torch.Tensor) else np.asarray(f.data) for f in frames], 1)


@pytest.mark.parametrize("fmt", ["fltp", "s16p"])
@pytest.mark.parametrize("ch", [1, 2, 6])
@pytest.mark.parametrize("run", sorted(RUNS))
def test_run_matches_jax(run, ch, fmt):
    desc = RUNS[run]
    x = _signal(ch, sum(CUTS))
    to, g = _run(TProps, TR, TL, TFrame, TGraph, desc, x, fmt,
                 torch.from_numpy)
    # mono against the duplicated channel (the fused form)
    jx = np.concatenate([x, x]) if ch == 1 else x
    jo, _ = _run(JProps, JR, JL, JFrame, JGraph, desc, jx, fmt, lambda d: d)
    assert [f.pts for f in jo] == [f.pts for f in to]
    a, b = _cat(jo)[:ch], _cat(to)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    # the run went through the cascade: its head holds every stage
    heads = [n.filter for n in g.graph.nodes
             if isinstance(n.filter, BQ._BiquadBase) and n.filter.run]
    lengths = {"f3": [4], "two": [2], "eight": [8], "broken": [2, 2]}
    assert [len(f.run) for f in heads] == lengths[run]


def _graph_runs(desc, inputs=1):
    props = TProps(media="audio", sample_rate=RATE, sample_fmt="fltp",
                   layout=TL.default(2), time_base=TR(1, RATE))
    g = TGraph(desc, [props] * inputs)
    return [[f.NAME for f in n.filter.run] for n in g.graph._topo()
            if isinstance(n.filter, BQ._BiquadBase) and n.filter.run]


@pytest.mark.parametrize("desc,inputs,runs", [
    ("lowpass", 1, [["lowpass"]]),
    ("highpass,lowpass,volume=0.5,bass,treble,equalizer", 1,
     [["highpass", "lowpass"], ["bass", "treble", "equalizer"]]),
    ("volume=0.5,allpass,aecho,biquad,afade=t=in:d=1", 1,
     [["allpass"], ["biquad"]]),
    ("[in]highpass,lowpass[a];[in2]bass[b];[a][b]amix,treble,allpass", 2,
     [["highpass", "lowpass"], ["bass"], ["treble", "allpass"]]),
])
def test_mark_runs_marks_the_maximal_runs(desc, inputs, runs):
    """Every biquad filter is in exactly one run; a run ends at any other
    filter; the other filters of a run hold none."""
    assert sorted(_graph_runs(desc, inputs)) == sorted(runs)


def _coefs(descs):
    from librempeg_tpu_torch.filters import find_filter

    out = []
    for d in descs:
        f = find_filter(d.split("=")[0])(d.partition("=")[2])
        b, a = f._coeffs(RATE)
        out.append(tuple(np.float32(c / a[0]) for c in b)
                   + (np.float32(a[1] / a[0]), np.float32(a[2] / a[0])))
    return out


@pytest.mark.parametrize("fmt", ["u8", "s16", "s32", "flt"])
def test_cascade_plain_is_the_stages_with_the_round_trip(fmt):
    """biquad_cascade_plain equals S calls of biquad_plain, each stage's
    output converted to the format and back (codecs/pcm.py) before the
    next and after the last, the states carried per stage."""
    coefs = _coefs(RUNS["eight"].split(",")[:4] + ["bass=f=120:g=12"])
    x = torch.from_numpy(_signal(3, 700, seed=5))
    rng = np.random.default_rng(1)
    z = torch.from_numpy(rng.uniform(-0.02, 0.02, (len(coefs), 3, 2))
                         .astype(np.float32))
    y, zo = biquad_cascade_plain(x, coefs, z, fmt)
    xs = x
    for s, c in enumerate(coefs):
        ys, zs = biquad_plain(xs, c[:3], c[3:], z[s])
        np.testing.assert_array_equal(zo[s].numpy(), zs.numpy())
        xs = to_float(from_float(ys, fmt), fmt)
    np.testing.assert_array_equal(y.numpy(), xs.numpy())
    if fmt != "flt":      # the last stage boosts past full scale
        assert float(ys.abs().max()) > 1.0


UNITS = {"u8": 2.0 ** -7, "s16": 2.0 ** -15, "s32": 2.0 ** -31}


@pytest.mark.parametrize("fmt", ["u8", "s16", "s32"])
def test_integer_units_stage_is_the_float_stage(fmt):
    """csrc/biquad.cu runs every stage after the first on the format's
    integer values X (x = X u, u a power of two) with b times u: the
    outputs and states equal the stage's on x, by value."""
    u = UNITS[fmt]
    coefs = _coefs(RUNS["eight"].split(",") + ["bass=f=120:g=12"])
    x = torch.from_numpy(_signal(2, 900, seed=7))
    xq = to_float(from_float(x, fmt), fmt)
    big = xq / u                       # X: integers, exact
    assert torch.equal(big, big.round())
    rng = np.random.default_rng(2)
    for c in coefs:
        z = torch.from_numpy(rng.uniform(-0.3, 0.3, (2, 2)).astype(
            np.float32))
        bu = tuple(np.float32(v * np.float32(u)) for v in c[:3])
        assert all(float(a) == float(b) * u for a, b in zip(bu, c[:3]))
        y1, z1 = biquad_plain(xq, c[:3], c[3:], z)
        y2, z2 = biquad_plain(big, bu, c[3:], z)
        np.testing.assert_array_equal(y1.numpy(), y2.numpy())
        np.testing.assert_array_equal(z1.numpy(), z2.numpy())


def _kernel_round_trip(out: np.ndarray, fmt: str) -> np.ndarray:
    """csrc/biquad.cu round_trip, in float32 numpy, times the unit (what
    the memory warp writes of the last stage's)."""
    f = np.float32
    magic = f(12582912.0)
    if fmt == "s16":
        v = np.fmin(np.fmax(out * f(32768), f(-32768)), f(32767))
        big = (v + magic) - magic
    elif fmt == "s32":
        v = np.fmin(np.fmax(out * f(2 ** 31), f(-2 ** 31)), f(2 ** 31))
        big = np.rint(v)
    else:       # out * 128 is exact: one rounding, the fma's
        v = np.fmin(np.fmax(out * f(128) + f(128), f(0)), f(255))
        big = (v + magic) - (magic + f(128))
    return big * f(UNITS[fmt])


@pytest.mark.parametrize("fmt", ["u8", "s16", "s32"])
def test_kernel_round_trip_form_is_pcms(fmt):
    """The kernel's clamp-then-round equals pcm's round-then-clamp on
    ties (k + 0.5 at every scale), the clip edges and past them, signed
    zeros, subnormals and random samples (NaN, +inf and values past 2^63
    are outside the contract: pcm's float-to-int64 conversion is
    undefined there)."""
    scale = {"u8": 128.0, "s16": 32768.0, "s32": 2.0 ** 31}[fmt]
    k = np.arange(-300, 300, dtype=np.float64)
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        (k + 0.5) / scale, k / scale, (k + 0.25) / scale,
        np.nextafter(np.float32((k + 0.5) / scale), np.float32(2)),
        [0.0, -0.0, 1.0, -1.0, 1.5, -1.5, 2.0 ** 20, -(2.0 ** 20),
         1e-45, -1e-45, 0.99999994, -0.99999994],
        rng.uniform(-1.2, 1.2, 20000)]).astype(np.float32)
    if fmt == "s16":
        vals = np.concatenate([vals, ((np.arange(32760, 32770) + 0.5)
                                      / 32768.0).astype(np.float32)])
    want = to_float(from_float(torch.from_numpy(vals), fmt), fmt).numpy()
    got = _kernel_round_trip(vals, fmt)
    np.testing.assert_array_equal(got, want)
