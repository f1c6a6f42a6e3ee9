"""The port's resampler, rematrix, dither and sample-format conversions
(librempeg_tpu_torch/resample, codecs/pcm) against the JAX package's on
the CPU.

Tolerances:
- Resampler: float32 within 2e-6 (the banded GEMM sums in another
  order), lengths exact.
- Swr to s16: at least 99.9% of samples equal, none off by more than
  1. A float32 difference crosses a rounding boundary on 1-5 samples in
  10^4 (2.3e-4 of 44.1k->48k samples in one call of 88200 samples,
  stereo or 5.1 in); the order of the GEMM's sums, and so that share,
  changes with the call's size in both packages.
- Ditherer: the non-shaping methods exact (the same Philox noise); the
  shaping methods' plain scan bit-exact against the JAX package's
  _shape_scan on identical input. XLA's CPU code adds each term of the
  feedback sum as an FMA except in channel 0 of a two-channel call
  (csrc/shape_scan.cu); the port takes the FMA form everywhere, so a
  two-channel scan is held to the JAX scan of each channel alone.

Deviations from the JAX package, asserted here: a final call under
compensation gives the length the ratio in force implies (48480, not
48980), and s32 +1.0 converts to 2147483647, not -2^31.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from librempeg_tpu.codecs import pcm as JPCM
from librempeg_tpu.core.samplefmt import ChannelLayout as JL
from librempeg_tpu.resample import Ditherer as JDither
from librempeg_tpu.resample import Resampler as JRes
from librempeg_tpu.resample import Swr as JSwr
from librempeg_tpu.resample.dither import _SHAPER_COEFS, _shape_scan
from librempeg_tpu_torch import compat
from librempeg_tpu_torch.codecs import pcm as TPCM
from librempeg_tpu_torch.core.samplefmt import ChannelLayout as TL
from librempeg_tpu_torch.resample import DITHER_METHODS
from librempeg_tpu_torch.resample import Ditherer as TDither
from librempeg_tpu_torch.resample import Resampler as TRes
from librempeg_tpu_torch.resample import Swr as TSwr
from librempeg_tpu_torch.resample.dither import _fma32, shape_scan_plain
from librempeg_tpu_torch.utils import testgen

F32_TOL = 2e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    print(f"{what}: {got.shape}, max |err| {err:.2e}")
    assert err <= F32_TOL, what


def _s16_agree(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and got.dtype == want.dtype, what
    d = np.abs(got.astype(np.int64) - want)
    share = np.count_nonzero(d) / d.size
    print(f"{what}: {share:.6f} of samples differ, max |d| {d.max()}")
    assert share <= 1e-3 and d.max() <= 1, what


@pytest.mark.parametrize("rates", [(44100, 48000), (48000, 44100),
                                   (8000, 48000)])
def test_resampler_matches_jax(rates):
    a, b = rates
    x = testgen.audio_mix(a, 6000)
    j = JRes(a, b, 2)
    want = np.concatenate([j.process(x), j.flush()], axis=1)
    t = TRes(a, b, 2, device="cpu")
    _close(torch.cat([t.process(_t(x)), t.flush()], 1), want,
           f"{a}->{b} one-shot")
    # chunked: the same output as one call
    j, t = JRes(a, b, 2), TRes(a, b, 2, device="cpu")
    cuts = [0, 1000, 1001, 3500, 6000]
    jo = [j.process(x[:, s:e]) for s, e in zip(cuts, cuts[1:])] + [j.flush()]
    to = [t.process(_t(x[:, s:e])) for s, e in zip(cuts, cuts[1:])] \
        + [t.flush()]
    assert [o.shape[1] for o in to] == [o.shape[1] for o in jo]
    _close(torch.cat(to, 1), np.concatenate(jo, 1), f"{a}->{b} chunked")
    assert torch.cat(to, 1).shape[1] == want.shape[1]


@pytest.mark.parametrize("layouts", [("stereo", "mono"), ("5.1", "stereo")])
def test_swr_rematrix_to_s16_matches_jax(layouts):
    li, lo = layouts
    nin = JL.from_string(li).nb_channels
    x = testgen.s16(testgen.audio_mix(44100, 8000, nin) * 0.9)
    j = JSwr(44100, 48000, JL.from_string(li), JL.from_string(lo),
             in_fmt="s16p", out_fmt="s16p")
    t = TSwr(44100, 48000, TL.from_string(li), TL.from_string(lo),
             in_fmt="s16p", out_fmt="s16p", device="cpu")
    assert np.array_equal(t.matrix, j.matrix)
    want = np.concatenate([j.convert(x[:, :3000]), j.convert(x[:, 3000:]),
                           np.asarray(j.flush_frame().data)], 1)
    got = torch.cat([t.convert(_t(x[:, :3000])), t.convert(_t(x[:, 3000:])),
                     t.flush_frame().data], 1)
    _s16_agree(got, want, f"{li}->{lo} 44.1k->48k s16")


def test_compensation_length_is_repaired():
    """One final call under compensation: 24000 outputs at the stretched
    ratio, then the rest of the input at 1:1 -> 48480 samples. The JAX
    package computes the whole remainder at the stretched ratio."""
    x = testgen.sine(440.0, 48000, 48000, channels=1)
    t = TRes(48000, 48000, 1, device="cpu")
    t.set_compensation(480, 24000)
    assert t.process(_t(x), final=True).shape[1] == 48480
    j = JRes(48000, 48000, 1)
    j.set_compensation(480, 24000)
    assert j.process(x, final=True).shape[1] == 48980
    # streamed, the compensation drains before the flush: both agree
    j, t = JRes(48000, 44100, 1), TRes(48000, 44100, 1, device="cpu")
    j.set_compensation(200, 10000)
    t.set_compensation(200, 10000)
    want = np.concatenate([j.process(x[:, :30000]), j.process(x[:, 30000:]),
                           j.flush()], 1)
    got = torch.cat([t.process(_t(x[:, :30000])), t.process(_t(x[:, 30000:])),
                     t.flush()], 1)
    _close(got, want, "compensated 48k->44.1k")


@pytest.mark.parametrize("fmt", ["u8", "s16", "s32"])
@pytest.mark.parametrize("method", [m for m in DITHER_METHODS
                                    if m not in _SHAPER_COEFS])
def test_dither_methods_match_jax(method, fmt):
    x = testgen.audio_mix(48000, 3000) * 0.99
    j, t = JDither(method, seed=5), TDither(method, seed=5)
    want = np.concatenate([j.apply(x[:, :1234], fmt),
                           j.apply(x[:, 1234:], fmt)], 1)
    got = torch.cat([t.apply(_t(x[:, :1234]), fmt),
                     t.apply(_t(x[:, 1234:]), fmt)], 1).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got, want), (method, fmt)


def _scan_case(method, c, n, seed):
    rng = np.random.default_rng(seed)
    k = len(_SHAPER_COEFS[method])
    x = np.clip(rng.normal(0, 9000, (c, n)), -32768, 32767).astype(np.float32)
    noise = (rng.random((c, n)) - rng.random((c, n))).astype(np.float32)
    err0 = rng.uniform(-0.5, 0.5, (k, c)).astype(np.float32)
    return x, noise, np.array(_SHAPER_COEFS[method], np.float32), err0


def _jax_scan(x, noise, coefs, err0):
    y, h = _shape_scan(jnp.asarray(x), jnp.asarray(noise),
                       jnp.asarray(coefs), jnp.asarray(err0))
    return np.asarray(y), np.asarray(h)


def _fma_exact(a, b, c):
    """a * b + c rounded once to float32, half to even, from the exact
    rational sum."""
    from fractions import Fraction

    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(x))
    cands = [f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf))]
    d = [abs(Fraction(float(v)) - x) for v in cands]
    best = min(d)
    near = [v for v, dv in zip(cands, d) if dv == best]
    return min(near, key=lambda v: int(v.view(np.int32)) & 1)


@pytest.mark.parametrize("case", ["ties", "random"])
def test_plain_fma_rounds_once(case):
    """_fma32, the plain scan's feedback term, is a single-rounded FMA.
    The tie cases are sums whose float64 rounding lands on a float32
    midpoint that the exact sum misses (a float64 multiply-add rounded
    to float32 gets them wrong); the random ones cover the shaper's
    range of errors, taps and partial sums."""
    if case == "ties":
        a = np.array([(2**18 - 1) * 2.0**-30, 130561 * 2.0**-30], np.float32)
        b = np.array([(2**18 + 1) * 2.0**-30, 526321 * 2.0**-30], np.float32)
        c = np.array([1 + 2.0**-23, 1.0], np.float32)
        naive = (a.astype(np.float64) * b + c).astype(np.float32)
        assert not np.array_equal(naive, [_fma_exact(*t) for t in
                                          zip(a, b, c)])
    else:
        rng = np.random.default_rng(7)
        a = rng.uniform(-1, 1, 4000).astype(np.float32)
        b = rng.choice(np.float32(_SHAPER_COEFS["lipshitz"]), 4000)
        c = (rng.normal(0, 3, 4000)
             * 2.0 ** rng.integers(-20, 4, 4000)).astype(np.float32)
    got = _fma32(_t(a), _t(b), _t(c)).numpy()
    want = np.array([_fma_exact(*t) for t in zip(a, b, c)], np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("method", sorted(_SHAPER_COEFS))
def test_shape_scan_plain_is_bit_exact_to_jax(method, c):
    x, noise, coefs, err0 = _scan_case(method, c, 3000, c)
    y, h = shape_scan_plain(_t(x), _t(noise), _t(coefs), _t(err0))
    if c == 2:   # XLA's channel 0 of a pair rounds each product: per channel
        parts = [_jax_scan(x[i:i + 1], noise[i:i + 1], coefs, err0[:, i:i + 1])
                 for i in range(c)]
        wy = np.concatenate([p[0] for p in parts])
        wh = np.concatenate([p[1] for p in parts], 1)
    else:
        wy, wh = _jax_scan(x, noise, coefs, err0)
    assert np.array_equal(y.numpy(), wy), method
    assert np.array_equal(h.numpy(), wh), method


@pytest.mark.parametrize("method", sorted(_SHAPER_COEFS))
def test_shaping_ditherer_streams_like_the_jax_scan(method):
    """The shaping Ditherer over two chunks: the JAX package's noise and
    LSB scaling, and each channel's scan carried across the chunks as
    the JAX scan carries it."""
    x = testgen.audio_mix(44100, 2500)
    t = TDither(method, seed=2)
    got = torch.cat([t.apply(_t(x[:, :1000]), "s16"),
                     t.apply(_t(x[:, 1000:]), "s16")], 1).numpy()
    xl = x.astype(np.float32) * 32768.0
    noise = JDither(method, seed=2)._noise(xl.shape)
    coefs = np.array(_SHAPER_COEFS[method], np.float32)
    want = []
    for ch in range(2):
        err = np.zeros((len(coefs), 1), np.float32)
        ys = []
        for s, e in ((0, 1000), (1000, 2500)):
            y, err = _jax_scan(xl[ch:ch + 1, s:e], noise[ch:ch + 1, s:e],
                               coefs, err)
            ys.append(y)
        want.append(np.concatenate(ys, 1))
    want = np.clip(np.concatenate(want), -32768, 32767).astype(np.int16)
    assert np.array_equal(got, want), method


def test_s32_full_scale_does_not_wrap():
    one = torch.tensor([[1.0, -1.0, 0.5]])
    want = [2147483647, -2147483648, 1073741824]
    assert TPCM.from_float(one, "s32").tolist() == [want]
    assert TDither("none").apply(one, "s32").tolist() == [want]
    assert TDither("triangular").apply(one[:, :1], "s32").tolist() \
        == [[2147483647]]
    # the JAX package clips in float32, where 2^31 - 1 rounds to 2^31
    assert JPCM.from_float(np.ones((1, 1), np.float32), "s32")[0, 0] \
        == -2147483648


@pytest.mark.parametrize("fmt", ["u8", "s16", "s32", "flt", "dbl"])
def test_sample_format_conversions_match_jax(fmt):
    x = np.clip(testgen.audio_mix(48000, 1000) * 1.2, -1.0, 0.999)
    want = JPCM.from_float(x, fmt)
    got = TPCM.from_float(_t(x), fmt).numpy()
    if fmt == "s32":   # the JAX package's int64 round trip ends in int32
        want = want.astype(np.int32)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(TPCM.to_float(_t(got), fmt).numpy(),
                          JPCM.to_float(want, fmt))


@pytest.mark.parametrize("codec", ["pcm_s16le", "pcm_s16be", "pcm_s24le",
                                   "pcm_f32be", "pcm_u8", "pcm_mulaw"])
def test_pcm_bytes_match_jax(codec):
    raw = np.random.default_rng(1).integers(0, 256, 6 * 120,
                                            dtype=np.uint8).tobytes()
    a = JPCM._decode_bytes(codec, raw, 2)
    b = TPCM._decode_bytes(codec, raw, 2)
    native = np.ascontiguousarray(a.astype(a.dtype.newbyteorder("=")))
    assert native.dtype == b.dtype and native.tobytes() == b.tobytes()
    if codec in TPCM.ENCODERS:
        assert TPCM._encode_array(codec, b) == JPCM._encode_array(codec, a)


def test_mid_stream_start_through_compat():
    """The JAX package's resampler (under compensation) and shaping
    ditherer run half a clip; the port takes their state and runs the
    rest as they do."""
    x = testgen.audio_mix(44100, 9000)
    j = JRes(44100, 48000, 2)
    j.set_compensation(300, 4000)
    head = j.process(x[:, :2500])
    c = j._comp
    t = compat.resampler_state_from_numpy(
        44100, 48000, 2, j._buf, j._buf_start, j._next_origin,
        j._out_count, j._total_in, j._keep,
        comp=None if c is None else {"p": c["p"], "q": c["q"],
                                     "remaining": c["remaining"]},
        device="cpu")
    assert head.shape[1] == t._out_count
    want = np.concatenate([j.process(x[:, 2500:]), j.flush()], 1)
    got = torch.cat([t.process(_t(x[:, 2500:])), t.flush()], 1)
    _close(got, want, "resampler from the JAX package's state")

    for method in ("triangular_hp", "f_weighted"):
        jd = JDither(method, seed=9)
        jd.apply(x[:1, :3000], "s16")
        td = compat.ditherer_state_from_numpy(
            method, jd._pos, hp_last=jd._hp_last,
            err=None if jd._err is None else np.asarray(jd._err), seed=9,
            device="cpu")
        assert np.array_equal(td.apply(_t(x[:1, 3000:5000]), "s16").numpy(),
                              jd.apply(x[:1, 3000:5000], "s16")), method
