"""The port's ebur128 and loudnorm (librempeg_tpu_torch/filters/
loudness.py) against the JAX package's, on the CPU.

At 48 kHz the measurement is the same host numpy (the K-weighting
through native.biquad in both packages): the integrated loudness, the
loudness range, the peak and every momentary value are equal exactly,
and loudnorm's output samples bit for bit, in s16 and in float input.
At 44.1 kHz the input is first resampled to 48 kHz, by the port's
Resampler on the frames' device and by the JAX package's in XLA, which
agree to 2e-6 (test_torch_resample.py): I and LRA within 1e-4 LU, the
peak within 1e-5, and loudnorm's s16 output at most one LSB off on at
most 0.1% of samples (a gain from the measured I moves a sample across
a rounding boundary only there).
"""
import numpy as np
import pytest

from test_torch_filters3 import J, T, _frame, _props


def _signal(ch, n, rate, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    env = 0.15 + 0.6 * (np.sin(2 * np.pi * 0.4 * t) > 0)  # loud/quiet
    x = np.stack([env * np.sin(2 * np.pi * (300 + 170 * c) * t)
                  for c in range(ch)]) + 0.02 * rng.standard_normal((ch, n))
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def _run(pkg, desc, x, rate, fmt, cut=4096):
    P, R, L = pkg[:3]
    g = pkg[4](desc, [P(media="audio", sample_rate=rate, sample_fmt=fmt,
                        layout=L.default(x.shape[0]),
                        time_base=R(1, rate))])
    data = np.round(x * 32767).astype(np.int16) if fmt == "s16p" else x
    out = []
    for s in range(0, x.shape[1], cut):
        f = _frame(pkg, data[:, s:s + cut], s, fmt)
        f = f.replace(sample_rate=rate, time_base=R(1, rate))
        out += g.push(f)
    out += g.finish()
    node = [n for n in g.graph.nodes
            if n.filter.NAME in ("ebur128", "loudnorm")][0]
    return out, node.filter


def _samples(frames):
    return np.concatenate([np.asarray(f.data) for f in frames], axis=1)


@pytest.mark.parametrize("rate,fmt,ch", [(48000, "s16p", 2),
                                         (48000, "fltp", 1),
                                         (44100, "s16p", 2)])
def test_ebur128_matches_jax(rate, fmt, ch):
    x = _signal(ch, rate * 5, rate, 1)
    (jo, jf), (to, tf) = (_run(pkg, "ebur128", x, rate, fmt)
                          for pkg in (J, T))
    assert np.array_equal(_samples(jo), _samples(to))
    js, ts = jf.stats, tf.stats
    assert len(js["momentary"]) == len(ts["momentary"]) > 40
    if rate == 48000:
        assert js == ts
    else:
        assert abs(js["I"] - ts["I"]) < 1e-4
        assert abs(js["LRA"] - ts["LRA"]) < 1e-4
        assert abs(js["peak"] - ts["peak"]) < 1e-5
    assert -40 < ts["I"] < -3 and ts["LRA"] > 1


@pytest.mark.parametrize("rate,fmt,opts", [
    (48000, "s16p", "I=-16:TP=-1.5"), (48000, "fltp", "I=-30"),
    (44100, "s16p", "I=-16:TP=-1.5")])
def test_loudnorm_matches_jax(rate, fmt, opts):
    x = _signal(2, rate * 4, rate, 2)
    (jo, jf), (to, tf) = (_run(pkg, f"loudnorm={opts}", x, rate, fmt)
                          for pkg in (J, T))
    a, b = _samples(jo), _samples(to)
    assert a.dtype == b.dtype and a.shape == b.shape
    if rate == 48000:
        assert np.array_equal(a, b)
        assert jf.measured == tf.measured
    else:
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= 1 and np.count_nonzero(d) <= 1e-3 * d.size
        assert abs(jf.measured["I"] - tf.measured["I"]) < 1e-4
