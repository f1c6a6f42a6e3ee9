"""The port's audio and host filters of misc2 (afade, aecho, areverse,
aselect, asetrate, asettb, volumedetect, astats, amerge/join, aloop,
ashowinfo, concat's audio), the rest of misc (asplit, apad,
channelsplit, pan, adelay, asetpts) and amix, against the JAX
package's, on the CPU -- the cases of the JAX package's
tests/test_filters3.py and test_filters2.py.

Samples and pts are equal bit for bit, the analyzers' stats exactly.
afade, aecho, amix and pan are float32 contracts whose tolerance is 0:
the port runs the JAX package's numpy operations in the same order in
float32 tensors (pan's matrix product in the order of numpy's float32
matmul on the CPU: the first rounded product, then a fused multiply-add
per input).
"""
import numpy as np
import pytest
import torch

from librempeg_tpu.core.frame import AudioFrame as JFrame
from librempeg_tpu.core.rational import Rational as JR
from librempeg_tpu.core.samplefmt import ChannelLayout as JL
from librempeg_tpu.filters import FilterGraph as JFG
from librempeg_tpu.filters import GraphRunner as JGraph
from librempeg_tpu.filters import StreamProps as JProps
from librempeg_tpu.filters.graph import BufferSink as JSink
from librempeg_tpu.filters.graph import BufferSource as JSrc
from librempeg_tpu_torch.core.frame import AudioFrame as TFrame
from librempeg_tpu_torch.core.rational import Rational as TR
from librempeg_tpu_torch.core.samplefmt import ChannelLayout as TL
from librempeg_tpu_torch.filters import FilterGraph as TFG
from librempeg_tpu_torch.filters import GraphRunner as TGraph
from librempeg_tpu_torch.filters import StreamProps as TProps
from librempeg_tpu_torch.filters.graph import BufferSink as TSink
from librempeg_tpu_torch.filters.graph import BufferSource as TSrc

RATE = 48000
J = (JProps, JR, JL, JFrame, JGraph)
T = (TProps, TR, TL, TFrame, TGraph)


def _props(pkg, ch=2, fmt="fltp"):
    P, R, L = pkg[:3]
    return P(media="audio", sample_rate=RATE, sample_fmt=fmt,
             layout=L.default(ch), time_base=R(1, RATE))


def _data(ch, n, seed, fmt):
    rng = np.random.default_rng(seed)
    t = (np.arange(n) + 1000 * seed) / RATE
    x = np.stack([0.5 * np.sin(2 * np.pi * (440 + 110 * c) * t)
                  for c in range(ch)]) + 0.1 * rng.standard_normal((ch, n))
    x = np.clip(x, -0.99, 0.99).astype(np.float32)
    return np.round(x * 32767).astype(np.int16) if fmt == "s16p" else x


def _frame(pkg, data, pts, fmt):
    R, L, F = pkg[1], pkg[2], pkg[3]
    d = torch.from_numpy(data) if pkg is T else data
    return F(data=d, sample_rate=RATE, sample_fmt=fmt,
             layout=L.default(data.shape[0]), pts=pts, time_base=R(1, RATE))


CUTS = (4800, 1023, 333, 4096)


def run_both(desc, ch=2, fmt="fltp", inputs=1, cuts=CUTS):
    """Push the cut frames into each input pad of both packages' graphs
    (pad k's samples seeded k); returns both outputs and graphs."""
    outs, graphs = [], []
    for pkg in (J, T):
        g = pkg[4](desc, [_props(pkg, ch, fmt)] * inputs)
        out, pos = [], 0
        for i, n in enumerate(cuts):
            for k in reversed(range(inputs)):
                out += g.push(_frame(pkg, _data(ch, n, 10 * k + i, fmt),
                                     pos, fmt), k)
            pos += n
        out += g.finish()
        outs.append(out)
        graphs.append(g)
    return outs[0], outs[1], graphs


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(jo, to):
    assert len(jo) == len(to) > 0
    for a, b in zip(jo, to):
        assert (a.pts, a.sample_rate, a.nb_channels, a.nb_samples) == \
            (b.pts, b.sample_rate, b.nb_channels, b.nb_samples)
        x, y = _np(a.data), _np(b.data)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fmt", ["fltp", "s16p"])
@pytest.mark.parametrize("desc", [
    "afade=t=in:ss=0:ns=4800",
    "afade=t=out:ss=2000:ns=6000",
    "afade=t=in:st=0.02:d=0.1",
    "aecho=0.6:0.3:100:0.5",
    "aecho=0.8:0.5:40|13:0.3|0.2",
    "areverse",
    "aselect=mod(n\\,2)",
    "asetrate=24000",
    "asettb=1/1000",
    "aloop=loop=1:size=1000:start=0",
    "aloop=loop=2:size=5000:start=3000",
    "apad=whole_len=12000",
    "apad=pad_len=100",
    "adelay=delays=10",
    "asetpts=PTS+100",
    "asetpts=N*1024",
    "pan=mono|c0=0.5*c0+0.5*c1",
    "pan=stereo|c0=c1|c1=0.25*c0+0.75*c1",
    "volumedetect",
    "astats",
    "ashowinfo",
])
def test_audio_filter_matches_jax(desc, fmt):
    jo, to, (jg, tg) = run_both(desc, fmt=fmt)
    assert_same(jo, to)
    jf, tf = jg.entry_nodes[0].filter, tg.entry_nodes[0].filter
    if hasattr(jf, "stats"):
        assert jf.stats == tf.stats
    if hasattr(jf, "records"):
        assert jf.records == tf.records


@pytest.mark.parametrize("fmt", ["fltp", "s16p"])
@pytest.mark.parametrize("desc,inputs", [
    ("[in][in2]amix", 2),
    ("[in][in2]amix=normalize=0", 2),
    ("[in][in2][in3]amix=inputs=3", 3),
    ("[in][in2]amerge", 2),
    ("[in][in2]join", 2),
    ("[in][in2]concat=n=2:v=0:a=1", 2),
])
def test_multi_input_audio_filter_matches_jax(desc, inputs, fmt):
    jo, to, _ = run_both(desc, fmt=fmt, inputs=inputs)
    assert_same(jo, to)
    if "amerge" in desc or "join" in desc:
        assert to[0].layout.nb_channels == 4


def test_amix_uneven_inputs_matches_jax():
    """amix's tail: inputs of different lengths, flushed at EOF."""
    outs = []
    for pkg in (J, T):
        g = pkg[4]("[in][in2]amix", [_props(pkg)] * 2)
        out = g.push(_frame(pkg, _data(2, 3000, 0, "fltp"), 0, "fltp"), 0)
        out += g.push(_frame(pkg, _data(2, 1000, 1, "fltp"), 0, "fltp"), 1)
        out += g.push(_frame(pkg, _data(2, 500, 2, "fltp"), 3000, "fltp"), 0)
        out += g.finish()
        outs.append(out)
    assert_same(*outs)


def _fanout(pkg, name, n_out, ch=2):
    G, Src, Sink = (JFG, JSrc, JSink) if pkg is J else (TFG, TSrc, TSink)
    g = G()
    src = g.add_instance(Src(_props(pkg, ch)))
    node = g.add(name)
    sinks = [Sink("audio") for _ in range(n_out)]
    g.link(src, 0, node, 0)
    for i, s in enumerate(sinks):
        g.link(node, i, g.add_instance(s), 0)
    g.configure()
    for i, n in enumerate(CUTS):
        src.out_links[0].queue.append(
            _frame(pkg, _data(ch, n, i, "fltp"), sum(CUTS[:i]), "fltp"))
        g.run()
    g.flush()
    return [list(s.frames) for s in sinks]


@pytest.mark.parametrize("name,n_out", [("asplit", 2), ("channelsplit", 2)])
def test_fanout_matches_jax(name, n_out):
    jo, to = _fanout(J, name, n_out), _fanout(T, name, n_out)
    for a, b in zip(jo, to):
        assert_same(a, b)
