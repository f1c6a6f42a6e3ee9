"""The port's filter graph (filters/graph.py, the rest of filters/video.py,
filters/metrics.py) against the JAX package's, on the CPU.

The cases are those of the JAX package's tests/test_filters.py that the
ported filters cover -- crop, pad, hflip/vflip, transpose (each
direction), fps, trim, setpts, overlay (the two-input graph), the
labelled multi-chain graph the parser test reads -- run through both
packages' GraphRunner on the same seeded frames. Integer outputs are
equal bit for bit and pts exact. psnr and ssim are float reductions in
a different order: each stat lies within 1e-5 relative (plus 1e-6
absolute, for an SSIM near 0) of the JAX package's; a PSNR of 99 (equal
planes) is exact.

Graphs with a scale hold the scaler's float contract instead (its
float32 GEMMs, tests/test_torch_scale.py): at most 0.1% of the samples
differ, by at most 1.

The card-only cases (the JPEG decode and psnr/ssim on CUDA against the
CPU) are in tests/test_torch_kernels.py, which runs on the card's
machine without JAX.
"""
import numpy as np
import pytest
import torch

from librempeg_tpu.core.frame import VideoFrame as JFrame
from librempeg_tpu.core.rational import Rational as JR
from librempeg_tpu.filters import GraphRunner as JGraph
from librempeg_tpu.filters import StreamProps as JProps
from librempeg_tpu_torch.core.frame import VideoFrame as TFrame
from librempeg_tpu_torch.core.rational import Rational as TR
from librempeg_tpu_torch.filters import FilterGraph, GraphRunner as TGraph
from librempeg_tpu_torch.filters import StreamProps as TProps
from librempeg_tpu_torch.filters.graph import BufferSink, BufferSource

STAT_REL = 1e-5
STAT_ABS = 1e-6


def _props(P, R, w=64, h=48, fmt="yuv420p"):
    return P(media="video", width=w, height=h, pix_fmt=fmt,
             frame_rate=R(25, 1), time_base=R(1, 25))


def _planes(w, h, i, seed=0):
    """Seeded yuv420p planes: a moving pattern plus noise."""
    rng = np.random.default_rng(seed * 1000 + i)
    out = []
    for ph, pw in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        gy, gx = np.mgrid[0:ph, 0:pw]
        base = 128 + 60 * np.sin((gx + 3 * i) / 7.0) * np.cos(gy / 5.0)
        out.append(np.clip(base + rng.normal(0, 8, (ph, pw)), 0,
                           255).astype(np.uint8))
    return out


def _pair(i, w=64, h=48, seed=0, pts=None):
    planes = _planes(w, h, i, seed)
    pts = i if pts is None else pts
    return (JFrame(planes=tuple(planes), format="yuv420p", width=w, height=h,
                   pts=pts, time_base=JR(1, 25)),
            TFrame(planes=tuple(torch.from_numpy(p) for p in planes),
                   format="yuv420p", width=w, height=h, pts=pts,
                   time_base=TR(1, 25)))


def _run(desc, inputs, sizes=((64, 48),)):
    """Push `inputs` ([(input_index, frame index, pts)]) through both
    packages' GraphRunner; returns each package's output frames."""
    jg = JGraph(desc, [_props(JProps, JR, w, h) for w, h in sizes])
    tg = TGraph(desc, [_props(TProps, TR, w, h) for w, h in sizes])
    jo, to = [], []
    for idx, i, pts in inputs:
        w, h = sizes[idx]
        jf, tf = _pair(i, w, h, seed=idx, pts=pts)
        jo += jg.push(jf, input_index=idx)
        to += tg.push(tf, input_index=idx)
    jo += jg.finish()
    to += tg.finish()
    p = tg.output_props
    assert (p.width, p.height, p.pix_fmt) == (
        jg.output_props.width, jg.output_props.height,
        jg.output_props.pix_fmt)
    return jo, to, jg, tg


def _assert_equal_frames(jo, to, scaled=False):
    assert len(jo) == len(to) > 0
    d = []
    for a, b in zip(jo, to):
        assert (a.pts, a.width, a.height, a.format) == \
            (b.pts, b.width, b.height, b.format)
        assert a.time_base.num * b.time_base.den == \
            b.time_base.num * a.time_base.den
        d += [np.abs(np.asarray(pa, np.int32) - pb.numpy()).ravel()
              for pa, pb in zip(a.planes, b.planes)]
    d = np.concatenate(d)
    if scaled:
        print(f"{np.count_nonzero(d) / d.size:.6f} of samples differ, "
              f"max |d| {d.max()}")
        assert np.count_nonzero(d) <= 1e-3 * d.size and d.max() <= 1
    else:
        assert not d.any()


ONE_INPUT = [(0, i, i) for i in range(12)]


@pytest.mark.parametrize("desc", [
    "crop=32:16:8:8",
    "crop=iw/2:ih/2",
    "pad=96:64:16:8",
    "pad=80:64:8:8:color=white",
    "hflip",
    "vflip",
    "hflip,hflip,vflip,vflip",
    "transpose=0",
    "transpose=1",
    "transpose=2",
    "transpose=3",
    "fps=5",
    "fps=10,setpts=N",
    "trim=start_frame=1:end_frame=3",
    "trim=start=0.1:end=0.3",
    "setpts=PTS+10",
    "setpts=PTS-STARTPTS",
    "scale=32:24,format=yuvj420p",
    "fps=5,crop=48:48,scale=32:24",
    "split[a][b];[a]hflip[c];[c][b]overlay=4:4",
])
def test_one_input_graph_matches_jax(desc):
    jo, to, _, _ = _run(desc, ONE_INPUT)
    _assert_equal_frames(jo, to, scaled="scale" in desc)


def test_overlay_two_inputs_matches_jax():
    """tests/test_filters.py:120-129 of the JAX package: a logo pushed on
    input 1 before the main frame, then a stream of main frames that
    holds it."""
    inputs = [(1, 9, 0)] + [(0, i, i) for i in range(5)]
    jo, to, _, _ = _run("[in][in2]overlay=8:8", inputs,
                        sizes=((64, 48), (16, 16)))
    _assert_equal_frames(jo, to)
    assert np.array_equal(to[0].planes[0][8:24, 8:24].numpy(),
                          _planes(16, 16, 9, seed=1)[0])


def test_framesync_holds_the_last_secondary_matches_jax():
    """Secondary frames at 1/3 the rate: each main frame takes the
    overlay frame with the latest pts at or before its own."""
    inputs = []
    for i in range(9):
        if i % 3 == 0:
            inputs.append((1, 20 + i, i))
        inputs.append((0, i, i))
    jo, to, _, _ = _run("[in][in2]overlay=x=W-w:y=H-h", inputs,
                        sizes=((64, 48), (16, 16)))
    _assert_equal_frames(jo, to)


def test_labelled_multichain_graph_matches_jax():
    """The graph tests/test_filters.py:36-38 parses, with two inputs."""
    desc = "[in]scale=32:24[a];[a][b]overlay=4:4[out];[in2]hflip[b]"
    inputs = [(1, 3, 0), (0, 0, 0), (1, 4, 1), (0, 1, 1), (0, 2, 2)]
    jo, to, _, _ = _run(desc, inputs, sizes=((64, 48), (16, 16)))
    _assert_equal_frames(jo, to, scaled=True)


def _stats(graph, name):
    return next(n.filter.stats for n in graph.graph.nodes
                if n.filter.NAME == name)


def _close(a, b):
    return abs(a - b) <= STAT_REL * abs(a) + STAT_ABS


@pytest.mark.parametrize("metric", ["psnr", "ssim"])
def test_metric_graph_matches_jax(metric):
    """Main frames against a reference of other noise (and once against
    themselves: PSNR 99, SSIM 1)."""
    inputs = []
    for i in range(4):
        inputs += [(1, i, i), (0, i, i)]
    jo, to, jg, tg = _run(f"[in][in2]{metric}", inputs,
                          sizes=((64, 48), (64, 48)))
    _assert_equal_frames(jo, to)
    js, ts = _stats(jg, metric), _stats(tg, metric)
    assert len(js) == len(ts) == 4
    for a, b in zip(js, ts):
        assert a.keys() == b.keys()
        for k in a:
            assert _close(float(a[k]), float(b[k])), (k, a[k], b[k])
    same = TGraph(f"[in][in2]{metric}", [_props(TProps, TR)] * 2)
    _, tf = _pair(0)
    same.push(tf, 1)
    same.push(tf, 0)
    st = _stats(same, metric)[0]
    assert st == ({"mse_y": 0.0, "psnr_y": 99.0, "mse_u": 0.0,
                   "psnr_u": 99.0, "mse_v": 0.0, "psnr_v": 99.0,
                   "mse_avg": 0.0, "psnr_avg": 99.0}
                  if metric == "psnr" else
                  {"ssim_y": 1.0, "ssim_u": 1.0, "ssim_v": 1.0,
                   "ssim_all": 1.0})


def test_psnr_built_by_hand_matches_jax():
    """The FilterGraph API of tests/test_filters.py:131-147: two buffer
    sources linked into psnr by hand."""
    graph = FilterGraph()
    s1 = graph.add_instance(BufferSource(_props(TProps, TR)))
    s2 = graph.add_instance(BufferSource(_props(TProps, TR)))
    p = graph.add("psnr")
    sink = BufferSink("video")
    sn = graph.add_instance(sink)
    graph.link(s1, 0, p, 0)
    graph.link(s2, 0, p, 1)
    graph.link(p, 0, sn, 0)
    graph.configure()
    _, a = _pair(0)
    s1.out_links[0].queue.append(a)
    s2.out_links[0].queue.append(a)
    graph.run()
    assert p.filter.stats[0]["psnr_avg"] == 99.0
    assert len(sink.frames) == 1


def test_negotiation_inserts_a_converter_before_overlay():
    """overlay blends in planar YUV: an rgb24 input gets an autoformat
    converter, as in the JAX package."""
    from librempeg_tpu_torch.core.frame import VideoFrame

    g = TGraph("[in][in2]overlay", [_props(TProps, TR),
                                     _props(TProps, TR, 16, 16, "rgb24")])
    names = sorted(n.filter.NAME for n in g.graph.nodes)
    assert "autoformat" in names
    rgb = torch.zeros(16, 16, 3, dtype=torch.uint8)
    g.push(VideoFrame(planes=(rgb,), format="rgb24", width=16, height=16,
                      pts=0, time_base=TR(1, 25)), 1)
    _, main = _pair(0)
    out = g.push(main, 0)
    assert len(out) == 1 and out[0].format == "yuv420p"
    assert int(out[0].planes[0][:16, :16].max()) <= 16
