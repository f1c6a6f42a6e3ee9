"""The port's video3 filters (xfade, minterpolate, showwaves,
showspectrum, afir, testsrc) against the JAX package's, on the CPU.

All exact, bit for bit:

* xfade, every transition, on seeded 64x48 pairs (fade is the JAX
  package's eager float32 blend; the wipes compare float32 positions;
  dissolve thresholds jax.random.uniform(PRNGKey(0), shape), whose bits
  the port makes with its own threefry-2x32: held to JAX at 48x64,
  24x32 and 1088x1920);
* minterpolate at 64x48 and 128x96, search_range 8 and 16, 25 -> 50
  fps and 25 -> 60 fps: the block search's MVs (mesearch.full_search_mc
  with the frame as one tile, against the JAX package's
  full_search_mc_xla) and every output frame;
* showwaves, showspectrum and afir (numpy host code in both packages),
  and the testsrc source.
"""
import jax
import numpy as np
import pytest
import torch

from librempeg_tpu.core.frame import AudioFrame as JAFrame
from librempeg_tpu.core.frame import VideoFrame as JFrame
from librempeg_tpu.core.rational import Rational as JR
from librempeg_tpu.core.samplefmt import ChannelLayout as JL
from librempeg_tpu.filters import GraphRunner as JGraph
from librempeg_tpu.filters import StreamProps as JProps
from librempeg_tpu_torch.core.frame import AudioFrame as TAFrame
from librempeg_tpu_torch.core.frame import VideoFrame as TFrame
from librempeg_tpu_torch.core.rational import Rational as TR
from librempeg_tpu_torch.core.samplefmt import ChannelLayout as TL
from librempeg_tpu_torch.filters import GraphRunner as TGraph
from librempeg_tpu_torch.filters import StreamProps as TProps
from librempeg_tpu_torch.filters.video3 import _jax_uniform

from test_torch_filters2 import _props, assert_same, run_both


@pytest.mark.parametrize("shape", [(48, 64), (24, 32), (1088, 1920)])
def test_dissolve_noise_is_jax_uniform(shape):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), shape))
    got = _jax_uniform(shape, "cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("transition", ["fade", "wipeleft", "wiperight",
                                        "wipeup", "wipedown", "dissolve"])
def test_xfade_matches_jax(transition):
    jo, to = run_both(f"[in][in2]xfade={transition}:0.4:0.2", n=20,
                      inputs=2)
    assert_same(jo, to)


def _moving(i, w, h):
    """A pattern drifting by a few pixels a frame, plus noise."""
    rng = np.random.default_rng(i)
    out = []
    for ph, pw, s in ((h, w, 1), (h // 2, w // 2, 2), (h // 2, w // 2, 2)):
        gy, gx = np.mgrid[0:ph, 0:pw]
        base = 128 + 70 * np.sin((gx * s + 3 * i) / 9.0) \
            * np.cos((gy * s - 2 * i) / 7.0)
        out.append(np.clip(base + rng.normal(0, 4, (ph, pw)), 0,
                           255).astype(np.uint8))
    return out


@pytest.mark.parametrize("fps", [50, 60])
@pytest.mark.parametrize("sr", [8, 16])
@pytest.mark.parametrize("size", [(64, 48), (128, 96)])
def test_minterpolate_matches_jax(size, sr, fps):
    w, h = size
    desc = f"minterpolate=fps={fps}:search_range={sr}"
    jg = JGraph(desc, _props(JProps, JR, w, h))
    tg = TGraph(desc, _props(TProps, TR, w, h))
    jo, to = [], []
    for i in range(5):
        pl = _moving(i, w, h)
        jo += jg.push(JFrame(planes=tuple(pl), format="yuv420p", width=w,
                             height=h, pts=i, time_base=JR(1, 25)))
        to += tg.push(TFrame(planes=tuple(torch.from_numpy(p) for p in pl),
                             format="yuv420p", width=w, height=h, pts=i,
                             time_base=TR(1, 25)))
    jo += jg.finish()
    to += tg.finish()
    assert len(jo) == 9 if fps == 50 else len(jo) == 11
    assert_same(jo, to)


@pytest.mark.parametrize("sr", [8, 16])
def test_minterpolate_search_mvs_match_jax(sr):
    """The MVs minterpolate's search gives (B against A, luma) in both
    packages; mv // 2 (the chroma MVs) floors in both."""
    from librempeg_tpu.ops import motion as JM
    from librempeg_tpu_torch.ops.pallas import mesearch as TMS

    a, b = _moving(0, 128, 96)[0], _moving(3, 128, 96)[0]
    jmv, jc, jp = JM.full_search_mc_xla(
        np.asarray(b, np.float32)[None], np.asarray(a, np.float32)[None], sr)
    tmv, tc, tp = TMS.full_search_mc(
        torch.from_numpy(b).float()[None], torch.from_numpy(a).float()[None],
        sr, 96, 128)
    np.testing.assert_array_equal(np.asarray(jmv), tmv.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    assert (tmv < 0).any()
    np.testing.assert_array_equal(np.asarray(jmv) // 2, (tmv // 2).numpy())


def _audio(J, ch=2, n=44100, seed=0, fmt="fltp"):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100.0
    x = np.stack([0.5 * np.sin(2 * np.pi * (300 + 200 * c) * t)
                  for c in range(ch)]) + 0.05 * rng.standard_normal((ch, n))
    x = x.astype(np.float32)
    if fmt == "s16p":
        x = np.round(x * 32767).astype(np.int16)
    if J:
        return JAFrame(data=x, sample_rate=44100, sample_fmt=fmt,
                       layout=JL.default(ch), pts=0, time_base=JR(1, 44100))
    return TAFrame(data=torch.from_numpy(x), sample_rate=44100,
                   sample_fmt=fmt, layout=TL.default(ch), pts=0,
                   time_base=TR(1, 44100))


def _aprops(P, R, L, ch=2, fmt="fltp"):
    return P(media="audio", sample_rate=44100, sample_fmt=fmt,
             layout=L.default(ch), time_base=R(1, 44100))


@pytest.mark.parametrize("desc", ["showwaves=s=120x80",
                                  "showwaves=s=64x48:n=7",
                                  "showspectrum=s=64x128"])
@pytest.mark.parametrize("fmt", ["fltp", "s16p"])
def test_audio_to_video_matches_jax(desc, fmt):
    jg = JGraph(desc, _aprops(JProps, JR, JL, fmt=fmt))
    tg = TGraph(desc, _aprops(TProps, TR, TL, fmt=fmt))
    jo = jg.push(_audio(True, n=30000, fmt=fmt)) + jg.finish()
    to = tg.push(_audio(False, n=30000, fmt=fmt)) + tg.finish()
    assert tg.output_props.media == "video"
    assert_same(jo, to)


@pytest.mark.parametrize("fmt", ["fltp", "s16p"])
def test_afir_matches_jax(fmt):
    """A 0.1 s decaying-noise impulse response on the second input."""
    rng = np.random.default_rng(5)
    n_ir = 4410
    ir = (rng.standard_normal((1, n_ir)) * np.exp(-np.arange(n_ir) / 800)
          ).astype(np.float32) * 0.3
    if fmt == "s16p":
        ir = np.round(ir * 32767).astype(np.int16)
    desc = "[in][in2]afir=dry=0.2:wet=0.8"
    jg = JGraph(desc, [_aprops(JProps, JR, JL, fmt=fmt),
                       _aprops(JProps, JR, JL, ch=1, fmt=fmt)])
    tg = TGraph(desc, [_aprops(TProps, TR, TL, fmt=fmt),
                       _aprops(TProps, TR, TL, ch=1, fmt=fmt)])
    jg.push(JAFrame(data=ir, sample_rate=44100, sample_fmt=fmt,
                    layout=JL.default(1), pts=0, time_base=JR(1, 44100)), 1)
    tg.push(TAFrame(data=torch.from_numpy(ir), sample_rate=44100,
                    sample_fmt=fmt, layout=TL.default(1), pts=0,
                    time_base=TR(1, 44100)), 1)
    jo, to = [], []
    for k, n in enumerate((3000, 1500, 4096)):
        jf, tf = _audio(True, n=n, seed=k, fmt=fmt), \
            _audio(False, n=n, seed=k, fmt=fmt)
        jo += jg.push(jf)
        to += tg.push(tf)
    jo += jg.finish()
    to += tg.finish()
    assert len(jo) == len(to) == 3
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(np.asarray(a.data), b.data.numpy())


def test_testsrc_matches_jax():
    from librempeg_tpu.filters import find_filter as jfind
    from librempeg_tpu_torch.filters import find_filter as tfind

    js = jfind("testsrc")("size=96x64:rate=25:duration=0.3")
    ts = tfind("testsrc")("size=96x64:rate=25:duration=0.3")
    js.configure([])
    ts.configure([])
    n = 0
    while True:
        try:
            a = js.request_frame()
        except Exception:
            with pytest.raises(Exception):
                ts.request_frame()
            break
        b = ts.request_frame()
        assert (a.pts, a.width, a.height) == (b.pts, b.width, b.height)
        for pa, pb in zip(a.planes, b.planes):
            np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))
        n += 1
    assert n == 8


def test_testsrc2_and_color_sources_match_jax():
    from librempeg_tpu.filters import find_filter as jfind
    from librempeg_tpu_torch.filters import find_filter as tfind

    for args in ("testsrc2=size=64x48:duration=0.2",
                 "color=c=red:size=32x16:duration=0.1",
                 "sine=frequency=1000:duration=0.05"):
        name, _, opts = args.partition("=")
        js, ts = jfind(name)(opts), tfind(name)(opts)
        js.configure([])
        ts.configure([])
        while True:
            try:
                a = js.request_frame()
            except Exception:
                break
            b = ts.request_frame()
            assert a.pts == b.pts
            if hasattr(a, "planes"):
                for pa, pb in zip(a.planes, b.planes):
                    np.testing.assert_array_equal(np.asarray(pa),
                                                  np.asarray(pb))
            else:
                np.testing.assert_array_equal(np.asarray(a.data),
                                              np.asarray(b.data))
