"""The port's video2, color and misc2 video filters against the JAX
package's, on the CPU.

Every graph runs through both packages' GraphRunner on the same seeded
64x48 frames. The outputs are equal bit for bit and their pts exact:

* negate, drawbox, lutyuv, yadif, the stacks, tile, extractplanes,
  shuffleplanes, concat, select, reverse, loop, tpad are integer or
  copy operations;
* boxblur sums integers (exact at this size in both packages);
* gblur, eq, fade, lut3d (every interpolation) and lut1d are float
  contracts whose tolerance is 0: the port takes the JAX package's float
  forms. Alone, a filter runs as eager jnp calls, each
  rounding its result; in a chain of two or more PURE filters the JAX
  package compiles one XLA program, which folds 128 + b into eq's luma
  constant and fuses each multiply feeding an add into one multiply-add
  (gblur's taps: fma(x0, k0, k1 * x1), then fma(xt, kt, sum)). The
  colour products take the order of XLA's eager [..., 3] x [3, 3] dot
  on the CPU. test_fused_forms_are_the_jax_forms plants the other form
  in each of eq and gblur and sees the comparison fail.
* colorspace (and F1's chain, which starts with it) holds the scaler's
  float contract, at most 0.1% of samples differ, by at most 1: its
  transfer functions raise to float32 powers, which XLA's CPU code
  approximates in its own way (one ulp off the correctly rounded power
  the port takes on about 0.07% of inputs). The samples read equal here;
  a transfer exponent of 0.46 for 0.45, planted, moves 74% of them.

boxblur at 1920x1088: the port equals the exact box mean
floor(sum / 25 + 0.5) computed in numpy; the JAX package does not
(its float32 summed-area table passes 2^24 and about 12% of luma
samples differ, by up to 2), which the test measures and states.
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
from librempeg_tpu_torch.filters import GraphRunner as TGraph
from librempeg_tpu_torch.filters import StreamProps as TProps

from chip_smoke import write_cube

W, H = 64, 48


def _props(P, R, w=W, h=H, fmt="yuv420p"):
    return P(media="video", width=w, height=h, pix_fmt=fmt,
             frame_rate=R(25, 1), time_base=R(1, 25))


def _planes(fmt, w, h, i, seed=0):
    """Seeded planes of `fmt`: a moving pattern plus noise."""
    rng = np.random.default_rng(seed * 1000 + i)
    if fmt == "rgb24":
        return [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)]
    shapes = ((h, w),) * 3 if fmt == "yuv444p" else \
        ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    out = []
    for ph, pw in shapes:
        gy, gx = np.mgrid[0:ph, 0:pw]
        base = 128 + 60 * np.sin((gx + 3 * i) / 7.0) * np.cos(gy / 5.0)
        out.append(np.clip(base + rng.normal(0, 8, (ph, pw)), 16,
                           235).astype(np.uint8))
    return out


def _pair(fmt, i, w=W, h=H, seed=0, pts=None, interlaced=False):
    planes = _planes(fmt, w, h, i, seed)
    pts = i if pts is None else pts
    kw = dict(format=fmt, width=w, height=h, pts=pts,
              interlaced=interlaced)
    return (JFrame(planes=tuple(planes), time_base=JR(1, 25), **kw),
            TFrame(planes=tuple(torch.from_numpy(p) for p in planes),
                   time_base=TR(1, 25), **kw))


def run_both(desc, n=6, fmt="yuv420p", inputs=1, w=W, h=H,
             interlaced=False):
    """Push n frames into each of `inputs` pads of both packages'
    graphs (pad k's frames seeded k); returns both output lists."""
    jg = JGraph(desc, [_props(JProps, JR, w, h, fmt)] * inputs)
    tg = TGraph(desc, [_props(TProps, TR, w, h, fmt)] * inputs)
    jo, to = [], []
    for i in range(n):
        for k in reversed(range(inputs)):
            jf, tf = _pair(fmt, i, w, h, seed=k, interlaced=interlaced)
            jo += jg.push(jf, k)
            to += tg.push(tf, k)
    jo += jg.finish()
    to += tg.finish()
    p, q = jg.output_props, tg.output_props
    assert (p.width, p.height, p.pix_fmt) == (q.width, q.height, q.pix_fmt)
    return jo, to


def assert_close(jo, to, share=1e-3):
    """The scaler's float contract: at most `share` of the samples
    differ, by at most 1; frames, pts and shapes as assert_same."""
    assert len(jo) == len(to) > 0
    d = []
    for a, b in zip(jo, to):
        assert (a.pts, a.width, a.height, a.format) == \
            (b.pts, b.width, b.height, b.format)
        d += [np.abs(np.asarray(pa, np.int32)
                     - torch.as_tensor(pb).numpy().astype(np.int32)).ravel()
              for pa, pb in zip(a.planes, b.planes)]
    d = np.concatenate(d)
    print(f"{np.count_nonzero(d) / d.size:.6f} of samples differ, max |d| "
          f"{d.max()}")
    assert np.count_nonzero(d) <= share * d.size and d.max() <= 1


def assert_same(jo, to):
    assert len(jo) == len(to) > 0
    for a, b in zip(jo, to):
        assert (a.pts, a.width, a.height, a.format) == \
            (b.pts, b.width, b.height, b.format)
        assert len(a.planes) == len(b.planes)
        for pa, pb in zip(a.planes, b.planes):
            np.testing.assert_array_equal(np.asarray(pa),
                                          torch.as_tensor(pb).numpy())


@pytest.mark.parametrize("desc", [
    "gblur=sigma=1.5",
    "gblur=0.5",
    "gblur=sigma=3",
    "boxblur=2",
    "boxblur=1",
    "boxblur=luma_radius=w/32",
    "eq=contrast=1.1:brightness=0.02:saturation=1.2",
    "eq=brightness=-0.1:contrast=0.8",
    "negate",
    "drawbox=8:8:16:16:white:t=2",
    "drawbox=x=3:y=5:w=40:h=30:c=red:t=5",
    "lutyuv=y=val*0.9+16",
    "lutyuv=y=255-val:u=128:v=val/2",
    "fade=in:0:4",
    "fade=out:2:3",
    "fade=t=in:st=0.04:d=0.12",
    # the chains the JAX package fuses into one XLA program
    "eq=contrast=1.1:brightness=0.02:saturation=1.2,gblur=sigma=1.5,"
    "boxblur=2",
    "gblur=2,negate",
    "eq=brightness=0.2,null",
    "negate,eq=saturation=0.5,gblur=1",
    "select=mod(n\\,2)",
    "reverse",
    "loop=loop=2:size=2:start=1",
    "tpad=start=2:stop=1:start_mode=add:stop_mode=clone",
    "tpad=start=1:start_mode=clone",
    "tile=2x2",
    "tile=3x1",
    "extractplanes=u",
    "shuffleplanes=0:2:1",
    "setsar=4/3",
    "settb=1/1000",
    "showinfo",
    "thumbnail=3",
])
def test_video_filter_matches_jax(desc):
    assert_same(*run_both(desc))


def test_yadif_interlaced_matches_jax():
    assert_same(*run_both("yadif", interlaced=True))


@pytest.mark.parametrize("desc,fmt", [
    ("colorspace=all=bt709:ispace=bt470bg:iprimaries=bt470bg", "yuv420p"),
    ("colorspace=all=bt709:ispace=bt470bg:iprimaries=bt470bg:"
     "itrc=smpte170m", "yuv444p"),
    ("colorspace=all=bt2020:range=pc", "yuv444p"),
    ("colorspace=space=bt709:trc=srgb:primaries=bt709:itrc=linear",
     "yuv420p"),
    ("colorspace=all=bt601-6-625:irange=pc", "yuv420p"),
])
def test_colorspace_matches_jax(desc, fmt):
    assert_close(*run_both(desc, n=3, fmt=fmt))


def test_f1_chain_matches_jax():
    """F1's filter chain at 64x48 (colorspace first, so the colorspace
    contract)."""
    assert_close(*run_both(
        "colorspace=all=bt709:ispace=bt470bg:iprimaries=bt470bg,"
        "eq=contrast=1.1:brightness=0.02:saturation=1.2,gblur=sigma=1.5,"
        "boxblur=2,lutyuv=y=val*0.9+16,drawbox=8:8:32:18:white:t=4,"
        "fade=in:0:4"))


def test_colorspace_contract_catches_a_planted_fault(monkeypatch):
    """A transfer exponent of 0.46 for 0.45 (bt709's inverse OETF)
    moves far more samples than the contract allows."""
    from librempeg_tpu_torch.filters import color

    def bad_from_lin(lin):
        return torch.where(lin < color._BT709_BETA, 4.5 * lin,
                           color._BT709_ALPHA * color._pow(
                               torch.clamp(lin, min=1e-9), 0.46)
                           - (color._BT709_ALPHA - 1))

    monkeypatch.setitem(color._TRC, "bt709",
                        (color._bt709_to_lin, bad_from_lin))
    with pytest.raises(AssertionError):
        assert_close(*run_both(
            "colorspace=all=bt709:ispace=bt470bg:iprimaries=bt470bg", n=2))


@pytest.mark.parametrize("desc", [
    "lut3d=file={c}:interp=tetrahedral",
    "lut3d=file={c}:interp=trilinear",
    "lut3d=file={c}:interp=nearest",
    "lut1d=file={c}1d",
    "lut1d=file={c}1d:interp=nearest",
])
def test_lut_matches_jax(desc, tmp_path):
    c = write_cube(str(tmp_path / "t.cube"), 17)
    assert_same(*run_both(desc.format(c=c), n=3, fmt="rgb24"))


def test_lut3d_after_format_matches_jax(tmp_path):
    """lut3d behind a format=rgb24 (the graph-API case at 1080p)."""
    c = write_cube(str(tmp_path / "t.cube"))
    jo, to = run_both(f"scale=32:24,format=rgb24,lut3d=file={c}", n=2)
    for a, b in zip(jo, to):
        d = np.abs(np.asarray(a.planes[0], np.int32)
                   - b.planes[0].numpy().astype(np.int32))
        # the scaler's float contract (tests/test_torch_scale.py)
        assert np.count_nonzero(d) <= 1e-3 * d.size and d.max() <= 1


@pytest.mark.parametrize("desc,inputs", [
    ("[in][in2]hstack", 2),
    ("[in][in2]vstack", 2),
    ("[in][in2]concat=n=2:v=1:a=0", 2),
])
def test_two_input_video_filter_matches_jax(desc, inputs):
    assert_same(*run_both(desc, n=4, inputs=inputs))


def test_fused_forms_are_the_jax_forms():
    """Each fused filter's other form (eager where the JAX package
    fuses, and the reverse) differs from the JAX package: the exact
    comparison above sees a wrong float form."""
    for desc in ("eq=contrast=1.1:brightness=0.02:saturation=1.2,null",
                 "gblur=sigma=1.5,null",
                 "eq=contrast=1.1:brightness=0.02:saturation=1.2",
                 "gblur=sigma=1.5"):
        jo, _ = run_both(desc, n=12, w=128, h=96)
        tg = TGraph(desc, _props(TProps, TR, 128, 96))
        for n in tg.graph.nodes:
            n.filter.fused = not n.filter.fused
        to = []
        for i in range(12):
            to += tg.push(_pair("yuv420p", i, 128, 96)[1])
        with pytest.raises(AssertionError):
            assert_same(jo, to)


def test_boxblur_1080p_is_the_exact_box_mean():
    rng = np.random.default_rng(7)
    h, w = 1088, 1920
    planes = [rng.integers(0, 256, s).astype(np.uint8)
              for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    tg = TGraph("boxblur=2", _props(TProps, TR, w, h))
    out = tg.push(TFrame(planes=tuple(torch.from_numpy(p) for p in planes),
                         format="yuv420p", width=w, height=h, pts=0,
                         time_base=TR(1, 25)))[0]
    jg = JGraph("boxblur=2", _props(JProps, JR, w, h))
    jout = jg.push(JFrame(planes=tuple(planes), format="yuv420p", width=w,
                          height=h, pts=0, time_base=JR(1, 25)))[0]
    for i, p in enumerate(planes):
        pad = np.pad(p.astype(np.int64), 2, mode="edge")
        s = sum(pad[dy:dy + p.shape[0], dx:dx + p.shape[1]]
                for dy in range(5) for dx in range(5))
        want = np.floor(s / 25.0 + 0.5).astype(np.uint8)
        np.testing.assert_array_equal(out.planes[i].numpy(), want)
        if i == 0:
            # the JAX package's float32 summed-area table loses the low
            # bits of its prefix sums past 2^24 (ROADMAP section 3)
            d = np.asarray(jout.planes[0]).astype(int) - want
            share = np.count_nonzero(d) / d.size
            print(f"JAX boxblur=2 at 1920x1088: {share:.4f} of luma "
                  f"samples differ from the exact mean, by up to "
                  f"{np.abs(d).max()}")
            assert share > 0.05
