"""The port's colour-space math (ops/colorspace) and its Scaler's colour,
range, layout and depth conversions against the JAX package's on the
CPU.

The matrices are the same float64 numpy code in both packages and must
be identical. The conversions are float32 3x3 products: values within
1e-4. Converted frames go through float32 GEMMs whose summation order
differs between XLA and PyTorch, so a stored integer sample can land on
the other side of the floor(x + 0.5) boundary: integer outputs must be
equal on at least 99.9% of samples and differ by at most 1; float
outputs within 1e-4. Each case prints the share of samples that differ.

The JAX Scaler packs planar RGB output (gbrp) into one [H, W, 1] plane
holding only G; the port emits the G, B and R planes, which are held to
the JAX package's rgb24 output of the same frame.
"""
import numpy as np
import pytest
import torch

from librempeg_tpu.ops import colorspace as JCS
from librempeg_tpu.scale import get_scaler as jget
from librempeg_tpu_torch.ops import colorspace as TCS
from librempeg_tpu_torch.scale import get_scaler as tget

CSPS = ("bt601", "bt709", "bt2020", "smpte240m", "fcc")


@pytest.mark.parametrize("csp", CSPS)
@pytest.mark.parametrize("full", [False, True])
def test_matrices_equal(csp, full):
    for name in ("rgb_to_yuv_matrix", "yuv_to_rgb_matrix"):
        jm, jo = getattr(JCS, name)(csp, full)
        tm, to = getattr(TCS, name)(csp, full)
        assert tm.dtype == np.float64
        assert np.array_equal(jm, tm) and np.array_equal(jo, to), name


def _rand(seed, *shape):
    return np.random.default_rng(seed).uniform(0, 255, shape) \
        .astype(np.float32)


@pytest.mark.parametrize("csp", ["bt601", "bt709", "bt2020"])
@pytest.mark.parametrize("full", [False, True])
def test_conversions_close(csp, full):
    y, u, v = (_rand(i, 2, 12, 20) for i in range(3))
    j = np.asarray(JCS.yuv_to_rgb(y, u, v, csp, full))
    t = TCS.yuv_to_rgb(*(torch.from_numpy(a) for a in (y, u, v)), csp, full)
    assert t.dtype == torch.float32 and t.shape == (2, 12, 20, 3)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-4)
    rgb = _rand(3, 2, 12, 20, 3)
    for a, b in zip(JCS.rgb_to_yuv(rgb, csp, full),
                    TCS.rgb_to_yuv(torch.from_numpy(rgb), csp, full)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-4)
    for src_full, dst_full in ((full, not full), (full, full)):
        for a, b in zip(JCS.range_convert(y, u, v, src_full, dst_full),
                        TCS.range_convert(*(torch.from_numpy(a)
                                            for a in (y, u, v)),
                                          src_full, dst_full)):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       rtol=0, atol=1e-4)


def _src_planes(fmt, h, w, seed=7):
    """Textured planes of `fmt` at h x w."""
    rng = np.random.default_rng(seed)
    gy, gx = np.mgrid[0:h, 0:w]
    y = np.clip(128 + 90 * np.sin(gx / 5.0) * np.cos(gy / 7.0)
                + rng.normal(0, 20, (h, w)), 0, 255)
    cu = np.clip(128 + 60 * np.cos(gx[::2, ::2] / 4.0)
                 + rng.normal(0, 15, (h // 2, w // 2)), 0, 255)
    cv = np.clip(128 + 60 * np.sin(gy[::2, ::2] / 3.0)
                 + rng.normal(0, 15, (h // 2, w // 2)), 0, 255)
    b8 = [a.astype(np.uint8) for a in (y, cu, cv)]
    if fmt in ("yuv420p", "yuvj420p"):
        return tuple(b8)
    if fmt == "yuv420p10le":
        return tuple((a * 4.0120).astype(np.uint16) for a in (y, cu, cv))
    if fmt == "nv12":
        return b8[0], np.stack([b8[1], b8[2]], -1)
    if fmt == "nv21":
        return b8[0], np.stack([b8[2], b8[1]], -1)
    if fmt == "rgb24":
        return (np.stack([b8[0], np.roll(b8[0], 5, 1),
                          np.clip(255 - b8[0].astype(int), 0, 255)
                          .astype(np.uint8)], -1),)
    raise AssertionError(fmt)


def _share_differing(jo, to, what, is_float):
    """Share of the output's samples (all planes) that differ."""
    n = bad = 0
    worst = 0.0
    for i, (a, b) in enumerate(zip(jo, to)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        assert a.dtype == b.dtype, (what, i, a.dtype, b.dtype)
        d = np.abs(a.astype(np.float64) - b.astype(np.float64))
        print(f"{what} plane {i}: {np.count_nonzero(d)}/{d.size} samples "
              f"differ, max |d| {d.max()}")
        n, bad, worst = n + d.size, bad + np.count_nonzero(d), \
            max(worst, float(d.max()))
    print(f"{what}: {bad / n:.6f} of samples differ")
    if is_float:
        assert worst <= 1e-4, what
    else:
        assert bad / n <= 1e-3 and worst <= 1, what


PAIRS = [
    ("yuv420p", "yuvj420p"), ("yuvj420p", "yuv420p"),
    ("yuv420p", "rgb24"), ("yuv420p", "bgr24"), ("yuv420p", "rgba"),
    ("yuv420p", "gbrp"), ("rgb24", "yuv420p"),
    ("yuv420p", "nv12"), ("yuv420p", "nv21"), ("nv12", "yuv420p"),
    ("nv21", "yuv420p"), ("yuv420p", "gray"), ("yuv420p10le", "yuv420p"),
    ("yuv420p", "yuv444p16le"), ("yuv420p", "grayf32le"),
]


@pytest.mark.parametrize("dst_hw", [(36, 40), (48, 64)],
                         ids=["48x64-36x40", "same-size"])
@pytest.mark.parametrize("src_fmt,dst_fmt", PAIRS,
                         ids=[f"{a}-{b}" for a, b in PAIRS])
def test_scaler_conversion_matches_jax(src_fmt, dst_fmt, dst_hw):
    h, w = 48, 64
    dh, dw = dst_hw
    planes = _src_planes(src_fmt, h, w)
    to = tget(src_fmt, w, h, dst_fmt, dw, dh).scale_planes(
        tuple(torch.from_numpy(np.ascontiguousarray(p)) for p in planes))
    if dst_fmt == "gbrp":
        # the JAX Scaler emits one [H, W, 1] G plane for planar RGB: hold
        # the port's G, B, R planes to its rgb24 output instead
        (jrgb,) = jget(src_fmt, w, h, "rgb24", dw, dh).scale_planes(planes)
        jo = tuple(np.asarray(jrgb)[..., c] for c in (1, 2, 0))
    else:
        jo = jget(src_fmt, w, h, dst_fmt, dw, dh).scale_planes(planes)
    assert len(jo) == len(to)
    _share_differing(jo, [t.numpy() for t in to],
                     f"{src_fmt}->{dst_fmt} {h}x{w}->{dh}x{dw}",
                     dst_fmt.endswith("f32le"))


def test_rgb_resize_uses_the_requested_kernel():
    """The JAX package's general path resizes RGB with bicubic whatever
    the kernel; the port honours it (equal to the JAX package at
    bicubic, see test_scaler_conversion_matches_jax)."""
    planes = tuple(torch.from_numpy(p) for p in _src_planes("yuv420p",
                                                            48, 64))
    a = tget("yuv420p", 64, 48, "rgb24", 40, 36, "bilinear") \
        .scale_planes(planes)[0]
    b = tget("yuv420p", 64, 48, "rgb24", 40, 36, "bicubic") \
        .scale_planes(planes)[0]
    assert not torch.equal(a, b)


def test_format_reaches_the_scaler_through_the_filters():
    """scale's format option and the format filter (the chain -pix_fmt
    builds) both convert through get_scaler: yuvj420p frames marked
    full range, equal to the Scaler's own output."""
    from librempeg_tpu_torch.core.frame import VideoFrame
    from librempeg_tpu_torch.filters import GraphRunner, StreamProps

    props = StreamProps(media="video", width=64, height=48,
                        pix_fmt="yuv420p")
    planes = tuple(torch.from_numpy(p) for p in _src_planes("yuv420p",
                                                            48, 64))
    want = tget("yuv420p", 64, 48, "yuv420p", 40, 36).scale_planes(planes)
    want = tget("yuv420p", 40, 36, "yuvj420p", 40, 36).scale_planes(want)
    for desc in ("null,scale=40:36,format=yuvj420p",
                 "scale=40:36,format=pix_fmts=yuvj420p|gray"):
        g = GraphRunner(desc, props)
        assert g.output_props.pix_fmt == "yuvj420p"
        (out,) = g.push(VideoFrame(planes=planes, format="yuv420p",
                                   width=64, height=48))
        assert (out.format, out.color_range) == ("yuvj420p", "jpeg")
        assert all(torch.equal(a, b) for a, b in zip(out.planes, want))
    g = GraphRunner("scale=w=40:h=36:format=yuvj420p", props)
    (out,) = g.push(VideoFrame(planes=planes, format="yuv420p", width=64,
                               height=48))
    direct = tget("yuv420p", 64, 48, "yuvj420p", 40, 36).scale_planes(planes)
    assert out.format == "yuvj420p"
    assert all(torch.equal(a, b) for a, b in zip(out.planes, direct))
