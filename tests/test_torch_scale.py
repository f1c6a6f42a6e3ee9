"""The port's planar scaler (float32 GEMMs + floor(x + 0.5)) against the
JAX package's Scaler on the CPU.

Resize matrices are the same numpy code in both packages and must be
identical. The products differ only in float32 summation order, so a
stored uint8 sample can land on the other side of a rounding boundary:
the tolerance is at most 0.1% of samples differing, by at most 1. Each
case prints its mismatch fraction and PSNR.
"""
import numpy as np
import pytest
import torch

from librempeg_tpu.ops import fir as JF
from librempeg_tpu.scale import get_scaler as jget
from librempeg_tpu_torch.core.errors import Unsupported
from librempeg_tpu_torch.core.frame import VideoFrame as TFrame
from librempeg_tpu_torch.filters import GraphRunner, StreamProps
from librempeg_tpu_torch.ops import fir as TF
from librempeg_tpu_torch.scale import get_scaler as tget


def _cmp(a, b, what):
    a = np.asarray(a).astype(np.int32)
    b = np.asarray(b).astype(np.int32)
    assert a.shape == b.shape
    diff = np.abs(a - b)
    frac = np.count_nonzero(diff) / diff.size
    mse = float((diff.astype(np.float64) ** 2).mean())
    psnr = float("inf") if mse == 0 else 10 * np.log10(255 ** 2 / mse)
    print(f"{what}: mismatch {frac:.6f}, max |d| {diff.max()}, "
          f"PSNR {psnr:.2f} dB")
    assert frac <= 1e-3 and diff.max() <= 1, what


def _planes(rng, w, h):
    gy, gx = np.mgrid[0:h, 0:w]
    y = np.clip(128 + 90 * np.sin(gx / 5.0) * np.cos(gy / 7.0)
                + rng.normal(0, 20, (h, w)), 0, 255).astype(np.uint8)
    u = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    return y, u, v


@pytest.mark.parametrize("src,dst,kernel", [
    ((192, 128), (128, 80), "bicubic"),
    ((96, 64), (160, 96), "bicubic"),
    ((192, 128), (96, 64), "bilinear"),
])
def test_scale_planar_matches_jax(src, dst, kernel):
    rng = np.random.default_rng(sum(src) + sum(dst))
    planes = _planes(rng, *src)
    js = jget("yuv420p", *src, "yuv420p", *dst, kernel=kernel)
    ts = tget("yuv420p", *src, "yuv420p", *dst, kernel=kernel)
    jo = js.scale_planes(planes)
    to = ts.scale_planes(tuple(torch.from_numpy(p) for p in planes))
    for a, b, name in zip(jo, to, "yuv"):
        assert b.dtype == torch.uint8
        _cmp(a, b, f"{src}->{dst} {kernel} {name}")


def test_resize_matrix_and_gemm():
    """Same matrices; the float32 GEMM agrees to float32 rounding."""
    m_j = JF.resize_matrix(1088, 720)
    m_t = TF.resize_matrix(1088, 720)
    assert m_t.dtype == np.float32 and np.array_equal(m_j, m_t)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (3, 68, 120)).astype(np.float32)
    j = np.asarray(JF.resize_plane(x, 45, 80))
    t = TF.resize_plane(torch.from_numpy(x), 45, 80).numpy()
    assert t.shape == (3, 45, 80)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-3)


def test_scale_filter_chain():
    """The scale filter in a null,scale chain: output props and frames
    of the expected shape, on the input's device."""
    props = StreamProps(media="video", width=96, height=64,
                        pix_fmt="yuv420p")
    g = GraphRunner("null,scale=64:-1", props)
    assert (g.output_props.width, g.output_props.height) == (64, 44)
    g = GraphRunner("null,scale=48:32", props)
    rng = np.random.default_rng(1)
    planes = tuple(torch.from_numpy(p) for p in _planes(rng, 96, 64))
    out = g.push(TFrame(planes=planes, format="yuv420p", width=96,
                        height=64))
    assert len(out) == 1 and g.finish() == []
    assert [tuple(p.shape) for p in out[0].planes] == \
        [(32, 48), (16, 24), (16, 24)]
    assert out[0].width == 48 and out[0].planes[0].device.type == "cpu"


def test_scaler_rejects_unported_conversions():
    """Every format core/pixfmt registers converts (test_torch_colorspace);
    an unknown pixel format or scaler kernel still raises."""
    with pytest.raises(Unsupported):
        tget("yuv420p", 64, 48, "yuv420p_nonesuch", 64, 48)
    with pytest.raises(Unsupported):
        tget("nonesuch", 64, 48, "yuv420p", 64, 48)
    with pytest.raises(Unsupported):
        tget("yuv420p", 64, 48, "yuv420p", 32, 24, kernel="nonesuch")
    assert tget("yuv420p", 64, 48, "rgb24", 64, 48).scale_planes(
        tuple(torch.zeros(s, dtype=torch.uint8)
              for s in ((48, 64), (24, 32), (24, 32))))[0].shape == (48, 64, 3)
