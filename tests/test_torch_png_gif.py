"""The port's PNG and GIF codecs and GIF container (copies of the JAX
package's codecs/png/codec.py, codecs/gif.py and formats/gif.py)
against the JAX package's.

PNG: the same seeded images give the same file bytes in both packages
for every format the encoder takes (the native library present on both
sides), and both decoders read them back to the image. The native row
filters are held to their plain versions: the port's `_filter_py` (the
least-SAD filter per row) and `_unfilter_py`. GIF: LZW, the palette and
the ordered-dither quantiser equal the JAX package's, and both CLIs
write the same .gif from the same clip and read it back to the same
frames. Without -c:v the port writes PNG into image2 `.png` files,
where the JAX package writes raw frames (asserted).
"""
import glob
import hashlib

import numpy as np
import pytest
import torch

from librempeg_tpu.codecs import gif as JG
from librempeg_tpu.codecs.png import codec as JP
from librempeg_tpu.core.frame import VideoFrame as JFrame
from librempeg_tpu_torch.codecs import gif as TG
from librempeg_tpu_torch.codecs.png import codec as TP
from librempeg_tpu_torch.core.errors import Unsupported
from librempeg_tpu_torch.core.frame import VideoFrame as TFrame
from librempeg_tpu_torch.native import build as native
from tools.audio_jax_repair import framemd5_repaired

# format: (channels, dtype)
FORMATS = {"gray": (1, np.uint8), "rgb24": (3, np.uint8),
           "rgba": (4, np.uint8), "rgb48le": (3, np.uint16),
           "gray16le": (1, np.uint16)}


def image(fmt, w, h, seed):
    """A seeded image with smooth and noisy parts, so that every row
    filter wins somewhere."""
    ch, dt = FORMATS[fmt]
    rng = np.random.default_rng(seed)
    top = np.iinfo(dt).max
    ramp = (np.add.outer(np.arange(h), np.arange(w)) * top //
            (w + h)).astype(dt)
    img = np.repeat(ramp[..., None], ch, 2)
    noisy = rng.integers(0, top + 1, (h, w, ch), dtype=np.int64)
    img[h // 2:] = noisy[:h - h // 2].astype(dt)
    return img[..., 0] if ch == 1 else img


def _cli(pkg, argv):
    if pkg == "jax":
        from librempeg_tpu.cli.ffmpeg import main
        return main(["-v", "error"] + argv)
    from librempeg_tpu_torch.cli.ffmpeg import main
    return main(argv + ["-device", "cpu"])


@pytest.mark.parametrize("level", [0, 6, 9])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_png_bytes_equal_jax(fmt, level):
    img = image(fmt, 37, 23, seed=len(fmt) + level)
    h, w = img.shape[:2]
    want = JP.encode_png(JFrame(planes=(img,), format=fmt, width=w,
                                height=h), level)
    got = TP.encode_png(TFrame(planes=(torch.from_numpy(img),), format=fmt,
                               width=w, height=h), level)
    assert got == want
    for dec in (TP.decode_png(got), JP.decode_png(got)):
        assert dec.format == fmt
        np.testing.assert_array_equal(np.asarray(dec.planes[0]), img)


def test_png_decoder_frames_on_its_device():
    img = image("rgb24", 16, 8, seed=1)
    data = TP.encode_png(TFrame(planes=(img,), format="rgb24", width=16,
                                height=8))
    from librempeg_tpu_torch.core.packet import Packet

    f, = TP.PngDecoder(device="cpu").decode(Packet(data=data, pts=3))
    assert isinstance(f.planes[0], torch.Tensor) and f.pts == 3
    np.testing.assert_array_equal(f.planes[0].numpy(), img)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_native_filters_against_plain(bpp):
    """The native filter picks the plain version's filter on every row
    and writes its bytes; the native unfilter inverts it and agrees with
    `_unfilter_py` on rows of every filter type."""
    rng = np.random.default_rng(bpp)
    h, stride = 12, 7 * bpp
    img = rng.integers(0, 256, (h, stride), dtype=np.uint8)
    img[:h // 2] = np.cumsum(img[:h // 2] % 3, 1, dtype=np.uint8)
    filtered = native.png_filter(img, h, stride, bpp)
    assert len(filtered) == h * (stride + 1)
    assert filtered == TP._filter_py(img, h, stride, bpp)
    assert sorted(set(filtered[::stride + 1])) != [0]
    np.testing.assert_array_equal(
        native.png_unfilter(filtered, h, stride, bpp), img.reshape(-1))
    rows = rng.integers(0, 256, (h, stride + 1), dtype=np.uint8)
    rows[:, 0] = np.arange(h) % 5
    raw = rows.tobytes()
    np.testing.assert_array_equal(
        native.png_unfilter(raw, h, stride, bpp),
        TP._unfilter_py(np.frombuffer(raw, np.uint8), h, stride, bpp))


def test_png_raises_without_the_native_library(monkeypatch):
    """No Python fallback: without the native library PNG raises (the
    JAX package filters in Python then)."""
    img = image("rgb24", 8, 4, seed=2)
    frame = TFrame(planes=(img,), format="rgb24", width=8, height=4)
    data = TP.encode_png(frame)
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(Unsupported):
        TP.encode_png(frame)
    with pytest.raises(Unsupported):
        TP.decode_png(data)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lzw_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n = 5000 + 3000 * seed
    idx = (rng.integers(0, 6, n) * (seed + 1) +
           np.repeat(rng.integers(0, 40, n // 50 + 1), 50)[:n]).astype(
               np.uint8)
    for mcs in (8, 7):
        x = idx & ((1 << mcs) - 1)
        data = TG.lzw_encode(x, mcs)
        assert data == JG.lzw_encode(x, mcs)
        np.testing.assert_array_equal(TG.lzw_decode(data, mcs, n), x)
        np.testing.assert_array_equal(JG.lzw_decode(data, mcs, n), x)


def test_palette_and_quantize_equal_jax():
    np.testing.assert_array_equal(TG.make_palette(), JG.make_palette())
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (37, 45, 3), dtype=np.uint8)
    np.testing.assert_array_equal(TG.quantize(rgb), JG.quantize(rgb))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    from tests.test_torch_slice import make_clip

    path = tmp_path_factory.mktemp("pg") / "clip.264"
    make_clip(str(path))
    return str(path)


@pytest.mark.parametrize("frames", [1, 3])
def test_gif_files_equal_jax(clip, tmp_path, frames):
    """-c:v rawvideo -pix_fmt rgb24 out.gif: the same file in both
    packages; both read it back to the same frames."""
    for pkg in ("jax", "torch"):
        assert _cli(pkg, ["-i", clip, "-frames:v", str(frames), "-c:v",
                          "rawvideo", "-pix_fmt", "rgb24", "-y",
                          str(tmp_path / f"{pkg}.gif")]) == 0
    data = (tmp_path / "torch.gif").read_bytes()
    assert data[:6] == b"GIF89a"
    assert data == (tmp_path / "jax.gif").read_bytes()
    for pkg in ("jax", "torch"):
        assert _cli(pkg, ["-i", str(tmp_path / "torch.gif"), "-f",
                          "framemd5", "-y",
                          str(tmp_path / f"{pkg}.md5")]) == 0
    text = (tmp_path / "torch.md5").read_text()
    # libavformat's last header line, which the JAX package leaves out
    assert text == framemd5_repaired((tmp_path / "jax.md5").read_text())
    assert len([ln for ln in text.splitlines()
                if not ln.startswith("#")]) == frames


def test_image2_png_default_codec(clip, tmp_path):
    """thumb_%03d.png with no -c:v: the port writes PNG, the files the
    JAX package's with -c:v png; the JAX package, given no -c:v, writes
    raw rgb24 frames into them. The port reads its files back to the
    frames it wrote."""
    for pkg, extra in (("jax", ["-c:v", "png"]), ("torch", []),
                       ("jaxraw", [])):
        d = tmp_path / pkg
        d.mkdir()
        assert _cli("torch" if pkg == "torch" else "jax",
                    ["-i", clip, "-frames:v", "3", "-pix_fmt", "rgb24"]
                    + extra + ["-y", str(d / "thumb_%03d.png")]) == 0

    def files(pkg):
        return [open(f, "rb").read()
                for f in sorted(glob.glob(str(tmp_path / pkg / "*.png")))]

    assert len(files("torch")) == 3
    assert files("torch") == files("jax")
    assert all(f.startswith(b"\x89PNG\r\n\x1a\n") for f in files("torch"))
    assert all(len(f) == 96 * 64 * 3 for f in files("jaxraw"))
    md5 = tmp_path / "back.md5"
    assert _cli("torch", ["-i", str(tmp_path / "torch" / "thumb_%03d.png"),
                          "-f", "framemd5", "-y", str(md5)]) == 0
    raw = files("jaxraw")
    got = [ln.split(",")[5].strip() for ln in md5.read_text().splitlines()
           if not ln.startswith("#")]
    assert got == [hashlib.md5(f).hexdigest() for f in raw]
