"""The JPEG/MJPEG path of the PyTorch port against the JAX package, on
the CPU (device="cpu").

Tolerances:
* ops/dct8x8.idct_int equals the JAX function bit for bit, also where
  the dequantised coefficients wrap int32;
* the decoder is bit-exact with the JAX decoder on JAX-encoded JPEGs
  (4:2:0, 4:2:2, 4:4:4, gray, odd sizes, a restart interval, 1920x1088);
* the encoder is a float contract: its levels may differ from the JAX
  package's only where the DCT lands on a rounding boundary (a DC of
  sum/8 that is exactly k + 1/2 quantiser steps is the common one). At
  most 1e-3 of the levels differ, each by at most 1, and each image's
  bytes lie within 0.5% of the JAX package's;
* the trellis size category (an integer bit length in the port) equals
  the JAX package's float ceil(log2(c + 1)) on all of 1..1023;
* -trellis reaches the port's JPEG encoder (the JAX package drops it:
  JpegEncoder.encode never passes its trellis option);
* transcodes of a small H.264 clip to MJPEG in AVI, to raw MJPEG and to
  image2 files: packet counts and pts equal, sizes within 0.5% (and 8
  bytes), the port's decoder bit-exact on the JAX package's streams,
  and the decoded PSNR of each package's stream against the same
  yuvj420p source within 0.05 dB of each other.
"""
import glob
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from librempeg_tpu.codecs.jpeg import decoder as JD
from librempeg_tpu.codecs.jpeg import encoder as JE
from librempeg_tpu.codecs.jpeg import tables as JT
from librempeg_tpu.core.frame import VideoFrame as JFrame
from librempeg_tpu.formats import api as JA
from librempeg_tpu.native import build as JN
from librempeg_tpu.ops import dct8x8 as JDCT
from librempeg_tpu.sched import pipeline as JP
from librempeg_tpu_torch.codecs.jpeg import decoder as TD
from librempeg_tpu_torch.codecs.jpeg import encoder as TE
from librempeg_tpu_torch.core.frame import VideoFrame as TFrame
from librempeg_tpu_torch.formats import api as TA
from librempeg_tpu_torch.ops import dct8x8 as TDCT
from librempeg_tpu_torch.sched import pipeline as TP

from test_torch_slice import make_clip

LEVEL_SHARE = 1e-3
BYTES_REL = 5e-3
PSNR_GAP_DB = 0.05

_SAMPLING = {"yuvj420p": (2, 2), "yuvj422p": (2, 1), "yuvj444p": (1, 1),
             "gray": None}


def _planes(fmt, w, h, seed):
    """Seeded planes of `fmt`: a smooth pattern plus noise."""
    rng = np.random.default_rng(seed)
    sub = _SAMPLING[fmt]
    shapes = [(h, w)] if sub is None else [
        (h, w)] + [(-(-h // sub[1]), -(-w // sub[0]))] * 2
    out = []
    for i, (ph, pw) in enumerate(shapes):
        gy, gx = np.mgrid[0:ph, 0:pw]
        base = 128 + 70 * np.sin(gx / 9.0 + i) * np.cos(gy / 7.0)
        out.append(np.clip(base + rng.normal(0, 12, (ph, pw)), 0,
                           255).astype(np.uint8))
    return out


def _frames(fmt, w, h, seed=0):
    planes = _planes(fmt, w, h, seed)
    return (JFrame(planes=tuple(planes), format=fmt, width=w, height=h),
            TFrame(planes=tuple(torch.from_numpy(p) for p in planes),
                   format=fmt, width=w, height=h))


def _psnr(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    mse = float((d * d).mean())
    return float("inf") if mse == 0 else 10 * np.log10(255 ** 2 / mse)


@pytest.mark.parametrize("scale", [10, 3000, 522_240, 2 ** 31 - 1])
def test_idct_int_matches_jax(scale):
    """Random blocks up to `scale`: 2047 x 255 = 522240 is the largest
    dequantised level of an 8-bit table; 2^31 - 1 wraps every pass."""
    rng = np.random.default_rng(scale)
    x = rng.integers(-scale, scale, (300, 8, 8), dtype=np.int64)
    x = x.astype(np.int32)
    want = np.asarray(JDCT.idct_int(jnp.asarray(x)))
    got = TDCT.idct_int(torch.from_numpy(x))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    pred = rng.integers(0, 256, (300, 8, 8), dtype=np.int64).astype(np.uint8)
    assert np.array_equal(
        TDCT.idct_int_add(torch.from_numpy(x), torch.from_numpy(pred)).numpy(),
        np.asarray(JDCT.idct_int_add(jnp.asarray(x), jnp.asarray(pred))))
    assert np.array_equal(TDCT.idct_int_put(torch.from_numpy(x)).numpy(),
                          np.asarray(JDCT.idct_int_put(jnp.asarray(x))))


def _with_restarts(jpg: bytes, fmt: str, w: int, h: int, every: int) -> bytes:
    """The same image with a restart marker every `every` MCUs: the JAX
    package's scan decoded to levels and Huffman-coded again one
    interval at a time by its native coder (each interval starts its DC
    prediction at 0), joined by RST0..RST7, with a DRI segment."""
    sos = jpg.index(b"\xff\xda")
    body = sos + 2 + struct.unpack(">H", jpg[sos + 2:sos + 4])[0]
    sub = _SAMPLING[fmt]
    samp = [(1, 1)] if sub is None else [sub, (1, 1), (1, 1)]
    cspec = [{"h": a, "v": b, "dc": int(i > 0), "ac": int(i > 0)}
             for i, (a, b) in enumerate(samp)]
    dct = [(JT.DC_LUMA_BITS, JT.DC_LUMA_VALS),
           (JT.DC_CHROMA_BITS, JT.DC_CHROMA_VALS)]
    act = [(JT.AC_LUMA_BITS, JT.AC_LUMA_VALS),
           (JT.AC_CHROMA_BITS, JT.AC_CHROMA_VALS)]
    hmax = max(a for a, _ in samp)
    vmax = max(b for _, b in samp)
    n = -(-w // (8 * hmax)) * -(-h // (8 * vmax))
    coeffs = JN.jpeg_decode_scan(jpg[body:], cspec, dct, act, n, 0)
    bpm = sum(a * b for a, b in samp)
    out = bytearray(jpg[:sos]) + b"\xff\xdd" + struct.pack(">HH", 4, every)
    out += jpg[sos:body]
    for k, m in enumerate(range(0, n, every)):
        if k:
            out += bytes([0xFF, 0xD0 + (k - 1) % 8])
        cnt = min(every, n - m)
        out += JN.jpeg_encode_scan(coeffs[m * bpm:(m + cnt) * bpm], cspec,
                                   dct, act, cnt)
    return bytes(out) + b"\xff\xd9"


@pytest.mark.parametrize("fmt,w,h,quality,restart", [
    ("yuvj420p", 37, 29, 75, 0),
    ("yuvj422p", 64, 48, 90, 0),
    ("yuvj444p", 40, 24, 50, 0),
    ("gray", 33, 17, 95, 0),
    ("yuvj420p", 96, 64, 85, 5),
    ("yuvj420p", 1920, 1088, 91, 0),
])
def test_decoder_bit_exact(fmt, w, h, quality, restart):
    jf, _ = _frames(fmt, w, h, seed=w)
    jpg = JE.encode_jpeg(jf, quality=quality)
    if restart:
        jpg = _with_restarts(jpg, fmt, w, h, restart)
        assert b"\xff\xd1" in jpg
    want = JD.decode_jpeg(jpg)
    got = TD.decode_jpeg(jpg, device="cpu")
    assert (got.format, got.width, got.height, got.color_range) == \
        (want.format, want.width, want.height, want.color_range)
    for a, b in zip(want.planes, got.planes):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("key,md5_key", [("stored_jpeg", "stored_md5"),
                                         ("a0_jpeg", "a_dec_md5")])
def test_decoder_matches_the_golden_frames(key, md5_key):
    """The JAX package's 1920x1088 frames of the JPEG golden (frame 0 at
    -q:v 31, and packet 0 of the -q:v 3 path) decode on the CPU to the
    md5 of the JAX decoder's planes, bit for bit."""
    import hashlib

    gold = np.load(os.path.join(os.path.dirname(__file__), "data",
                                "torch_port", "bench_1080p_mjpeg.npz"))
    got = TD.decode_jpeg(gold[key].tobytes(), device="cpu")
    h = hashlib.md5()
    for p in got.planes:
        h.update(p.contiguous().numpy().tobytes())
    assert h.hexdigest() == str(gold[md5_key].reshape(-1)[0])


@pytest.mark.parametrize("quality", [2, 50, 90])
@pytest.mark.parametrize("trellis", [0, 1])
def test_encoder_levels_match_jax(quality, trellis):
    """The levels of a 256x128 luma and a chroma plane, then the whole
    image's bytes."""
    jf, tf = _frames("yuvj420p", 256, 128, seed=5)
    lq = JT.quant_for_quality(JT.STD_LUMA_QUANT, quality)
    cq = JT.quant_for_quality(JT.STD_CHROMA_QUANT, quality)
    lam = 0.85 * float(np.mean(lq.reshape(-1)[1:])) ** 2
    diff, n = 0, 0
    for i, q in ((0, lq), (1, cq)):
        p = jf.planes[i]
        if trellis:
            want = JE._plane_to_coeffs_rd(jnp.asarray(p),
                                          jnp.asarray(q.reshape(-1)),
                                          jnp.float32(lam), i > 0)
            got = TE._plane_to_coeffs_rd(torch.from_numpy(p),
                                         torch.from_numpy(q.reshape(-1)),
                                         lam, i > 0)
        else:
            want = JE._plane_to_coeffs(jnp.asarray(p),
                                       jnp.asarray(q.reshape(-1)))
            got = TE._plane_to_coeffs(torch.from_numpy(p),
                                      torch.from_numpy(q.reshape(-1)))
        d = np.abs(np.asarray(want, np.int32) - got.numpy())
        assert got.dtype == torch.int16 and d.max() <= 1
        diff += np.count_nonzero(d)
        n += d.size
    jb = JE.encode_jpeg(jf, quality=quality, trellis=trellis)
    tb = TE.encode_jpeg(tf, quality=quality, trellis=trellis, device="cpu")
    print(f"q {quality} trellis {trellis}: {diff / n:.6f} of levels differ; "
          f"{len(tb)} bytes (JAX {len(jb)})")
    assert diff / n <= LEVEL_SHARE
    assert abs(len(tb) - len(jb)) <= BYTES_REL * len(jb)


def test_codec_registry():
    """The port's registry: the JAX package's names for the port's
    codecs, every PCM codec bound to its name, loud on an unknown one."""
    from librempeg_tpu_torch.codecs import api
    from librempeg_tpu_torch.codecs.aac.codec import AacEncoder
    from librempeg_tpu_torch.codecs.aac.decoder import AacDecoder
    from librempeg_tpu_torch.codecs.h264.codec import H264Decoder
    from librempeg_tpu_torch.codecs.mpeg4._decoder import Mpeg4Decoder
    from librempeg_tpu_torch.codecs.mpeg4.encoder import Mpeg4Encoder
    from librempeg_tpu_torch.core.errors import NotFound
    from librempeg_tpu_torch.formats.api import CodecParameters

    want = {("h264", "dec"): H264Decoder, ("mpeg4", "dec"): Mpeg4Decoder,
            ("mjpeg", "dec"): TD.JpegDecoder, ("aac", "dec"): AacDecoder,
            ("mpeg4", "enc"): Mpeg4Encoder, ("mjpeg", "enc"): TE.JpegEncoder,
            ("aac", "enc"): AacEncoder}
    for (name, kind), cls in want.items():
        find = api.find_decoder if kind == "dec" else api.find_encoder
        assert find(name) is cls
    par = CodecParameters(codec_type="audio", codec_id="pcm_s16le",
                          sample_rate=8000, nb_channels=2)
    dec = api.find_decoder("pcm_s16le")(par, device="cpu")
    enc = api.find_encoder("pcm_s16le")(sample_rate=8000, channels=2)
    assert (dec.codec, enc.codec) == ("pcm_s16le", "pcm_s16le")
    assert {"pcm_s16le", "pcm_f32le", "pcm_u8"} <= set(api.decoders())
    with pytest.raises(NotFound):
        api.find_encoder("no_such_codec")


def test_size_category_matches_jax():
    c = np.arange(1, 1024, dtype=np.int32)
    want = np.asarray(jnp.int32(jnp.ceil(jnp.log2(
        jnp.asarray(c).astype(jnp.float32) + 1))))
    assert np.array_equal(TE.size_category(torch.from_numpy(c)).numpy(), want)


def test_trellis_option_reaches_the_encoder():
    """-trellis 1 on mjpeg: the port's JpegEncoder codes what
    encode_jpeg(trellis=1) codes (the JAX package's own RD path, held to
    the JAX bytes within the float contract); the JAX JpegEncoder
    ignores the option and writes its trellis-0 bytes."""
    jf, tf = _frames("yuvj420p", 96, 64, seed=2)
    jenc = JE.JpegEncoder(width=96, height=64, quality=80, trellis=1)
    assert bytes(jenc.encode(jf)[0].data) == JE.encode_jpeg(jf, quality=80)
    tenc = TE.JpegEncoder(width=96, height=64, quality=80, trellis=1,
                          device="cpu")
    got = bytes(tenc.encode(tf)[0].data)
    assert got == TE.encode_jpeg(tf, quality=80, trellis=1, device="cpu")
    assert got != TE.encode_jpeg(tf, quality=80, device="cpu")
    want = JE.encode_jpeg(jf, quality=80, trellis=1)
    assert abs(len(got) - len(want)) <= BYTES_REL * len(want)
    a = JD.decode_jpeg(want)
    b = TD.decode_jpeg(got, device="cpu")
    assert min(_psnr(x, y.numpy()) for x, y in zip(a.planes, b.planes)) > 45


def _source_frames(src):
    """The clip as the encoders take it: the port's decode on the CPU,
    then the port's format=yuvj420p (numpy planes)."""
    from librempeg_tpu_torch.codecs.h264.codec import H264Decoder
    from librempeg_tpu_torch.filters import GraphRunner, StreamProps
    from librempeg_tpu_torch.core.rational import Rational

    demux = TA.open_input(str(src))
    par = demux.streams[0].codecpar
    dec = H264Decoder(par, device="cpu")
    g = GraphRunner("format=yuvj420p", StreamProps(
        media="video", width=par.width, height=par.height,
        pix_fmt="yuv420p", frame_rate=Rational(25, 1),
        time_base=demux.streams[0].time_base))
    out = []
    for pkt in demux.packets():
        for f in dec.decode(pkt):
            out += g.push(f)
    for f in dec.flush():
        out += g.push(f)
    return [[p.numpy() for p in f.planes] for f in out]


def _packets(path, fmt=None):
    if "%" in path:
        return [(i, open(f, "rb").read()) for i, f in
                enumerate(sorted(glob.glob(path.replace("%03d", "*"))))]
    return [(p.pts, bytes(p.data))
            for p in TA.open_input(path, fmt).packets()]


@pytest.mark.parametrize("out_name,fmt", [
    ("out.avi", None), ("out.mjpeg", "mjpeg"), ("out_%03d.jpg", "image2")])
def test_transcode_to_mjpeg_matches_jax(tmp_path, out_name, fmt):
    src = tmp_path / "clip.264"
    make_clip(src)
    src_frames = _source_frames(src)
    outs = {}
    for name, P, kw in (("jax", JP, {}), ("port", TP, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        # the port picks mjpeg itself for raw MJPEG and image2 outputs
        codec = "mjpeg" if name == "jax" or fmt is None else ""
        P.Transcoder(P.TranscodeSpec(
            input_url=str(src), output_url=str(d / out_name),
            output_format=fmt,
            video=P.StreamMap(codec=codec, pix_fmt="yuvj420p",
                              codec_opts={"quality_scale": 3.0}),
            **kw)).run()
        outs[name] = _packets(str(d / out_name))
    jp, tp = outs["jax"], outs["port"]
    assert len(jp) == len(tp) == len(src_frames) == 12
    assert [p for p, _ in jp] == [p for p, _ in tp] == list(range(12))
    if fmt == "image2":
        names = [os.path.basename(f) for f in
                 sorted(glob.glob(str(tmp_path / "port" / "out_*.jpg")))]
        assert names == [f"out_{i:03d}.jpg" for i in range(1, 13)]
    gaps = []
    for (_, a), (_, b), ref in zip(jp, tp, src_frames):
        assert abs(len(a) - len(b)) <= max(8, BYTES_REL * len(a))
        ja = JD.decode_jpeg(a)
        ta = TD.decode_jpeg(a, device="cpu")
        for x, y in zip(ja.planes, ta.planes):
            assert np.array_equal(np.asarray(x), y.numpy())
        tb = TD.decode_jpeg(b, device="cpu")
        pj = _psnr(np.concatenate([np.asarray(p).ravel() for p in ja.planes]),
                   np.concatenate([p.ravel() for p in ref]))
        pt = _psnr(np.concatenate([p.numpy().ravel() for p in tb.planes]),
                   np.concatenate([p.ravel() for p in ref]))
        gaps.append(pt - pj)
    print("decoded PSNR port - JAX per frame (dB):",
          " ".join(f"{g:+.4f}" for g in gaps))
    assert abs(np.mean(gaps)) <= PSNR_GAP_DB


def test_mjpeg_avi_to_mpeg4_and_thumbnails(tmp_path):
    """Path B and path C of the JPEG phase at a small size: the JAX
    package's MJPEG AVI through both packages' transcodes to MPEG-4
    (-vf scale, constant qscale), then fps/crop/scale thumbnails as
    image2 files and their stream copy into raw MJPEG."""
    src = tmp_path / "clip.264"
    make_clip(src)
    mj = tmp_path / "mjpeg.avi"
    JP.Transcoder(JP.TranscodeSpec(
        input_url=str(src), output_url=str(mj),
        video=JP.StreamMap(codec="mjpeg", pix_fmt="yuvj420p",
                           codec_opts={"quality_scale": 3.0}))).run()
    types = {}
    for name, P, kw in (("jax", JP, {}), ("port", TP, {"device": "cpu"})):
        out = tmp_path / f"{name}_back.avi"
        P.Transcoder(P.TranscodeSpec(
            input_url=str(mj), output_url=str(out),
            video=P.StreamMap(codec="mpeg4", filters="scale=64:48",
                              codec_opts={"quality_scale": 4.0}),
            **kw)).run()
        types[name] = [(p.pts, bytes(p.data)[bytes(p.data).index(
            b"\x00\x00\x01\xb6") + 4] >> 6)
            for p in JA.open_input(str(out)).packets()]
    assert types["jax"] == types["port"] and len(types["port"]) == 12
    # and back to MJPEG through the registry's host MPEG-4 decoder, its
    # frames uploaded to the chain's device
    again = tmp_path / "again.avi"
    TP.Transcoder(TP.TranscodeSpec(
        input_url=str(tmp_path / "port_back.avi"), output_url=str(again),
        device="cpu", video=TP.StreamMap(codec="mjpeg"))).run()
    frames = [TD.decode_jpeg(d, device="cpu") for _, d in _packets(str(again))]
    assert [(f.width, f.height) for f in frames] == [(64, 48)] * 12

    thumbs = str(tmp_path / "thumb_%03d.jpg")
    TP.Transcoder(TP.TranscodeSpec(
        input_url=str(src), output_url=thumbs, output_format="image2",
        device="cpu", video=TP.StreamMap(
            filters="fps=5,crop=72:48,scale=32:24",
            codec_opts={"quality_scale": 2.0}))).run()
    files = sorted(glob.glob(str(tmp_path / "thumb_*.jpg")))
    # 12 frames at 25 fps span 0.48 s: fps=5 keeps the frames at 0.0,
    # 0.2 and 0.4 s
    assert [os.path.basename(f) for f in files] == [
        "thumb_001.jpg", "thumb_002.jpg", "thumb_003.jpg"]
    for f in files:
        g = TD.decode_jpeg(open(f, "rb").read(), device="cpu")
        assert (g.width, g.height, g.format) == (32, 24, "yuvj420p")
    raw = tmp_path / "thumbs.mjpeg"
    TP.Transcoder(TP.TranscodeSpec(
        input_url=thumbs, output_url=str(raw), output_format="mjpeg",
        device="cpu", video=TP.StreamMap(codec="copy"))).run()
    assert [d for _, d in _packets(str(raw))] == \
        [open(f, "rb").read() for f in files]


def test_cli_parses_the_jpeg_commands():
    """-f before -i names the input's format, after it the output's;
    -q:v reaches the chain as the CLI-level quality_scale, which the
    chain maps per encoder (mjpeg: quality 100 - 3.1 q)."""
    from librempeg_tpu_torch.cli.ffmpeg import parse_args

    spec, overwrite = parse_args(
        ["-i", "in.264", "-vf", "fps=5,crop=1440:1080,scale=320:240",
         "-q:v", "2", "-f", "image2", "thumb_%03d.jpg"])
    assert (spec.input_format, spec.output_format, spec.video.codec,
            spec.video.codec_opts, overwrite) == (
        None, "image2", "", {"quality_scale": 2.0}, False)
    spec, overwrite = parse_args(
        ["-f", "image2", "-i", "thumb_%03d.jpg", "-c:v", "copy", "-f",
         "mjpeg", "-y", "thumbs.mjpeg"])
    assert (spec.input_format, spec.output_format, spec.video.codec,
            overwrite) == ("image2", "mjpeg", "copy", True)
    assert TP._translate_codec_opts(TE.JpegEncoder, {
        "quality_scale": 3.0, "trellis": 1}) == {"quality": 91, "trellis": 1}
    from librempeg_tpu_torch.codecs.mpeg4.encoder import Mpeg4Encoder

    assert TP._translate_codec_opts(Mpeg4Encoder, {"quality_scale": 4.0}) \
        == {"qscale": 4.0}
    from librempeg_tpu_torch.core.errors import Unsupported

    with pytest.raises(Unsupported):
        TP._translate_codec_opts(TE.JpegEncoder, {"gop_size": 12})


@pytest.mark.parametrize("q", [4.5, 0.25])
def test_fractional_qscale_is_refused_for_mpeg4(q):
    """MPEG-4's qscale is an integer: a -q:v with a fraction raises in
    place of being truncated; mjpeg's quality rule rounds it."""
    from librempeg_tpu_torch.cli.ffmpeg import parse_args
    from librempeg_tpu_torch.codecs.mpeg4.encoder import Mpeg4Encoder
    from librempeg_tpu_torch.core.errors import Unsupported

    spec, _ = parse_args(["-i", "in.264", "-c:v", "mpeg4", "-q:v", str(q),
                          "out.avi"])
    with pytest.raises(Unsupported, match="not an integer qscale"):
        TP._translate_codec_opts(Mpeg4Encoder, spec.video.codec_opts)
    assert TP._translate_codec_opts(TE.JpegEncoder, spec.video.codec_opts) \
        == {"quality": int(max(2, min(100, round(100 - q * 3.1))))}
