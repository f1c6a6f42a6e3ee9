"""The bitstream layer of the port -- core/hash.py, core/sidedata.py,
codecs/parsers.py, codecs/bsf.py and codecs/h264/entropy_transcode.py,
copies of the JAX package's -- against the JAX package on the same
seeded inputs: equal digests, equal side data, equal split points and
equal filtered packets (all host code: no tolerance).

The streams are the JAX package's encoders' output (test_parsers.py's
encode_stream); h264_mp4toannexb runs on the packets and avcC of an MP4
copy of a small H.264 clip, h264_cavlc2cabac on an H.264 stream with a
B frame, whose CABAC form the port's decoder must decode to the CAVLC
form's frames.
"""
import dataclasses

import numpy as np
import pytest

from librempeg_tpu.codecs import bsf as JB
from librempeg_tpu.codecs import parsers as JPA
from librempeg_tpu.codecs.api import find_encoder as j_find_encoder
from librempeg_tpu.core import hash as JH
from librempeg_tpu.core import packet as JPK
from librempeg_tpu.core import sidedata as JS
from librempeg_tpu.formats import api as JA
from librempeg_tpu.utils import testgen
from librempeg_tpu_torch.codecs import bsf as TB
from librempeg_tpu_torch.codecs import parsers as TPA
from librempeg_tpu_torch.core import hash as TH
from librempeg_tpu_torch.core import packet as TPK
from librempeg_tpu_torch.core import sidedata as TS
from librempeg_tpu_torch.core.rational import Rational as TR
from librempeg_tpu_torch.formats import api as TA

PKG = {"jax": (JH, JS, JPA, JB, JPK, JA), "torch": (TH, TS, TPA, TB, TPK,
                                                   TA)}
RNG = np.random.default_rng(1234)
BLOBS = [b"", bytes([0x5A]), RNG.integers(0, 256, 4097, np.uint8).tobytes()]


@pytest.mark.parametrize("fn", ["adler32", "crc32", "crc32_mpeg2",
                                "crc8_flac", "crc16_flac"])
@pytest.mark.parametrize("blob", range(len(BLOBS)))
def test_hash_functions_equal(fn, blob):
    data = BLOBS[blob]
    assert getattr(TH, fn)(data) == getattr(JH, fn)(data)


@pytest.mark.parametrize("name", JH.Hasher.NAMES)
def test_hasher_equal(name):
    """Create by name, two updates, hexdigest."""
    assert TH.Hasher.NAMES == JH.Hasher.NAMES
    a, b = BLOBS[2][:1000], BLOBS[2][1000:]
    assert TH.Hasher(name).update(a).update(b).hexdigest() == \
        JH.Hasher(name).update(a).update(b).hexdigest()


def test_hasher_refuses_unknown_names():
    for mod in (JH, TH):
        with pytest.raises(ValueError):
            mod.Hasher("crc64")


SIDE = {
    "DisplayMatrix": {"rotation_degrees": 90.0, "hflip": True},
    "ReplayGain": {"track_gain_db": -6.5, "track_peak": 0.9,
                   "album_gain_db": -7.0, "album_peak": 0.95},
    "AudioServiceType": {"service": "effects"},
    "SkipSamples": {"start": 2112, "end": 576},
    "ContentLightLevel": {"max_cll": 1000, "max_fall": 400},
    "MasteringDisplayMetadata": {
        "primaries": ((0.708, 0.292), (0.17, 0.797), (0.131, 0.046)),
        "white_point": (0.3127, 0.329), "min_luminance": 0.005,
        "max_luminance": 1000.0},
    "CropRect": {"top": 4, "bottom": 8, "left": 2, "right": 6},
    "Timecode": {"hours": 1, "minutes": 2, "seconds": 3, "frames": 4,
                 "drop": True},
}


@pytest.mark.parametrize("name", list(SIDE))
def test_side_data_roundtrip(name):
    """Each typed side datum set on a packet reads back as itself, with
    the JAX package's key and fields; the wrong type raises."""
    assert set(TS.side_data_types()) == set(JS.side_data_types())
    got = {}
    for pkg, (_, S, _, _, PK, _) in PKG.items():
        cls = getattr(S, name)
        value = cls(**SIDE[name])
        pkt = PK.Packet(data=b"x")
        S.set_side_data(pkt, value)
        assert S.get_side_data(pkt, cls) is value
        assert pkt.side_data[cls.KEY] is value
        other = S.CropRect if cls is not S.CropRect else S.SkipSamples
        assert S.get_side_data(pkt, other) is None
        pkt.side_data[other.KEY] = value
        with pytest.raises(TypeError):
            S.get_side_data(pkt, other)
        with pytest.raises(TypeError):
            S.set_side_data(pkt, object())
        got[pkg] = (cls.KEY, dataclasses.astuple(value), str(value))
    assert got["jax"] == got["torch"]


def encode_stream(codec, n=4, **opts):
    """test_parsers.encode_stream: the JAX package's encoder at 64x48."""
    enc = j_find_encoder(codec)(width=64, height=48, **opts)
    out = []
    for i in range(n):
        out += enc.encode(testgen.video_frame_yuv420(64, 48, i))
    out += enc.flush()
    return [bytes(p.data) for p in out]


def run_parser(parsers, name, data, chunk):
    p = parsers.find_parser(name)
    frames = []
    for i in range(0, len(data), chunk):
        frames += p.parse(data[i:i + chunk])
    frames += p.flush()
    return frames


def test_parser_registry():
    assert set(TPA.parsers()) == set(JPA.parsers()) >= {
        "h264", "mpeg4video", "mjpeg", "flac"}


@pytest.mark.parametrize("name,codec,opts,chunk", [
    ("h264", "h264", {"qp": 30}, 7),
    ("h264", "h264", {"qp": 30}, 256),
    ("h264", "h264", {"qp": 26, "bf": 1}, 1 << 20),
    ("h264", "h264", {"qp": 26}, 13),
    ("mpeg4video", "mpeg4", {"qscale": 4}, 11),
    ("mpeg4video", "mpeg4", {"qscale": 4}, 1 << 20),
    ("mjpeg", "mjpeg", {}, 100),
])
def test_parsers_split_equal(name, codec, opts, chunk):
    """Both packages frame the same byte stream at the same points, and
    the frames are the encoder's packets."""
    pkts = encode_stream(codec, **opts)
    blob = b"".join(pkts)
    got = run_parser(TPA, name, blob, chunk)
    assert got == run_parser(JPA, name, blob, chunk)
    assert got == pkts
    assert got == run_parser(TPA, name, blob, 1 << 20)


@pytest.mark.parametrize("chunk", [3, 64, 1 << 20])
def test_flac_parser_split_equal(chunk):
    """Sync codes planted in random bytes (the parser only scans for
    the 14-bit sync; CRCs are the decoder's)."""
    data = bytearray(RNG.integers(0, 0xF0, 3000, np.uint8).tobytes())
    for off in (0, 411, 1200, 2999 - 2):
        data[off:off + 2] = b"\xff\xf8"
    data = bytes(data)
    got = run_parser(TPA, "flac", data, chunk)
    assert got == run_parser(JPA, "flac", data, chunk)
    assert b"".join(got) == data and len(got) == 4


def test_bsf_registry():
    assert set(TB.bsfs()) == set(JB.bsfs()) >= {
        "null", "chomp", "noise", "setts", "dump_extra",
        "h264_mp4toannexb", "extract_extradata", "h264_cavlc2cabac"}


def _filtered(pkg, name, packets, params=None, **opts):
    """`packets` ((data, pts, dts, flags)) through bsf `name` of pkg."""
    _, _, _, B, PK, _ = PKG[pkg]
    f = B.find_bsf(name)(params, **opts) if params is not None else \
        B.find_bsf(name)(**opts)
    out = []
    for d, pts, dts, flags in packets:
        out += f.filter(PK.Packet(data=d, pts=pts, dts=dts, flags=flags))
    out += f.flush()
    return [(bytes(p.data), p.pts, p.dts, int(p.flags)) for p in out], f


@pytest.mark.parametrize("name,opts", [
    ("null", {}),
    ("chomp", {}),
    ("noise", {"amount": 8, "seed": 42}),
    ("noise", {"drop": 100}),
    ("setts", {"offset": 10, "scale_num": 2}),
])
def test_simple_bsfs_equal(name, opts):
    """test_bsf.py's cases, in both packages."""
    packets = [(bytes(range(64)) + b"\x00\x00", 5, 5, 1),
               (b"abc\x00", 6, 6, 0), (b"x" * 100, 7, 6, 0)]
    j, _ = _filtered("jax", name, packets, **opts)
    t, _ = _filtered("torch", name, packets, **opts)
    assert t == j
    if name == "chomp":
        assert t[1][0] == b"abc"
    if name == "noise" and "seed" in opts:
        assert t[0][0] != packets[0][0] and t[0][3] & JPK.PktFlags.CORRUPT
    if name == "noise" and "drop" in opts:
        assert t == []
    if name == "setts":
        assert t[0][1] == 20


def test_dump_extra_equal():
    out = {}
    for pkg in PKG:
        par = PKG[pkg][5].CodecParameters(extradata=b"HDR")
        out[pkg], _ = _filtered(pkg, "dump_extra", [
            (b"payload", 0, 0, 1), (b"more", 1, 1, 0),
            (b"HDRkey", 2, 2, 1)], par)
    assert out["jax"] == out["torch"]
    assert out["torch"][0][0] == b"HDRpayload"


@pytest.fixture(scope="module")
def h264_mp4(tmp_path_factory):
    """make_clip's clip (JAX H264Encoder) stream-copied into MP4 by the
    port: its samples (length-prefixed) and avcC, and the annex-B
    source."""
    from librempeg_tpu_torch.cli.ffmpeg import main
    from tests.test_torch_slice import make_clip

    td = tmp_path_factory.mktemp("mp4")
    src, mp4 = td / "clip.264", td / "clip.mp4"
    make_clip(str(src), n=8)
    assert main(["-i", str(src), "-c:v", "copy", "-device", "cpu", "-y",
                 str(mp4)]) == 0
    from librempeg_tpu_torch.codecs.h264.avcc import annexb_to_lp, build_avcc

    # the demuxer hands out annex B; the samples as the MP4 stores them
    # are its length-prefixed form, the parameter sets in the avcC
    d = TA.open_input(str(mp4))
    extra = build_avcc(bytes(d.streams[0].codecpar.extradata))
    pk = [(annexb_to_lp(bytes(p.data)), p.pts, p.dts, int(p.flags))
          for p in d.packets()]
    return extra, pk, src.read_bytes()


def test_h264_mp4toannexb_equal(h264_mp4):
    """The MP4's length-prefixed packets back to annex B: equal in both
    packages, and the parameter sets ahead of the first keyframe."""
    extra, pk, annexb = h264_mp4
    assert extra[:1] == b"\x01"                   # avcC
    out = {}
    for pkg in PKG:
        par = PKG[pkg][5].CodecParameters(codec_type="video",
                                          codec_id="h264", extradata=extra)
        out[pkg], _ = _filtered(pkg, "h264_mp4toannexb", pk, par)
    assert out["jax"] == out["torch"]
    from librempeg_tpu_torch.codecs.h264.parse import split_annexb

    assert [n for d, *_ in out["torch"] for n in split_annexb(d)] == \
        split_annexb(annexb)


def test_extract_extradata_equal(h264_mp4):
    _, _, annexb = h264_mp4
    from librempeg_tpu_torch.codecs.parsers import find_parser

    aus = find_parser("h264").parse(annexb) + find_parser("h264").flush()
    packets = [(a, i, i, 1 if i == 0 else 0) for i, a in enumerate(aus)]
    out = {}
    for pkg in PKG:
        out[pkg], f = _filtered(pkg, "extract_extradata", packets,
                                remove=1)
        out[pkg] = (out[pkg], f.extradata)
    assert out["jax"] == out["torch"]
    assert out["torch"][1].startswith(b"\x00\x00\x00\x01\x67")


def test_h264_cavlc2cabac_equal_and_decodes():
    """A CAVLC stream with a B frame (I0 P2 B1 P3 ...) recoded to CABAC:
    the same bytes in both packages; the port's decoder gives the CAVLC
    stream's frames from it."""
    from librempeg_tpu.codecs.h264.codec import H264Encoder
    from librempeg_tpu_torch.codecs.h264.codec import H264Decoder

    enc = H264Encoder(width=64, height=48, qp=26, bf=1, g=6)
    pk = []
    for i in range(6):
        pk += enc.encode(testgen.video_frame_yuv420(64, 48, i))
    pk += enc.flush()
    extra = bytes(enc.codec_parameters().extradata)
    packets = [(bytes(p.data), p.pts, p.dts, int(p.flags)) for p in pk]
    out, extras = {}, {}
    for pkg in PKG:
        par = PKG[pkg][5].CodecParameters(codec_type="video",
                                          codec_id="h264", extradata=extra)
        out[pkg], _ = _filtered(pkg, "h264_cavlc2cabac", packets, par)
        extras[pkg] = bytes(par.extradata)
    assert out["jax"] == out["torch"] and extras["jax"] == extras["torch"]
    assert extras["torch"] != extra

    def decode(extradata, packets):
        dec = H264Decoder(TA.CodecParameters(extradata=extradata),
                          device="cpu")
        fr = [f for d, pts, dts, fl in packets
              for f in dec.decode(TPK.Packet(data=d, pts=pts, dts=dts,
                                             flags=fl,
                                             time_base=TR(1, 25)))]
        fr += dec.flush()
        dec.close()
        return [[np.asarray(p) for p in f.planes] for f in fr]

    a, b = decode(extra, packets), decode(extras["torch"], out["torch"])
    assert len(a) == len(b) == 6
    assert all(np.array_equal(x, y) for fa, fb in zip(a, b)
               for x, y in zip(fa, fb))
