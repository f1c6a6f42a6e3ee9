"""The port's MPEG-1/2 video codec (copies of the JAX package's
codecs/mpeg12/) against the JAX package's, and its containers.

The same seeded numpy frames go through both packages' encoders: every
packet's bytes, pts, dts and flags must be equal (the DCT is float64 in
both, computed the same way in one process). Both decoders decode both
streams to the same frames, and the port's decode equals its encoder's
recon (every picture is a reference: I/P GOPs). Through the CLI and
Transcoder the raw .m2v and Matroska outputs equal the JAX package's
files byte for byte; in MPEG-TS the port writes stream type 0x02 where
the JAX package writes 0x06 (private data, a fault its own demuxer
cannot read back), so there the elementary stream is compared.
"""
import numpy as np
import pytest
import torch

from librempeg_tpu.codecs.mpeg12.decoder import Mpeg12Decoder as JDec
from librempeg_tpu.codecs.mpeg12.encoder import Mpeg1Encoder as J1
from librempeg_tpu.codecs.mpeg12.encoder import Mpeg2Encoder as J2
from librempeg_tpu.core.frame import VideoFrame as JFrame
from librempeg_tpu.core.packet import Packet as JPacket
from librempeg_tpu.formats import api as JA
from librempeg_tpu_torch.codecs.mpeg12.decoder import Mpeg12Decoder as TDec
from librempeg_tpu_torch.codecs.mpeg12.encoder import Mpeg1Encoder as T1
from librempeg_tpu_torch.codecs.mpeg12.encoder import Mpeg2Encoder as T2
from librempeg_tpu_torch.core.frame import VideoFrame as TFrame
from librempeg_tpu_torch.core.packet import Packet as TPacket
from librempeg_tpu_torch.formats import api as TA
from tests.test_torch_h264_encoder import frames

ENC = {"mpeg1": (J1, T1), "mpeg2": (J2, T2)}


def encode(enc_cls, frame_cls, planes, w, h, refs=None, tensors=False,
           **opts):
    enc = enc_cls(width=w, height=h, **opts)
    out = []
    for i, pl in enumerate(planes):
        if tensors:
            pl = tuple(torch.from_numpy(p) for p in pl)
        out += enc.encode(frame_cls(planes=pl, format="yuv420p", width=w,
                                    height=h, pts=i))
        if refs is not None:
            refs.append([p.copy() for p in enc._ref])
    out += enc.flush()
    return enc, [(bytes(p.data), p.pts, p.dts, int(p.flags)) for p in out]


def decode(dec, packet_cls, pk):
    out = [f for d, pts, dts, fl in pk
           for f in dec.decode(packet_cls(data=d, pts=pts, dts=dts,
                                          flags=fl))] + dec.flush()
    return [[np.asarray(p) for p in f.planes] for f in out]


@pytest.mark.parametrize("qscale", [2, 6, 31])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("codec", list(ENC))
def test_bytes_equal_jax(codec, g, qscale):
    w, h = 176, 144
    planes = frames(w, h, 6, seed=5)
    jc, tc = ENC[codec]
    j_enc, j_pk = encode(jc, JFrame, planes, w, h, qscale=qscale, g=g)
    t_enc, t_pk = encode(tc, TFrame, planes, w, h, qscale=qscale, g=g)
    assert len(t_pk) == 6 and t_pk == j_pk
    assert bytes(t_enc.codec_parameters().extradata) == \
        bytes(j_enc.codec_parameters().extradata)
    assert [fl & 1 for *_, fl in t_pk] == [int(i % g == 0)
                                           for i in range(6)]


@pytest.mark.parametrize("codec", list(ENC))
def test_decoders_equal_and_recon_equals_decode(codec):
    """Both decoders on both streams (a cropped size, 170x138: 176x144
    coded); the port's decode equals its encoder's recon, on the CPU
    as numpy and as tensors on the device it is given."""
    w, h = 170, 138
    planes = frames(w, h, 6, seed=9)
    jc, tc = ENC[codec]
    refs = []
    _, t_pk = encode(tc, TFrame, planes, w, h, refs=refs, qscale=5, g=4)
    _, j_pk = encode(jc, JFrame, planes, w, h, qscale=5, g=4)
    assert t_pk == j_pk
    a = decode(JDec(), JPacket, j_pk)
    b = decode(TDec(device=None), TPacket, t_pk)     # numpy planes
    c = decode(TDec(device="cpu"), TPacket, t_pk)
    assert len(a) == len(b) == len(c) == 6
    for fa, fb, fc, ref in zip(a, b, c, refs):
        assert fb[0].shape == (h, w)
        for x, y, z, r in zip(fa, fb, fc, ref):
            assert np.array_equal(x, y) and np.array_equal(y, z)
            assert np.array_equal(y, r[:y.shape[0], :y.shape[1]])
    f = TDec(device="cpu").decode(TPacket(data=t_pk[0][0], pts=0))
    assert f == [] or isinstance(f[0].planes[0], torch.Tensor)


def test_tensor_planes_equal_numpy_planes():
    planes = frames(176, 144, 4, seed=3)
    _, a = encode(T2, TFrame, planes, 176, 144, qscale=4, g=3)
    _, b = encode(T2, TFrame, planes, 176, 144, tensors=True, qscale=4, g=3)
    assert a == b


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    from tests.test_torch_slice import make_clip

    path = tmp_path_factory.mktemp("m12") / "clip.264"
    make_clip(str(path))
    return str(path)


def _cli(pkg, argv):
    if pkg == "jax":
        from librempeg_tpu.cli.ffmpeg import main
        return main(["-v", "error"] + argv)
    from librempeg_tpu_torch.cli.ffmpeg import main
    return main(argv + ["-device", "cpu"])


@pytest.mark.parametrize("codec,ext", [("mpeg2video", "m2v"),
                                       ("mpeg1video", "m1v"),
                                       ("mpeg2video", "mkv")])
def test_transcoder_files_equal_jax(clip, tmp_path, codec, ext):
    """The H.264 clip to MPEG-1/2 through both CLIs: the same file."""
    out = {}
    for pkg in ("jax", "torch"):
        path = tmp_path / f"{pkg}.{ext}"
        assert _cli(pkg, ["-i", clip, "-c:v", codec, "-q:v", "5", "-y",
                          str(path)]) == 0
        out[pkg] = path.read_bytes()
    assert out["jax"] == out["torch"]
    d = TA.open_input(str(tmp_path / f"torch.{ext}"))
    assert d.streams[0].codecpar.codec_id in ("mpeg1video", "mpeg2video")
    pk = [(bytes(p.data), p.pts, p.dts, int(p.flags)) for p in d.packets()]
    assert len(pk) == 12
    assert len(decode(TDec(device="cpu"), TPacket, pk)) == 12


def _pmt_types(path):
    import chip_smoke

    return chip_smoke.ts_stream_types(str(path))


def test_mpegts_stream_type(clip, tmp_path):
    """MPEG-2 video in MPEG-TS: the port's PMT says 0x02 (ISO 13818-1
    Table 2-29) and its demuxer reads the stream back as mpeg2video,
    packet for packet the JAX package's encoder output; the JAX
    package's PMT says 0x06 (the fault ROADMAP section 3b names), which
    its own demuxer refuses as a file with no stream it knows."""
    for pkg in ("jax", "torch"):
        assert _cli(pkg, ["-i", clip, "-c:v", "mpeg2video", "-q:v", "5",
                          "-f", "mpegts", "-y", str(tmp_path / pkg)]) == 0
    assert _pmt_types(tmp_path / "jax") == [0x06]
    assert _pmt_types(tmp_path / "torch") == [0x02]
    from librempeg_tpu.core.errors import InvalidData

    with pytest.raises(InvalidData, match="no recognized streams"):
        JA.open_input(str(tmp_path / "jax"))
    d = TA.open_input(str(tmp_path / "torch"))
    assert [s.codecpar.codec_id for s in d.streams] == ["mpeg2video"]
    tb = d.streams[0].time_base
    t_pk = [(bytes(p.data), p.pts * 25 * tb.num // tb.den)
            for p in d.packets()]
    # the JAX package's ES: its .m2v, split by its raw demuxer
    assert _cli("jax", ["-i", clip, "-c:v", "mpeg2video", "-q:v", "5", "-y",
                        str(tmp_path / "j.m2v")]) == 0
    j_pk = [(bytes(p.data), p.pts)
            for p in JA.open_input(str(tmp_path / "j.m2v")).packets()]
    assert b"".join(d for d, _ in t_pk) == b"".join(d for d, _ in j_pk)
    assert [p for _, p in t_pk] == list(range(12))
    frames_ = decode(TDec(device="cpu"), TPacket,
                     [(d, p, p, 0) for d, p in t_pk])
    assert len(frames_) == 12


def test_gop_option_reaches_the_encoder(clip, tmp_path):
    """-g 3 reaches Mpeg1Encoder's g in the port (an I picture every 3);
    the JAX pipeline drops gop_size, so its stream keeps a GOP of 12."""
    keys = {}
    for pkg, api in (("jax", JA), ("torch", TA)):
        path = tmp_path / f"{pkg}.m2v"
        assert _cli(pkg, ["-i", clip, "-c:v", "mpeg2video", "-q:v", "5",
                          "-g", "3", "-y", str(path)]) == 0
        keys[pkg] = [int(p.flags & 1)
                     for p in api.open_input(str(path)).packets()]
    assert keys["torch"] == [int(i % 3 == 0) for i in range(12)]
    assert keys["jax"] == [1] + [0] * 11
