"""The port's containers against the JAX package's.

MP4/MOV, Matroska, MPEG-TS, Y4M, raw video, raw s16le audio, the hash
muxers (framecrc, framemd5, md5, crc, null) and MP3: the same packets
through the JAX muxer and the port's give identical bytes, and the two
demuxers give identical packets (data, pts, dts, duration, flags) and
stream parameters (extradata included) on those files. The one
difference is the port's repair of the MPEG-TS demuxer, which fills an
H.264 stream's extradata and size from its first packet (the JAX
package's leaves them empty). read_seek on MP4 and Matroska
lands on the same packet in both packages. Then the non-reference cases
of the JAX package's test_mov, test_matroska, test_mpegts and
test_formats (round trips, Y4M, raw video, framecrc's format, -metadata)
in the port. The streams are made from seeds: H.264 by the JAX package's
encoder (test_torch_slice.make_clip), MPEG-4 and AAC by its encoders,
PCM and MP3 frames by numpy.
"""
import functools

import numpy as np
import pytest

from librempeg_tpu.codecs.api import find_encoder as j_find_encoder
from librempeg_tpu.core import packet as JPK
from librempeg_tpu.core.rational import Rational as JR
from librempeg_tpu.formats import api as JA
from librempeg_tpu.utils import testgen
from librempeg_tpu_torch.core import packet as TPK
from librempeg_tpu_torch.core.rational import Rational as TR
from librempeg_tpu_torch.formats import api as TA

from tests.test_torch_slice import make_clip
from tools.audio_jax_repair import framemd5_repaired

PKG = {"jax": (JA, JPK, JR), "torch": (TA, TPK, TR)}
W, H = 64, 48


def _par(pkg, d: dict):
    api, _, R = PKG[pkg]
    d = dict(d)
    for k in ("framerate", "sample_aspect_ratio"):
        if k in d:
            d[k] = R(*d[k])
    return api.CodecParameters(**d)


def _mux(pkg, fmt: str, streams, pkts, metadata=None) -> bytes:
    """Mux neutral (par dict, time base) streams and (stream, data, pts,
    dts, duration, flags) packets with package `pkg`'s muxer."""
    api, P, R = PKG[pkg]
    mux = api.open_output_bytes(fmt)
    mux.metadata.update(metadata or {})
    for par, tb in streams:
        mux.add_stream(_par(pkg, par), R(*tb))
    for si, data, pts, dts, dur, flags in pkts:
        mux.write(P.Packet(data=data, pts=pts, dts=dts, duration=dur,
                           flags=flags, stream_index=si,
                           time_base=R(*streams[si][1])))
    mux.finish()
    return mux.io.getvalue()


def _par_dict(par) -> dict:
    """The fields both packages' CodecParameters have: the port's
    ch_layout (AVCodecParameters.ch_layout), which the JAX package does
    not have, is held in tests/test_torch_channel_layouts.py."""
    return {k: (bytes(v) if isinstance(v, (bytes, bytearray)) else
                (v.num, v.den) if hasattr(v, "den") else v)
            for k, v in vars(par).items() if k != "ch_layout"}


def _demux(pkg, blob: bytes, fmt=None, **opts):
    """(format name, stream summaries, packets, metadata) of a blob."""
    api = PKG[pkg][0]
    d = api.open_input_bytes(blob, fmt, **opts)
    streams = [(s.index, _par_dict(s.codecpar), (s.time_base.num,
                                                 s.time_base.den),
                s.start_time, s.duration) for s in d.streams]
    pkts = [(p.stream_index, bytes(p.data), p.pts, p.dts, p.duration,
             int(p.flags), (p.time_base.num, p.time_base.den))
            for p in d.packets()]
    return d.NAME, streams, pkts, dict(d.metadata)


# ---------------------------------------------------------------------------
# streams, made once
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _h264():
    """8 frames of H.264 (IDR at 0 and 6): the stream, its packets."""
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        path = f"{td}/clip.264"
        make_clip(path, w=W, h=H, n=8)
        d = TA.open_input(path)
        par = _par_dict(d.streams[0].codecpar)
        pkts = []
        for p in d.packets():
            data = bytes(p.data)
            key = b"\x00\x00\x00\x01\x65" in data or b"\x00\x00\x01\x65" \
                in data
            pkts.append((data, p.pts, int(key)))
    return par, pkts


@functools.lru_cache(maxsize=None)
def _mpeg4():
    enc = j_find_encoder("mpeg4")(width=W, height=H, qscale=3,
                                  framerate=JR(25, 1))
    out = []
    for i in range(6):
        out += enc.encode(testgen.video_frame_yuv420(W, H, i))
    out += enc.flush()
    par = _par_dict(enc.codec_parameters())
    return par, [(bytes(p.data), p.pts, int(p.flags)) for p in out]


@functools.lru_cache(maxsize=None)
def _aac():
    from librempeg_tpu.core.frame import AudioFrame

    enc = j_find_encoder("aac")(sample_rate=44100, channels=2)
    pcm = testgen.audio_mix(44100, 44100 // 4)
    out = list(enc.packets([AudioFrame(data=pcm, sample_rate=44100,
                                       sample_fmt="fltp", pts=0)]))
    par = _par_dict(enc.codec_parameters())
    return par, [(bytes(p.data), p.pts, p.duration) for p in out]


def _pcm(n_chunks=5, chunk=1920):
    pcm = testgen.s16(testgen.audio_mix(48000, chunk * n_chunks, 2)).T
    return [np.ascontiguousarray(pcm[i:i + chunk]).tobytes()
            for i in range(0, len(pcm), chunk)]


def _mp3_frames(n=6):
    """MPEG-1 layer III frames, 128 kb/s, 44.1 kHz, stereo: valid
    headers, seeded payload (the containers parse only the headers)."""
    rng = np.random.default_rng(5)
    size = 144 * 128000 // 44100
    return [b"\xff\xfb\x90\x64" + rng.integers(0, 256, size - 4,
                                                 dtype=np.uint8).tobytes()
            for _ in range(n)]


def _video(kind: str):
    """(par, time base, [(data, pts, dts, duration, flags)])."""
    if kind == "h264":
        par, pk = _h264()
        return par, (1, 25), [(d, p, p, 1, f) for d, p, f in pk]
    if kind == "mpeg4":
        par, pk = _mpeg4()
        return par, (1, 25), [(d, p, p, 1, f) for d, p, f in pk]
    frames = [b"".join(p.tobytes() for p in testgen.video_yuv420(W, H, i))
              for i in range(4)]
    par = dict(codec_type="video", codec_id="rawvideo", width=W, height=H,
               pix_fmt="yuv420p", framerate=(25, 1))
    return par, (1, 25), [(f, i, i, 1, 1) for i, f in enumerate(frames)]


def _audio(kind: str):
    if kind == "aac":
        par, pk = _aac()
        return par, (1, 44100), [(d, p, p, n, 1) for d, p, n in pk]
    if kind == "mp3":
        par = dict(codec_type="audio", codec_id="mp3", sample_rate=44100,
                   nb_channels=2)
        return par, (1, 44100), [(f, i * 1152, i * 1152, 1152, 1)
                                 for i, f in enumerate(_mp3_frames())]
    par = dict(codec_type="audio", codec_id="pcm_s16le", sample_rate=48000,
               nb_channels=2, sample_fmt="s16")
    return par, (1, 48000), [(c, i * 1920, i * 1920, 1920, 1)
                             for i, c in enumerate(_pcm())]


def _program(kinds):
    """Streams and packets for the stream kinds, interleaved by time."""
    streams, pkts = [], []
    for si, kind in enumerate(kinds):
        par, tb, pk = (_video(kind) if kind in ("h264", "mpeg4", "rawvideo")
                       else _audio(kind))
        streams.append((par, tb))
        pkts += [(si, *p) for p in pk]
    pkts.sort(key=lambda p: (p[3] * streams[p[0]][1][0]
                             / streams[p[0]][1][1], p[0]))
    return streams, pkts


CASES = {
    "mp4_h264_aac": ("mp4", ("h264", "aac")),
    "mp4_mpeg4_aac": ("mp4", ("mpeg4", "aac")),
    "mkv_h264_pcm": ("matroska", ("h264", "pcm")),
    "mkv_mpeg4_aac": ("matroska", ("mpeg4", "aac")),
    "ts_h264_aac": ("mpegts", ("h264", "aac")),
    "ts_mpeg4_mp3": ("mpegts", ("mpeg4", "mp3")),
    "y4m": ("yuv4mpegpipe", ("rawvideo",)),
    "rawvideo": ("rawvideo", ("rawvideo",)),
    "s16le": ("s16le", ("pcm",)),
    "mp3": ("mp3", ("mp3",)),
    "framecrc": ("framecrc", ("h264", "aac")),
    "framemd5": ("framemd5", ("h264", "aac")),
    "md5": ("md5", ("h264", "aac")),
    "crc": ("crc", ("h264", "aac")),
    "null": ("null", ("h264", "aac")),
}
# formats with a demuxer, and the options a headerless one needs
DEMUX = {"mp4": {}, "matroska": {}, "mpegts": {}, "yuv4mpegpipe": {},
         "rawvideo": {"width": W, "height": H, "pix_fmt": "yuv420p"},
         "s16le": {"sample_rate": 48000, "channels": 2}, "mp3": {}}


@functools.lru_cache(maxsize=None)
def _muxed(case: str) -> tuple[bytes, bytes]:
    fmt, kinds = CASES[case]
    streams, pkts = _program(kinds)
    meta = {"title": "Clip"} if fmt in ("mp4", "matroska", "mp3") else {}
    return (_mux("jax", fmt, streams, pkts, meta),
            _mux("torch", fmt, streams, pkts, meta))


@pytest.mark.parametrize("case", sorted(CASES))
def test_muxers_write_identical_bytes(case):
    j, t = _muxed(case)
    if case in ("framecrc", "framemd5"):
        # the AAC stream's parameters give two channels and no layout:
        # the port describes that as libavformat does ("2 channels",
        # tests/test_torch_channel_layouts.py), the JAX package writes
        # "stereo" for every layout (ROADMAP.md section 3b)
        line = b"#channel_layout_name 1: %s\n"
        assert line % b"2 channels" in t and line % b"stereo" in j
        t = t.replace(line % b"2 channels", line % b"stereo")
    if case == "framemd5":
        # and libavformat's last header line, which the JAX package
        # leaves out (ROADMAP.md section 3b)
        j = framemd5_repaired(j)
    assert j == t and (len(j) > 0) == (case != "null")


def _ts_repaired(case, streams_j, streams_t):
    """The port's MPEG-TS demuxer fills what the JAX package's leaves
    empty for an H.264 stream; put the JAX values back after checking
    the port's against the ES demuxer's."""
    if not case.startswith("ts_h264"):
        return streams_t
    es = _h264()[0]
    out = []
    for idx, par, tb, st, du in streams_t:
        if par["codec_id"] == "h264":
            jpar = next(p for i, p, *_ in streams_j if i == idx)
            assert (jpar["extradata"], jpar["width"], jpar["height"]) \
                == (b"", 0, 0)
            assert (par["extradata"], par["width"], par["height"],
                    par["pix_fmt"]) == (es["extradata"], W, H, "yuv420p")
            par = {**par, **{k: jpar[k] for k in
                             ("extradata", "width", "height")}}
        out.append((idx, par, tb, st, du))
    return out


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if CASES[c][0] in DEMUX))
def test_demuxers_give_identical_packets(case):
    fmt = CASES[case][0]
    opts = DEMUX[fmt]
    blob_j, blob_t = _muxed(case)
    fj = fmt if opts else None
    name_j, st_j, pk_j, meta_j = _demux("jax", blob_j, fj, **opts)
    name_t, st_t, pk_t, meta_t = _demux("torch", blob_j, fj, **opts)
    assert name_j == name_t
    assert pk_j == pk_t and len(pk_t) > 0
    assert meta_j == meta_t
    assert _ts_repaired(case, st_j, st_t) == st_j
    # the port's own file reads back the same
    assert _demux("torch", blob_t, fj, **opts)[2] == pk_t


@pytest.mark.parametrize("case", ["mp4_h264_aac", "mkv_h264_pcm"])
@pytest.mark.parametrize("t", [0.0, 0.13, 0.2, 0.29])
def test_read_seek_lands_on_the_same_packet(case, t):
    blob = _muxed(case)[0]
    got = []
    for pkg in ("jax", "torch"):
        d = PKG[pkg][0].open_input_bytes(blob)
        st = next(s for s in d.streams if s.codecpar.codec_type == "video")
        d.read_seek(st.index, int(t * st.time_base.den / st.time_base.num))
        got.append([(p.stream_index, p.pts, bytes(p.data))
                    for p in list(d.packets())[:4]])
    assert got[0] == got[1] and got[0]


def test_mp3_carries_its_id3v2_title():
    blob = _muxed("mp3")[1]
    assert blob.startswith(b"ID3")
    assert _demux("torch", blob)[3] == {"title": "Clip"}


# ---------------------------------------------------------------------------
# the JAX package's own cases, in the port
# ---------------------------------------------------------------------------


def test_mp4_mux_demux_roundtrip():
    """test_mov.TestMp4.test_mux_demux_roundtrip."""
    name, streams, pkts, _ = _demux("torch", _muxed("mp4_mpeg4_aac")[1])
    assert name == "mov"
    assert sorted(s[1]["codec_type"] for s in streams) == ["audio", "video"]
    vi = next(s[0] for s in streams if s[1]["codec_type"] == "video")
    assert len([p for p in pkts if p[0] == vi]) == 6


def test_matroska_own_roundtrip():
    """test_matroska.TestMatroskaMux.test_own_roundtrip."""
    streams, pkts = _program(("mpeg4", "pcm"))
    blob = _mux("torch", "matroska", streams, pkts)
    name, st, got, _ = _demux("torch", blob)
    assert name == "matroska"
    assert sorted(s[1]["codec_id"] for s in st) == ["mpeg4", "pcm_s16le"]
    v = [p for p in got if p[0] == 0]
    assert [p[1] for p in v] == [d for d, *_ in _video("mpeg4")[2]]
    assert b"".join(p[1] for p in got if p[0] == 1) == b"".join(_pcm())
    assert [p[2] for p in v] == [i * 40 for i in range(len(v))]


def test_mpegts_packets_are_188_and_roundtrip():
    """test_mpegts.TestMpegTs: 188-byte packets, the MPEG-4 stream back,
    and the first VOP decoded by the port's MPEG-4 decoder."""
    from librempeg_tpu_torch.codecs.mpeg4._decoder import (
        Mpeg4BitstreamDecoder,
    )

    streams, pkts = _program(("mpeg4",))
    blob = _mux("torch", "mpegts", streams, pkts)
    assert len(blob) % 188 == 0
    assert all(blob[i] == 0x47 for i in range(0, len(blob), 188))
    name, st, got, _ = _demux("torch", blob)
    assert name == "mpegts" and st[0][1]["codec_id"] == "mpeg4"
    assert len(got) == 6
    out = Mpeg4BitstreamDecoder().decode_frame(got[0][1])
    y0, _, _ = testgen.video_yuv420(W, H, 0)
    mse = np.mean((out[0][:H, :W].astype(float) - y0.astype(float)) ** 2)
    assert 10 * np.log10(255 * 255 / max(mse, 1e-9)) > 30


def test_y4m_roundtrip():
    """test_formats.TestY4m.test_roundtrip."""
    frames = [b"".join(p.tobytes() for p in testgen.video_yuv420(32, 16, i))
              for i in range(3)]
    par = dict(codec_type="video", codec_id="rawvideo", width=32, height=16,
               pix_fmt="yuv420p", framerate=(25, 1))
    blob = _mux("torch", "yuv4mpegpipe", [(par, (1, 25))],
                [(0, f, i, i, 1, 0) for i, f in enumerate(frames)])
    name, st, got, _ = _demux("torch", blob)
    assert name == "yuv4mpegpipe"
    assert (st[0][1]["width"], st[0][1]["height"]) == (32, 16)
    assert [p[1] for p in got] == frames


def test_rawvideo_demux(tmp_path):
    """test_formats.TestRawVideo.test_rawvideo_demux."""
    frames = [b"".join(p.tobytes() for p in testgen.video_yuv420(16, 16, i))
              for i in range(4)]
    f = tmp_path / "in.yuv"
    f.write_bytes(b"".join(frames))
    d = TA.open_input(str(f), format="rawvideo", width=16, height=16,
                      pix_fmt="yuv420p")
    pkts = list(d.packets())
    assert len(pkts) == 4 and [p.pts for p in pkts] == [0, 1, 2, 3]


def test_framecrc_lines():
    """test_formats.TestFrameCrc's muxer side: the framecrc line of one
    raw frame (Adler-32 from 0, framecrcenc.c's field widths)."""
    import zlib

    y, u, v = testgen.video_yuv420(32, 16, 3)
    data = y.tobytes() + u.tobytes() + v.tobytes()
    par = dict(codec_type="video", codec_id="rawvideo", width=32, height=16,
               pix_fmt="yuv420p")
    out = {}
    for pkg in PKG:
        out[pkg] = _mux(pkg, "framecrc", [(par, (1, 25))],
                        [(0, data, 0, 0, 1, 1)]).decode()
    assert out["jax"] == out["torch"]
    body = [ln for ln in out["torch"].splitlines() if not ln.startswith("#")]
    assert body == [f"0,          0,          0,        1,      768, "
                    f"0x{zlib.adler32(data, 0):08x}"]


def _cli(pkg, argv):
    if pkg == "jax":
        from librempeg_tpu.cli.ffmpeg import main
        return main(["-v", "error"] + argv)
    from librempeg_tpu_torch.cli.ffmpeg import main
    return main(argv + ["-device", "cpu"])


@pytest.mark.parametrize("pkg", list(PKG))
def test_metadata_roundtrips(pkg, tmp_path):
    """test_formats.TestMetadata: -metadata into WAV LIST/INFO, a
    Matroska Title and MP4 ilst, read back by both demuxers."""
    wav, mkv, mp4 = (tmp_path / n for n in ("m.wav", "m.mkv", "m.mp4"))
    assert _cli(pkg, ["-f", "lavfi", "-i", "sine=frequency=440:duration=0.1",
                      "-metadata", "title=Hello World", "-metadata",
                      "artist=TPU", "-y", str(wav)]) == 0
    for ext, out, tags in (("mkv", mkv, ["title=MkvTitle"]),
                           ("mp4", mp4, ["title=Mp4Title", "artist=TPU"])):
        argv = ["-f", "lavfi", "-i", "testsrc2=size=64x48:duration=0.2",
                "-c:v", "mpeg4", "-q:v", "4"]
        for t in tags:
            argv += ["-metadata", t]
        assert _cli(pkg, argv + ["-y", str(out)]) == 0
    for api in (JA, TA):
        d = api.open_input(str(wav))
        assert d.metadata == {"title": "Hello World", "artist": "TPU"}
        assert sum(len(p.data) for p in d.packets()) == int(0.1 * 44100) * 2
        assert api.open_input(str(mkv)).metadata["title"] == "MkvTitle"
        assert api.open_input(str(mp4)).metadata == {"title": "Mp4Title",
                                                     "artist": "TPU"}


@pytest.mark.parametrize("argv", [
    ["-f", "rawvideo", "-s", "64x48", "-r", "30", "-pix_fmt", "yuv420p",
     "-i", "in.yuv", "-r", "10", "-ss", "1.5", "-t", "00:00:02.25",
     "-metadata", "title=a=b", "-f", "framemd5", "out"],
    ["-f", "s16le", "-ar", "8000", "-ch_layout", "mono", "-i", "in.raw",
     "-ac", "2", "-ar", "16000", "out.wav"],
    ["-framerate", "24000/1001", "-channels", "2", "-i", "in.y4m",
     "-s", "32x16", "-pix_fmt", "yuvj420p", "out.mkv"],
])
def test_cli_options_match_jax(argv):
    """The pre-input options, -ss, -t, -metadata and a post-input -r
    parse into the same spec fields in both packages."""
    from librempeg_tpu.cli.ffmpeg import parse_args as jparse
    from librempeg_tpu_torch.cli.ffmpeg import parse_args as tparse

    j, _ = jparse(argv)
    t, _ = tparse(argv)

    def fields(s):
        return ({k: str(v) for k, v in s.input_opts.items()}, s.input_format,
                s.output_format, s.seek, s.duration, s.metadata,
                s.video.filters, s.video.width, s.video.height,
                s.video.pix_fmt, s.audio.sample_rate, s.audio.channels)

    assert fields(j) == fields(t)


def test_rawvideo_input_through_the_cli(tmp_path):
    """-f rawvideo -s -r -pix_fmt before -i reach the demuxer: the same
    framemd5 in both packages."""
    raw = tmp_path / "in.yuv"
    raw.write_bytes(b"".join(
        b"".join(p.tobytes() for p in testgen.video_yuv420(32, 16, i))
        for i in range(3)))
    argv = ["-f", "rawvideo", "-s", "32x16", "-r", "30", "-pix_fmt",
            "yuv420p", "-i", str(raw), "-f", "framemd5"]
    assert _cli("jax", argv + ["-y", str(tmp_path / "j.md5")]) == 0
    assert _cli("torch", argv + ["-y", str(tmp_path / "t.md5")]) == 0
    text = (tmp_path / "t.md5").read_text()
    assert text == framemd5_repaired((tmp_path / "j.md5").read_text())
    assert "#tb 0: 1/30" in text and text.count("\n0, ") == 3
