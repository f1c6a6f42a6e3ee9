"""Channel layouts in the port, held to libavutil, libavformat and
libavcodec 59 through tests/data/torch_port/libav_layouts.json (written
by tools/torch_port_libav_fixtures.py against the system FFmpeg 5.1):

- `core.samplefmt`'s table, `ChannelLayout.default`, `.name`
  (av_channel_layout_describe) and `.from_string` give libavutil's
  masks and names: "5.1" is 0x3F, the default of six channels, and
  0x60F is "5.1(side)"; a mask with no name is "3 channels (FL+FR+BL)",
  a count in no known order "6 channels";
- the WAV muxer writes libavformat's file byte for byte (AVFMT_FLAG_BITEXACT)
  in each case of its rule, WAVE_FORMAT_EXTENSIBLE or not, and the WAV
  demuxer reads each back to the same codec, rate and layout;
- framemd5 names the layout as libavformat does (mono, stereo,
  5.1(side), 5.1, 6 channels);
- the CLI carries a layout from the demuxer to the muxer (a WAV's
  channel mask, an AC-3 stream's acmod, the decoder's layout of an AC-3
  track in Matroska) and `-ac N` gives libavutil's default of N;
- the downmix to stereo of the new six- and five-channel defaults is
  the one the old table's defaults gave, so no downmixed sample moves.
"""
import json
import os
import struct

import numpy as np
import pytest

from librempeg_tpu_torch.cli import ffmpeg as TCLI
from librempeg_tpu_torch.core.packet import Packet
from librempeg_tpu_torch.core.samplefmt import (
    CHANNEL_NAMES,
    LAYOUTS,
    ChannelLayout,
)
from librempeg_tpu_torch.formats import api as TA
from librempeg_tpu_torch.resample.rematrix import build_matrix

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")
LIBAV = json.load(open(os.path.join(DATA, "libav_layouts.json")))
BITS = {"pcm_s16le": 16, "pcm_s24le": 24, "pcm_s32le": 32,
        "pcm_f32le": 32}


def _lay(d: dict) -> ChannelLayout:
    """A layout of the JSON (order 1 native, 0 unspecified)."""
    assert d["order"] in (0, 1)
    return ChannelLayout(d["nb_channels"], d["mask"] if d["order"] else 0)


def test_versions():
    assert LIBAV["versions"] == ["Lavu57.28.100", "Lavc59.37.100",
                                 "Lavf59.27.100"]


def test_layout_table_is_libavutils():
    """LAYOUTS is channel_layout_map in its order, masks and names."""
    assert [(k, v) for k, v in LAYOUTS.items()] == \
        [(d["name"], d["mask"]) for d in LIBAV["layouts"]]
    for d in LIBAV["layouts"]:
        lay = ChannelLayout.from_string(d["name"])
        assert lay == _lay(d) and lay.name == d["name"]
    names = [ChannelLayout(1, 1 << b).name for b in range(64)]
    assert names == ["mono" if b == 2 else f"1 channels ({n})"
                     for b, n in enumerate(LIBAV["channels"])]
    assert CHANNEL_NAMES[:18] == tuple(LIBAV["channels"][:18])


@pytest.mark.parametrize("n", range(1, 11))
def test_default_is_libavutils(n):
    want = LIBAV["defaults"][n - 1]
    got = ChannelLayout.default(n)
    assert got == _lay(want) and got.name == want["name"]


@pytest.mark.parametrize("s", sorted(LIBAV["from_string"]))
def test_from_string_is_libavutils(s):
    want = LIBAV["from_string"][s]
    got = ChannelLayout.from_string(s)
    assert got == _lay(want) and got.name == want["name"]


@pytest.mark.parametrize("s", sorted(LIBAV["describe"]))
def test_describe_is_libavutils(s):
    """Unnamed masks list their channels; a count in no known order is
    "<n> channels" (the port said "<n>c" before)."""
    want = LIBAV["describe"][s]
    assert ChannelLayout.from_string(s).name == want["name"]


def test_unknown_layouts_are_refused():
    for s in ("", "0", "0c", "5.2", "FL+XX", "six"):
        with pytest.raises(ValueError):
            ChannelLayout.from_string(s)


def _write_wav(path, codec, rate, layout, n):
    mux = TA.open_output(str(path))
    mux.add_stream(TA.CodecParameters(
        codec_type="audio", codec_id=codec, sample_rate=rate,
        nb_channels=layout.nb_channels, ch_layout=layout))
    mux.write(Packet(data=bytes(n * layout.nb_channels * BITS[codec] // 8),
                     pts=0, duration=n))
    mux.close()
    return path.read_bytes()


@pytest.mark.parametrize("case", sorted(LIBAV["wav"]))
def test_wav_file_is_libavformats(case, tmp_path):
    """Every byte of libavformat's file (the zero payload included), and
    the demuxer reads it back to the same codec, rate and layout (a
    16-byte fmt chunk carries none: the CLI then takes the default of
    the count, which for one and two channels is the layout written)."""
    want = LIBAV["wav"][case]
    layout = ChannelLayout.from_string(want["layout"])
    raw = _write_wav(tmp_path / "o.wav", want["codec"], want["rate"],
                     layout, want["samples"])
    head = bytes.fromhex(want["header"])
    assert raw == head + bytes(want["payload"])
    extensible = struct.unpack("<H", head[20:22])[0] == 0xFFFE
    assert extensible == (case not in ("s16_mono_44k", "s16_stereo_48k",
                                       "s16_eac3_stereo", "s16_eac3_44k"))
    d = TA.open_input(str(tmp_path / "o.wav"))
    par = d.streams[0].codecpar
    assert (par.codec_id, par.sample_rate, par.nb_channels) == \
        (want["codec"], want["rate"], layout.nb_channels)
    assert par.ch_layout == (layout if extensible else None)
    assert (par.ch_layout or ChannelLayout.default(par.nb_channels)) \
        == layout
    assert sum(len(p.data) for p in d.packets()) == want["payload"]


@pytest.mark.parametrize("case", sorted(LIBAV["framemd5"]))
def test_framemd5_header_is_libavformats(case, tmp_path):
    """The layout line is libavformat's; so is every other line of its
    header, the last, "#stream#, dts, ...", included (the JAX package
    stops before it)."""
    layout = ChannelLayout.from_string(case)
    mux = TA.open_output(str(tmp_path / "o.md5"), format="framemd5")
    mux.add_stream(TA.CodecParameters(
        codec_type="audio", codec_id="pcm_s16le", sample_rate=48000,
        nb_channels=layout.nb_channels, ch_layout=layout),
        time_base=TA.Rational(1, 48000))
    mux.write_header()
    mux.close()
    got = (tmp_path / "o.md5").read_text().splitlines()
    want = LIBAV["framemd5"][case].splitlines()
    assert want[-1].startswith("#stream#")
    assert got == want
    assert f"#channel_layout_name 0: {layout.name}" in got


def _src_wav(path, layout, rate=48000, seconds=0.1):
    """A WAV of distinct tones a channel, written by the port."""
    t = np.arange(int(rate * seconds)) / rate
    x = np.stack([0.3 * np.sin(2 * np.pi * (220 + 110 * c) * t)
                  for c in range(layout.nb_channels)])
    pcm = np.rint(x.T * 32767).astype("<i2")
    mux = TA.open_output(str(path))
    mux.add_stream(TA.CodecParameters(
        codec_type="audio", codec_id="pcm_s16le", sample_rate=rate,
        nb_channels=layout.nb_channels, ch_layout=layout))
    mux.write(Packet(data=pcm.tobytes(), pts=0, duration=pcm.shape[0]))
    mux.close()


def _cli(*args):
    assert TCLI.main([*map(str, args), "-device", "cpu"]) == 0


def _fmt(raw: bytes) -> bytes:
    """The fmt chunk (tag and size included)."""
    assert raw[12:16] == b"fmt "
    return raw[12:20 + struct.unpack("<I", raw[16:20])[0]]


@pytest.mark.parametrize("layout", ["mono", "stereo", "5.1(side)",
                                    "6.1", "quad(side)"])
def test_cli_carries_the_wav_layout(layout, tmp_path):
    """A WAV's layout reaches the muxer decoded and re-encoded, copied,
    and in framemd5's layout line."""
    lay = ChannelLayout.from_string(layout)
    src = tmp_path / "in.wav"
    _src_wav(src, lay)
    for args, out in ((["-c:a", "pcm_s16le"], "enc.wav"),
                      (["-c:a", "copy"], "copy.wav")):
        _cli("-i", src, *args, "-y", tmp_path / out)
        assert _fmt((tmp_path / out).read_bytes()) == \
            _fmt(src.read_bytes())
        par = TA.open_input(str(tmp_path / out)).streams[0].codecpar
        assert (par.ch_layout or ChannelLayout.default(par.nb_channels)) \
            == lay
    _cli("-i", src, "-f", "framemd5", "-y", tmp_path / "o.md5")
    assert f"#channel_layout_name 0: {layout}\n" in \
        (tmp_path / "o.md5").read_text()


@pytest.mark.parametrize("n,case", [(2, "s16_stereo_48k"), (3, "s16_3ch"),
                                    (6, "s16_6ch")])
def test_cli_ac_writes_the_default_layout(n, case, tmp_path):
    """-ac N gives av_channel_layout_default(N): the fmt chunk of
    libavformat's file for that layout."""
    src = tmp_path / "in.wav"
    _src_wav(src, ChannelLayout.from_string("stereo" if n != 2 else "mono"))
    _cli("-i", src, "-ac", n, "-c:a", "pcm_s16le", "-y", tmp_path / "o.wav")
    head = bytes.fromhex(LIBAV["wav"][case]["header"])
    assert _fmt((tmp_path / "o.wav").read_bytes()) == _fmt(head)


def test_cli_ac_1_names_mono(tmp_path):
    src = tmp_path / "in.wav"
    _src_wav(src, ChannelLayout.from_string("stereo"))
    _cli("-i", src, "-ac", 1, "-f", "framemd5", "-y", tmp_path / "o.md5")
    assert "#channel_layout_name 0: mono\n" in \
        (tmp_path / "o.md5").read_text()


def test_ac3_in_matroska_takes_the_decoders_layout(tmp_path):
    """Matroska says six channels and no layout; the decoder reports
    5.1(side), and the graph, configured from the first decoded frame as
    ffmpeg configures it, writes libavformat's 5.1(side) header (K9D of
    chip_smoke.py)."""
    src = os.path.join(DATA, "acodecs", "ac3_51.ac3")
    mkv = tmp_path / "a.mkv"
    _cli("-i", src, "-c:a", "copy", "-y", mkv)
    assert TA.open_input(str(mkv)).streams[0].codecpar.ch_layout is None
    _cli("-i", mkv, "-c:a", "pcm_s16le", "-y", tmp_path / "o.wav")
    head = bytes.fromhex(LIBAV["wav"]["s16_ac3_51"]["header"])
    raw = (tmp_path / "o.wav").read_bytes()
    assert raw[:len(head)] == head and len(raw) == \
        LIBAV["wav"]["s16_ac3_51"]["size"]


@pytest.mark.parametrize("n,old", [(5, 0x607), (6, 0x60F)])
def test_new_defaults_downmix_as_the_old(n, old):
    """default(5) is now 5.0 (back surrounds, 0x37) and default(6) 5.1
    (0x3F); the old table gave 0x607 and 0x60F. libswresample mixes
    back and side surrounds into FL/FR alike, so the matrices to stereo
    and mono are equal."""
    new = ChannelLayout.default(n)
    assert new.mask != old and new.nb_channels == n
    for out in ("stereo", "mono"):
        o = ChannelLayout.from_string(out)
        np.testing.assert_array_equal(
            build_matrix(new, o), build_matrix(ChannelLayout.from_mask(old),
                                               o))
