"""The WAV muxer's non-PCM tags held to libavformat 59's wavenc.c, byte
for byte, on the CPU.

tests/data/torch_port/libav_wav/ holds the files libavformat writes with
AVFMT_FLAG_BITEXACT for libavcodec's pcm_alaw, pcm_mulaw, adpcm_ima_wav
and adpcm_ms encodes of tools/torch_port_libav_audio.py's `wav_input()`
(libav_audio.json: the encoder's frame size, block align and packets).
The port's muxer, given those packets and the codec parameters the
encoder gives (libavcodec's ADPCM encoders keep AVCodecContext's 128
kb/s), writes the same files: WAVEFORMATEX's cbSize, the ADPCM extension
and byte rate, and a `fact` chunk with the packets' sample span. The
JAX package's muxer writes no fact chunk (ROADMAP.md section 3b). A
`-c:a copy` of each file into WAV gives the file back.
"""
import json
import os
import struct

import numpy as np
import pytest

from librempeg_tpu.core.packet import Packet as JPacket
from librempeg_tpu.formats import api as JA
from librempeg_tpu_torch.core.packet import Packet
from librempeg_tpu_torch.core.rational import Rational
from librempeg_tpu_torch.formats import api as TA

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")
LIBAV = json.load(open(os.path.join(DATA, "libav_audio.json")))
CODECS = sorted(LIBAV["wav"])
WAV = LIBAV["wav_input"]


def libav_file(codec) -> bytes:
    return open(os.path.join(DATA, "libav_wav", codec + ".wav"), "rb").read()


def libav_packets(codec):
    """The file's payload cut into libavcodec's packets, with their pts
    and durations in samples."""
    raw = libav_file(codec)
    start = raw.index(b"data") + 8
    out, at, pts = [], start, 0
    for size, dur in LIBAV["wav"][codec]["packets"]:
        out.append((raw[at:at + size], pts, dur))
        at += size
        pts += dur
    assert at == len(raw)
    return out


def params(codec):
    info = LIBAV["wav"][codec]
    adpcm = codec.startswith("adpcm")
    return TA.CodecParameters(
        codec_type="audio", codec_id=codec, sample_rate=WAV["rate"],
        nb_channels=WAV["channels"], block_align=info["block_align"],
        frame_size=info["frame_size"],
        bit_rate=128000 if adpcm else WAV["rate"] * WAV["channels"] * 8)


def mux(path, codec):
    m = TA.open_output(str(path), format="wav")
    m.add_stream(params(codec), time_base=Rational(1, WAV["rate"]))
    for data, pts, dur in libav_packets(codec):
        m.write(Packet(data=data, pts=pts, dts=pts, duration=dur))
    m.close()
    return open(path, "rb").read()


def test_the_files_are_libavformats():
    for codec in CODECS:
        raw = libav_file(codec)
        info = LIBAV["wav"][codec]
        assert len(raw) == info["size"]
        assert raw[:len(bytes.fromhex(info["header"]))].hex() == \
            info["header"]
        assert b"fact" in raw[:80]


@pytest.mark.parametrize("codec", CODECS)
def test_wav_file_is_libavformats(codec, tmp_path):
    assert mux(tmp_path / "t.wav", codec) == libav_file(codec)


@pytest.mark.parametrize("codec", CODECS)
def test_wav_reads_back(codec):
    """The port's demuxer reads libavformat's file: the codec, its
    block align and every payload byte."""
    d = TA.open_input(os.path.join(DATA, "libav_wav", codec + ".wav"))
    par = d.streams[0].codecpar
    assert (par.codec_id, par.sample_rate, par.nb_channels,
            par.block_align) == (codec, WAV["rate"], WAV["channels"],
                                 LIBAV["wav"][codec]["block_align"])
    got = b"".join(bytes(p.data) for p in d.packets())
    d.close()
    assert got == b"".join(data for data, _, _ in libav_packets(codec))


@pytest.mark.parametrize("codec", ["pcm_alaw", "adpcm_ms"])
def test_jax_wav_has_no_fact_chunk(codec, tmp_path):
    """The JAX muxer writes the same payload under a header without the
    fact chunk libavformat writes for every tag but PCM."""
    from librempeg_tpu.core.rational import Rational as JR

    m = JA.open_output(str(tmp_path / "j.wav"), format="wav")
    info = LIBAV["wav"][codec]
    m.add_stream(JA.CodecParameters(
        codec_type="audio", codec_id=codec, sample_rate=WAV["rate"],
        nb_channels=WAV["channels"], block_align=info["block_align"],
        frame_size=info["frame_size"]), time_base=JR(1, WAV["rate"]))
    for data, pts, dur in libav_packets(codec):
        m.write(JPacket(data=data, pts=pts, dts=pts, duration=dur))
    m.close()
    j, want = (tmp_path / "j.wav").read_bytes(), libav_file(codec)
    assert b"fact" not in j and b"fact" in want
    assert j[j.index(b"data") + 8:] == want[want.index(b"data") + 8:]
    assert struct.unpack("<H", j[20:22])[0] == \
        struct.unpack("<H", want[20:22])[0]
    assert j != want


def test_fact_counts_the_packets_span(tmp_path):
    """The fact chunk counts the last pts less the first plus the last
    duration (wavenc.c), here a short last packet of A-law."""
    x = np.arange(3001 * 2, dtype=np.uint8).tobytes()
    m = TA.open_output(str(tmp_path / "t.wav"), format="wav")
    m.add_stream(params("pcm_alaw"), time_base=Rational(1, WAV["rate"]))
    m.write(Packet(data=x[:4000], pts=0, duration=2000))
    m.write(Packet(data=x[4000:], pts=2000, duration=1001))
    m.close()
    raw = (tmp_path / "t.wav").read_bytes()
    k = raw.index(b"fact")
    assert struct.unpack("<II", raw[k + 4:k + 12]) == (4, 3001)


@pytest.mark.parametrize("codec", CODECS)
def test_copy_keeps_the_file(codec, tmp_path):
    """`-c:a copy` of libavformat's file into WAV writes it back byte for
    byte: the demuxer takes the bit rate from the header's byte rate (as
    ff_get_wav_header does), so an ADPCM copy keeps its byte rate."""
    from librempeg_tpu_torch.cli import ffmpeg as TCLI

    src = os.path.join(DATA, "libav_wav", codec + ".wav")
    d = TA.open_input(src)
    assert d.streams[0].codecpar.bit_rate == \
        8 * struct.unpack("<I", libav_file(codec)[28:32])[0]
    d.close()
    out = tmp_path / "copy.wav"
    assert TCLI.main(["-i", src, "-c:a", "copy", "-device", "cpu", "-y",
                      str(out)]) == 0
    assert out.read_bytes() == libav_file(codec)
