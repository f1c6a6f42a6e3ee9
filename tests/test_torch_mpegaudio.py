"""MPEG audio in both packages on the CPU: the port's copies
(codecs/mpegaudio.py, mpegaudio_tables.py, mp3dec.py, mp3tables.py)
held to the JAX package's on the committed streams
(tests/data/torch_port/acodecs, tools/torch_port_audio_fixtures.py):
MP2 48 kHz stereo 192 kb/s (twolame), MP3 44.1 kHz joint stereo 128
kb/s with a LAME tag and MP3 32 kHz mono 64 kb/s (LAME).

- the demuxers' packets and the decoders' frames equal: pts, sample
  rate, layout and every float sample (the same host numpy on one CPU);
- seeded corruptions of the packets (bytes flipped, cut, zeroed): frame
  by frame both packages give the same output or raise the same error
  class, and the decoders carry on alike after an error;
- `-f framemd5` through both CLIs, equal.

The JAX decoders run with the repairs the port makes
(tools/audio_jax_repair.py `mpegaudio_repaired`: libavcodec's synthesis
window, no 481-sample trim, the LAME tag's gapless trim); the port is
held to libavcodec itself in test_torch_libav_audio.py.
"""
import os

import numpy as np
import pytest

from librempeg_tpu.cli import ffmpeg as JCLI
from librempeg_tpu.codecs.api import find_decoder as jfind
from librempeg_tpu.core.packet import Packet as JPacket
from librempeg_tpu.formats.api import open_input as jopen
from librempeg_tpu_torch.cli import ffmpeg as TCLI
from librempeg_tpu_torch.codecs.api import find_decoder as tfind
from librempeg_tpu_torch.core.packet import Packet as TPacket
from librempeg_tpu_torch.formats.api import open_input as topen
from tools.audio_jax_repair import framemd5_repaired, mpegaudio_repaired

FX = os.path.join(os.path.dirname(__file__), "data", "torch_port", "acodecs")
STREAMS = {"mp2.mp2": "mp2", "mp3.mp3": "mp3", "mp3_mono32k.mp3": "mp3"}


def demux(path):
    j, t = jopen(path), topen(path)
    jp, tp = list(j.packets()), list(t.packets())
    jpar, tpar = j.streams[0].codecpar, t.streams[0].codecpar
    j.close()
    t.close()
    return (jpar, jp), (tpar, tp)


def frames_equal(jf, tf):
    assert [(f.pts, f.sample_rate, f.sample_fmt) for f in jf] == \
        [(f.pts, f.sample_rate, f.sample_fmt) for f in tf]
    for a, b in zip(jf, tf):
        assert b.data.device.type == "cpu"
        np.testing.assert_array_equal(b.data.numpy(), np.asarray(a.data))


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_committed_streams_decode_as_jax(name):
    with mpegaudio_repaired():
        decode_as_jax(name)


def decode_as_jax(name):
    (jpar, jp), (tpar, tp) = demux(os.path.join(FX, name))
    assert tpar.codec_id == jpar.codec_id == STREAMS[name]
    assert (tpar.sample_rate, tpar.nb_channels) == \
        (jpar.sample_rate, jpar.nb_channels)
    assert [(p.pts, p.duration, bytes(p.data)) for p in tp] == \
        [(p.pts, p.duration, bytes(p.data)) for p in jp]
    jd = jfind(jpar.codec_id)(jpar)
    td = tfind(tpar.codec_id)(tpar, device="cpu")
    assert td.sample_fmt == "fltp"
    jf = [f for p in jp for f in jd.decode(p)] + jd.flush()
    tf = [f for p in tp for f in td.decode(p)] + td.flush()
    assert len(tf) > 20
    frames_equal(jf, tf)


def corrupt(data: bytes, rng) -> bytes:
    b = bytearray(data)
    kind = rng.integers(4)
    if kind == 0:                       # flip a few bytes past the header
        for i in rng.integers(4, len(b), 3):
            b[i] ^= int(rng.integers(1, 256))
    elif kind == 1:                     # cut the frame short
        b = b[:int(rng.integers(4, len(b)))]
    elif kind == 2:                     # zero a run of side info
        s = int(rng.integers(4, max(5, len(b) - 20)))
        b[s:s + 16] = bytes(len(b[s:s + 16]))
    else:                               # break the header
        b[1] ^= 0x06
    return bytes(b)


def outcome(dec, pkt):
    try:
        return "ok", dec.decode(pkt)
    except Exception as e:             # the class is what is compared
        return type(e).__name__, []


@pytest.mark.parametrize("name,seed", [("mp2.mp2", 1), ("mp3.mp3", 2),
                                       ("mp3_mono32k.mp3", 3)])
def test_seeded_corruptions_match_jax(name, seed):
    # the packets carry no side data here: neither decoder trims
    (jpar, jp), (tpar, tp) = demux(os.path.join(FX, name))
    rng = np.random.default_rng(seed)
    kinds = set()
    with mpegaudio_repaired():
        jd = jfind(jpar.codec_id)(jpar)
        td = tfind(tpar.codec_id)(tpar, device="cpu")
        for i, (a, b) in enumerate(zip(jp[:60], tp[:60])):
            data = bytes(a.data)
            if i % 3 == 1:
                data = corrupt(data, rng)
            jo = outcome(jd, JPacket(data=data, pts=a.pts,
                                     duration=a.duration,
                                     time_base=a.time_base))
            to = outcome(td, TPacket(data=data, pts=b.pts,
                                     duration=b.duration,
                                     time_base=b.time_base))
            assert to[0] == jo[0], (i, jo[0], to[0])
            kinds.add(jo[0])
            frames_equal(jo[1], to[1])
    assert "ok" in kinds


def test_cli_framemd5_matches_jax(tmp_path):
    src = os.path.join(FX, "mp3_mono32k.mp3")
    with mpegaudio_repaired():
        assert JCLI.main(["-i", src, "-f", "framemd5", "-y",
                          str(tmp_path / "j.md5")]) == 0
    assert TCLI.main(["-i", src, "-f", "framemd5", "-device", "cpu", "-y",
                      str(tmp_path / "t.md5")]) == 0
    t = (tmp_path / "t.md5").read_text()
    j = framemd5_repaired((tmp_path / "j.md5").read_text())
    # the stream is mono: the port names it as libavformat does, the JAX
    # package calls every layout "stereo" (ROADMAP.md section 3b)
    mono, stereo = (f"#channel_layout_name 0: {n}\n"
                    for n in ("mono", "stereo"))
    assert mono in t and stereo in j
    assert t.replace(mono, stereo) == j and t.count("\n") > 30
