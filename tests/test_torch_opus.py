"""Opus in both packages on the CPU: the port's copies
(codecs/opus/{tables_data,silk_tables,rc,celt,silk,resample,codec}.py and
formats/ogg.py) held to the JAX package's.

- the committed Ogg Opus streams (tests/data/torch_port/acodecs, made by
  tools/torch_port_audio_fixtures.py from libopus): CELT only fullband
  stereo 20 ms (its first 2 s), hybrid fullband stereo 20 ms, SILK
  wideband mono 40 and 60 ms. The demuxers' packets equal (the pre-skip
  takes 312 samples off the first frame, the end granule trims the
  last), the decoders' frames equal float for float (the same host numpy on one
  CPU);
- packets made at test time by libopus where it is present (this case
  alone skips where it is not): SILK narrow-, medium- and wideband,
  hybrid super-wide- and fullband and CELT, mono and stereo, 10, 20,
  40 and 60 ms frames (tools/gen_silk_vectors.py's encode, the CELT
  cases through tools/torch_port_audio_fixtures.py's opus_packets), the
  first 50 packets of each decoded by both packages, equal;
- a copy of a committed stream into Matroska through both CLIs: equal
  bytes, and equal frames decoded from the copies.
"""
import ctypes.util
import importlib.util
import os

import numpy as np
import pytest

from librempeg_tpu.cli import ffmpeg as JCLI
from librempeg_tpu.codecs.opus.codec import OpusDecoder as JOpus
from librempeg_tpu.core.packet import Packet as JPacket
from librempeg_tpu.formats.api import CodecParameters as JPar
from librempeg_tpu.formats.api import open_input as jopen
from librempeg_tpu_torch.cli import ffmpeg as TCLI
from librempeg_tpu_torch.codecs.opus.codec import OpusDecoder as TOpus
from librempeg_tpu_torch.core.packet import Packet as TPacket
from librempeg_tpu_torch.formats.api import CodecParameters as TPar
from librempeg_tpu_torch.formats.api import open_input as topen
from tools.audio_jax_repair import framemd5_repaired

HERE = os.path.dirname(__file__)
FX = os.path.join(HERE, "data", "torch_port", "acodecs")
TOOLS = os.path.join(HERE, "..", "tools")


def frames_equal(jf, tf):
    assert [(f.pts, f.data.shape[1] if hasattr(f.data, "shape") else 0)
            for f in jf] == [(f.pts, f.data.shape[1]) for f in tf]
    for a, b in zip(jf, tf):
        assert b.sample_fmt == a.sample_fmt == "fltp"
        np.testing.assert_array_equal(b.data.numpy(), np.asarray(a.data))


@pytest.mark.parametrize("name,limit", [("opus_celt.ogg", 100),
                                        ("opus_hybrid.ogg", None),
                                        ("opus_silk40.ogg", None),
                                        ("opus_silk60.ogg", None)])
def test_committed_streams_decode_as_jax(name, limit):
    path = os.path.join(FX, name)
    j, t = jopen(path), topen(path)
    assert t.NAME == j.NAME == "ogg"
    jpar, tpar = j.streams[0].codecpar, t.streams[0].codecpar
    assert tpar.codec_id == jpar.codec_id == "opus"
    assert bytes(tpar.extradata) == bytes(jpar.extradata)
    jp, tp = list(j.packets()), list(t.packets())
    assert [(p.pts, p.duration, bytes(p.data)) for p in tp] == \
        [(p.pts, p.duration, bytes(p.data)) for p in jp]
    if limit:
        jp, tp = jp[:limit], tp[:limit]
    jd, td = JOpus(jpar), TOpus(tpar, device="cpu")
    jf = [f for p in jp for f in jd.decode(p)]
    tf = [f for p in tp for f in td.decode(p)]
    frames_equal(jf, tf)
    # the pre-skip: 312 samples off the first frame (960 -> 648 at 20 ms)
    assert tf[0].data.shape[1] == tf[1].data.shape[1] - 312
    if limit is None:                             # the end granule's trim
        total = sum(f.data.shape[1] for f in tf)
        assert tf[-1].pts + tf[-1].data.shape[1] == total


def libopus_cases():
    out = []
    for mode, bw, ch, ms in (("silk", "nb", 1, 10), ("silk", "mb", 2, 20),
                             ("silk", "wb", 2, 40), ("silk", "wb", 1, 60),
                             ("hybrid", "swb", 1, 10),
                             ("hybrid", "fb", 2, 20),
                             ("celt", "fb", 1, 10), ("celt", "wb", 2, 20)):
        out.append(pytest.param(mode, bw, ch, ms,
                                id=f"{mode}-{bw}-{ch}ch-{ms}ms"))
    return out


@pytest.mark.skipif(ctypes.util.find_library("opus") is None,
                    reason="libopus is not installed: no packets to make")
@pytest.mark.parametrize("mode,bw,ch,ms", libopus_cases())
def test_libopus_packets_decode_as_jax(mode, bw, ch, ms):
    spec = importlib.util.spec_from_file_location(
        "torch_port_audio_fixtures",
        os.path.join(TOOLS, "torch_port_audio_fixtures.py"))
    F = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(F)
    G = F.G
    if mode == "celt":
        pkts = F.opus_packets(F.make_signal(1.0, 48000, ch), mode, bw, ms,
                              64000 * ch)
    else:
        pkts, _ = G.encode(mode, bw, ch, ms, 24000 * ch)
    pkts = pkts[:50]
    configs = {p[0] >> 3 for p in pkts}
    assert configs and all(((c >= 16) == (mode == "celt")) for c in configs)
    jd = JOpus(JPar(codec_type="audio", codec_id="opus", nb_channels=ch,
                    sample_rate=48000))
    td = TOpus(TPar(codec_type="audio", codec_id="opus", nb_channels=ch,
                    sample_rate=48000), device="cpu")
    jf = [f for p in pkts for f in jd.decode(JPacket(data=p))]
    tf = [f for p in pkts for f in td.decode(TPacket(data=p))]
    assert len(tf) == len(pkts)
    frames_equal(jf, tf)


def test_matroska_copy_matches_jax(tmp_path):
    """-c:a copy into Matroska and a decode of the copy, through both
    CLIs: the same bytes and the same frames (the copy keeps the last
    frame untrimmed in both packages: Matroska carries no end granule)."""
    src = os.path.join(FX, "opus_silk60.ogg")
    for cli, tag, dev in ((JCLI, "j", []), (TCLI, "t", ["-device", "cpu"])):
        assert cli.main(["-i", src, "-c:a", "copy", *dev, "-y",
                         str(tmp_path / f"{tag}.mkv")]) == 0
        assert cli.main(["-i", str(tmp_path / f"{tag}.mkv"), "-f",
                         "framemd5", *dev, "-y",
                         str(tmp_path / f"{tag}.md5")]) == 0
    assert (tmp_path / "t.mkv").read_bytes() == \
        (tmp_path / "j.mkv").read_bytes()
    t, j = (tmp_path / "t.md5").read_text(), (tmp_path / "j.md5").read_text()
    # the stream is mono: the port names it as libavformat does, the JAX
    # package calls every layout "stereo" (ROADMAP.md section 3b)
    mono, stereo = (f"#channel_layout_name 0: {n}\n"
                    for n in ("mono", "stereo"))
    assert mono in t and stereo in j
    # and libavformat's last header line, which the JAX package leaves out
    assert t.replace(mono, stereo) == framemd5_repaired(j) \
        and t.count("\n") > 40
