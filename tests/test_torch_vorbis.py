"""Vorbis in both packages on the CPU: the port's copy
(codecs/vorbis/decoder.py, with formats/ogg.py) held to the JAX
package's on the committed stream (tests/data/torch_port/acodecs/
vorbis.ogg: libvorbisenc at quality 0.4, 44.1 kHz stereo, 5 s, with
transients that switch the block size; tools/torch_port_audio_fixtures.py).

- the Ogg demuxers' packets (headers in the extradata, granule pts)
  equal, and the decoders' frames equal float for float (the same host
  numpy on one CPU), the block switches included;
- the same packets one at a time with the headers in-band, equal;
- `-c:a copy` into Matroska and `-f framemd5` of the copy through both
  CLIs: equal bytes and equal frames.
"""
import os

import numpy as np

from librempeg_tpu.cli import ffmpeg as JCLI
from librempeg_tpu.codecs.vorbis.decoder import VorbisCodec as JVorbis
from librempeg_tpu.formats.api import open_input as jopen
from librempeg_tpu_torch.cli import ffmpeg as TCLI
from librempeg_tpu_torch.codecs.vorbis.decoder import VorbisCodec as TVorbis
from librempeg_tpu_torch.formats.api import open_input as topen

SRC = os.path.join(os.path.dirname(__file__), "data", "torch_port", "acodecs",
                   "vorbis.ogg")


def frames_equal(jf, tf):
    assert [(f.pts, f.sample_rate) for f in jf] == \
        [(f.pts, f.sample_rate) for f in tf]
    for a, b in zip(jf, tf):
        assert b.sample_fmt == a.sample_fmt == "fltp"
        np.testing.assert_array_equal(b.data.numpy(), np.asarray(a.data))


def test_committed_stream_decodes_as_jax():
    j, t = jopen(SRC), topen(SRC)
    jpar, tpar = j.streams[0].codecpar, t.streams[0].codecpar
    assert tpar.codec_id == jpar.codec_id == "vorbis"
    assert (tpar.sample_rate, tpar.nb_channels) == (44100, 2)
    assert bytes(tpar.extradata) == bytes(jpar.extradata)
    jp, tp = list(j.packets()), list(t.packets())
    assert [(p.pts, p.duration, bytes(p.data)) for p in tp] == \
        [(p.pts, p.duration, bytes(p.data)) for p in jp]
    jd, td = JVorbis(jpar), TVorbis(tpar, device="cpu")
    jf = [f for p in jp for f in jd.decode(p)]
    tf = [f for p in tp for f in td.decode(p)]
    assert len(tf) > 100
    frames_equal(jf, tf)
    # both window sizes occur: the transients switch blocks
    assert len({f.data.shape[1] for f in tf}) > 1


def test_in_band_headers_decode_as_jax():
    """The three header packets sent as packets (no extradata)."""
    from librempeg_tpu.core.packet import Packet as JPacket
    from librempeg_tpu.formats.api import CodecParameters as JPar
    from librempeg_tpu_torch.core.packet import Packet as TPacket
    from librempeg_tpu_torch.formats.api import CodecParameters as TPar

    t = topen(SRC)
    ed = bytes(t.streams[0].codecpar.extradata)
    pkts = [bytes(p.data) for p in t.packets()][:40]
    assert ed[0] == 2                         # xiph lacing of 3 headers
    sizes, pos = [], 1
    for _ in range(2):
        v = 0
        while True:
            v += ed[pos]
            pos += 1
            if ed[pos - 1] != 255:
                break
        sizes.append(v)
    hdrs = [ed[pos:pos + sizes[0]],
            ed[pos + sizes[0]:pos + sizes[0] + sizes[1]],
            ed[pos + sizes[0] + sizes[1]:]]
    jd = JVorbis(JPar(codec_type="audio", codec_id="vorbis"))
    td = TVorbis(TPar(codec_type="audio", codec_id="vorbis"), device="cpu")
    jf = [f for d in hdrs + pkts for f in jd.decode(JPacket(data=d))]
    tf = [f for d in hdrs + pkts for f in td.decode(TPacket(data=d))]
    assert len(tf) > 30
    frames_equal(jf, tf)


def test_matroska_copy_matches_jax(tmp_path):
    for cli, tag, dev in ((JCLI, "j", []), (TCLI, "t", ["-device", "cpu"])):
        assert cli.main(["-i", SRC, "-c:a", "copy", *dev, "-y",
                         str(tmp_path / f"{tag}.mkv")]) == 0
        assert cli.main(["-i", str(tmp_path / f"{tag}.mkv"), "-f",
                         "framemd5", *dev, "-y",
                         str(tmp_path / f"{tag}.md5")]) == 0
    assert (tmp_path / "t.mkv").read_bytes() == \
        (tmp_path / "j.mkv").read_bytes()
    t = (tmp_path / "t.md5").read_text()
    assert t == (tmp_path / "j.md5").read_text() and t.count("\n") > 100
