"""Vorbis in both packages on the CPU: the port's copy
(codecs/vorbis/decoder.py, with formats/ogg.py) held to the JAX
package's on the committed stream (tests/data/torch_port/acodecs/
vorbis.ogg: libvorbisenc at quality 0.4, 44.1 kHz stereo, 5 s, with
transients that switch the block size; tools/torch_port_audio_fixtures.py).

- the Ogg demuxers' packets (headers in the extradata) equal, and the
  decoders' frames equal float for float (the same host numpy on one
  CPU), the block switches included;
- the same packets one at a time with the headers in-band, equal;
- `-c:a copy` into Matroska and `-f framemd5` of the copy: the same
  packets in both packages, and the copy decodes to the Ogg file's
  frames.

The JAX decoder runs with the floor repair the port makes
(tools/audio_jax_repair.py `vorbis_repaired`: the spec's floor 1 curve
points, the last packet trimmed to the end granule). The packets' pts
differ: the port times them as libavformat does (a quarter of each
block and the one before it), the JAX demuxer gives each the granule of
the page before it; test_torch_libav_audio.py holds the port's to
libavformat's.
"""
import json
import math
import os
import struct

import numpy as np

from librempeg_tpu.cli import ffmpeg as JCLI
from librempeg_tpu.codecs.vorbis.decoder import VorbisCodec as JVorbis
from librempeg_tpu.formats.api import open_input as jopen
from librempeg_tpu_torch.cli import ffmpeg as TCLI
from librempeg_tpu_torch.codecs.vorbis.decoder import VorbisCodec as TVorbis
from librempeg_tpu_torch.formats.api import open_input as topen
from tools.audio_jax_repair import vorbis_repaired

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")
SRC = os.path.join(DATA, "acodecs", "vorbis.ogg")
LIBAV = json.load(open(os.path.join(DATA, "libav_audio.json")))


def frames_equal(jf, tf, pts=True):
    assert [(f.pts if pts else 0, f.sample_rate) for f in jf] == \
        [(f.pts if pts else 0, f.sample_rate) for f in tf]
    for a, b in zip(jf, tf):
        assert b.sample_fmt == a.sample_fmt == "fltp"
        np.testing.assert_array_equal(b.data.numpy(), np.asarray(a.data))


def test_committed_stream_decodes_as_jax():
    j, t = jopen(SRC), topen(SRC)
    jpar, tpar = j.streams[0].codecpar, t.streams[0].codecpar
    assert tpar.codec_id == jpar.codec_id == "vorbis"
    assert (tpar.sample_rate, tpar.nb_channels) == (44100, 2)
    assert bytes(tpar.extradata) == bytes(jpar.extradata)
    with vorbis_repaired():
        jp, tp = list(j.packets()), list(t.packets())
        assert [bytes(p.data) for p in tp] == [bytes(p.data) for p in jp]
        jd, td = JVorbis(jpar), TVorbis(tpar, device="cpu")
        jf = [f for p in jp for f in jd.decode(p)]
        tf = [f for p in tp for f in td.decode(p)]
    assert len(tf) > 100
    frames_equal(jf, tf, pts=False)
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
    with vorbis_repaired():
        jf = [f for d in hdrs + pkts for f in jd.decode(JPacket(data=d))]
        tf = [f for d in hdrs + pkts for f in td.decode(TPacket(data=d))]
    assert len(tf) > 30
    frames_equal(jf, tf)


def _mkv_head(data):
    """The bytes before the first Cluster, with the Segment's size and
    the Info's Duration (ms) read out and zeroed."""
    head = bytearray(data[:data.index(b"\x1f\x43\xb6\x75")])
    k = head.index(b"\x18\x53\x80\x67") + 4         # Segment's size
    n = 9 - head[k].bit_length()                      # EBML vint length
    size = int.from_bytes(head[k:k + n], "big") & ((1 << 7 * n) - 1)
    head[k:k + n] = bytes(n)
    k = head.index(b"\x44\x89\x88") + 3             # Duration, float64
    (duration,) = struct.unpack(">d", head[k:k + 8])
    head[k:k + 8] = bytes(8)
    return bytes(head), size, duration


def test_matroska_copy_matches_jax(tmp_path):
    """-c:a copy into Matroska, held to the JAX package's copy and to
    libavformat's (libav_audio.json `vorbis_copy_mkv`).

    - Before the first Cluster the bytes are the JAX package's but for
      two fields: the Segment's size (the port's last block is a
      BlockGroup carrying DiscardPadding, the JAX package's a
      SimpleBlock) and the Duration (the port's last packet lasts its
      84 trimmed samples, the JAX package's 128: 4998 + 1 ms against
      4998 + 2).
    - Every packet's payload is the JAX copy's and its size libavformat's;
      its end trim (DiscardPadding) is libavformat's on every packet.
    - Block times: the port floors each Ogg pts to milliseconds, as the
      JAX package does; libavformat rounds it and shifts the stream by
      the first packet's -3 ms (avoid_negative_ts), which the port's
      muxer does not (ROADMAP.md section 3a). Each is held exactly to
      its own demuxer's Ogg pts, and those two timelines to each other.
    - The port's demuxer gives the packets no duration (libavformat's
      takes it from its Vorbis parser, section 3a), so the decode is
      held instead: the copy decodes to libavformat's decode of its own
      copy frame for frame (239 frames, 220500 samples) and to the Ogg
      file's samples, hash for hash."""
    for cli, tag, dev in ((JCLI, "j", []), (TCLI, "t", ["-device", "cpu"])):
        assert cli.main(["-i", SRC, "-c:a", "copy", *dev, "-y",
                         str(tmp_path / f"{tag}.mkv")]) == 0
    tb, jb = ((tmp_path / f"{tag}.mkv").read_bytes() for tag in "tj")
    (th, tsize, tdur), (jh, jsize, jdur) = _mkv_head(tb), _mkv_head(jb)
    assert th == jh
    assert tsize - jsize == len(tb) - len(jb) > 0
    assert (tdur, jdur) == (4999.0, 5000.0)

    copy = LIBAV["decodes"]["vorbis_copy_mkv"]
    ogg = topen(SRC)
    src = list(ogg.packets())
    j, t = jopen(str(tmp_path / "j.mkv")), topen(str(tmp_path / "t.mkv"))
    tp = list(t.packets())
    assert len(tp) == len(src) == len(copy["packets"]) == 240
    assert [bytes(p.data) for p in tp] == [bytes(p.data) for p in j.packets()]
    assert [len(p.data) for p in tp] == [n for _, _, n, _, _ in
                                         copy["packets"]]
    assert [(p.side_data["skip_samples"].end if p.side_data else 0)
            for p in tp] == [e for *_, e in copy["packets"]]
    assert copy["packets"][-1][4] == 44
    assert src[0].pts == -128
    assert [p.pts for p in tp] == [math.floor(p.pts * 1000 / 44100)
                                   for p in src]
    lms = [pts * 1000 / 44100 for pts, *_ in
           LIBAV["decodes"]["vorbis"]["packets"]]
    shift = -math.floor(lms[0] + 0.5)
    assert shift == 3
    assert [round(pts * 1000 / 44100) for pts, *_ in copy["packets"]] == \
        [math.floor(x + 0.5) + shift for x in lms]
    # the two Ogg timelines differ only where libavformat's Vorbis
    # parser is reset inside a page
    # (test_torch_libav_audio.py::test_vorbis_packets_are_timed_as_libavformat)
    assert [i for i, (p, x) in enumerate(zip(src, lms))
            if p.pts * 1000 / 44100 != x] == [16, 72, 122, 172, 222]

    par = t.streams[0].codecpar
    dec = TVorbis(par, device="cpu")
    frames = [f for p in tp for f in dec.decode(p)] + dec.flush()
    assert [f.nb_samples for f in frames] == [n for _, n in copy["frames"]]
    assert sum(f.nb_samples for f in frames) == copy["samples"] == 220500
    assert TCLI.main(["-i", str(tmp_path / "t.mkv"), "-f", "framemd5",
                      "-device", "cpu", "-y", str(tmp_path / "t.md5")]) == 0
    assert TCLI.main(["-i", SRC, "-f", "framemd5", "-device", "cpu", "-y",
                      str(tmp_path / "ogg.md5")]) == 0

    def hashes(name):
        return [ln.split(",")[-1] for ln in
                (tmp_path / name).read_text().splitlines()
                if not ln.startswith("#")]

    assert hashes("t.md5") == hashes("ogg.md5")
    assert len(hashes("t.md5")) == 239
