"""FLAC in both packages on the CPU: the port's copies
(codecs/flac/codec.py, formats/flac.py, formats/ogg.py) held byte for
byte to the JAX package's, and the two repairs with the JAX package's
faults asserted beside them.

- encoder bytes and decoded samples equal over block lengths that are
  not a multiple of 4096, mono and stereo, 8-, 16- and 24-bit, fed in
  frames of 1000 samples;
- the frame pts: the JAX decoder stamps a short last frame with
  frame_no x its own size (45864-style), the port with frame_no x
  STREAMINFO's block size; the JAX demuxer gives it a duration of 4096,
  the port its own;
- STREAMINFO: the JAX muxer leaves 0 total samples and a zero MD5, the
  port writes back the final ones at close (seekable output);
- stream copies into Ogg and Matroska through both CLIs: the same
  packets as the .flac file's, and the same bytes apart from the end
  granule (Ogg) and the duration (Matroska) that the repaired demuxer
  gives the last packet.
"""
import hashlib

import numpy as np
import pytest

from librempeg_tpu.cli import ffmpeg as JCLI
from librempeg_tpu.codecs.api import find_decoder as jfind_dec
from librempeg_tpu.codecs.api import find_encoder as jfind_enc
from librempeg_tpu.codecs.flac.codec import build_streaminfo as jbuild
from librempeg_tpu.core.frame import AudioFrame as JFrame
from librempeg_tpu.formats.api import open_input_bytes as jopen_bytes
from librempeg_tpu.formats.api import open_output_bytes as jout_bytes
from librempeg_tpu_torch.cli import ffmpeg as TCLI
from librempeg_tpu_torch.codecs.api import find_decoder as tfind_dec
from librempeg_tpu_torch.codecs.api import find_encoder as tfind_enc
from librempeg_tpu_torch.core.frame import AudioFrame as TFrame
from librempeg_tpu_torch.formats.api import open_input, open_input_bytes
from librempeg_tpu_torch.formats.api import open_output_bytes as tout_bytes
from librempeg_tpu_torch.utils import testgen

RATE = 44100
BLOCK = 4096


def pcm(n, ch, bps, seed=0):
    """[ch, n] samples of testgen.audio_mix at `bps` bits (int16 for 16,
    int32 in range for 8 and 24)."""
    x = testgen.audio_mix(RATE, n, channels=ch)
    x = x + 0.01 * np.random.default_rng(seed).standard_normal(x.shape)
    scale = float(1 << (bps - 1))
    v = np.clip(np.rint(np.asarray(x) * scale * 0.9), -scale, scale - 1)
    return v.astype(np.int16 if bps == 16 else np.int32)


def fmt(bps):
    return "s16p" if bps == 16 else "s32p"


def jax_encode(x, bps, chunk=1000):
    enc = jfind_enc("flac")(sample_rate=RATE, channels=x.shape[0], bps=bps)
    pkts = []
    for s in range(0, x.shape[1], chunk):
        pkts += enc.encode(JFrame(data=x[:, s:s + chunk], sample_rate=RATE,
                                  sample_fmt=fmt(bps), pts=s))
    return enc, pkts + enc.flush()


def port_encode(x, bps, chunk=1000):
    import torch

    enc = tfind_enc("flac")(sample_rate=RATE, channels=x.shape[0], bps=bps)
    pkts = []
    for s in range(0, x.shape[1], chunk):
        pkts += enc.encode(TFrame(
            data=torch.from_numpy(np.ascontiguousarray(x[:, s:s + chunk])),
            sample_rate=RATE, sample_fmt=fmt(bps), pts=s))
    return enc, pkts + enc.flush()


CASES = [(1, 5000, 16), (2, 9000, 16), (2, 3 * BLOCK + 17, 16),
         (2, 2 * BLOCK, 16), (1, BLOCK + 1, 24), (2, 7000, 24),
         (1, 6000, 8)]


@pytest.mark.parametrize("ch,n,bps", CASES)
def test_encoder_and_decoder_match_jax(ch, n, bps):
    x = pcm(n, ch, bps)
    jenc, jp = jax_encode(x, bps)
    tenc, tp = port_encode(x, bps)
    assert [bytes(p.data) for p in jp] == [bytes(p.data) for p in tp]
    assert [(p.pts, p.duration) for p in jp] == \
        [(p.pts, p.duration) for p in tp]
    assert tenc.md5 == jenc.md5 and tenc.total_samples == n
    jdec = jfind_dec("flac")(jenc.codec_parameters())
    tdec = tfind_dec("flac")(tenc.codec_parameters(), device="cpu")
    jf = [f for p in jp for f in jdec.decode(p)]
    tf = [f for p in tp for f in tdec.decode(p)]
    out_fmt = "s16p" if bps <= 16 else "s32p"     # the decoder's widths
    assert tdec.sample_fmt == out_fmt and all(
        f.sample_fmt == out_fmt for f in tf + jf)
    jx = np.concatenate([np.asarray(f.data) for f in jf], 1)
    tx = np.concatenate([f.data.numpy() for f in tf], 1)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(tx, x)
    # pts: the port's are the sample positions; the JAX decoder's too,
    # but for a short last frame of a fixed-blocksize stream
    assert [f.pts for f in tf] == list(range(0, n, BLOCK))
    last = n - (len(tf) - 1) * BLOCK
    want_jax = [f.pts for f in tf]
    want_jax[-1] = (len(tf) - 1) * last
    assert [f.pts for f in jf] == want_jax


def muxed(pkts, par, mux):
    mux.add_stream(par)
    for p in pkts:
        mux.write(p)
    mux.finish()
    return mux.io.getvalue()


def test_streaminfo_written_back_at_close():
    """The port's .flac declares the total samples and the MD5 of the
    interleaved input; the JAX package's keeps the zeros it opened
    with, and every other byte is the same."""
    x = pcm(3 * BLOCK + 100, 2, 16)
    jenc, jp = jax_encode(x, 16)
    tenc, tp = port_encode(x, 16)
    jblob = muxed(jp, jenc.codec_parameters(), jout_bytes("flac"))
    tblob = muxed(tp, tenc.codec_parameters(), tout_bytes("flac"))
    md5 = hashlib.md5(x.T.astype("<i2").tobytes()).digest()
    assert jblob[8:42] == jbuild(RATE, 2, 16, 0, BLOCK)          # the fault
    assert tblob[8:42] == jbuild(RATE, 2, 16, x.shape[1], BLOCK, md5)
    assert tblob[:8] == jblob[:8] and tblob[42:] == jblob[42:]
    d = open_input_bytes(tblob)
    assert d.streams[0].duration == x.shape[1]
    # stream copies keep the input's STREAMINFO (no new side data)
    copy = tout_bytes("flac")
    copy.add_stream(d.streams[0].codecpar)
    for p in d.packets():
        copy.write(p)
    copy.finish()
    assert copy.io.getvalue() == tblob


def test_demuxer_gives_the_short_last_packet_its_duration():
    x = pcm(2 * BLOCK + 2184, 2, 16)
    jenc, jp = jax_encode(x, 16)
    blob = muxed(jp, jenc.codec_parameters(), jout_bytes("flac"))
    jd = [(p.pts, p.duration) for p in jopen_bytes(blob).packets()]
    td = [(p.pts, p.duration) for p in open_input_bytes(blob).packets()]
    assert td == [(0, BLOCK), (BLOCK, BLOCK), (2 * BLOCK, 2184)]
    assert jd == [(0, BLOCK), (BLOCK, BLOCK), (2 * BLOCK, BLOCK)]  # fault


def write_wav(path, x):
    from librempeg_tpu_torch.core.packet import Packet
    from librempeg_tpu_torch.formats import api as TA

    mux = TA.open_output(str(path))
    mux.add_stream(TA.CodecParameters(codec_type="audio",
                                      codec_id="pcm_s16le",
                                      sample_rate=RATE,
                                      nb_channels=x.shape[0]))
    mux.write(Packet(data=np.ascontiguousarray(x.T).tobytes(), pts=0))
    mux.close()


def framemd5(path):
    return [ln.split(",") for ln in open(path).read().splitlines()
            if not ln.startswith("#")]


@pytest.fixture(scope="module")
def flac_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("flac")
    x = pcm(5 * BLOCK + 2184, 2, 16, seed=3)
    write_wav(d / "in.wav", x)
    assert JCLI.main(["-i", str(d / "in.wav"), "-c:a", "flac", "-y",
                      str(d / "j.flac")]) == 0
    assert TCLI.main(["-i", str(d / "in.wav"), "-c:a", "flac", "-device",
                      "cpu", "-y", str(d / "t.flac")]) == 0
    return d, x


def test_cli_encode_and_framemd5(flac_files):
    d, x = flac_files
    j, t = (d / "j.flac").read_bytes(), (d / "t.flac").read_bytes()
    assert j[:8] == t[:8] and j[42:] == t[42:]
    assert t[8:42] == jbuild(RATE, 2, 16, x.shape[1], BLOCK, hashlib.md5(
        x.T.astype("<i2").tobytes()).digest())
    assert JCLI.main(["-i", str(d / "j.flac"), "-f", "framemd5", "-y",
                      str(d / "j.md5")]) == 0
    assert TCLI.main(["-i", str(d / "t.flac"), "-f", "framemd5", "-device",
                      "cpu", "-y", str(d / "t.md5")]) == 0
    jr, tr = framemd5(d / "j.md5"), framemd5(d / "t.md5")
    assert [r[3:] for r in jr] == [r[3:] for r in tr]   # sizes, hashes
    assert [int(r[2]) for r in tr] == [i * BLOCK for i in range(6)]
    assert int(jr[-1][2]) == 5 * 2184                    # the JAX fault


@pytest.mark.parametrize("ext", ["ogg", "mkv"])
def test_stream_copies_match_jax(flac_files, ext):
    d, _ = flac_files
    src = str(d / "t.flac")
    jo, to = str(d / f"j_copy.{ext}"), str(d / f"t_copy.{ext}")
    assert JCLI.main(["-i", src, "-c:a", "copy", "-y", jo]) == 0
    assert TCLI.main(["-i", src, "-c:a", "copy", "-device", "cpu", "-y",
                      to]) == 0
    want = [bytes(p.data) for p in open_input(src).packets()]
    for path in (jo, to):
        d2 = open_input(path)
        assert d2.streams[0].codecpar.codec_id == "flac"
        assert [bytes(p.data) for p in d2.packets()] == want
    j, t = open(jo, "rb").read(), open(to, "rb").read()
    assert len(j) == len(t)
    diff = [i for i in range(len(j)) if j[i] != t[i]]
    if ext == "mkv":
        # the segment's duration: the last packet's own 2184 samples
        assert len(diff) <= 2
        return
    # the last two pages' granule (and CRC): the port's end granule is
    # the stream's length, the JAX package's counts a whole last block
    pages = [i for i in range(len(t)) if t[i:i + 4] == b"OggS"]
    last2 = pages[-2]
    assert diff and min(diff) >= last2
    assert int.from_bytes(t[pages[-1] + 6:pages[-1] + 14], "little") == \
        5 * BLOCK + 2184
    assert int.from_bytes(j[pages[-1] + 6:pages[-1] + 14], "little") == \
        6 * BLOCK
