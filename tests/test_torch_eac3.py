"""E-AC-3 and 5.1 AC-3 in both packages on the CPU, on the streams that
tools/torch_port_ac3_fixtures.py wrote with libavcodec's encoders
(tests/data/torch_port/acodecs/: E-AC-3 stereo 48 kHz 192 kb/s, E-AC-3
5.1 384 kb/s, AC-3 5.1 with LFE 448 kb/s with channel coupling in every
block, E-AC-3 stereo 44.1 kHz; 1 s each), beside libavcodec's float
decode of each (every 16th sample):

- the port's raw AC-3/E-AC-3 demuxer gives the JAX demuxer's packets
  (bytes, pts, duration, codec_id; E-AC-3's frame size from frmsiz with
  6 blocks); for AC-3 it counts the LFE channel, which the JAX demuxer
  drops (5 channels for 5.1; asserted below, ROADMAP.md section 3b);
- the port's decoder gives the JAX decoder's float samples on every
  frame, equal float for float (the same host numpy), in libavcodec's
  channel order (FL FR FC LFE SL SR), one 6 x 1536 upload a frame;
- both reach libavcodec's decode at tests/test_eac3.py's SNR: more than
  80 dB on the stereo tones, more than 70 dB on 5.1, every channel.
  At 44.1 kHz both read 63.7 dB: the decoders put zeros where
  libavcodec puts its dither noise (bap-0 mantissas), and the frame in
  which the tones stop has many of them. With libavcodec's dither
  generator patched into the JAX decoder every stream reads 98.7-99.9 dB
  (ROADMAP.md section 3b);
- `-c:a pcm_s16le` and `-f framemd5` through both CLIs give equal
  bytes, but that the JAX package's WAV header for 5.1 AC-3 says five
  channels over six-channel data; `-c:a copy` into Matroska gives the
  same packets. Both write a six-channel WAV with a plain PCM fmt chunk
  (no WAVE_FORMAT_EXTENSIBLE channel mask) and name every layout
  "stereo" in framemd5; the tests below assert both faults on the JAX
  side (ROADMAP.md section 3b).
"""
import hashlib
import os
import struct

import numpy as np
import pytest

from librempeg_tpu.cli import ffmpeg as JCLI
from librempeg_tpu.codecs.ac3 import decoder as JAC3
from librempeg_tpu.codecs.api import find_decoder as jfind
from librempeg_tpu.formats.api import open_input as jopen
from librempeg_tpu_torch.cli import ffmpeg as TCLI
from librempeg_tpu_torch.codecs.ac3 import decoder as TAC3
from librempeg_tpu_torch.codecs.api import find_decoder as tfind
from librempeg_tpu_torch.formats.api import open_input as topen

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port",
                    "acodecs")
# stream -> (codec_id, rate, channels, packets, SNR floor or None)
STREAMS = {
    "eac3_stereo.eac3": ("eac3", 48000, 2, 32, 80.0),
    "eac3_51.eac3": ("eac3", 48000, 6, 32, 70.0),
    "ac3_51.ac3": ("ac3", 48000, 6, 32, 70.0),
    "eac3_44k.eac3": ("eac3", 44100, 2, 29, None),
}


def path(name):
    return os.path.join(DATA, name)


def oracle(name):
    z = np.load(path(name) + ".npz")
    return z["pcm"], int(z["step"])


def snr_db(x, ref, step):
    """Per-channel and overall SNR of x [ch, n] against libavcodec's
    every-`step`th sample."""
    y = x[:, ::step][:, :ref.shape[1]]
    assert y.shape == ref.shape
    e = (y.astype(np.float64) - ref) ** 2
    r = ref.astype(np.float64) ** 2
    return (10 * np.log10(r.sum(1) / e.sum(1)),
            float(10 * np.log10(r.sum() / e.sum())))


def jax_decode(name):
    d = jopen(path(name))
    dec = jfind(d.streams[0].codecpar.codec_id)(d.streams[0].codecpar)
    return [f for p in d.packets() for f in dec.decode(p)]


def port_decode(name):
    d = topen(path(name))
    dec = tfind(d.streams[0].codecpar.codec_id)(d.streams[0].codecpar,
                                                 device="cpu")
    return [f for p in d.packets() for f in dec.decode(p)]


@pytest.mark.parametrize("name", STREAMS)
def test_demuxer_packets_match_jax(name):
    codec_id, rate, ch, npk, _ = STREAMS[name]
    jd, td = jopen(path(name)), topen(path(name))
    assert td.NAME == jd.NAME == "ac3"
    jpar, tpar = jd.streams[0].codecpar, td.streams[0].codecpar
    assert (tpar.codec_id, tpar.sample_rate, tpar.nb_channels,
            tpar.frame_size) == (codec_id, rate, ch, 1536)
    # the JAX demuxer counts no AC-3 LFE channel (the test below)
    assert (jpar.codec_id, jpar.sample_rate, jpar.frame_size,
            jpar.nb_channels + (name == "ac3_51.ac3")) == \
        (codec_id, rate, 1536, ch)
    jp = [(p.pts, p.duration, bytes(p.data)) for p in jd.packets()]
    tp = [(p.pts, p.duration, bytes(p.data)) for p in td.packets()]
    assert tp == jp and len(tp) == npk
    assert [p[0] for p in tp] == [i * 1536 for i in range(npk)]
    assert b"".join(p[2] for p in tp) == open(path(name), "rb").read()


@pytest.mark.parametrize("name", STREAMS)
def test_decoder_matches_jax_and_libavcodec(name):
    _, rate, ch, npk, floor = STREAMS[name]
    jf, tf = jax_decode(name), port_decode(name)
    assert len(tf) == len(jf) == npk
    for j, t in zip(jf, tf):
        assert (t.pts, t.sample_rate, t.sample_fmt) == \
            (j.pts, j.sample_rate, j.sample_fmt)
        assert t.data.device.type == "cpu" and t.data.is_contiguous()
        assert tuple(t.data.shape) == (ch, 1536)
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    x = np.concatenate([t.data.numpy() for t in tf], 1)
    assert np.isfinite(x).all()
    ref, step = oracle(name)
    per_ch, total = snr_db(x, ref, step)
    print(f"{name}: SNR {total:.2f} dB against libavcodec, per channel "
          f"{np.round(per_ch, 2).tolist()}")
    if floor is None:
        # the zero-dither fault, in both packages (see the docstring)
        assert 55.0 < total < 80.0
    else:
        assert total > floor and per_ch.min() > floor


def test_ac3_51_uses_coupling_in_every_block():
    """acmod 7 with LFE, the coupling branch taken in all 192 blocks
    (the port's decoder, whose samples equal the JAX decoder's)."""
    d = TAC3.Ac3FrameDecoder()
    blocks = coupled = 0
    decode_block = d._decode_block

    def count(br, blk):
        nonlocal blocks, coupled
        pcm = decode_block(br, blk)
        blocks += 1
        coupled += any(d.channel_in_cpl[1:d.fbw + 1])
        return pcm

    d._decode_block = count
    for p in topen(path("ac3_51.ac3")).packets():
        d.decode_frame(bytes(p.data))
    assert (d.acmod, d.lfeon, d.fbw) == (7, 1, 5)
    assert blocks == coupled == 192


class _LavuLFG:
    """libavutil's av_lfg_init(seed)/av_lfg_get: the generator of
    ac3dec.c's dither."""

    def __init__(self, seed=0):
        self.state, tmp = [0] * 64, bytearray(16)
        for i in range(8, 64, 4):
            tmp[0:4] = struct.pack("<I", seed)
            tmp[4] = i
            tmp = bytearray(hashlib.md5(bytes(tmp)).digest())
            self.state[i:i + 4] = struct.unpack("<4I", bytes(tmp))
        self.index = 0

    def get(self):
        s, i = self.state, self.index
        s[i & 63] = (s[(i - 24) & 63] + s[(i - 55) & 63]) & 0xFFFFFFFF
        self.index += 1
        return s[i & 63]


def test_jax_decoder_zeroes_the_dither(monkeypatch):
    """The JAX decoder's fault at 44.1 kHz: below tests/test_eac3.py's
    80 dB. ac3dec.c fills each bap-0 mantissa of a dithered channel
    (and of the coupling channel) with ((lfg >> 8) * 181 >> 8) -
    5931008 in Q23; with that filled in, in read order, every stream
    reads above 95 dB, so the zeros are the whole gap."""
    ref, step = oracle("eac3_44k.eac3")
    x = np.concatenate([np.asarray(f.data)
                        for f in jax_decode("eac3_44k.eac3")], 1)
    assert snr_db(x, ref, step)[1] < 80.0
    plain = JAC3.Ac3FrameDecoder._decode_mantissas_block

    def dithered(self, br, order):
        plain(self, br, order)
        lfg = self.__dict__.setdefault("_lfg", _LavuLFG(0))
        st = self.st
        for ch, out in order:
            if ch == self.lfe_ch or not (ch == 0 or self.dither_flag[ch]):
                continue
            for f in range(st.start_freq[ch], st.end_freq[ch]):
                if st.bap[ch][f] == 0:
                    m = (((lfg.get() >> 8) * 181) >> 8) - 5931008
                    out[f] = m / 2.0 ** 23 * 2.0 ** -float(st.dexps[ch][f])

    monkeypatch.setattr(JAC3.Ac3FrameDecoder, "_decode_mantissas_block",
                        dithered)
    for name in STREAMS:
        x = np.concatenate([np.asarray(f.data) for f in jax_decode(name)], 1)
        per_ch, total = snr_db(x, *oracle(name))
        assert total > 95.0 and per_ch.min() > 90.0, (name, total)


def _both(tmp_path, name, args, ext):
    out = {}
    for tag, cli, dev in (("j", JCLI, []), ("t", TCLI, ["-device", "cpu"])):
        o = tmp_path / f"{tag}.{ext}"
        assert cli.main(["-i", path(name), *args, *dev, "-y", str(o)]) == 0
        out[tag] = o.read_bytes()
    return out["j"], out["t"]


@pytest.mark.parametrize("name", STREAMS)
def test_cli_matches_jax(tmp_path, name):
    _, rate, ch, npk, _ = STREAMS[name]
    j, t = _both(tmp_path, name, ["-c:a", "pcm_s16le"], "wav")
    # the JAX package's header for 5.1 AC-3 takes the demuxer's five
    # channels over six-channel data (the LFE test above)
    jch = ch - (name == "ac3_51.ac3")
    for b, n in ((t, ch), (j, jch)):
        assert struct.unpack("<4sIHHIIHH", b[12:36]) == \
            (b"fmt ", 16, 1, n, rate, rate * 2 * n, 2 * n, 16)
    assert t[36:] == j[36:] and t[:12] == j[:12]
    s16 = np.frombuffer(t[44:], "<i2").reshape(-1, ch).T
    x = np.concatenate([f.data.numpy() for f in port_decode(name)], 1)
    np.testing.assert_array_equal(
        s16, np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16))
    j, t = _both(tmp_path, name, ["-f", "framemd5"], "md5")
    assert t == j and len(t.decode().splitlines()) == 8 + npk


def test_ac3_copy_into_matroska(tmp_path):
    """The same packets in both files; the port's track says 6 channels,
    the JAX package's 5 (its demuxer's count, the test below)."""
    j, t = _both(tmp_path, "ac3_51.ac3", ["-c:a", "copy"], "mkv")
    stream = open(path("ac3_51.ac3"), "rb").read()
    for f, want in (("t.mkv", 6), ("j.mkv", 5)):
        d = topen(str(tmp_path / f))
        par = d.streams[0].codecpar
        assert (par.codec_id, par.sample_rate, par.nb_channels) == \
            ("ac3", 48000, want)
        assert b"".join(bytes(p.data) for p in d.packets()) == stream
    assert len(t) == len(j)


def test_jax_ac3_demuxer_drops_the_lfe_channel():
    """A/52's lfeon sits after cmixlev, surmixlev and dsurmod, each
    present for some acmods; the JAX demuxer reads acmod only, so 5.1
    (acmod 7, lfeon 1) is 5 channels there and 6 in the port, as the
    decoder's frames have."""
    jpar = jopen(path("ac3_51.ac3")).streams[0].codecpar
    tpar = topen(path("ac3_51.ac3")).streams[0].codecpar
    assert (jpar.nb_channels, tpar.nb_channels) == (5, 6)
    assert port_decode("ac3_51.ac3")[0].data.shape[0] == 6


def test_jax_six_channel_wav_has_no_channel_mask(tmp_path):
    """libavformat's riffenc.c writes WAVE_FORMAT_EXTENSIBLE (tag
    0xFFFE, a 40-byte fmt chunk with the channel mask 0x60F of 5.1)
    for six channels; the JAX package writes a 16-byte PCM fmt chunk,
    and the port, held to it, does too."""
    j, t = _both(tmp_path, "eac3_51.eac3", ["-c:a", "pcm_s16le"], "wav")
    for b in (j, t):
        assert b[12:16] == b"fmt " and struct.unpack("<I", b[16:20])[0] == 16
        assert struct.unpack("<HH", b[20:24]) == (1, 6)


def test_jax_framemd5_names_every_layout_stereo(tmp_path):
    """libavformat names a 5.1 stream's layout "5.1(side)" in framemd5;
    both packages write "stereo" whatever the channel count."""
    j, t = _both(tmp_path, "ac3_51.ac3", ["-f", "framemd5"], "md5")
    for b in (j, t):
        assert b"#channel_layout_name 0: stereo\n" in b
