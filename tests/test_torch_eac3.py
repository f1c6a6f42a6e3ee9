"""E-AC-3 and 5.1 AC-3 in both packages on the CPU, on the streams that
tools/torch_port_ac3_fixtures.py wrote with libavcodec's encoders
(tests/data/torch_port/acodecs/: E-AC-3 stereo 48 kHz 192 kb/s, E-AC-3
5.1 384 kb/s, AC-3 5.1 with LFE 448 kb/s with channel coupling in every
block, E-AC-3 stereo 44.1 kHz; 1 s each), beside libavcodec's float
decode of each (every 16th sample) and what
tools/torch_port_libav_fixtures.py recorded of libavcodec and
libavformat (libav_layouts.json):

- the port's raw AC-3/E-AC-3 demuxer gives the JAX demuxer's packets
  (bytes, pts, duration, codec_id; E-AC-3's frame size from frmsiz with
  6 blocks); for AC-3 it counts the LFE channel, which the JAX demuxer
  drops (5 channels for 5.1; asserted below, ROADMAP.md section 3b),
  and it carries the layout libavformat's demuxer gives (5.1(side));
- the port's decoder fills libavcodec's dither into the bap-0
  mantissas, where the JAX decoder puts zeros: its float samples equal,
  float for float, the JAX decoder's with the same dither patched in
  (tools/ac3_jax_dither.py), in libavcodec's channel order (FL FR FC
  LFE SL SR) and layout, one 6 x 1536 upload a frame;
- the port reads more than 95 dB against libavcodec's decode on every
  stream, more than 90 dB in every channel. The JAX decoder reads 63.7
  dB at 44.1 kHz (the frame in which the tones stop has many dithered
  mantissas), and above 95 dB with the dither patched in: the zeros are
  the whole gap (ROADMAP.md section 3b);
- the generator is carried across frames and kept by a flush, as
  libavcodec keeps it through avcodec_flush_buffers; a -ss seek and a
  resumed snapshot start a fresh decoder at the frame, as ffmpeg's -ss
  does;
- `-c:a pcm_s16le` and `-f framemd5` through both CLIs give the same
  samples (the JAX decoder patched); the port's WAV header is
  libavformat's (WAVE_FORMAT_EXTENSIBLE, mask 0x60F, for 5.1) and its
  framemd5 names the layout as libavformat does, where the JAX package
  writes a plain PCM fmt chunk (with five channels for 5.1 AC-3) and
  calls every layout "stereo" (both faults asserted on the JAX side);
  `-c:a copy` into Matroska gives the same packets.
"""
import json
import os
import struct

import numpy as np
import pytest

from librempeg_tpu.cli import ffmpeg as JCLI
from librempeg_tpu.codecs.api import find_decoder as jfind
from librempeg_tpu.formats.api import open_input as jopen
from librempeg_tpu_torch.cli import ffmpeg as TCLI
from librempeg_tpu_torch.codecs.ac3 import decoder as TAC3
from librempeg_tpu_torch.codecs.api import find_decoder as tfind
from librempeg_tpu_torch.core.samplefmt import ChannelLayout
from librempeg_tpu_torch.formats.api import open_input as topen
from librempeg_tpu_torch.sched import checkpoint as TCK
from librempeg_tpu_torch.sched import pipeline as TP

from tools.ac3_jax_dither import LavuLFG, dithered
from tools.audio_jax_repair import framemd5_repaired

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port",
                    "acodecs")
LIBAV = json.load(open(os.path.join(os.path.dirname(DATA),
                                    "libav_layouts.json")))
# stream -> (codec_id, rate, channels, packets, the libavformat WAV case
# of its s16 decode)
STREAMS = {
    "eac3_stereo.eac3": ("eac3", 48000, 2, 32, "s16_eac3_stereo"),
    "eac3_51.eac3": ("eac3", 48000, 6, 32, "s16_eac3_51"),
    "ac3_51.ac3": ("ac3", 48000, 6, 32, "s16_ac3_51"),
    "eac3_44k.eac3": ("eac3", 44100, 2, 29, "s16_eac3_44k"),
}
SNR_DB, SNR_CH_DB = 95.0, 90.0   # against libavcodec: overall, each channel


def path(name):
    return os.path.join(DATA, name)


def oracle(name):
    z = np.load(path(name) + ".npz")
    return z["pcm"], int(z["step"])


def libav_layout(name, who="decoder"):
    """The layout libavcodec's decoder (or libavformat's demuxer)
    reports for a stream."""
    lay = LIBAV["ac3"][name][who]
    assert lay["order"] == 1           # AV_CHANNEL_ORDER_NATIVE
    return ChannelLayout(lay["nb_channels"], lay["mask"]), lay["name"]


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


def port_decode(name, packets=None, dec=None):
    d = topen(path(name))
    if dec is None:
        dec = tfind(d.streams[0].codecpar.codec_id)(d.streams[0].codecpar,
                                                     device="cpu")
    return [f for p in (packets or list(d.packets())) for f in dec.decode(p)]


def joined(frames):
    return np.concatenate([np.asarray(f.data) for f in frames], 1)


@pytest.mark.parametrize("name", STREAMS)
def test_demuxer_packets_match_jax(name):
    codec_id, rate, ch, npk, _ = STREAMS[name]
    jd, td = jopen(path(name)), topen(path(name))
    assert td.NAME == jd.NAME == "ac3"
    jpar, tpar = jd.streams[0].codecpar, td.streams[0].codecpar
    assert (tpar.codec_id, tpar.sample_rate, tpar.nb_channels,
            tpar.frame_size) == (codec_id, rate, ch, 1536)
    # libavformat's raw demuxer reports the layout of acmod and lfeon
    assert tpar.ch_layout == libav_layout(name, "demuxer")[0]
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
    _, rate, ch, npk, _ = STREAMS[name]
    with dithered():
        jf = jax_decode(name)
    tf = port_decode(name)
    assert len(tf) == len(jf) == npk
    layout, _ = libav_layout(name)
    for j, t in zip(jf, tf):
        assert (t.pts, t.sample_rate, t.sample_fmt) == \
            (j.pts, j.sample_rate, j.sample_fmt)
        assert t.data.device.type == "cpu" and t.data.is_contiguous()
        assert tuple(t.data.shape) == (ch, 1536)
        assert t.layout == layout
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    x = joined(tf)
    assert np.isfinite(x).all()
    ref, step = oracle(name)
    per_ch, total = snr_db(x, ref, step)
    print(f"{name}: SNR {total:.2f} dB against libavcodec, per channel "
          f"{np.round(per_ch, 2).tolist()}")
    assert total > SNR_DB and per_ch.min() > SNR_CH_DB


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


def test_lagged_fibonacci_is_libavutils():
    """The port's generator, drawn in runs of every length its step
    splits (0, 1, 23-25, 55, several steps), gives libavutil's
    av_lfg_get sequence from av_lfg_init(0), and from another seed."""
    for seed in (0, 12345):
        ref, gen = LavuLFG(seed), TAC3.LaggedFibonacci(seed)
        runs = [1, 23, 24, 25, 0, 55, 100, 1, 771]
        got = np.concatenate([gen.get(n) for n in runs])
        want = np.array([ref.get() for _ in range(sum(runs))], np.uint32)
        np.testing.assert_array_equal(got, want)


def test_jax_decoder_zeroes_the_dither():
    """The JAX decoder's fault at 44.1 kHz: below tests/test_eac3.py's
    80 dB. ac3dec.c fills each bap-0 mantissa of a dithered channel
    (and of the coupling channel) with ((lfg >> 8) * 181 >> 8) -
    5931008 in Q23; with that filled in, in read order, every stream
    reads above 95 dB, so the zeros are the whole gap."""
    ref, step = oracle("eac3_44k.eac3")
    x = joined(jax_decode("eac3_44k.eac3"))
    assert snr_db(x, ref, step)[1] < 80.0
    with dithered():
        for name in STREAMS:
            per_ch, total = snr_db(joined(jax_decode(name)), *oracle(name))
            assert total > SNR_DB and per_ch.min() > SNR_CH_DB, (name, total)


RESTART_AT = 10      # the flush oracle's packet (libav_layouts.json)


def _restart(how, tmp_path):
    """The port's decode of eac3_44k from packet RESTART_AT on, after
    a flush of a decoder that decoded the packets before it (reset, the
    avcodec_flush_buffers analog), after a -ss seek into that packet
    through the CLI, or after a snapshot taken there and restored."""
    name = "eac3_44k.eac3"
    pk = list(topen(path(name)).packets())
    if how == "flush":
        dec = tfind("eac3")(topen(path(name)).streams[0].codecpar,
                            device="cpu")
        port_decode(name, pk[:RESTART_AT], dec)
        dec.reset()
        return joined(port_decode(name, pk[RESTART_AT:], dec))
    out = tmp_path / "o.wav"
    if how == "seek":
        t = (RESTART_AT * 1536 + 100) / 44100
        assert TCLI.main(["-ss", f"{t:.6f}", "-i", path(name), "-c:a",
                          "pcm_f32le", "-device", "cpu", "-y",
                          str(out)]) == 0
    else:
        def spec(o):
            return TP.TranscodeSpec(
                input_url=path(name), output_url=str(o), device="cpu",
                audio=TP.StreamMap(codec="pcm_f32le"))

        tc = TP.Transcoder(spec(tmp_path / "cut.wav"))
        for i, p in enumerate(tc.demux.packets()):
            tc.chains[p.stream_index].send_packet(p, tc.mux)
            if i + 1 == RESTART_AT:
                break
        blob = TCK.snapshot(tc)
        tc = TP.Transcoder(spec(out))
        TCK.restore(tc, blob)
        tc.run()
    d = topen(str(out))
    assert d.streams[0].codecpar.codec_id == "pcm_f32le"
    return joined(port_decode(str(out), dec=tfind("pcm_f32le")(
        d.streams[0].codecpar, device="cpu")))


@pytest.mark.parametrize("how", ["flush", "seek", "resume"])
def test_dither_generator_at_a_restart(how, tmp_path):
    """libavcodec 59 keeps the generator (and the overlap) through
    avcodec_flush_buffers: a flushed decoder decodes the next packet as
    one that was never flushed (libav_layouts.json: equal). ffmpeg's -ss
    seeks before it opens its decoder, which so starts at the seek's
    frame with its generator at the seed. The port's reset() keeps the
    state; its -ss seeks the raw stream before its decoder sees a
    packet; a resumed snapshot carries no decoder state, so it restarts
    the generator as -ss does. Each is held to libavcodec's decode of
    the same kind (flushed or fresh, every 16th sample) above 95 dB,
    and exactly to the port's own decode of that kind."""
    flush = LIBAV["ac3"]["eac3_44k.eac3"]["flush"]
    assert flush["at"] == RESTART_AT and flush["equals_continued"] \
        and not flush["equals_fresh"]
    z = np.load(path("eac3_44k.eac3.flush.npz"))
    assert int(z["at"]) == RESTART_AT
    x = _restart(how, tmp_path)
    pk = list(topen(path("eac3_44k.eac3")).packets())
    if how == "flush":
        want = joined(port_decode("eac3_44k.eac3"))[:, RESTART_AT * 1536:]
    else:
        want = joined(port_decode("eac3_44k.eac3", pk[RESTART_AT:]))
    np.testing.assert_array_equal(x, want)
    per_ch, total = snr_db(x, z["flushed" if how == "flush" else "fresh"],
                           int(z["step"]))
    assert total > SNR_DB and per_ch.min() > SNR_CH_DB, (how, total)


def _both(tmp_path, name, args, ext):
    out = {}
    for tag, cli, dev in (("j", JCLI, []), ("t", TCLI, ["-device", "cpu"])):
        o = tmp_path / f"{tag}.{ext}"
        with dithered():
            assert cli.main(["-i", path(name), *args, *dev, "-y",
                             str(o)]) == 0
        out[tag] = o.read_bytes()
    return out["j"], out["t"]


@pytest.mark.parametrize("name", STREAMS)
def test_cli_matches_jax(tmp_path, name):
    """The data chunk and framemd5 hashes equal the patched JAX
    package's; the port's WAV header is libavformat's, byte for byte,
    and its framemd5 layout line libavformat's name."""
    _, rate, ch, npk, case = STREAMS[name]
    j, t = _both(tmp_path, name, ["-c:a", "pcm_s16le"], "wav")
    # the JAX package's header for 5.1 AC-3 takes the demuxer's five
    # channels over six-channel data (the LFE test above)
    jch = ch - (name == "ac3_51.ac3")
    assert struct.unpack("<4sIHHIIHH", j[12:36]) == \
        (b"fmt ", 16, 1, jch, rate, rate * 2 * jch, 2 * jch, 16)
    want = LIBAV["wav"][case]
    head = bytes.fromhex(want["header"])
    assert t[:len(head)] == head and len(t) == want["size"]
    assert t[len(head):] == j[44:]
    s16 = np.frombuffer(t[len(head):], "<i2").reshape(-1, ch).T
    x = joined(port_decode(name))
    np.testing.assert_array_equal(
        s16, np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16))
    j, t = _both(tmp_path, name, ["-f", "framemd5"], "md5")
    # the JAX header stops before libavformat's last line (section 3b)
    jl = framemd5_repaired(j.decode()).splitlines()
    tl = t.decode().splitlines()
    assert len(tl) == len(jl) == 9 + npk
    k = tl.index(f"#channel_layout_name 0: {libav_layout(name)[1]}")
    assert jl[k] == "#channel_layout_name 0: stereo"
    assert tl[:k] + tl[k + 1:] == jl[:k] + jl[k + 1:]


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
    0xFFFE, a 40-byte fmt chunk with the channel mask 0x60F of
    5.1(side)) for six channels; the JAX package writes a 16-byte PCM
    fmt chunk. The port writes libavformat's header."""
    j, t = _both(tmp_path, "eac3_51.eac3", ["-c:a", "pcm_s16le"], "wav")
    assert j[12:16] == b"fmt " and struct.unpack("<I", j[16:20])[0] == 16
    assert struct.unpack("<HH", j[20:24]) == (1, 6)
    head = bytes.fromhex(LIBAV["wav"]["s16_eac3_51"]["header"])
    assert t[:len(head)] == head
    assert struct.unpack("<IHH", t[16:24]) == (40, 0xFFFE, 6)
    assert struct.unpack("<I", t[40:44])[0] == 0x60F


def test_jax_framemd5_names_every_layout_stereo(tmp_path):
    """libavformat names a 5.1 stream's layout "5.1(side)" in framemd5;
    the JAX package writes "stereo" whatever the channel count, the
    port libavformat's name."""
    j, t = _both(tmp_path, "ac3_51.ac3", ["-f", "framemd5"], "md5")
    assert b"#channel_layout_name 0: stereo\n" in j
    want = LIBAV["framemd5"]["5.1(side)"]
    line = next(ln for ln in want.splitlines()
                if ln.startswith("#channel_layout_name"))
    assert line == "#channel_layout_name 0: 5.1(side)"
    assert (line + "\n").encode() in t
