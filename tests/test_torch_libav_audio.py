"""The port's MP2, MP3 and Vorbis decoders held to libavcodec 59 on the
CPU, and the faults of the JAX package's decoders that the port does
not copy (ROADMAP.md section 3b).

The oracle is committed: tests/data/torch_port/libav_audio.json and
acodecs/<stream>.libav.npz, written by tools/torch_port_libav_audio.py
with libavformat 59.27 and libavcodec 59.37 (every packet's pts,
duration and AV_PKT_DATA_SKIP_SAMPLES; every decoded frame's pts and
length; every 15th sample and a few whole frames).

- MP2: libavcodec's default decoder is fixed point with s16 output; the
  port's float output converted to s16 as pcm_s16le converts it is
  within 1 LSB of it on every committed sample, frame for frame.
- MP3: libavformat trims the LAME tag's encoder delay plus the decoder's
  529 samples at the start and the padding less 529 at the end; the
  port's packets, frames and samples are libavcodec's (mp3float) at 115
  dB or more on every channel. The start skip is applied once: not
  again after -ss, on a resumed run, or in a -c:a copy's decode; an MP3
  without a LAME tag is not trimmed.
- Vorbis: every frame at 100 dB or more, the whole stream at 110 dB or
  more, libavcodec's sample count and frame lengths.
- The JAX side: its MP2/MP3 window and 481-sample trim read about 32
  dB against libavcodec, its MP3 keeps the LAME delay and padding, its
  Vorbis frames diverge from the 16th on; what the repairs leave alone
  (the subband samples before synthesis, the Vorbis frames before the
  fault) equals the JAX package's.
"""
import json
import os

import numpy as np
import pytest
import torch

from librempeg_tpu.codecs import mp3dec as JM3
from librempeg_tpu.codecs import mpegaudio as JMA
from librempeg_tpu.codecs.api import find_decoder as jfind
from librempeg_tpu.formats.api import open_input as jopen
from librempeg_tpu_torch.cli import ffmpeg as TCLI
from librempeg_tpu_torch.codecs import mp3dec as TM3
from librempeg_tpu_torch.codecs import mpegaudio as TMA
from librempeg_tpu_torch.codecs.api import find_decoder as tfind
from librempeg_tpu_torch.codecs.pcm import from_float
from librempeg_tpu_torch.formats.api import open_input as topen
from librempeg_tpu_torch.sched import checkpoint as TCK
from librempeg_tpu_torch.sched import pipeline as TP

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")
FX = os.path.join(DATA, "acodecs")
LIBAV = json.load(open(os.path.join(DATA, "libav_audio.json")))
MP3_SNR_DB = 115.0              # every channel, against mp3float
VORBIS_FRAME_SNR_DB = 100.0     # every frame
VORBIS_SNR_DB = 110.0           # the whole stream


def oracle(key):
    z = np.load(os.path.join(FX, key + ".libav.npz"))
    return {k: z[k] for k in z.files}


def port_frames(name, packets=None):
    d = topen(os.path.join(FX, name))
    par = d.streams[0].codecpar
    dec = tfind(par.codec_id)(par, device="cpu")
    frames = [f for p in (packets or d.packets()) for f in dec.decode(p)]
    d.close()
    return frames + dec.flush()


def joined(frames):
    return torch.cat([f.data for f in frames], 1).numpy()


def frame_list(frames):
    return [[int(f.pts), f.nb_samples] for f in frames]


def snr_db(x, ref, axis=None):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return 10 * np.log10((ref ** 2).sum(axis) / ((x - ref) ** 2).sum(axis))


def test_the_oracle_is_libavs():
    assert LIBAV["versions"] == ["Lavu57.28.100", "Lavc59.37.100",
                                 "Lavf59.27.100"]
    dec = LIBAV["decodes"]
    assert (dec["mp2"]["decoder"], dec["mp2"]["sample_fmt"]) == \
        ("mp2", "s16p")
    assert {dec[k]["decoder"] for k in ("mp3", "mp3_mono32k")} == \
        {"mp3float"}
    assert [dec[k]["samples"] for k in ("mp2", "mp3", "mp3_mono32k",
                                        "vorbis")] == \
        [240768, 220500, 32000, 220500]


def test_mp2_is_libavcodecs_to_one_lsb():
    info, z = LIBAV["decodes"]["mp2"], oracle("mp2")
    frames = port_frames("mp2.mp2")
    assert frame_list(frames) == info["frames"]
    s16 = from_float(torch.from_numpy(joined(frames)), "s16p").numpy()
    s16 = s16.astype(np.int64)
    assert s16.shape == (2, info["samples"])
    step = int(z["step"])
    ref = np.rint(z["pcm"].astype(np.float64) * 32768).astype(np.int64)
    assert np.abs(s16[:, ::step] - ref).max() <= 1
    n = frames[0].nb_samples
    for k in (k for k in z if k.startswith("full_")):
        i = int(k[5:])
        full = np.rint(z[k].astype(np.float64) * 32768).astype(np.int64)
        assert np.abs(s16[:, i * n:(i + 1) * n] - full).max() <= 1, i


@pytest.mark.parametrize("key", ["mp3", "mp3_mono32k"])
def test_mp3_is_libavcodecs(key):
    info, z = LIBAV["decodes"][key], oracle(key)
    name = info["src"]
    lame = LIBAV["lame"][name]
    d = topen(os.path.join(FX, name))
    assert d.streams[0].start_time == info["start_time"] \
        == lame["delay"] + 529
    packets = list(d.packets())
    d.close()
    sd = [p.side_data.get("skip_samples") for p in packets]
    assert [[p.pts, p.duration, len(p.data), s.start if s else 0,
             s.end if s else 0] for p, s in zip(packets, sd)] == \
        info["packets"]
    assert info["packets"][-1][4] == lame["padding"] - 529
    frames = port_frames(name, packets)
    assert frame_list(frames) == info["frames"]
    x = joined(frames)
    assert x.shape[1] == info["samples"]
    step = int(z["step"])
    assert snr_db(x[:, ::step], z["pcm"], 1).min() >= MP3_SNR_DB
    # mpegaudio.OUTPUT_GAIN: the least-squares gain against libavcodec
    ref = z["pcm"].astype(np.float64)
    gain = (x[:, ::step] * ref).sum() / (ref ** 2).sum()
    assert abs(gain - 1) < 1e-5
    starts = np.cumsum([0] + [n for _, n in info["frames"]])
    for k in (k for k in z if k.startswith("full_")):
        i = int(k[5:])
        got = x[:, starts[i]:starts[i + 1]]
        assert snr_db(got, z[k], 1).min() >= MP3_SNR_DB, i


def vorbis_frames():
    return port_frames("vorbis.ogg")


def test_vorbis_is_libavcodecs():
    info, z = LIBAV["decodes"]["vorbis"], oracle("vorbis")
    frames = vorbis_frames()
    assert [n for _, n in frame_list(frames)] == \
        [n for _, n in info["frames"]]
    x = joined(frames)
    assert x.shape == (2, info["samples"]) == (2, 220500)
    step, ref = int(z["step"]), z["pcm"]
    assert snr_db(x[:, ::step], ref) >= VORBIS_SNR_DB
    at = 0
    for i, (_, n) in enumerate(info["frames"]):
        sel = np.arange(at, at + n)
        sel = sel[sel % step == 0]
        assert snr_db(x[:, sel], ref[:, sel // step]) >= \
            VORBIS_FRAME_SNR_DB, i
        if f"full_{i}" in z:
            assert snr_db(x[:, at:at + n], z[f"full_{i}"]) >= \
                VORBIS_FRAME_SNR_DB, i
        at += n


def test_vorbis_packets_are_timed_as_libavformat():
    """Every packet's pts and length as libavformat's, and the end trim;
    but for the short blocks after a long one inside a page, where
    oggparsevorbis.c times the packet from the page's granule with its
    parser reset (a short block before it): there libavformat's pts is
    448 samples later and its duration 128, where the decoder returns
    576 samples; the port keeps the decoder's timeline."""
    info = LIBAV["decodes"]["vorbis"]
    d = topen(os.path.join(FX, "vorbis.ogg"))
    packets = list(d.packets())
    d.close()
    got = [[p.pts, p.duration, len(p.data),
            p.side_data["skip_samples"].end if p.side_data else 0]
           for p in packets]
    want = [[a, b, c, e] for a, b, c, _, e in info["packets"]]
    assert len(got) == len(want) == 240
    assert got[0][:2] == [-128, 128] and got[-1] == want[-1]
    assert want[-1][3] == 44
    moved = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    assert moved == [16, 72, 122, 172, 222]
    for i in moved:
        assert (got[i][1], want[i][1], want[i][0] - got[i][0]) == \
            (576, 128, 448)
        assert got[i + 1][0] == want[i + 1][0]
    frames = frame_list(vorbis_frames())
    assert [i for i, (g, w) in enumerate(zip(frames, info["frames"]))
            if g != w] == [i - 1 for i in moved]


# ---------------------------------------------------------------------------
# the MP3 start skip, once
# ---------------------------------------------------------------------------

def cli_pcm(args, out):
    assert TCLI.main([*args, "-c:a", "pcm_f32le", "-device", "cpu", "-y",
                      str(out)]) == 0
    d = topen(str(out))
    x = np.frombuffer(b"".join(bytes(p.data) for p in d.packets()),
                      "<f4")
    d.close()
    return x.reshape(-1, 2).T


def test_mp3_skip_not_again_after_ss(tmp_path):
    """-ss 0.5 counts from the stream's start time (1105 samples, as
    ffmpeg's -ss does) and seeks to the packet that holds it (pts 23040,
    where libavformat's seek goes too): no start skip there. The main
    data of that frame and the next began in the packets before the
    seek, so the port's decoder gives them no samples (libavcodec gives
    1152 each with their unreachable granules zeroed, ROADMAP.md section
    3a); from the third frame on the frames are libavcodec's, untrimmed,
    and from the fifth the samples are the whole decode's."""
    src = os.path.join(FX, "mp3.mp3")
    full = cli_pcm(["-i", src], tmp_path / "full.wav")
    cut = cli_pcm(["-ss", "0.5", "-i", src], tmp_path / "ss.wav")
    seek = LIBAV["decodes"]["mp3_seek"]
    assert seek["frames"][0] == [23040, 1152]
    assert seek["packets"][0][:2] == [23040, 1152]
    assert cut.shape[1] == seek["samples"] - 2 * 1152 == 196261
    np.testing.assert_array_equal(cut[:, 2304:],
                                  full[:, full.shape[1] - 196261 + 2304:])


def test_mp3_skip_not_again_in_a_copy(tmp_path):
    """-c:a copy into Matroska keeps the end trim (DiscardPadding) and
    not the start skip, as libavformat's copy does; its decode is
    libavcodec's decode of that copy, frame for frame."""
    src = os.path.join(FX, "mp3.mp3")
    assert TCLI.main(["-i", src, "-c:a", "copy", "-device", "cpu", "-y",
                      str(tmp_path / "c.mkv")]) == 0
    d = topen(str(tmp_path / "c.mkv"))
    packets = list(d.packets())
    d.close()
    copy = LIBAV["decodes"]["mp3_copy_mkv"]
    # Matroska's milliseconds (the port's muxer floors them where
    # libavformat rounds: within a millisecond)
    assert len(packets) == len(copy["packets"]) == 193
    assert all(abs(p.pts * 44.1 - pts) < 45
               for p, (pts, *_) in zip(packets, copy["packets"]))
    assert [(p.side_data["skip_samples"].end if p.side_data else 0)
            for p in packets] == [e for *_, e in copy["packets"]]
    frames = port_frames("mp3.mp3", packets)
    assert [n for _, n in frame_list(frames)] == \
        [n for _, n in copy["frames"]]
    x, whole = joined(frames), joined(port_frames("mp3.mp3"))
    assert x.shape[1] == copy["samples"] == whole.shape[1] + 1105
    np.testing.assert_array_equal(x[:, 1105:], whole)


def lame_delay(data: bytes, delay: int) -> bytes:
    """The MP3 with its LAME tag's encoder delay set to `delay`."""
    k = data.find(b"LAME")
    v = int.from_bytes(data[k + 21:k + 24], "big")
    v = (delay << 12) | (v & 4095)
    return data[:k + 21] + v.to_bytes(3, "big") + data[k + 24:]


@pytest.mark.parametrize("delay", [576, 2000])
def test_mp3_skip_not_again_on_resume(delay, tmp_path):
    """A snapshot after two packets, resumed: the skip left (none at a
    576-sample delay; 2529 - 2304 at 2000) goes with the snapshot and is
    dropped once. The resumed decoder starts fresh: the first packet's
    frame has its main data before the cut and gives no samples (its
    length counts against the skip left), so the run holds the samples
    from the fourth frame on, and from the sixth they are the
    uninterrupted run's."""
    src = tmp_path / "in.mp3"
    src.write_bytes(lame_delay(open(os.path.join(FX, "mp3.mp3"), "rb")
                               .read(), delay))

    def spec(out):
        return TP.TranscodeSpec(input_url=str(src),
                                output_url=str(tmp_path / out),
                                audio=TP.StreamMap(codec="pcm_f32le"),
                                device="cpu")

    def pcm(out):
        d = topen(str(tmp_path / out))
        x = np.frombuffer(b"".join(bytes(p.data) for p in d.packets()),
                          "<f4")
        d.close()
        return x.reshape(-1, 2).T

    TP.Transcoder(spec("a.wav")).run()
    tc = TP.Transcoder(spec("b1.wav"))
    for i, pkt in enumerate(tc.demux.packets()):
        tc.chains[pkt.stream_index].send_packet(pkt, tc.mux)
        if i == 1:
            break
    assert tc.chains[0].decoder._pending_skip == max(0, delay + 529 - 2304)
    blob = TCK.snapshot(tc)
    tc2 = TP.Transcoder(spec("b2.wav"))
    TCK.restore(tc2, blob)
    assert tc2.chains[0].decoder._pending_skip == \
        max(0, delay + 529 - 2304)
    tc2.run()
    a, b = pcm("a.wav"), pcm("b2.wav")
    assert a.shape[1] == 222336 - (delay + 529) - 731
    assert b.shape[1] == 222336 - 3456 - 731
    np.testing.assert_array_equal(b[:, 2304:], a[:, a.shape[1] -
                                                 b.shape[1] + 2304:])


def test_mp3_without_a_lame_tag_is_not_trimmed(tmp_path):
    """The MP3 with its Info frame taken out: no skip and no discard, as
    libavformat and libavcodec give it (mp3_strip)."""
    from tools.torch_port_libav_audio import strip_info_frame

    strip_info_frame(os.path.join(FX, "mp3.mp3"), str(tmp_path / "s.mp3"))
    d = topen(str(tmp_path / "s.mp3"))
    packets = list(d.packets())
    par = d.streams[0].codecpar
    d.close()
    assert not any(p.side_data for p in packets)
    dec = tfind(par.codec_id)(par, device="cpu")
    frames = [f for p in packets for f in dec.decode(p)]
    strip = LIBAV["decodes"]["mp3_strip"]
    assert frame_list(frames) == strip["frames"]
    assert joined(frames).shape[1] == strip["samples"] == 222336


# ---------------------------------------------------------------------------
# the JAX package's faults, and what the repairs leave alone
# ---------------------------------------------------------------------------

def jax_pcm(name):
    d = jopen(os.path.join(FX, name))
    par = d.streams[0].codecpar
    dec = jfind(par.codec_id)(par)
    frames = [f for p in d.packets() for f in dec.decode(p)]
    d.close()
    return np.concatenate([np.asarray(f.data) for f in frames], 1)


@pytest.mark.parametrize("key", ["mp2", "mp3", "mp3_mono32k"])
def test_jax_mpegaudio_window_and_trim(key):
    """The JAX window flips taps 320, 384 and 448, and its decoders trim
    481 samples: at the best shift (the JAX output 481 samples late) it
    reads about 32 dB against libavcodec; its MP3 keeps the LAME delay
    and padding (1105 + 731 samples for a stereo stream)."""
    info, z = LIBAV["decodes"][key], oracle(key)
    x = jax_pcm(info["src"])
    lead = 0 if key == "mp2" else 1105
    untrimmed = info["samples"] + (0 if key == "mp2" else
                                   lead + info["packets"][-1][4])
    assert x.shape[1] == untrimmed - 481
    assert JMA.SYNTH_DELAY == 481
    # libavcodec's sample j is the JAX decoder's sample j + lead - 481
    step, ref = int(z["step"]), z["pcm"].astype(np.float64)
    idx = np.arange(ref.shape[1]) * step + lead - 481
    ok = idx >= 0
    snr = snr_db(x[:, idx[ok]], ref[:, ok])
    assert 30 < snr < 36


def test_jax_vorbis_frames_diverge_from_the_16th():
    """The JAX floor leaves out a neighbour of a nonzero point whose own
    value was predicted: its frames read 120 dB or more against
    libavcodec up to the 15th and fall below 60 dB at the 16th; it keeps
    44 samples past the end granule."""
    info, z = LIBAV["decodes"]["vorbis"], oracle("vorbis")
    x = jax_pcm("vorbis.ogg")
    assert x.shape[1] == info["samples"] + 44
    at, snrs = 0, []
    for i, (_, n) in enumerate(info["frames"][:20]):
        snrs.append(snr_db(x[:, at:at + n], z[f"full_{i}"])
                    if f"full_{i}" in z else None)
        at += n
    assert min(snrs[i] for i in (0, 1, 14)) >= 120
    assert snrs[15] < 60 and snrs[16] < 60
    bad = 0
    at = 0
    step = int(z["step"])
    for _, n in info["frames"]:
        sel = np.arange(at, at + n)
        sel = sel[sel % step == 0]
        bad += snr_db(x[:, sel], z["pcm"][:, sel // step]) < 60
        at += n
    assert bad > 100


class _Recorder(np.ndarray):
    """A synthesis matrix that records each subband vector it is
    multiplied with."""

    def __matmul__(self, other):
        self.log.append(np.array(other))
        return np.asarray(self) @ other


def _recording(module, monkeypatch, log):
    rec = np.asarray(module._N).view(_Recorder)
    rec.log = log
    monkeypatch.setattr(module, "_N", rec)


@pytest.mark.parametrize("name", ["mp2.mp2", "mp3.mp3"])
def test_subband_samples_are_the_jax_packages(name, monkeypatch):
    """Before the synthesis, which the repair changes, both packages
    decode the same subband samples, vector for vector."""
    jlog, tlog = [], []
    for mod, log in ((JMA, jlog), (JM3, jlog), (TMA, tlog), (TM3, tlog)):
        _recording(mod, monkeypatch, log)
    d = jopen(os.path.join(FX, name))
    jdec = jfind(d.streams[0].codecpar.codec_id)(d.streams[0].codecpar)
    jp = list(d.packets())[:12]
    d.close()
    for p in jp:
        jdec.decode(p)
    d = topen(os.path.join(FX, name))
    tdec = tfind(d.streams[0].codecpar.codec_id)(d.streams[0].codecpar,
                                                  device="cpu")
    for p in list(d.packets())[:12]:
        tdec.decode(p)
    d.close()
    assert len(tlog) == len(jlog) > 12 * 18
    for a, b in zip(jlog, tlog):
        np.testing.assert_array_equal(a, b)


def test_vorbis_frames_before_the_fault_are_the_jax_packages():
    """The frames the floor fault does not reach (the first 15) equal
    the JAX decoder's float for float."""
    d = jopen(os.path.join(FX, "vorbis.ogg"))
    dec = jfind("vorbis")(d.streams[0].codecpar)
    jf = [f for p in list(d.packets())[:17] for f in dec.decode(p)]
    d.close()
    tf = vorbis_frames()[:15]
    for a, b in zip(jf[:15], tf):
        np.testing.assert_array_equal(b.data.numpy(), np.asarray(a.data))
    assert not np.array_equal(vorbis_frames()[15].data.numpy(),
                              np.asarray(jf[15].data))


def test_jax_generic_seek_drops_the_read_ahead(tmp_path):
    """The JAX package's generic seek re-reads the MP3 header and drops
    the demuxer's read-ahead buffer (64 KB), so -ss 0.5 decodes only
    what lies past it; the port reads on from the first byte the header
    did not consume (test_mp3_skip_not_again_after_ss)."""
    from librempeg_tpu.sched import pipeline as JP

    out = tmp_path / "j.wav"
    JP.Transcoder(JP.TranscodeSpec(
        input_url=os.path.join(FX, "mp3.mp3"), output_url=str(out),
        seek=0.5, audio=JP.StreamMap(codec="pcm_s16le"))).run()
    d = jopen(str(out))
    n = sum(len(p.data) for p in d.packets()) // 4
    d.close()
    assert 0 < n < 196261 // 4


def test_framemd5_header_is_libavformats(tmp_path):
    """A video and an audio stream's framemd5 header, its last line
    "#stream#, dts, ..." included, as libavformat writes it (the JAX
    package stops before that line)."""
    from librempeg_tpu_torch.core.rational import Rational
    from librempeg_tpu_torch.core.samplefmt import ChannelLayout
    from librempeg_tpu_torch.formats import api as TA

    mux = TA.open_output(str(tmp_path / "o.md5"), format="framemd5")
    mux.add_stream(TA.CodecParameters(
        codec_type="video", codec_id="rawvideo", width=320, height=240),
        time_base=Rational(1, 25))
    mux.add_stream(TA.CodecParameters(
        codec_type="audio", codec_id="pcm_s16le", sample_rate=44100,
        nb_channels=2, ch_layout=ChannelLayout.default(2)),
        time_base=Rational(1, 44100))
    mux.write_header()
    mux.close()
    assert (tmp_path / "o.md5").read_text() == LIBAV["framemd5"]
