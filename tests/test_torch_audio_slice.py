"""The audio transcode through both packages' command lines on the CPU:
1 s of testgen.audio_mix at 44.1 kHz stereo s16 in a WAV.

- `-ar 48000 -c:a aac -b:a 128k` -> ADTS: the same packet count, every
  header valid (sync, rate index 3, two channels, lengths adding up to
  the file), the bytes within 1% of the JAX package's and the decoded
  SNR (each package's decoder on its own stream, against the JAX
  package's resampled s16 input) within 0.05 dB.
- `-ar 48000 -c:a pcm_s16le` -> WAV: the same length, at least 99.9% of
  samples equal and none off by more than 1 (test_torch_resample.py).
- `-ac 1 -c:a pcm_s16le`, the port alone (the JAX package parses -ac
  and writes stereo): a mono WAV equal to build_matrix(stereo, mono)
  applied to the input within 1 LSB.
- the port's ADTS back to WAV through its own chain (`-c:a pcm_s16le`):
  its AAC decoder's samples, rounded to s16.
- `-af aresample=48000` (the port alone: the JAX package writes its
  samples under the input's rate) equal to `-ar 48000`; with
  `:dither_method=lipshitz` equal to the port's shaping Swr over the
  WAV's packets.
- the filters off the CLI's path (volume, atrim, aformat) in a chain
  of both packages' GraphRunner, frame by frame: the same frames, pts
  and samples (aresample's s16 within the resampler's limit).
"""
import numpy as np
import pytest
import torch

from librempeg_tpu.cli import ffmpeg as JCLI
from librempeg_tpu.codecs.aac.decoder import AacDecoder as JDec
from librempeg_tpu.core.packet import Packet as JPacket
from librempeg_tpu_torch.cli import ffmpeg as TCLI
from librempeg_tpu_torch.codecs.aac.decoder import AacDecoder as TDec
from librempeg_tpu_torch.core.packet import Packet as TPacket
from librempeg_tpu_torch.core.samplefmt import MONO, STEREO
from librempeg_tpu_torch.formats import api as TA
from librempeg_tpu_torch.resample.rematrix import build_matrix
from librempeg_tpu_torch.utils import testgen

IN_RATE, OUT_RATE = 44100, 48000


def write_wav(path, x_s16, rate):
    """[channels, n] int16 -> a pcm_s16le WAV (the port's muxer)."""
    mux = TA.open_output(str(path))
    mux.add_stream(TA.CodecParameters(
        codec_type="audio", codec_id="pcm_s16le", sample_rate=rate,
        nb_channels=x_s16.shape[0]))
    mux.write(TPacket(data=np.ascontiguousarray(x_s16.T).tobytes(), pts=0))
    mux.close()


def read_wav(path):
    """(rate, [channels, n] int16) of a pcm_s16le WAV (the port's
    demuxer)."""
    d = TA.open_input(str(path))
    par = d.streams[0].codecpar
    assert par.codec_id == "pcm_s16le"
    raw = b"".join(bytes(p.data) for p in d.packets())
    d.close()
    return par.sample_rate, np.frombuffer(raw, "<i2").reshape(
        -1, par.nb_channels).T


def adts_frames(data: bytes) -> list[bytes]:
    """The ADTS frames of a stream, each header checked: sync word, AAC
    LC, rate index 3 (48 kHz), channel configuration 2, and lengths that
    add up to the stream."""
    out, pos = [], 0
    while pos < len(data):
        h = data[pos:pos + 7]
        assert h[0] == 0xFF and h[1] & 0xF6 == 0xF0, pos
        assert (h[2] >> 6) == 1 and (h[2] >> 2) & 0xF == 3, pos
        assert ((h[2] & 1) << 2 | h[3] >> 6) == 2, pos
        ln = (h[3] & 3) << 11 | h[4] << 3 | h[5] >> 5
        assert ln > 7 and pos + ln <= len(data), pos
        out.append(data[pos:pos + ln])
        pos += ln
    assert pos == len(data)
    return out


def _decode(dec, frames, pkt_cls, port):
    out = [dec.decode(pkt_cls(data=f, pts=i * 1024))[0].data
           for i, f in enumerate(frames)]
    return np.concatenate([o.numpy() if port else np.asarray(o)
                           for o in out], 1)


def _snr_db(ref_s16, decoded):
    ref = ref_s16.astype(np.float64) / 32768.0
    y = decoded[:, 1024:1024 + ref.shape[1]]
    e = ref[:, :y.shape[1]] - y
    return 10 * np.log10((ref ** 2).sum() / (e ** 2).sum())


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    d = tmp_path_factory.mktemp("audio")
    x = testgen.s16(testgen.audio_mix(IN_RATE, IN_RATE))
    write_wav(d / "in.wav", x, IN_RATE)
    return d, x


def _run(d, args, name):
    """The same command through both packages -> (jax out, port out)."""
    j, t = d / f"jax_{name}", d / f"port_{name}"
    assert JCLI.main(["-i", str(d / "in.wav"), *args, "-y", str(j)]) == 0
    assert TCLI.main(["-i", str(d / "in.wav"), *args, "-device", "cpu",
                      "-y", str(t)]) == 0
    return j, t


def test_resample_to_pcm_matches_jax(clip):
    d, _ = clip
    j, t = _run(d, ["-ar", "48000", "-c:a", "pcm_s16le"], "rs.wav")
    (jr, jx), (tr, tx) = read_wav(j), read_wav(t)
    assert jr == tr == OUT_RATE and tx.shape == jx.shape == (2, OUT_RATE)
    diff = np.abs(tx.astype(np.int32) - jx)
    share = np.count_nonzero(diff) / diff.size
    print(f"-ar 48000 pcm: {share:.6f} of samples differ, max {diff.max()}")
    assert share <= 1e-3 and diff.max() <= 1


def test_resample_to_aac_matches_jax(clip):
    d, _ = clip
    j, t = _run(d, ["-ar", "48000", "-c:a", "aac", "-b:a", "128k"], "a.aac")
    jf, tf = adts_frames(j.read_bytes()), adts_frames(t.read_bytes())
    assert len(tf) == len(jf)
    jb, tb = len(j.read_bytes()), len(t.read_bytes())
    # the resampled input both encoders took
    _, ref = read_wav(_run(d, ["-ar", "48000", "-c:a", "pcm_s16le"],
                           "ref.wav")[0])
    js = _snr_db(ref, _decode(JDec(), jf, JPacket, False))
    ts = _snr_db(ref, _decode(TDec(device="cpu"), tf, TPacket, True))
    same = sum(a == b for a, b in zip(jf, tf))
    print(f"aac 128k: {len(tf)} packets ({same} identical), {tb} vs {jb} "
          f"bytes, decoded SNR {ts:.4f} vs {js:.4f} dB")
    assert abs(tb - jb) <= 0.01 * jb and abs(ts - js) <= 0.05
    # back to s16 through the port's own chain (AAC decoder, anull)
    back = d / "back.wav"
    assert TCLI.main(["-i", str(t), "-c:a", "pcm_s16le", "-device", "cpu",
                      "-y", str(back)]) == 0
    rate, bx = read_wav(back)
    want = np.clip(np.rint(_decode(TDec(device="cpu"), tf, TPacket, True)
                           * 32768.0), -32768, 32767).astype(np.int16)
    assert rate == OUT_RATE and np.array_equal(bx, want)


def test_channels_option_downmixes(clip):
    d, x = clip
    out = d / "mono.wav"
    assert TCLI.main(["-i", str(d / "in.wav"), "-ac", "1", "-c:a",
                      "pcm_s16le", "-device", "cpu", "-y", str(out)]) == 0
    rate, y = read_wav(out)
    assert rate == IN_RATE and y.shape == (1, x.shape[1])
    m = build_matrix(STEREO, MONO)
    want = m.astype(np.float64) @ (x.astype(np.float64) / 32768.0) * 32768.0
    assert np.abs(y - want).max() <= 1.0


def _port_cli(src, args, out):
    assert TCLI.main(["-i", str(src), *args, "-device", "cpu", "-y",
                      str(out)]) == 0
    return read_wav(out)


def test_af_aresample_sets_the_output_rate(clip):
    """-af aresample=48000 writes a 48 kHz WAV, the samples of -ar 48000
    (the JAX package retunes the encoder to the decoded frames' 44.1 kHz
    and writes 48 kHz samples under a 44.1 kHz header)."""
    d, _ = clip
    src = d / "in.wav"
    rate, y = _port_cli(src, ["-af", "aresample=48000", "-c:a", "pcm_s16le"],
                        d / "af_rs.wav")
    rate_ar, y_ar = _port_cli(src, ["-ar", "48000", "-c:a", "pcm_s16le"],
                              d / "ar_rs.wav")
    assert rate == rate_ar == OUT_RATE and np.array_equal(y, y_ar)


def test_aresample_dither_method_reaches_the_shaper(clip):
    """-af aresample=48000:dither_method=lipshitz -c:a pcm_s16le: the
    samples of the port's Swr with the noise shaper over the WAV's
    packets (its scan is held to the JAX package's in
    test_torch_resample.py), not those of the undithered path, and
    within 55 dB of them."""
    from librempeg_tpu_torch.codecs.pcm import PcmDecoder
    from librempeg_tpu_torch.resample import Swr

    d, x = clip
    src = d / "short.wav"
    write_wav(src, x[:, :IN_RATE // 10], IN_RATE)
    rate, y = _port_cli(src, ["-af", "aresample=48000:dither_method=lipshitz",
                              "-c:a", "pcm_s16le"], d / "dither.wav")
    _, plain = _port_cli(src, ["-af", "aresample=48000", "-c:a", "pcm_s16le"],
                         d / "nodither.wav")
    demux = TA.open_input(str(src))
    dec = PcmDecoder("pcm_s16le", demux.streams[0].codecpar, device="cpu")
    swr = Swr(IN_RATE, OUT_RATE, in_fmt="s16p", out_fmt="s16p",
              dither="lipshitz", device="cpu")
    want = [swr.convert(f.data) for p in demux.packets()
            for f in dec.decode(p)]
    demux.close()
    want = torch.cat(want + [swr.flush_frame().data], 1).numpy()
    assert rate == OUT_RATE and np.array_equal(y, want)
    e = y.astype(np.float64) - plain
    snr = 10 * np.log10((plain.astype(np.float64) ** 2).sum() / (e ** 2).sum())
    print(f"dithered: {np.count_nonzero(e) / e.size:.4f} of samples moved, "
          f"SNR {snr:.2f} dB against the undithered path")
    assert np.count_nonzero(e) > e.size // 4 and snr > 55


def test_aresample_refuses_unported_dither_methods(clip):
    d, _ = clip
    with pytest.raises(ValueError, match="dither_method"):
        TCLI.main(["-i", str(d / "in.wav"), "-af",
                   "aresample=48000:dither_method=shibata", "-c:a",
                   "pcm_s16le", "-device", "cpu", "-y", str(d / "x.wav")])


@pytest.mark.parametrize("desc", [
    "volume=-6dB,atrim=start=0.01:end=0.05",
    "aformat=sample_fmts=fltp:channel_layouts=mono,volume=0.5",
    "aresample=48000,volume=1.5"])
def test_audio_filters_match_jax(desc):
    from librempeg_tpu.core.frame import AudioFrame as JFrame
    from librempeg_tpu.core.samplefmt import ChannelLayout as JL
    from librempeg_tpu.filters import GraphRunner as JGraph
    from librempeg_tpu.filters import StreamProps as JProps
    from librempeg_tpu_torch.core.frame import AudioFrame as TFrame
    from librempeg_tpu_torch.core.samplefmt import ChannelLayout as TL
    from librempeg_tpu_torch.filters import GraphRunner as TGraph
    from librempeg_tpu_torch.filters import StreamProps as TProps

    x = testgen.s16(testgen.audio_mix(IN_RATE, 4096) * 0.8)
    kw = dict(media="audio", sample_rate=IN_RATE, sample_fmt="s16p")
    jg = JGraph(desc, JProps(layout=JL.from_string("stereo"), **kw))
    tg = TGraph(desc, TProps(layout=TL.from_string("stereo"), **kw))
    jout, tout = [], []
    for s in range(0, 4096, 1024):
        blk = x[:, s:s + 1024]
        jout += jg.push(JFrame(data=blk, sample_rate=IN_RATE,
                               sample_fmt="s16p", pts=s))
        tout += tg.push(TFrame(data=torch.from_numpy(blk),
                               sample_rate=IN_RATE, sample_fmt="s16p",
                               pts=s))
    jout += jg.finish()
    tout += tg.finish()
    assert [(f.pts, f.sample_rate, f.sample_fmt, f.nb_samples)
            for f in tout] == [(f.pts, f.sample_rate, f.sample_fmt,
                                f.nb_samples) for f in jout]
    a = np.concatenate([np.asarray(f.data) for f in jout], 1)
    b = torch.cat([f.data for f in tout], 1).numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    d = np.abs(a.astype(np.float64) - b)
    if a.dtype == np.int16:
        assert np.count_nonzero(d) <= 1e-3 * d.size and d.max() <= 1, desc
    else:
        assert d.max() <= 2e-6, desc


def test_cli_defaults_to_the_card(clip):
    d, _ = clip
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        TCLI.main(["-i", str(d / "in.wav"), "-ar", "48000", "-c:a", "aac",
                   "-b:a", "128k", "-y", str(d / "card.aac")])
