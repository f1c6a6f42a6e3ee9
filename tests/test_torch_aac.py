"""The port's AAC-LC encoder and decoder (librempeg_tpu_torch/codecs/aac)
and ADTS container against the JAX package's on the CPU.

Both encoders take the same s16 frames. The MDCT is a float32 product
summed in another order, so a spectral value near a quantiser boundary
can round the other way; the psy model, quantiser, rate loop and
Huffman coder are the same host code. Limits (measured on 1 s of
testgen.audio_mix at 48 kHz stereo: 43 of 48 packets byte-identical at
constant quality, 37 of 48 at 128 kb/s, where a flip also moves the
rate control's later frames; decoded SNR gaps under 0.002 dB):
- constant quality: >= 80% of packets byte-identical, total bytes
  within 0.5%;
- 128 kb/s: >= 50% byte-identical, total bytes within 1%;
- decoded SNR (each package's decoder on its own stream, against the
  encoder's input) within 0.05 dB of the JAX package's.
The decoder, on the JAX encoder's stream, must give the JAX decoder's
samples within 1e-5 (the IMDCT is a float32 product; the rest is the
same float64 host code; 1e-6 measured).
"""
import os

import numpy as np
import pytest
import torch

from librempeg_tpu.codecs.aac.codec import AacEncoder as JEnc
from librempeg_tpu.codecs.aac.decoder import AacDecoder as JDec
from librempeg_tpu.core.frame import AudioFrame as JFrame
from librempeg_tpu.core.packet import Packet as JPacket
from librempeg_tpu_torch import compat
from librempeg_tpu_torch.codecs.aac.codec import AacEncoder as TEnc
from librempeg_tpu_torch.codecs.aac.decoder import AacDecoder as TDec
from librempeg_tpu_torch.core.frame import AudioFrame as TFrame
from librempeg_tpu_torch.core.packet import Packet as TPacket
from librempeg_tpu_torch.formats import api as TA
from librempeg_tpu_torch.utils import testgen

RATE = 48000
FRAME = 1024


def _pcm(n, seed=0):
    x = testgen.audio_mix(RATE, n + seed)[:, seed:]
    return testgen.s16(x)


def _encode_jax(enc, x, flush=True):
    pk = []
    for i in range(0, x.shape[1], FRAME):
        pk += enc.encode(JFrame(data=x[:, i:i + FRAME], sample_rate=RATE,
                                sample_fmt="s16p"))
    return pk + (enc.flush() if flush else [])


def _encode_port(enc, x):
    pk = []
    for i in range(0, x.shape[1], FRAME):
        pk += enc.encode(TFrame(data=torch.from_numpy(x[:, i:i + FRAME]),
                                sample_rate=RATE, sample_fmt="s16p"))
    return pk + enc.flush()


def _decode(dec, packets, port):
    pkt = TPacket if port else JPacket
    out = []
    for p in packets:
        d = dec.decode(pkt(data=bytes(p.data), pts=p.pts))[0].data
        out.append(d.numpy() if port else np.asarray(d))
    return np.concatenate(out, 1)


def _snr_db(x_s16, decoded):
    """Decoded samples (one frame late, the MDCT overlap) against the
    encoder's input."""
    ref = x_s16.astype(np.float64) / 32768.0
    y = decoded[:, FRAME:FRAME + ref.shape[1]]
    e = ref[:, :y.shape[1]] - y
    return 10 * np.log10((ref ** 2).sum() / (e ** 2).sum())


@pytest.mark.parametrize("bit_rate,same_floor,bytes_tol",
                         [(0, 0.8, 0.005), (128000, 0.5, 0.01)])
def test_encoder_matches_jax(bit_rate, same_floor, bytes_tol):
    x = _pcm(RATE)
    opts = {"bit_rate": bit_rate} if bit_rate else {}
    jp = _encode_jax(JEnc(RATE, 2, **opts), x)
    tp = _encode_port(TEnc(RATE, 2, device="cpu", **opts), x)
    assert [(p.pts, p.duration) for p in tp] == \
        [(p.pts, p.duration) for p in jp]
    same = sum(bytes(a.data) == bytes(b.data) for a, b in zip(jp, tp))
    jb, tb = (sum(len(p.data) for p in pk) for pk in (jp, tp))
    js = _snr_db(x, _decode(JDec(), jp, False))
    ts = _snr_db(x, _decode(TDec(device="cpu"), tp, True))
    print(f"bit_rate {bit_rate}: {same}/{len(jp)} packets identical, bytes "
          f"{tb} vs {jb}, decoded SNR {ts:.4f} vs {js:.4f} dB")
    assert same >= same_floor * len(jp)
    assert abs(tb - jb) <= bytes_tol * jb
    assert abs(ts - js) <= 0.05


def test_decoder_matches_jax():
    jp = _encode_jax(JEnc(RATE, 2, bit_rate=96000), _pcm(RATE // 2, 7))
    want = _decode(JDec(), jp, False)
    got = _decode(TDec(device="cpu"), jp, True)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float(np.abs(got - want).max())
    print(f"decoder max |err| {err:.2e}")
    assert err <= 1e-5


def test_he_aac_stream_decodes_as_in_jax(tmp_path, monkeypatch):
    """An HE-AAC v1 stream (the port's SBR stream generator, whose bytes
    are the JAX package's generator's, 24 kHz core, mono, random envelopes whose gains reach far past full
    scale). The port's SBR copy inside the JAX decoder gives the JAX
    decoder's samples exactly; the port's whole decoder (its float32
    IMDCT feeds the SBR's gains) within 90 dB SNR of them (102.6 dB
    measured). The port's chain takes the doubled rate from the first
    decoded frame: -c:a pcm_s16le gives a 48 kHz WAV of its decoder's
    samples."""
    import librempeg_tpu.codecs.aac.sbr as JSBR
    from librempeg_tpu_torch.cli import ffmpeg as TCLI
    from librempeg_tpu_torch.codecs.aac import sbr as TSBR

    data = TSBR.generate_he_stream(24000, 1, 6, seed=3, device="cpu")
    assert data == JSBR.generate_he_stream(24000, 1, 6, seed=3)
    frames, pos = [], 0
    while pos < len(data):
        n = (data[pos + 3] & 3) << 11 | data[pos + 4] << 3 | data[pos + 5] >> 5
        frames.append(TPacket(data=data[pos:pos + n]))
        pos += n
    want = _decode(JDec(), frames, False)
    with monkeypatch.context() as m:
        m.setattr(JSBR, "Sbr", TSBR.Sbr)
        assert np.array_equal(_decode(JDec(), frames, False), want)
    got = _decode(TDec(device="cpu"), frames, True)
    assert got.shape == want.shape == (1, 6 * 2048)
    e = (got - want).astype(np.float64)
    snr = 10 * np.log10((want.astype(np.float64) ** 2).sum() / (e ** 2).sum())
    print(f"HE-AAC decoder: SNR {snr:.2f} dB against the JAX decoder")
    assert snr >= 90.0
    src, out = tmp_path / "he.aac", tmp_path / "he.wav"
    src.write_bytes(data)
    assert TCLI.main(["-i", str(src), "-c:a", "pcm_s16le", "-device", "cpu",
                      "-y", str(out)]) == 0
    d = TA.open_input(str(out))
    assert d.streams[0].codecpar.sample_rate == 48000
    pcm = np.frombuffer(b"".join(bytes(p.data) for p in d.packets()), "<i2")
    assert np.array_equal(pcm, np.clip(np.rint(got[0] * 32768.0), -32768,
                                       32767).astype(np.int16))


@pytest.mark.parametrize("seed", (3, 11))
@pytest.mark.parametrize("frames", (6, 12))
@pytest.mark.parametrize("rate", (22050, 24000))
@pytest.mark.parametrize("channels", (1, 2))
def test_he_stream_writer_matches_jax(channels, rate, frames, seed):
    """The port's HE-AAC writer (write_sbr_payload through
    generate_he_stream, on the port's AAC encoder) gives the JAX
    generator's bytes: the same random header, grids and envelopes, the
    same FIL elements, the same AAC-LC core."""
    import librempeg_tpu.codecs.aac.sbr as JSBR
    from librempeg_tpu_torch.codecs.aac import sbr as TSBR

    got = TSBR.generate_he_stream(rate, channels, frames, seed=seed,
                                  device="cpu")
    assert got == JSBR.generate_he_stream(rate, channels, frames, seed=seed)
    d = TA.open_input_bytes(got)
    assert len(list(d.packets())) == frames


def test_adts_round_trip():
    """AacEncoder packets -> AdtsMuxer -> AdtsDemuxer: the same packets,
    pts every 1024 samples, and the stream's rate and channels."""
    tp = _encode_port(TEnc(44100, 2, device="cpu"), _pcm(9000))
    mux = TA.open_output_bytes("adts")
    mux.add_stream(TEnc(44100, 2, device="cpu").codec_parameters())
    for p in tp:
        mux.write(p)
    mux.finish()
    data = mux.io.getvalue()
    assert data == b"".join(bytes(p.data) for p in tp)
    demux = TA.open_input_bytes(data)
    par = demux.streams[0].codecpar
    assert (par.codec_id, par.sample_rate, par.nb_channels) == \
        ("aac", 44100, 2)
    back = list(demux.packets())
    assert [bytes(p.data) for p in back] == [bytes(p.data) for p in tp]
    assert [p.pts for p in back] == [i * 1024 for i in range(len(tp))]


def test_encoder_mid_stream_start_through_compat():
    """The JAX encoder codes 10 frames at 128 kb/s; the port takes its
    state and codes the rest as the JAX encoder does: the next packet
    byte-identical (it depends on every carried field: the overlap, the
    pending samples, the frame count and the rate control's knob and
    balance); of the 15 packets, >= 40% byte-identical (7 measured: a
    flip moves the rate control's later frames) and the bytes within
    1%."""
    x = _pcm(RATE // 2, 3)
    j = JEnc(RATE, 2, bit_rate=128000)
    _encode_jax(j, x[:, :10 * FRAME + 300], flush=False)
    t = compat.aac_encoder_state_from_numpy(
        RATE, 2, j._hist, j._pend, j._frame_no, j._rc_q, j._rc_buffer,
        device="cpu", bit_rate=128000)
    rest = x[:, 10 * FRAME + 300:]
    jp = _encode_jax(j, rest)
    tp = _encode_port(t, rest)
    assert [p.pts for p in tp] == [p.pts for p in jp]
    assert tp[0].pts == 10 * FRAME
    same = sum(bytes(a.data) == bytes(b.data) for a, b in zip(jp, tp))
    print(f"{same}/{len(jp)} packets identical after the carried state")
    assert bytes(tp[0].data) == bytes(jp[0].data)
    jb, tb = (sum(len(p.data) for p in pk) for pk in (jp, tp))
    assert same >= 0.4 * len(jp) and abs(tb - jb) <= 0.01 * jb


def test_k5_jax_encoder_on_the_port_mdct_gives_the_port_packets(tmp_path):
    """chip_smoke.py's K5 (the committed MP3 to AAC at 128 kb/s) in both
    packages, the JAX MP3 decoder with the port's repairs
    (tools/audio_jax_repair.py `mpegaudio_repaired`). Given the port's
    MDCT values in place of its own, the JAX encoder writes the port's
    217 packets byte for byte: its psy model, quantiser and rate control
    are the port's, and the MDCT is all that differs. With its own
    (XLA's float32 product) the rate control takes another path and
    packets differ (62 measured), which is why K5's golden takes the
    JAX encoder with an exact MDCT (`aac_mdct_exact`)."""
    import types

    from librempeg_tpu.cli import ffmpeg as JCLI
    from librempeg_tpu.codecs.aac import codec as JAAC
    from librempeg_tpu.ops import tx as JTX
    from librempeg_tpu_torch.cli import ffmpeg as TCLI
    from librempeg_tpu_torch.ops import tx as TTX
    from tools.audio_jax_repair import mpegaudio_repaired

    src = os.path.join(os.path.dirname(__file__), "data", "torch_port",
                       "acodecs", "mp3.mp3")
    args = ["-i", src, "-c:a", "aac", "-b:a", "128k"]

    def packets(path):
        d = TA.open_input(str(path))
        out = [bytes(p.data) for p in d.packets()]
        d.close()
        return out

    assert TCLI.main([*args, "-device", "cpu", "-y",
                      str(tmp_path / "t.m4a")]) == 0

    def port_mdct(x):
        return TTX.mdct(torch.from_numpy(np.asarray(x, np.float32))).numpy()

    plain = JAAC.tx
    with mpegaudio_repaired():
        assert JCLI.main([*args, "-y", str(tmp_path / "j.m4a")]) == 0
        JAAC.tx = types.SimpleNamespace(**{**vars(JTX), "mdct": port_mdct})
        try:
            assert JCLI.main([*args, "-y", str(tmp_path / "jt.m4a")]) == 0
        finally:
            JAAC.tx = plain
    t, jt, j = (packets(tmp_path / n) for n in ("t.m4a", "jt.m4a", "j.m4a"))
    assert len(t) == len(j) == 217
    assert jt == t
    assert sum(a != b for a, b in zip(j, t)) > 0
