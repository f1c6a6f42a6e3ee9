"""AC-3 in both packages on the CPU: the port's copies
(codecs/ac3/{tables_data,decoder,encoder}.py, formats/ac3.py) held to
the JAX package's.

- the encoder's bytes equal, mono and stereo, at 32, 44.1 and 48 kHz,
  at low rates (64 and 96 kb/s: coupling territory) and high ones, on
  tones and on a transient that switches the blocks; each case a few
  1536-sample frames (the host encoder takes about 5.6 s a second of
  stereo);
- the decoder's samples on those streams equal, float for float (the
  same host numpy on one CPU);
- the .ac3 muxer's bytes and the demuxer's packets equal;
- the CLI: `-c:a ac3 -b:a 192k` and `-f framemd5` of the result through
  both packages, equal.

E-AC-3 and 5.1 AC-3 are held to the JAX package in test_torch_eac3.py,
on streams libavcodec's encoders wrote (the JAX encoder writes mono and
stereo only; tools/torch_port_ac3_fixtures.py).
"""
import numpy as np
import pytest
import torch

from librempeg_tpu.cli import ffmpeg as JCLI
from librempeg_tpu.codecs.api import find_decoder as jfind_dec
from librempeg_tpu.codecs.api import find_encoder as jfind_enc
from librempeg_tpu.core.frame import AudioFrame as JFrame
from librempeg_tpu.formats.api import open_input_bytes as jopen_bytes
from librempeg_tpu.formats.api import open_output_bytes as jout_bytes
from librempeg_tpu_torch.cli import ffmpeg as TCLI
from librempeg_tpu_torch.codecs.api import find_decoder as tfind_dec
from librempeg_tpu_torch.codecs.api import find_encoder as tfind_enc
from librempeg_tpu_torch.core.frame import AudioFrame as TFrame
from librempeg_tpu_torch.formats.api import open_input_bytes
from librempeg_tpu_torch.formats.api import open_output_bytes as tout_bytes
from tools.audio_jax_repair import framemd5_repaired

FRAME = 1536


def signal(n, ch, rate, kind, seed=7):
    """[ch, n] float32: two tones per channel, and for "transient" a
    noise burst with a sharp attack in the third frame."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    x = np.stack([0.3 * np.sin(2 * np.pi * (300 + 160 * c) * t)
                  + 0.1 * np.sin(2 * np.pi * 2500 * t + c)
                  for c in range(ch)])
    if kind == "transient":
        s = 2 * FRAME + 700
        k = np.arange(n - s) / rate
        x[:, s:] += 0.6 * np.exp(-k / 0.01) * rng.standard_normal((ch, n - s))
    return np.clip(x, -1, 1).astype(np.float32)


def encode_both(x, rate, kbps, chunk=1000):
    ch = x.shape[0]
    je = jfind_enc("ac3")(sample_rate=rate, channels=ch,
                          bit_rate=kbps * 1000)
    te = tfind_enc("ac3")(sample_rate=rate, channels=ch,
                          bit_rate=kbps * 1000)
    jp, tp = [], []
    for s in range(0, x.shape[1], chunk):
        c = x[:, s:s + chunk]
        jp += je.encode(JFrame(data=c, sample_rate=rate, sample_fmt="fltp",
                               pts=s))
        tp += te.encode(TFrame(data=torch.from_numpy(c.copy()),
                               sample_rate=rate, sample_fmt="fltp", pts=s))
    return (je, jp + je.flush()), (te, tp + te.flush())


CASES = [(2, 48000, 192, "tones"), (2, 44100, 96, "tones"),
         (1, 32000, 64, "tones"), (2, 32000, 384, "transient"),
         (1, 48000, 160, "transient"), (2, 44100, 192, "transient")]


@pytest.mark.parametrize("ch,rate,kbps,kind", CASES)
def test_encoder_and_decoder_match_jax(ch, rate, kbps, kind):
    x = signal(4 * FRAME + 100, ch, rate, kind)
    (je, jp), (te, tp) = encode_both(x, rate, kbps)
    assert len(tp) == 5
    assert [bytes(p.data) for p in jp] == [bytes(p.data) for p in tp]
    assert [(p.pts, p.duration) for p in jp] == \
        [(p.pts, p.duration) for p in tp]
    jpar, tpar = je.codec_parameters(), te.codec_parameters()
    assert (jpar.sample_rate, jpar.nb_channels, jpar.bit_rate) == \
        (tpar.sample_rate, tpar.nb_channels, tpar.bit_rate)
    jd = jfind_dec("ac3")(jpar)
    td = tfind_dec("ac3")(tpar, device="cpu")
    jf = [f for p in jp for f in jd.decode(p)]
    tf = [f for p in tp for f in td.decode(p)]
    assert [f.pts for f in jf] == [f.pts for f in tf]
    jx = np.concatenate([np.asarray(f.data) for f in jf], 1)
    tx = np.concatenate([f.data.numpy() for f in tf], 1)
    assert tx.dtype == jx.dtype and tx.shape == (ch, 5 * FRAME)
    np.testing.assert_array_equal(tx, jx)
    assert np.isfinite(tx).all()


def test_ac3_container_matches_jax():
    x = signal(3 * FRAME, 2, 48000, "tones")
    (je, jp), (te, tp) = encode_both(x, 48000, 192)
    jm, tm = jout_bytes("ac3"), tout_bytes("ac3")
    for mux, enc, pkts in ((jm, je, jp), (tm, te, tp)):
        mux.add_stream(enc.codec_parameters())
        for p in pkts:
            mux.write(p)
        mux.finish()
    jb, tb = jm.io.getvalue(), tm.io.getvalue()
    assert jb == tb == b"".join(bytes(p.data) for p in tp)
    jd, td = jopen_bytes(jb), open_input_bytes(tb)
    assert td.NAME == jd.NAME == "ac3"
    jpar, tpar = jd.streams[0].codecpar, td.streams[0].codecpar
    assert (tpar.codec_id, tpar.sample_rate, tpar.nb_channels) == \
        (jpar.codec_id, jpar.sample_rate, jpar.nb_channels) == \
        ("ac3", 48000, 2)
    jpk = [(p.pts, p.duration, bytes(p.data)) for p in jd.packets()]
    tpk = [(p.pts, p.duration, bytes(p.data)) for p in td.packets()]
    assert tpk == jpk and [p[0] for p in tpk] == [0, FRAME, 2 * FRAME]


def test_cli_encode_and_decode_match_jax(tmp_path):
    from librempeg_tpu_torch.core.packet import Packet
    from librempeg_tpu_torch.formats import api as TA

    x = signal(6 * FRAME, 2, 44100, "transient")
    s16 = np.clip(np.rint(x * 32768), -32768, 32767).astype(np.int16)
    mux = TA.open_output(str(tmp_path / "in.wav"))
    mux.add_stream(TA.CodecParameters(codec_type="audio",
                                      codec_id="pcm_s16le",
                                      sample_rate=44100, nb_channels=2))
    mux.write(Packet(data=np.ascontiguousarray(s16.T).tobytes(), pts=0))
    mux.close()
    args = ["-i", str(tmp_path / "in.wav"), "-c:a", "ac3", "-b:a", "192k"]
    assert JCLI.main(args + ["-y", str(tmp_path / "j.ac3")]) == 0
    assert TCLI.main(args + ["-device", "cpu", "-y",
                             str(tmp_path / "t.ac3")]) == 0
    j, t = (tmp_path / "j.ac3").read_bytes(), (tmp_path / "t.ac3").read_bytes()
    assert t == j and len(t) > 0
    for cli, src, out, dev in ((JCLI, "j.ac3", "j.md5", []),
                               (TCLI, "t.ac3", "t.md5", ["-device", "cpu"])):
        assert cli.main(["-i", str(tmp_path / src), "-f", "framemd5", *dev,
                         "-y", str(tmp_path / out)]) == 0
    # libavformat's last framemd5 header line, which the JAX package
    # leaves out (ROADMAP.md section 3b)
    assert (tmp_path / "t.md5").read_text() == \
        framemd5_repaired((tmp_path / "j.md5").read_text())
