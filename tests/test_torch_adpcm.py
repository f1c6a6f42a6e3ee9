"""ADPCM in both packages on the CPU: the port's copy (codecs/adpcm.py)
and its WAV container held to the JAX package's, byte for byte.

- the IMA-WAV and Microsoft encoders, mono and stereo, fed in frames
  that are not multiples of a block: the same bytes, the same
  codec parameters;
- the IMA-WAV, Microsoft and Yamaha decoders: the same samples, on the
  encoders' streams and on seeded random blocks (every nibble and
  predictor index reached);
- `-c:a adpcm_ima_wav` / `-c:a adpcm_ms` into WAV and `-f framemd5` of
  the result through both CLIs: the same files and the same text.
"""
import numpy as np
import pytest
import torch

from librempeg_tpu.cli import ffmpeg as JCLI
from librempeg_tpu.codecs.api import find_decoder as jfind_dec
from librempeg_tpu.codecs.api import find_encoder as jfind_enc
from librempeg_tpu.core.frame import AudioFrame as JFrame
from librempeg_tpu.core.packet import Packet as JPacket
from librempeg_tpu.formats.api import CodecParameters as JPar
from librempeg_tpu_torch.cli import ffmpeg as TCLI
from librempeg_tpu_torch.codecs.api import find_decoder as tfind_dec
from librempeg_tpu_torch.codecs.api import find_encoder as tfind_enc
from librempeg_tpu_torch.core.frame import AudioFrame as TFrame
from librempeg_tpu_torch.core.packet import Packet as TPacket
from librempeg_tpu_torch.formats.api import CodecParameters as TPar
from librempeg_tpu_torch.utils import testgen
from tools.audio_jax_repair import framemd5_repaired, wav_tags_repaired

RATE = 44100


def pcm(ch, n=9000):
    return testgen.s16(testgen.audio_mix(RATE, n, channels=ch))


def encode_both(name, x, chunk=777):
    ch = x.shape[0]
    je = jfind_enc(name)(sample_rate=RATE, channels=ch)
    te = tfind_enc(name)(sample_rate=RATE, channels=ch)
    jp, tp = [], []
    for s in range(0, x.shape[1], chunk):
        c = np.ascontiguousarray(x[:, s:s + chunk])
        jp += je.encode(JFrame(data=c, sample_rate=RATE, sample_fmt="s16p",
                               pts=s))
        tp += te.encode(TFrame(data=torch.from_numpy(c), sample_rate=RATE,
                               sample_fmt="s16p", pts=s))
    return (je, jp + je.flush()), (te, tp + te.flush())


def decoded(frames):
    return np.concatenate([np.asarray(f.data) if not hasattr(f.data, "cpu")
                           else f.data.numpy() for f in frames], 1)


@pytest.mark.parametrize("name", ["adpcm_ima_wav", "adpcm_ms"])
@pytest.mark.parametrize("ch", [1, 2])
def test_encoders_and_decoders_match_jax(name, ch):
    (je, jp), (te, tp) = encode_both(name, pcm(ch))
    assert [bytes(p.data) for p in tp] == [bytes(p.data) for p in jp]
    assert [(p.pts, p.duration) for p in tp] == \
        [(p.pts, p.duration) for p in jp]
    jpar, tpar = je.codec_parameters(), te.codec_parameters()
    assert (tpar.block_align, tpar.frame_size) == \
        (jpar.block_align, jpar.frame_size)
    jd, td = jfind_dec(name)(jpar), tfind_dec(name)(tpar, device="cpu")
    jf = [f for p in jp for f in jd.decode(p)]
    tf = [f for p in tp for f in td.decode(p)]
    assert [f.pts for f in tf] == [f.pts for f in jf]
    assert td.sample_fmt == "s16p"
    np.testing.assert_array_equal(decoded(tf), decoded(jf))


@pytest.mark.parametrize("name,ba", [("adpcm_ima_wav", 1024),
                                     ("adpcm_ms", 1024),
                                     ("adpcm_yamaha", 512)])
@pytest.mark.parametrize("ch", [1, 2])
def test_decoders_match_jax_on_random_blocks(name, ba, ch):
    rng = np.random.default_rng(ch * 10 + ba)
    raw = rng.integers(0, 256, 4 * ba * ch, dtype=np.uint8)
    kw = dict(codec_type="audio", codec_id=name, sample_rate=RATE,
              nb_channels=ch, block_align=ba * ch if name != "adpcm_yamaha"
              else ba)
    jd = jfind_dec(name)(JPar(**kw))
    td = tfind_dec(name)(TPar(**kw), device="cpu")
    data = raw.tobytes()
    step = len(data) // 4
    jf = [f for i in range(4) for f in jd.decode(JPacket(
        data=data[i * step:(i + 1) * step], pts=i))]
    tf = [f for i in range(4) for f in td.decode(TPacket(
        data=data[i * step:(i + 1) * step], pts=i))]
    assert len(tf) == len(jf) > 0
    np.testing.assert_array_equal(decoded(tf), decoded(jf))


@pytest.mark.parametrize("codec", ["adpcm_ima_wav", "adpcm_ms"])
def test_cli_wav_matches_jax(tmp_path, codec):
    from librempeg_tpu_torch.formats import api as TA

    x = pcm(2, 20000)
    mux = TA.open_output(str(tmp_path / "in.wav"))
    mux.add_stream(TA.CodecParameters(codec_type="audio",
                                      codec_id="pcm_s16le",
                                      sample_rate=RATE, nb_channels=2))
    mux.write(TPacket(data=np.ascontiguousarray(x.T).tobytes(), pts=0))
    mux.close()
    for cli, tag, dev in ((JCLI, "j", []), (TCLI, "t", ["-device", "cpu"])):
        assert cli.main(["-i", str(tmp_path / "in.wav"), "-c:a", codec,
                         *dev, "-y", str(tmp_path / f"{tag}.wav")]) == 0
        assert cli.main(["-i", str(tmp_path / f"{tag}.wav"), "-f",
                         "framemd5", *dev, "-y",
                         str(tmp_path / f"{tag}.md5")]) == 0
    # the fact chunk and byte rate of libavformat's header, and its last
    # framemd5 header line, which the JAX package leaves out (ROADMAP.md
    # section 3b; the WAV header is held to libavformat's in
    # test_torch_wav_tags.py)
    assert (tmp_path / "t.wav").read_bytes() == \
        wav_tags_repaired((tmp_path / "j.wav").read_bytes())
    assert (tmp_path / "t.md5").read_text() == \
        framemd5_repaired((tmp_path / "j.md5").read_text())
    d = TA.open_input(str(tmp_path / "t.wav"))
    assert d.streams[0].codecpar.codec_id == codec
    assert d.streams[0].duration >= x.shape[1]
