"""The port's FLV demuxer and muxer (librempeg_tpu_torch/formats/flv.py)
against the JAX package's, on the CPU.

Stream copies through both CLIs write the same bytes: a raw H.264 clip
(test_torch_slice.make_clip, two IDRs) and an ADTS AAC file into FLV,
and the FLV back out as raw H.264. Both demuxers read the same packets
(pts, dts, flags, data) and parameters from those files and from an FLV
holding both streams, interleaved, written through the JAX package's
muxer API. The port's decode of the FLV gives the raw clip's frames
exactly (framemd5 text equal).
"""
import numpy as np
import pytest

from librempeg_tpu.cli.ffmpeg import main as jmain
from librempeg_tpu.formats import api as JA
from librempeg_tpu_torch.cli.ffmpeg import main as tmain
from librempeg_tpu_torch.formats import api as TA
from tests.test_torch_slice import make_clip


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    td = tmp_path_factory.mktemp("flv")
    clip = str(td / "clip.264")
    make_clip(clip, w=64, h=48, n=8)
    # AAC in FLV, written by the port (the JAX package's FLV of its AAC
    # encoder has no stream: test_aac_encode_into_flv)
    aac = str(td / "tone.flv")
    assert tmain(["-f", "lavfi", "-i", "sine=frequency=1000:duration=0.5",
                  "-c:a", "aac", "-b:a", "96k", "-device", "cpu", "-y",
                  aac]) == 0
    return td, clip, aac


def _both(td, argv, name):
    """Run argv + output through both CLIs; the two outputs' bytes."""
    out = []
    for tag, main, extra in (("j", jmain, ["-v", "error"]),
                             ("t", tmain, ["-device", "cpu"])):
        path = str(td / f"{tag}_{name}")
        assert main(extra + argv + ["-y", path]) == 0
        with open(path, "rb") as f:
            out.append(f.read())
    return out


def _demux(api, path):
    d = api.open_input(path)
    par = [(s.codecpar.codec_type, s.codecpar.codec_id, s.codecpar.width,
            s.codecpar.height, s.codecpar.sample_rate,
            s.codecpar.nb_channels, bytes(s.codecpar.extradata or b""))
           for s in d.streams]
    pk = [(p.stream_index, p.pts, p.dts, int(p.flags), bytes(p.data))
          for p in d.packets()]
    d.close()
    return par, pk


@pytest.mark.parametrize("src", ["clip", "aac"])
def test_stream_copy_into_flv_matches_jax(media, src):
    td, clip, aac = media
    j, t = _both(td, ["-i", clip if src == "clip" else aac, "-c", "copy"],
                 f"{src}.flv")
    assert j == t and j[:3] == b"FLV"
    path = str(td / f"t_{src}.flv")
    jd, tdm = _demux(JA, path), _demux(TA, path)
    assert jd == tdm
    assert len(tdm[1]) == (8 if src == "clip" else 23)


def test_aac_encode_into_flv(media):
    """-c:a aac into FLV. The JAX muxer writes the encoder's ADTS frames
    with no AudioSpecificConfig, and its own demuxer finds no stream in
    the file (a fault of the reference); the port writes the config tag
    and raw frames, which both demuxers read alike: as many frames as
    the JAX encoder writes, decoding to the tone."""
    from librempeg_tpu.core.errors import InvalidData
    from librempeg_tpu_torch.codecs.api import find_decoder

    td = media[0]
    argv = ["-f", "lavfi", "-i", "sine=frequency=1000:duration=0.5",
            "-c:a", "aac", "-b:a", "96k"]
    _both(td, argv, "enc.flv")
    with pytest.raises(InvalidData, match="no streams"):
        JA.open_input(str(td / "j_enc.flv"))
    jd, tdm = (_demux(api, str(td / "t_enc.flv")) for api in (JA, TA))
    assert jd == tdm
    assert tdm[0][0][:2] == ("audio", "aac") and tdm[0][0][6]
    # as many AAC frames as the JAX encoder's ADTS stream of the tone
    _both(td, argv, "enc.aac")
    assert len(tdm[1]) == len(_demux(JA, str(td / "j_enc.aac"))[1])
    d = TA.open_input(str(td / "t_enc.flv"))
    dec = find_decoder("aac")(d.streams[0].codecpar, device="cpu")
    x = np.concatenate([f.data.numpy() for p in d.packets()
                        for f in dec.decode(p)], 1)
    spec = np.abs(np.fft.rfft(x[0, 2048:2048 + 8192]))
    rate = d.streams[0].codecpar.sample_rate
    assert abs(np.argmax(spec) * rate / 8192 - 1000) < 10


def test_flv_back_to_raw_and_decode(media):
    td, clip, _ = media
    _both(td, ["-i", clip, "-c", "copy"], "clip.flv")
    flv = str(td / "t_clip.flv")
    j, t = _both(td, ["-i", flv, "-c", "copy", "-f", "h264"], "back.264")
    assert j == t
    with open(clip, "rb") as f:
        raw = f.read()
    # the same access units (FLV carries length-prefixed NALs with the
    # parameter sets in its header, so the bytes may be reframed)
    assert _demux(TA, str(td / "t_back.264"))[1] and len(t) > 0.9 * len(raw)
    framemd5 = []
    for src in (clip, flv):
        out = str(td / f"dec_{len(framemd5)}.md5")
        assert tmain(["-i", src, "-f", "framemd5", "-device", "cpu", "-y",
                      out]) == 0
        with open(out) as f:
            framemd5.append([ln.split(",")[-1] for ln in f
                             if not ln.startswith("#")])
    assert framemd5[0] == framemd5[1] and len(framemd5[0]) == 8


def test_interleaved_flv_demux_matches_jax(media, tmp_path):
    _, clip, aac = media
    path = str(tmp_path / "av.flv")
    vin, ain = JA.open_input(clip), JA.open_input(aac)
    mux = JA.open_output(path, "flv")
    vs = mux.add_stream(vin.streams[0].codecpar, vin.streams[0].time_base)
    as_ = mux.add_stream(ain.streams[0].codecpar, ain.streams[0].time_base)
    vp, ap = list(vin.packets()), list(ain.packets())
    for i in range(max(len(vp), len(ap))):
        if i < len(vp):
            mux.write(vp[i].replace(stream_index=vs.index, pts=i * 2,
                                    dts=i * 2))
        if i < len(ap):
            mux.write(ap[i].replace(stream_index=as_.index))
    mux.close()
    jd, tdm = _demux(JA, path), _demux(TA, path)
    assert jd == tdm
    kinds = np.array([p[0] for p in tdm[1]])
    assert (kinds == 0).sum() == len(vp) and (kinds == 1).sum() == len(ap)
