"""The port's lavfi virtual input (formats/lavfi.py), the rawvideo
decoder it feeds and `-f lavfi` on the CLI, against the JAX package's,
on the CPU -- the cases of the JAX package's tests/test_lavfi.py.

The packets (bytes, pts) are equal to the JAX package's; the decoded
rawvideo and pcm_f32le frames equal the source filters' output; the
CLI writes MPEG-4 in AVI from testsrc (the JAX package's VOP types and
I-VOP bytes, the total size within 2% of its transcode of the same
graph at -q:v 4) and AAC from sine.
"""
import numpy as np
import pytest

from librempeg_tpu.formats.api import open_input as jopen
from librempeg_tpu_torch.cli.ffmpeg import main as tmain
from librempeg_tpu_torch.codecs.api import find_decoder
from librempeg_tpu_torch.formats.api import open_input as topen


@pytest.mark.parametrize("graph", [
    "testsrc2=size=64x48:rate=25:duration=0.2",
    "testsrc=size=96x64:rate=25:duration=0.2",
    "testsrc2=size=64x48:duration=0.2,negate,hflip",
    "color=c=red:size=32x16:duration=0.12",
    "sine=frequency=440:duration=0.1",
    "sine=frequency=1000:duration=0.05,volume=0.5",
])
def test_lavfi_packets_match_jax(graph):
    jd, td = jopen(graph, format="lavfi"), topen(graph, format="lavfi")
    jp, tp = list(jd.packets()), list(td.packets())
    assert len(jp) == len(tp) > 0
    for a, b in zip(jp, tp):
        assert (a.pts, a.dts, a.duration) == (b.pts, b.dts, b.duration)
        assert bytes(a.data) == bytes(b.data)
    jc, tc = jd.streams[0].codecpar, td.streams[0].codecpar
    assert (jc.codec_id, jc.width, jc.height, jc.pix_fmt, jc.sample_rate,
            jc.nb_channels) == (tc.codec_id, tc.width, tc.height,
                                tc.pix_fmt, tc.sample_rate, tc.nb_channels)


def test_video_source():
    d = topen("testsrc2=size=64x48:rate=25:duration=0.2", format="lavfi")
    par = d.streams[0].codecpar
    assert (par.codec_id, par.width, par.height) == ("rawvideo", 64, 48)
    pkts = list(d.packets())
    assert [p.pts for p in pkts] == [0, 1, 2, 3, 4]
    dec = find_decoder("rawvideo")(par, device="cpu")
    from librempeg_tpu_torch.utils import testgen

    for p in pkts:
        (f,) = dec.decode(p)
        want = testgen.video_yuv420(64, 48, p.pts)
        for got, w in zip(f.planes, want):
            np.testing.assert_array_equal(got.numpy(), w)


def test_audio_source():
    d = topen("sine=frequency=440:duration=0.1", format="lavfi")
    par = d.streams[0].codecpar
    assert par.codec_id == "pcm_f32le"
    pkts = list(d.packets())
    dec = find_decoder("pcm_f32le")(par, device="cpu")
    x = np.concatenate([dec.decode(p)[0].data.numpy() for p in pkts], 1)
    assert x.shape == (1, int(0.1 * par.sample_rate))
    assert 0.2 < np.max(np.abs(x)) <= 1.0


def _avi_payloads(path):
    from chip_smoke import avi_payloads

    return avi_payloads(str(path))


def vop_type(data: bytes) -> str:
    from chip_smoke import vop_type as vt

    return vt(data)


def test_cli_testsrc_mpeg4_matches_jax(tmp_path):
    from librempeg_tpu.cli.ffmpeg import main as jmain

    args = ["-f", "lavfi", "-i", "testsrc=size=64x48:rate=25:duration=0.4",
            "-c:v", "mpeg4", "-q:v", "4", "-y"]
    assert jmain(["-v", "error"] + args + [str(tmp_path / "j.avi")]) == 0
    assert tmain(args + ["-device", "cpu", str(tmp_path / "t.avi")]) == 0
    jv, tv = _avi_payloads(tmp_path / "j.avi"), _avi_payloads(
        tmp_path / "t.avi")
    assert len(jv) == len(tv) == 10
    # the I-VOP is the same bytes; the P-VOPs' float searches may settle
    # a near-tie differently (the port's MPEG-4 encoder's contract,
    # tests/test_torch_mpeg4.py), so their sizes stay close
    assert jv[0] == tv[0]
    assert [vop_type(v) for v in jv] == [vop_type(v) for v in tv]
    assert sum(map(len, tv)) == pytest.approx(sum(map(len, jv)), rel=0.02)


def test_cli_sine_aac(tmp_path):
    out = tmp_path / "s.aac"
    assert tmain(["-f", "lavfi", "-i", "sine=frequency=1000:duration=1",
                  "-c:a", "aac", "-b:a", "128k", "-device", "cpu", "-y",
                  str(out)]) == 0
    data = out.read_bytes()
    assert data[:2] == b"\xff\xf1" and len(data) > 4000
    d = topen(str(out))
    dec = find_decoder("aac")(d.streams[0].codecpar, device="cpu")
    x = np.concatenate([f.data.numpy() for p in d.packets()
                        for f in dec.decode(p)], 1)
    assert x.shape[0] == 1 and x.shape[1] >= 44100
    # a 1 kHz tone at half scale: its spectrum peaks at 1 kHz
    spec = np.abs(np.fft.rfft(x[0, 4096:4096 + 32768]))
    assert abs(np.argmax(spec) * 44100 / 32768 - 1000) < 3
