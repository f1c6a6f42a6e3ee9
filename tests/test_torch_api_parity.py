"""The last of the JAX package's public API in the port, against the JAX
package on the CPU:

- the CLI's option table: every option of librempeg_tpu/cli/ffmpeg.py's
  parse_args, with each of its aliases, gives the port the same video
  and audio stream settings (`-q` is the video quantiser in both), and
  `-q 5` encodes the bytes `-q:v 5` does;
- core.frame's stack_video/unstack_video (tests/test_core.py's round
  trip) and AudioFrame.duration, exported from core as the JAX package
  exports them;
- Resampler.delay after every chunk of a stream and after the flush.
"""
import numpy as np
import pytest
import torch

from librempeg_tpu.cli import ffmpeg as JCLI
from librempeg_tpu.core import AudioFrame as JAudio
from librempeg_tpu.core import VideoFrame as JVideo
from librempeg_tpu.core import stack_video as jstack
from librempeg_tpu.core import unstack_video as junstack
from librempeg_tpu.core.rational import Rational as JRational
from librempeg_tpu.resample.resampler import Resampler as JResampler
from librempeg_tpu_torch.cli import ffmpeg as TCLI
from librempeg_tpu_torch.core import AudioFrame, VideoFrame, stack_video
from librempeg_tpu_torch.core import unstack_video
from librempeg_tpu_torch.core.rational import Rational
from librempeg_tpu_torch.resample.resampler import Resampler

# (argv after "-i in.264", the stream settings it should set)
OPTIONS = [
    ["-q", "5"], ["-q:v", "5"], ["-qscale:v", "3.5"],
    ["-b", "4M"], ["-b:v", "500k"], ["-b:a", "128k"], ["-b:v", "2000000"],
    ["-s", "320x240"], ["-s:v", "320x240"], ["-video_size", "64x48"],
    ["-r", "30000/1001"], ["-r:v", "25"], ["-framerate", "12"],
    ["-pix_fmt", "yuvj420p"], ["-ar", "44100"], ["-ac", "1"],
    ["-channels", "2"], ["-ch_layout", "mono"],
    ["-c", "copy"], ["-codec", "copy"], ["-c:v", "mpeg4"],
    ["-codec:v", "mjpeg"], ["-vcodec", "h264"], ["-c:a", "aac"],
    ["-codec:a", "flac"], ["-acodec", "ac3"],
    ["-vf", "scale=64:48"], ["-filter:v", "hflip"],
    ["-af", "volume=0.5"], ["-filter:a", "aresample=48000"],
    ["-frames:v", "3"], ["-vframes", "4"], ["-frames:a", "5"],
    ["-aframes", "6"], ["-g", "12"], ["-bf", "2"], ["-trellis", "1"],
    ["-ss", "1.5"], ["-t", "00:00:02.5"], ["-an"], ["-vn"],
    ["-metadata", "title=x"], ["-map", "0:v"], ["-mesh", "spatial=2"],
]


def _stream(s):
    return (s.codec, s.filters, s.width, s.height, s.pix_fmt,
            s.sample_rate, s.channels, s.frames_limit,
            {k: (float(v) if isinstance(v, (int, float)) else v)
             for k, v in s.codec_opts.items()})


@pytest.mark.parametrize("opt", OPTIONS, ids=" ".join)
def test_option_table_matches_jax(opt):
    argv = ["-i", "in.264", *opt, "out.avi"]
    jspec, _ = JCLI.parse_args(argv)
    tspec, _ = TCLI.parse_cli(argv)
    assert _stream(tspec.video) == _stream(jspec.video)
    # the port's audio map starts as pcm_s16le where the JAX one has no
    # codec; every option sets the same field in both
    ja, ta = _stream(jspec.audio), _stream(tspec.audio)
    assert ta[1:] == ja[1:]
    assert ta[0] == (ja[0] or "pcm_s16le")
    for key in ("seek", "duration", "no_audio", "no_video", "metadata",
                "maps", "mesh"):
        assert getattr(tspec, key, None) == getattr(jspec, key, None), key


def test_q_is_the_video_quantiser():
    argv = ["-i", "in.264", "-q", "5", "out.avi"]
    jspec, _ = JCLI.parse_args(argv)
    tspec, _ = TCLI.parse_cli(argv)
    assert jspec.video.codec_opts == {"quality_scale": 5.0}
    assert tspec.video.codec_opts == jspec.video.codec_opts
    assert "codec_opts" not in vars(tspec) or not tspec.codec_opts


def test_q_encodes_as_q_v(tmp_path):
    src = ["-f", "lavfi", "-i", "testsrc=size=96x64:rate=25:duration=0.32",
           "-c:v", "mpeg4", "-device", "cpu"]
    out = {}
    for name, q in (("q", "-q"), ("qv", "-q:v")):
        path = tmp_path / f"{name}.avi"
        assert TCLI.main(src + [q, "5", "-y", str(path)]) == 0
        out[name] = path.read_bytes()
    assert out["q"] == out["qv"] and len(out["q"]) > 1000


def _planes(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (48, 64), np.uint8),
            rng.integers(0, 256, (24, 32), np.uint8),
            rng.integers(0, 256, (24, 32), np.uint8))


def test_stack_unstack_matches_jax():
    kw = dict(format="yuv420p", width=64, height=48)
    jf = [JVideo(planes=_planes(i), pts=i, **kw) for i in range(4)]
    tf = [VideoFrame(planes=tuple(torch.from_numpy(p) for p in _planes(i)),
                     pts=i, **kw) for i in range(4)]
    jb, tb = jstack(jf), stack_video(tf)
    assert tb.planes[0].shape == (4, 48, 64)
    assert tb.side_data == jb.side_data == {"batch_pts": [0, 1, 2, 3]}
    for jp, tp in zip(jb.planes, tb.planes):
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    jo, to = junstack(jb), unstack_video(tb)
    assert [f.pts for f in to] == [f.pts for f in jo] == [0, 1, 2, 3]
    for j, t in zip(jo, to):
        assert t.side_data == j.side_data == {}
        for jp, tp in zip(j.planes, t.planes):
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # numpy planes stack too; a batch without batch_pts unstacks to NOPTS
    nb = stack_video([VideoFrame(planes=_planes(9), **kw)] * 2)
    assert [f.pts for f in unstack_video(nb.replace(side_data={}))] == \
        [f.pts for f in junstack(jstack([JVideo(planes=_planes(9), **kw)] * 2)
                                 .replace(side_data={}))]


@pytest.mark.parametrize("n,rate,tb", [(480, 48000, None),
                                       (1024, 44100, (1, 1000)),
                                       (1152, 32000, (1, 90000)),
                                       (333, 22050, (1001, 30000))])
def test_audio_frame_duration_matches_jax(n, rate, tb):
    kw = {} if tb is None else {"time_base": tb}
    j = JAudio(data=np.zeros((2, n), np.float32), sample_rate=rate,
               **{k: JRational(*v) for k, v in kw.items()})
    t = AudioFrame(data=torch.zeros((2, n)), sample_rate=rate,
                   **{k: Rational(*v) for k, v in kw.items()})
    assert t.duration == j.duration
    if tb is None:
        assert t.duration == n


@pytest.mark.parametrize("rin,rout", [(44100, 48000), (48000, 44100),
                                      (48000, 16000)])
def test_resampler_delay_matches_jax(rin, rout):
    x = np.random.default_rng(rin).standard_normal((2, 9000)) \
        .astype(np.float32)
    j, t = JResampler(rin, rout, 2), Resampler(rin, rout, 2, device="cpu")
    assert t.delay == j.delay == 0
    delays = []
    for s, e in ((0, 100), (100, 1500), (1500, 1501), (1501, 9000)):
        j.process(x[:, s:e])
        t.process(torch.from_numpy(x[:, s:e]))
        delays.append(j.delay)
        assert t.delay == j.delay
    assert max(delays) > 0
    j.flush()
    t.flush()
    assert t.delay == j.delay
