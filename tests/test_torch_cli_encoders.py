"""The port's CLI options that reach the new encoders: -to as a position,
private codec options and their :v/:a scopes, -g and -bf, and the
H.264 and MPEG-2 encoders through both packages' CLIs.

Where the JAX package is wrong the test asserts its fault beside the
port's behaviour (ROADMAP section 3b): its CLI reads every -to as a
duration, and its pipeline drops -g and -bf (stored as gop_size and
max_b_frames) for an encoder that declares g and bf.
"""
import numpy as np
import pytest

from librempeg_tpu.cli.ffmpeg import parse_args as jparse
from librempeg_tpu.sched.pipeline import Transcoder as JT
from librempeg_tpu_torch.cli.ffmpeg import CliError
from librempeg_tpu_torch.cli.ffmpeg import main as tmain
from librempeg_tpu_torch.cli.ffmpeg import parse_args as tparse
from librempeg_tpu_torch.core.errors import Unsupported
from librempeg_tpu_torch.sched.pipeline import Transcoder as TT


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    from tests.test_torch_slice import make_clip

    path = tmp_path_factory.mktemp("cli") / "clip.264"
    make_clip(str(path))
    return str(path)


@pytest.mark.parametrize("argv,seek,duration,jax_duration", [
    # output -to: a position on the output timeline
    (["-i", "in.264", "-to", "2", "o.264"], 0.0, 2.0, 2.0),
    # output -ss and output -to: the run lasts to - ss
    (["-i", "in.264", "-ss", "0.5", "-to", "1.5", "o.264"], 0.5, 1.0, 1.5),
    # input -ss restarts the timestamps at 0: -to acts as a duration
    (["-ss", "0.5", "-i", "in.264", "-to", "1.5", "o.264"], 0.5, 1.5, 1.5),
    # input -ss and input -to: positions on the input's timeline
    (["-ss", "0.5", "-to", "1.5", "-i", "in.264", "o.264"], 0.5, 1.0, 1.5),
    # output -ss, input -to: the input ends at 1.5, the output drops <0.5
    (["-to", "1.5", "-i", "in.264", "-ss", "0.5", "o.264"], 0.5, 1.0, 1.5),
    # -t wins over -to, on either side of it
    (["-i", "in.264", "-ss", "0.5", "-t", "0.4", "-to", "1.5", "o.264"],
     0.5, 0.4, 1.5),
    (["-i", "in.264", "-to", "1.5", "-t", "0.4", "o.264"], 0.0, 0.4, 0.4),
    (["-i", "in.264", "-to", "00:00:01.250", "o.264"], 0.0, 1.25, 1.25),
])
def test_to_is_a_position(argv, seek, duration, jax_duration):
    t, _ = tparse(argv)
    assert (t.seek, t.duration) == (seek, pytest.approx(duration))
    j, _ = jparse(argv)
    assert j.duration == pytest.approx(jax_duration)


@pytest.mark.parametrize("argv", [
    ["-i", "in.264", "-ss", "1", "-to", "1", "o.264"],
    ["-i", "in.264", "-ss", "1.5", "-to", "0.5", "o.264"],
    ["-ss", "1", "-to", "0.5", "-i", "in.264", "o.264"],
    ["-to", "0", "-i", "in.264", "o.264"],
])
def test_to_at_or_before_ss_raises(argv):
    with pytest.raises(CliError):
        tparse(argv)


def _framemd5(tmp_path, clip, name, *opts):
    out = tmp_path / f"{name}.md5"
    assert tmain(["-i", clip, *opts, "-f", "framemd5", "-device", "cpu",
                  "-y", str(out)]) == 0
    return [ln for ln in out.read_text().splitlines()
            if not ln.startswith("#")]


def test_to_runs_like_t(clip, tmp_path):
    """-ss 0.24 -to 0.36 is -ss 0.24 -t 0.12: frames 6-8 of the 25 fps
    clip (6 is its second IDR); -to 0.2 alone is its first 5 frames."""
    a = _framemd5(tmp_path, clip, "a", "-ss", "0.24", "-to", "0.36")
    b = _framemd5(tmp_path, clip, "b", "-ss", "0.24", "-t", "0.12")
    c = _framemd5(tmp_path, clip, "c")
    assert a == b == c[6:9]
    assert _framemd5(tmp_path, clip, "d", "-to", "0.2") == c[:5]


def _encoder_opts(argv):
    spec, _ = tparse(argv + ["-device", "cpu"])
    tc = TT(spec)
    try:
        return tc.chains[0].encoder.opts
    finally:
        tc.demux.close()


def test_private_options_reach_the_encoder(clip, tmp_path):
    out = str(tmp_path / "o.264")
    opts = _encoder_opts(["-i", clip, "-c:v", "h264", "-qp", "31", "-sr",
                          "3", "-cabac", "1", "-y", out])
    assert (opts["qp"], opts["sr"], opts["cabac"]) == (31, 3, 1)
    opts = _encoder_opts(["-i", clip, "-c:v", "h264", "-qp:v", "17",
                          "-variety:v", "1", "-y", out])
    assert (opts["qp"], opts["variety"]) == (17, 1)
    # a scoped option wins over the unscoped one
    opts = _encoder_opts(["-i", clip, "-c:v", "h264", "-qp", "30",
                          "-qp:v", "22", "-y", out])
    assert opts["qp"] == 22
    # an :a option with no audio stream binds to no encoder
    opts = _encoder_opts(["-i", clip, "-c:v", "h264", "-qp:a", "40", "-y",
                          out])
    assert opts["qp"] == 26
    spec, _ = tparse(["-i", clip, "-qp", "30", "-qp:v", "20", "-qp:a", "9",
                      out])
    assert spec.codec_opts == {"qp": "30"}
    assert spec.video.codec_opts == {"qp": "20"}
    assert spec.audio.codec_opts == {"qp": "9"}
    # the JAX package's CLI: unscoped options go to both streams
    j, _ = jparse(["-i", clip, "-qp", "30", out])
    assert j.video.codec_opts["qp"] == j.audio.codec_opts["qp"] == "30"


@pytest.mark.parametrize("argv,match", [
    # mpeg4 declares no qp: unscoped, no encoder of the run takes it
    (["-c:v", "mpeg4", "-qp", "30"], "not declared by any encoder"),
    # scoped to the video encoder, which does not declare it
    (["-c:v", "mpeg4", "-qp:v", "30"], "unknown option 'qp'"),
    # MPEG-1/2 declares g but no B frames: -bf stays max_b_frames
    (["-c:v", "mpeg2video", "-bf", "1"], "unknown option 'max_b_frames'"),
    (["-c:v", "h264", "-nonsense", "1"], "not declared by any encoder"),
])
def test_undeclared_options_raise(clip, tmp_path, argv, match):
    with pytest.raises(Unsupported, match=match):
        _encoder_opts(["-i", clip, *argv, "-y", str(tmp_path / "o.mkv")])


def test_undeclared_pre_input_option_raises(clip):
    """A private option before -i goes to the demuxer, which refuses a
    name it does not take."""
    spec, _ = tparse(["-probesize_x", "5", "-i", clip, "-device", "cpu",
                      "o.264"])
    assert spec.input_opts == {"probesize_x": "5"}
    with pytest.raises(TypeError):
        TT(spec)


def test_g_and_bf_reach_the_encoders(clip, tmp_path):
    """-g and -bf become the g and bf that H264Encoder and Mpeg1Encoder
    declare; the JAX pipeline drops them, so its encoders keep g 12 and
    bf 0."""
    out = str(tmp_path / "o.264")
    opts = _encoder_opts(["-i", clip, "-c:v", "h264", "-g", "3", "-bf", "1",
                          "-y", out])
    assert (opts["g"], opts["bf"]) == (3, 1)
    opts = _encoder_opts(["-i", clip, "-c:v", "mpeg2video", "-g", "5", "-y",
                          str(tmp_path / "o.m2v")])
    assert opts["g"] == 5
    # mpeg4 declares gop_size and max_b_frames itself
    opts = _encoder_opts(["-i", clip, "-c:v", "mpeg4", "-g", "6", "-bf", "2",
                          "-y", str(tmp_path / "o.avi")])
    assert (opts["gop_size"], opts["max_b_frames"]) == (6, 2)
    j, _ = jparse(["-i", clip, "-c:v", "h264", "-g", "3", "-bf", "1", "-y",
                   out])
    jt = JT(j)
    assert (jt.chains[0].encoder.opts["g"],
            jt.chains[0].encoder.opts["bf"]) == (12, 0)
    jt.demux.close()


def _packets(path):
    from librempeg_tpu_torch.formats.api import open_input

    d = open_input(str(path))
    return [(bytes(p.data), p.pts, int(p.flags)) for p in d.packets()]


@pytest.mark.parametrize("argv,ext,jax_opts", [
    (["-c:v", "h264", "-qp", "26", "-sr", "4"], "264", {}),
    (["-c:v", "h264", "-qp", "30", "-cabac", "1", "-frames:v", "5"], "mp4",
     {}),
    # the JAX CLI drops -g and -bf: its encoder is given g and bf
    (["-c:v", "h264", "-qp:v", "28", "-g", "4", "-bf", "1"], "mkv",
     {"g": "4", "bf": "1"}),
    (["-c:v", "h264", "-qp", "26", "-bf", "1", "-f", "mpegts"], "ts",
     {"bf": "1"}),
    (["-c:v", "mpeg2video", "-q:v", "5"], "m2v", {}),
    (["-c:v", "mpeg1video", "-q:v", "7", "-g", "4"], "m1v", {"g": "4"}),
])
def test_encoders_through_both_clis(clip, tmp_path, argv, ext, jax_opts):
    """The same file from both packages' parser and Transcoder."""
    jout, tout = tmp_path / f"j.{ext}", tmp_path / f"t.{ext}"
    j, _ = jparse(["-i", clip, *argv, "-y", str(jout)])
    for k in ("gop_size", "max_b_frames"):
        j.video.codec_opts.pop(k, None)
    j.video.codec_opts.update(jax_opts)
    JT(j).run()
    assert tmain(["-i", clip, *argv, "-device", "cpu", "-y",
                  str(tout)]) == 0
    assert tout.read_bytes() == jout.read_bytes()
    pk = _packets(tout)
    assert len(pk) == (5 if "-frames:v" in argv else 12)
    if ext == "mkv":
        # I0 P2 B1, then P3 closes the GOP before I4 (pts in ms)
        assert [p for _, p, _ in pk][:5] == [0, 80, 40, 120, 160]


def test_h264_cli_output_decodes_to_the_encoder_input_quality(clip,
                                                            tmp_path):
    """-c:v h264 -qp 20 written as .264 and decoded back by the port:
    every frame within a PSNR floor of the source's decode."""
    from librempeg_tpu_torch.codecs.h264.codec import H264Decoder
    from librempeg_tpu_torch.formats.api import open_input

    out = tmp_path / "o.264"
    assert tmain(["-i", clip, "-c:v", "h264", "-qp", "20", "-device", "cpu",
                  "-y", str(out)]) == 0

    def decoded(path):
        d = open_input(str(path))
        dec = H264Decoder(d.streams[0].codecpar, device="cpu")
        fr = [f for p in d.packets() for f in dec.decode(p)] + dec.flush()
        dec.close()
        return [np.concatenate([np.asarray(q, np.float64).ravel()
                                for q in f.planes]) for f in fr]

    a, b = decoded(clip), decoded(out)
    assert len(a) == len(b) == 12
    for x, y in zip(a, b):
        mse = float(((x - y) ** 2).mean())
        assert 10 * np.log10(255 ** 2 / max(mse, 1e-9)) > 38.0
