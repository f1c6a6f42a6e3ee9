"""-ss/-t in the port against the JAX package's Transcoder.

A 40-frame H.264 clip (64x48, 25 fps, an IDR every 6 frames) as raw
.264 and stream-copied by the port into MP4, Matroska and MPEG-TS goes
through `-ss 0.5 -t 1.0` to framemd5 on the CPU. From every container
the lines are the uninterrupted run's frames with pts in [0.5, 1.5):
frames 13-37 (the seek snaps to the IDR at frame 12, which is decoded
and dropped). From .264, MP4 and Matroska the JAX package gives the same
text; from MPEG-TS it refuses, since its demuxer leaves the stream's
SPS/PPS out of extradata and its decoder then starts at frame 12 with
none (the port's demuxer fills them; ROADMAP section 3b).
"""
import pytest

from librempeg_tpu.core.errors import InvalidData as JInvalidData
from librempeg_tpu.sched import pipeline as JP
from librempeg_tpu_torch.sched import pipeline as TP

from tests.test_torch_slice import make_clip
from tools.audio_jax_repair import framemd5_repaired

SOURCES = ("264", "mp4", "mkv", "ts")


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("seek")
    es = str(d / "clip.264")
    make_clip(es, w=64, h=48, n=40)
    out = {"264": es}
    for ext in SOURCES[1:]:
        out[ext] = str(d / f"clip.{ext}")
        TP.Transcoder(TP.TranscodeSpec(
            input_url=es, output_url=out[ext],
            video=TP.StreamMap(codec="copy"), device="cpu")).run()
    return out


def _lines(path):
    return [ln for ln in open(path).read().splitlines()
            if not ln.startswith("#")]


def _port(src, out, **kw):
    TP.Transcoder(TP.TranscodeSpec(input_url=src, output_url=out,
                                   output_format="framemd5", device="cpu",
                                   **kw)).run()
    return open(out).read()


def _jax(src, out, **kw):
    """The JAX run's framemd5 text, with libavformat's last header line
    that the JAX package leaves out (ROADMAP.md section 3b)."""
    JP.Transcoder(JP.TranscodeSpec(input_url=src, output_url=out,
                                   output_format="framemd5", **kw)).run()
    return framemd5_repaired(open(out).read())


@pytest.mark.parametrize("src", SOURCES)
def test_seek_and_duration(clips, src, tmp_path):
    full = str(tmp_path / "full.md5")
    _port(clips[src], full)
    got = _port(clips[src], str(tmp_path / "t.md5"), seek=0.5, duration=1.0)
    lines = _lines(str(tmp_path / "t.md5"))
    # the header lines as the uninterrupted run's, frames 13-37 of it
    assert got.split("\n0,")[0] == open(full).read().split("\n0,")[0]
    assert lines == _lines(full)[13:38]
    assert len(_lines(full)) == 40
    if src == "ts":
        with pytest.raises(JInvalidData, match="slice before SPS/PPS"):
            _jax(clips[src], str(tmp_path / "j.md5"), seek=0.5,
                 duration=1.0)
    else:
        assert _jax(clips[src], str(tmp_path / "j.md5"), seek=0.5,
                    duration=1.0) == got


def test_every_source_gives_the_same_frames(clips, tmp_path):
    hashes = []
    for src in SOURCES:
        out = str(tmp_path / f"{src}.md5")
        _port(clips[src], out, seek=0.5, duration=1.0)
        hashes.append([ln.split(", ")[-1] for ln in _lines(out)])
    assert len(hashes[0]) == 25 and all(h == hashes[0] for h in hashes)


def test_cli_takes_ss_t_and_the_hash_muxer(clips, tmp_path):
    from librempeg_tpu_torch.cli.ffmpeg import main

    out = str(tmp_path / "cli.md5")
    assert main(["-ss", "0.5", "-i", clips["mkv"], "-t", "00:00:01.0",
                 "-f", "framemd5", "-device", "cpu", "-y", out]) == 0
    want = str(tmp_path / "want.md5")
    _port(clips["mkv"], want, seek=0.5, duration=1.0)
    assert open(out).read() == open(want).read()


def test_audio_seek_matches_jax(tmp_path):
    """A 2 s WAV through -ss 0.5 -t 1.0 to framemd5: the audio chain's
    decode-and-drop (a frame by its end) as the JAX package's."""
    import wave

    import numpy as np

    from librempeg_tpu.utils import testgen

    x = testgen.s16(testgen.audio_mix(44100, 2 * 44100, 2)).T
    wav = str(tmp_path / "in.wav")
    with wave.open(wav, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(44100)
        w.writeframes(np.ascontiguousarray(x).tobytes())
    got = _port(wav, str(tmp_path / "t.md5"), seek=0.5, duration=1.0)
    assert got == _jax(wav, str(tmp_path / "j.md5"), seek=0.5, duration=1.0)
    lines = _lines(str(tmp_path / "t.md5"))
    # 1024-sample frames from the one that ends after 0.5 s to 1.5 s
    assert lines[0].split(",")[2].strip() == "22050" and len(lines) == 44
