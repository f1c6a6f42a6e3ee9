"""The port's ffprobe against the JAX package's: probe() dicts and every
writer's text are equal on each container, with and without the packet
count, and so is main()'s output for -show_streams -show_format
-show_packets. On an MPEG-TS with H.264 the port reads the stream's size
from its SPS where the JAX package reports 0x0 (the demuxer repair of
test_torch_containers); those two values are checked and then put back.
"""
import contextlib
import io

import pytest

from librempeg_tpu.cli import ffprobe as JF
from librempeg_tpu_torch.cli import ffprobe as TF

from tests.test_torch_containers import W, H, _muxed

FILES = {"mp4": "mp4_h264_aac", "mkv": "mkv_mpeg4_aac", "ts": "ts_h264_aac",
         "ts2": "ts_mpeg4_mp3", "y4m": "y4m", "mp3": "mp3",
         "m4a": "mp4_mpeg4_aac"}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("probe")
    out = {}
    for name, case in FILES.items():
        ext = name.rstrip("2")
        out[name] = str(d / f"{name}.{ext}")
        with open(out[name], "wb") as f:
            f.write(_muxed(case)[0])
    return out


def _unrepair(name, info):
    """Check the port's H.264-in-TS size and put the JAX value back."""
    if name != "ts":
        return info
    for s in info["streams"]:
        if s["codec_name"] == "h264":
            assert (s["width"], s["height"]) == (W, H)
            s["width"] = s["height"] = 0
    return info


@pytest.mark.parametrize("count", [False, True])
@pytest.mark.parametrize("name", sorted(FILES))
def test_probe_and_writers_agree(files, name, count):
    j = JF.probe(files[name], count_packets=count)
    t = _unrepair(name, TF.probe(files[name], count_packets=count))
    assert j == t
    assert (len(t.get("packets", [])) > 0) == count
    for w in sorted(JF._WRITERS):
        a, b = io.StringIO(), io.StringIO()
        JF._WRITERS[w](j, a)
        TF._WRITERS[w](t, b)
        assert a.getvalue() == b.getvalue(), w


@pytest.mark.parametrize("of", ["json", "default", "flat", "csv", "ini",
                                "xml"])
def test_main_agrees(files, of):
    for name in ("mp4", "mkv", "ts2"):
        argv = ["-show_streams", "-show_format", "-show_packets", "-of", of,
                files[name]]
        out = []
        for mod in (JF, TF):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert mod.main(argv) == 0
            out.append(buf.getvalue())
        assert out[0] == out[1] and out[0]
