"""The CLI's stream and run options in the port against the JAX
package's, on the CPU: -c/-codec, -map, -v/-loglevel, -progress and
-stats_period, -benchmark and -threads (librempeg_tpu_torch/cli/
ffmpeg.py parse_cli; sched/pipeline.py maps, _map_matches and
run(progress=...)).

Both parsers read the same spec and global options; -c copy and -map
write the same bytes through both CLIs, exactly; the -progress file
holds the JAX package's keys in its order, block by block, and ends
with progress=end. -mesh reads into the spec as in the JAX package (the
mesh run itself is tests/test_torch_product_mesh.py's).
"""
import pytest

from librempeg_tpu.cli.ffmpeg import main as jmain
from librempeg_tpu.cli.ffmpeg import parse_args as jparse
from librempeg_tpu.core.log import get_level as jget_level
from librempeg_tpu.core.log import set_level as jset_level
from librempeg_tpu.formats import api as JA
from librempeg_tpu_torch.cli.ffmpeg import parse_cli
from librempeg_tpu_torch.cli.ffmpeg import main as tmain
from librempeg_tpu_torch.core.log import get_level as tget_level
from librempeg_tpu_torch.core.log import set_level as tset_level
from librempeg_tpu_torch.formats import api as TA
from librempeg_tpu_torch.sched.pipeline import _map_matches
from tests.test_torch_slice import make_clip

ARGV = ["-v", "error", "-i", "in.flv", "-c", "copy", "-map", "0:v",
        "-map", "0:a:0", "-progress", "p.txt", "-stats_period", "0.25",
        "-benchmark", "-threads", "2", "-y", "out.mkv"]


@pytest.fixture(scope="module")
def av(tmp_path_factory):
    """An FLV with H.264 (8 frames) and AAC."""
    td = tmp_path_factory.mktemp("maps")
    clip, tone, path = (str(td / n) for n in ("c.264", "a.flv", "av.flv"))
    make_clip(clip, w=64, h=48, n=8)
    assert tmain(["-f", "lavfi", "-i", "sine=frequency=1000:duration=0.4",
                  "-c:a", "aac", "-device", "cpu", "-y", tone]) == 0
    vin, ain = TA.open_input(clip), TA.open_input(tone)
    mux = TA.open_output(path, "flv")
    vs = mux.add_stream(vin.streams[0].codecpar, vin.streams[0].time_base)
    as_ = mux.add_stream(ain.streams[0].codecpar, ain.streams[0].time_base)
    vp, ap = list(vin.packets()), list(ain.packets())
    for i in range(max(len(vp), len(ap))):
        if i < len(ap):
            mux.write(ap[i].replace(stream_index=as_.index))
        if i < len(vp):
            mux.write(vp[i].replace(stream_index=vs.index, pts=i * 40,
                                    dts=i * 40))
    mux.close()
    return td, path


def test_options_parse_as_in_jax():
    before = jget_level(), tget_level()
    try:
        jspec, jglob = jparse(ARGV)
        jlevel = jget_level()
        tspec, tglob = parse_cli(ARGV)
        assert tget_level() == jlevel != before[1]
    finally:
        jset_level(before[0])
        tset_level(before[1])
    assert (tspec.video.codec, tspec.audio.codec, tspec.maps) == \
        (jspec.video.codec, jspec.audio.codec, jspec.maps) == \
        ("copy", "copy", ["0:v", "0:a:0"])
    assert tglob == jglob
    assert not tspec.codec_opts
    mesh_argv = ["-i", "a.264", "-mesh", "data=2,spatial=3", "o.avi"]
    assert parse_cli(mesh_argv)[0].mesh == jparse(mesh_argv)[0].mesh == \
        "data=2,spatial=3"


@pytest.mark.parametrize("maps,want", [
    ([], "va"), (["0"], "va"), (["0:v"], "v"), (["0:a"], "a"),
    (["0:1"], "a"), (["0:v:0"], "v"), (["0:a:1"], ""), (["1:v"], ""),
    (["0:s"], "")])
def test_map_matches(av, maps, want):
    d = TA.open_input(av[1])
    kinds = {0: "v", 1: "a"}
    got = "".join(kinds[s.index] for s in d.streams
                  if not maps or _map_matches(maps, s, 0))
    assert got == want


@pytest.mark.parametrize("extra,ext", [
    (["-c", "copy"], "mkv"), (["-map", "0:v", "-c", "copy"], "mkv"),
    (["-map", "0:a", "-c", "copy"], "mkv"),
    (["-map", "0:v", "-c:v", "copy", "-f", "h264"], "264")],
    ids=["copy", "map_v", "map_a", "raw"])
def test_copy_and_map_match_jax(av, extra, ext):
    td, path = av
    out = []
    for tag, main, pre in (("j", jmain, ["-v", "error"]),
                           ("t", tmain, ["-device", "cpu"])):
        o = str(td / f"{tag}_{'_'.join(extra)}.{ext}")
        assert main(pre + ["-i", path] + extra + ["-y", o]) == 0
        with open(o, "rb") as f:
            out.append(f.read())
    assert out[0] == out[1] and len(out[1]) > 1000
    if "0:a" in extra:
        d = TA.open_input(str(td / f"t_{'_'.join(extra)}.{ext}"))
        assert [s.codecpar.codec_type for s in d.streams] == ["audio"]


def test_progress_feed_matches_jax(av, capsys):
    td, path = av
    blocks = []
    for tag, main, pre in (("j", jmain, []), ("t", tmain, ["-device", "cpu"])):
        prog = str(td / f"{tag}_progress.txt")
        assert main(pre + ["-i", path, "-map", "0:v", "-c:v", "rawvideo",
                           "-progress", prog, "-stats_period", "0",
                           "-benchmark", "-threads", "2", "-f", "framemd5",
                           "-y", str(td / f"{tag}.md5")]) == 0
        with open(prog) as f:
            lines = f.read().splitlines()
        blocks.append([ln.split("=")[0] for ln in lines])
        assert lines[-1] == "progress=end"
        assert lines[-6] == "frame=8"
    assert blocks[0][-6:] == blocks[1][-6:] == [
        "frame", "fps", "out_time_us", "out_time", "speed", "progress"]
    assert set(blocks[0]) == set(blocks[1])
    assert "bench: utime=" in capsys.readouterr().err
