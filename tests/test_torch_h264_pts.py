"""The H.264 decoder's display pts in both packages on the CPU.

The raw .264 demuxer stamps packets 0, 1, 2, ... in decode order. The
JAX decoder gives each frame its own packet's pts while it outputs in
POC order, so a stream with B frames decodes to pts 0, 2, 1, 4, 3, ...
(asserted here as the JAX package's fault). The port's decoder stamps
each frame as it leaves with the least pts of the pictures decoded and
not yet output (the HEVC decoder's rule), so the same stream decodes to
0, 1, 2, 3, 4, ... with the same frames. Display-order pts, as an MP4's
ctts gives them, come out as they were in both packages.

The stream: tests/test_torch_slice.py's make_clip (96x64) re-encoded by
the port's CLI at `-c:v h264 -bf 1 -g 6`.
"""
import pytest

from librempeg_tpu.cli import ffmpeg as JCLI
from librempeg_tpu_torch.cli import ffmpeg as TCLI

N = 12


def rows(path):
    """(pts, hash) of each frame line of a framemd5 file."""
    out = []
    for ln in open(path).read().splitlines():
        if not ln.startswith("#"):
            f = ln.split(",")
            out.append((int(f[2]), f[5].strip()))
    return out


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    from tests.test_torch_slice import make_clip

    d = tmp_path_factory.mktemp("h264pts")
    make_clip(str(d / "clip.264"), n=N)
    for ext in ("264", "mp4"):
        assert TCLI.main(["-i", str(d / "clip.264"), "-c:v", "h264", "-bf",
                          "1", "-g", "6", "-device", "cpu", "-y",
                          str(d / f"b.{ext}")]) == 0
    return d


def decode_both(d, src):
    assert JCLI.main(["-i", str(d / src), "-f", "framemd5", "-y",
                      str(d / "j.md5")]) == 0
    assert TCLI.main(["-i", str(d / src), "-f", "framemd5", "-device",
                      "cpu", "-y", str(d / "t.md5")]) == 0
    return rows(d / "j.md5"), rows(d / "t.md5")


def test_raw_stream_decodes_to_display_pts(streams):
    j, t = decode_both(streams, "b.264")
    assert [p for p, _ in t] == list(range(N))
    assert [h for _, h in t] == [h for _, h in j]
    # the JAX package's fault: each B frame keeps its packet's
    # decode-order pts
    assert [p for p, _ in j][:5] == [0, 2, 1, 4, 3]


def test_mp4_copy_keeps_its_ctts_times(streams):
    j, t = decode_both(streams, "b.mp4")
    assert t == j
    assert [p for p, _ in t] == sorted(p for p, _ in t)
    assert len(t) == N
    # the MP4 carries B frames: its packets' pts are out of decode order
    from librempeg_tpu_torch.formats.api import open_input

    pts = [p.pts for p in open_input(str(streams / "b.mp4")).packets()]
    assert pts != sorted(pts)
    # the MP4 copied back to a raw .264 (chip_smoke's E1 check): its
    # packets restamped 0, 1, 2, ... in decode order decode to the same
    # frames, stamped 0, 1, 2, ... in display order
    assert TCLI.main(["-i", str(streams / "b.mp4"), "-c:v", "copy",
                      "-device", "cpu", "-y", str(streams / "c.264")]) == 0
    _, r = decode_both(streams, "c.264")
    assert [p for p, _ in r] == list(range(N))
    assert [h for _, h in r] == [h for _, h in t]
