"""The port's HLS and DASH muxers (librempeg_tpu_torch/formats/hls.py)
and demuxers (formats/hlsdemux.py) against the JAX package's, on the
CPU and over loopback HTTP (127.0.0.1, port 0).

The bench asset's H.264 is stream-copied (-c copy) into HLS and DASH
through both CLIs with -metadata hls_time=0.5: the playlist or manifest
text and every MPEG-TS segment are equal bytes. Both packages' demuxers
read the port's playlist and manifest, from the files and over http://,
into the same packets, whose payloads are the asset's access units (a
segment's first with the parameter sets in front).
"""
import os

import pytest

from librempeg_tpu.cli.ffmpeg import main as jmain
from librempeg_tpu.formats import api as JA
from librempeg_tpu_torch.cli.ffmpeg import main as tmain
from librempeg_tpu_torch.formats import api as TA
from test_torch_net import serve

ASSET = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets",
                     "bench_1080p.264")


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    td = tmp_path_factory.mktemp("hls")
    for tag, main, pre in (("j", jmain, ["-v", "error"]),
                           ("t", tmain, ["-device", "cpu"])):
        for name in ("index.m3u8", "manifest.mpd"):
            d = td / tag / name.split(".")[1]
            d.mkdir(parents=True)
            assert main(pre + ["-i", ASSET, "-c", "copy", "-metadata",
                               "hls_time=0.5", "-y", str(d / name)]) == 0
    return td


def _packets(api, url):
    d = api.open_input(url)
    out = [(p.pts, p.dts, int(p.flags), bytes(p.data)) for p in d.packets()]
    d.close()
    return out


@pytest.mark.parametrize("kind,name", [("m3u8", "index.m3u8"),
                                       ("mpd", "manifest.mpd")])
def test_muxer_matches_jax(outs, kind, name):
    j, t = outs / "j" / kind, outs / "t" / kind
    assert sorted(os.listdir(j)) == sorted(os.listdir(t))
    segs = sorted(f for f in os.listdir(t) if f.endswith(".ts"))
    assert len(segs) >= 3
    for f in os.listdir(t):
        assert (j / f).read_bytes() == (t / f).read_bytes(), f
    text = (t / name).read_text()
    assert all(s in text for s in segs)


@pytest.mark.parametrize("name", ["m3u8/index.m3u8", "mpd/manifest.mpd"])
def test_demuxer_matches_jax_from_files_and_http(outs, name):
    src = _packets(TA, ASSET)
    path = str(outs / "t" / name)
    got = [_packets(JA, path), _packets(TA, path)]
    with serve(outs / "t") as base:
        url = f"{base}/{name}"
        got += [_packets(JA, url), _packets(TA, url)]
    assert got[0] == got[1] == got[2] == got[3]
    # the asset's access units; a segment's first repeats the parameter
    # sets in front (each segment decodes on its own)
    assert len(got[1]) == len(src) == 48
    assert all(g[3].endswith(s[3]) for g, s in zip(got[1], src))
    assert sum(g[3] != s[3] for g, s in zip(got[1], src)) >= 3
