"""HEVC through both packages' CLIs: raw .265, MP4, Matroska and
MPEG-TS, and raw MPEG-4 (.m4v).

Single-slice streams: `-c:v copy` writes the same file in both packages,
ffprobe reads the same JSON from it, and the frames decode to the same
hashes (in MPEG-TS the port's demuxer reads the size from the SPS,
where the JAX package's reads 0x0, as for H.264). Two faults of the JAX
package are repaired in the port and asserted here beside it:

* its raw HEVC demuxer ends an access unit at every slice segment, so a
  picture of two slice segments becomes two packets, a copy into a
  container stores them as two samples, and its decoder (which groups
  slice segments only within a packet) fails on them; the port's
  demuxer makes one packet of a picture;
* its decoder stamps each frame with its packet's pts and outputs the
  frames in display order, so a raw I P B P B stream's frames read pts
  0, 2, 1, 4, 3; the port's read 0, 1, 2, 3, 4.
"""
import contextlib
import hashlib
import io
import json

import numpy as np
import pytest

from librempeg_tpu.codecs.hevc import decoder as JD
from librempeg_tpu.core.packet import Packet as JPacket
from librempeg_tpu.formats import api as JA
from librempeg_tpu_torch.codecs.hevc import decoder as TD
from librempeg_tpu_torch.formats import api as TA

W, H = 96, 64
CONTAINERS = ("mp4", "mkv", "ts")


def _cli(pkg, argv):
    if pkg == "jax":
        from librempeg_tpu.cli.ffmpeg import main
        return main(["-v", "error"] + argv)
    from librempeg_tpu_torch.cli.ffmpeg import main
    return main(argv + ["-device", "cpu"])


def _probe(pkg, path) -> dict:
    if pkg == "jax":
        from librempeg_tpu.cli import ffprobe
    else:
        from librempeg_tpu_torch.cli import ffprobe
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert ffprobe.main(["-show_streams", "-show_format",
                             "-show_packets", "-of", "json", path]) == 0
    info = json.loads(buf.getvalue())
    info["format"]["filename"] = "x"
    return info


def _md5_lines(path) -> list[tuple[int, str]]:
    """(pts, md5) of each frame line of a framemd5 file (stream, dts,
    pts, duration, size, hash and, for a packet, its flags where they
    are not key)."""
    rows = [ln.split(",") for ln in open(path).read().splitlines()
            if ln and not ln.startswith("#")]
    return [(int(r[2]), r[5].strip()) for r in rows]


def _ranks(pts: list[int]) -> list[int]:
    """Each pts's place among them (the containers' time bases differ:
    Matroska counts milliseconds)."""
    order = sorted(pts)
    return [order.index(p) for p in pts]


def _whole_decode_md5s(stream: bytes) -> list[str]:
    """The JAX decoder's frames of the stream given whole (its own tests'
    way), hashed as framemd5 hashes them."""
    dec = JD.HevcDecoder()
    frames = dec.decode(JPacket(data=stream, pts=0)) + dec.flush()
    return [hashlib.md5(b"".join(np.ascontiguousarray(p).tobytes()
                                 for p in f.planes)).hexdigest()
            for f in frames]


def _packets(api, path) -> list[bytes]:
    d = api.open_input(str(path))
    out = [bytes(p.data) for p in d.packets()]
    d.close()
    return out


STREAMS = {
    # name: (generate_stream options, display-order pts in the JAX package)
    "intra_p": (dict(n_frames=4, p_frames=True, deblock=True, seed=1),
                [0, 1, 2, 3]),
    "ipb": (dict(n_frames=5, b_frames=True, deblock=True, sao=True, seed=2),
            [0, 2, 1, 4, 3]),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_single_slice_copies_equal_jax(tmp_path, name):
    """A single-slice stream: the raw stream copied to .265, MP4,
    Matroska and MPEG-TS gives the same file and ffprobe JSON in both
    packages; each decodes to the JAX decoder's hashes of the whole
    stream, in display order, at pts 0..n-1 in the port (in the JAX
    package too without B pictures; with them 0, 2, 1, 4, 3)."""
    kw, jax_pts = STREAMS[name]
    data = TD.generate_stream(W, H, **kw)
    src = tmp_path / "s.265"
    src.write_bytes(data)
    want = _whole_decode_md5s(data)
    n = kw["n_frames"]
    for ext in ("265",) + CONTAINERS:
        files = {}
        for pkg in ("jax", "torch"):
            out = tmp_path / f"{pkg}.{ext}"
            assert _cli(pkg, ["-i", str(src), "-c:v", "copy", "-y",
                              str(out)]) == 0
            files[pkg] = out
        assert files["jax"].read_bytes() == files["torch"].read_bytes(), ext
        if ext == "265":
            assert files["torch"].read_bytes() == data
        info = {pkg: _probe(pkg, str(files[pkg])) for pkg in files}
        if ext == "ts":     # the size the JAX package's demuxer leaves 0x0
            for pkg, size in (("jax", (0, 0)), ("torch", (W, H))):
                st = info[pkg]["streams"][0]
                assert (st["width"], st["height"]) == size
                st["width"] = st["height"] = 0
        assert info["jax"] == info["torch"], ext
        assert len(_packets(TA, files["torch"])) == n
        got = {}
        for pkg in ("jax", "torch"):
            md5 = tmp_path / f"{pkg}.{ext}.md5"
            assert _cli(pkg, ["-i", str(files[pkg]), "-f", "framemd5", "-y",
                              str(md5)]) == 0
            got[pkg] = _md5_lines(md5)
        assert [m for _, m in got["torch"]] == want, ext
        assert [m for _, m in got["jax"]] == want, ext
        assert _ranks([p for p, _ in got["torch"]]) == list(range(n)), ext
        if ext != "ts":
            assert _ranks([p for p, _ in got["jax"]]) == jax_pts, ext


def test_multi_slice_one_packet_per_picture(tmp_path):
    """A 2-slice I/P/B stream (5 pictures, 10 slice segments): the port
    reads 5 packets from raw .265 and from its MP4, Matroska and
    MPEG-TS copies, each decoding to the JAX decoder's hashes of the
    whole stream at pts 0..4. The JAX package reads 10 packets and its
    CLI's decode fails."""
    data = TD.generate_stream(W, H, 5, b_frames=True, deblock=True, sao=True,
                              slices=2, seed=14)
    assert data == JD.generate_stream(W, H, 5, b_frames=True, deblock=True,
                                      sao=True, slices=2, seed=14)
    src = tmp_path / "s.265"
    src.write_bytes(data)
    want = _whole_decode_md5s(data)
    assert len(want) == 5
    assert len(_packets(JA, src)) == 10
    with pytest.raises(Exception):
        _cli("jax", ["-i", str(src), "-f", "framemd5", "-y",
                     str(tmp_path / "jax.md5")])
    aus = _packets(TA, src)
    assert len(aus) == 5 and b"".join(aus) == data
    for ext in ("265",) + CONTAINERS:
        path = src
        if ext != "265":
            path = tmp_path / f"s.{ext}"
            assert _cli("torch", ["-i", str(src), "-c:v", "copy", "-y",
                                  str(path)]) == 0
            info = _probe("torch", str(path))
            st = info["streams"][0]
            assert (st["codec_name"], st["width"], st["height"],
                    st["pix_fmt"]) == ("hevc", W, H, "yuv420p"), ext
            assert len(info["packets"]) == 5, ext
        md5 = tmp_path / f"{ext}.md5"
        assert _cli("torch", ["-i", str(path), "-f", "framemd5", "-y",
                              str(md5)]) == 0
        got = _md5_lines(md5)
        assert [m for _, m in got] == want, ext
        assert _ranks([p for p, _ in got]) == list(range(5)), ext
        # -c copy -f framemd5 hashes the packets: the raw stream's AUs
        pk = tmp_path / f"{ext}.pk.md5"
        assert _cli("torch", ["-i", str(path), "-c:v", "copy", "-f",
                              "framemd5", "-y", str(pk)]) == 0
        hashed = [m for _, m in _md5_lines(pk)]
        first = aus[0]
        if ext in ("mp4", "mkv"):   # the parameter sets go into hvcC
            first = first[first.index(b"\x00\x00\x00\x01\x26"):]
        assert hashed == [hashlib.md5(a).hexdigest()
                          for a in [first] + aus[1:]], ext


def test_hevc_in_mpegts_reads_back(tmp_path):
    """MPEG-TS carries the HEVC stream as type 0x24 and its PES pts read
    back in decode order; the decode gives display order at the
    demuxer's time base."""
    import chip_smoke

    data = TD.generate_stream(W, H, 3, b_frames=True, slices=2, seed=5)
    src, ts = tmp_path / "s.265", tmp_path / "s.ts"
    src.write_bytes(data)
    assert _cli("torch", ["-i", str(src), "-c:v", "copy", "-y",
                          str(ts)]) == 0
    assert chip_smoke.ts_stream_types(str(ts)) == [0x24]
    d = TA.open_input(str(ts))
    dec = TD.HevcDecoder(d.streams[0].codecpar, device="cpu")
    pk = list(d.packets())
    frames = [f for p in pk for f in dec.decode(p)] + dec.flush()
    assert [f.pts for f in frames] == sorted(p.pts for p in pk)


@pytest.mark.parametrize("frames", [3, 5])
def test_m4v_raw_mpeg4_equal_jax(tmp_path, frames):
    """Raw MPEG-4 (.m4v): each package's CLI writes one from the same
    H.264 clip (the encoders' float DCTs may part by a level, so the
    files are not compared). Both demuxers split each file into the same
    packets (the VOL in front of the first VOP, also as extradata); a
    copy back to .m4v is the same file in both packages, and both decode
    the port's file to the same frames."""
    from tests.test_torch_slice import make_clip

    clip = tmp_path / "clip.264"
    make_clip(str(clip))
    for pkg in ("jax", "torch"):
        path = tmp_path / f"{pkg}.m4v"
        assert _cli(pkg, ["-i", str(clip), "-frames:v", str(frames), "-c:v",
                          "mpeg4", "-q:v", "5", "-y", str(path)]) == 0
        t, j = TA.open_input(str(path)), JA.open_input(str(path))
        assert t.NAME == j.NAME == "m4v"
        assert t.streams[0].codecpar.codec_id == "mpeg4"
        assert bytes(t.streams[0].codecpar.extradata) == \
            bytes(j.streams[0].codecpar.extradata) != b""
        pk = [(bytes(p.data), p.pts) for p in t.packets()]
        assert pk == [(bytes(p.data), p.pts) for p in j.packets()]
        assert len(pk) == frames
        for cli in ("jax", "torch"):
            back = tmp_path / f"{pkg}.{cli}.m4v"
            assert _cli(cli, ["-i", str(path), "-c:v", "copy", "-y",
                              str(back)]) == 0
            assert back.read_bytes() == path.read_bytes()
    got = {}
    for cli in ("jax", "torch"):
        md5 = tmp_path / f"{cli}.md5"
        assert _cli(cli, ["-i", str(tmp_path / "torch.m4v"), "-f",
                          "framemd5", "-y", str(md5)]) == 0
        got[cli] = _md5_lines(md5)
    assert got["jax"] == got["torch"] and len(got["jax"]) == frames
