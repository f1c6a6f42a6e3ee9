"""The -mesh product path of the port (librempeg_tpu_torch/parallel/
product_mesh.py) on the CPU: the MPEG-4 encoder's P-VOPs over row
bands, the scaler's vertical GEMM over output rows, the Transcoder's
mesh, and the CLI's -mesh.

Contract: under a mesh the port gives the port's own single-device
bytes, for every option the encoder accepts (-trellis included). The
port's meshes here are explicit CPU shards (devices=["cpu"] * n); the
counters (product_mesh.COUNTS) show that each run went through the
sharded forms, so no test passes on an unsharded run.

Against the JAX package: the port's single-device bytes equal the JAX
encoder's under tools/mpeg4_jax_repair.repaired() (the decoder's
reference in both), and so do the JAX encoder's own mesh bytes on the 8
virtual CPU devices, under repaired() too (its host callbacks run inside
shard_map). The JAX mesh pass is given to the JAX encoder wrapped in
jax.jit at run time (_jax_mesh_jitted; the JAX package is not edited):
called eagerly, its shard_map runs op by op and takes about 90 s a
P-VOP on an 8-core CPU even at 64x32 (why tests/test_product_mesh.py is
marked slow), jitted about 2 s a mesh shape. The JAX package's two mesh
faults, which the port does not copy (ROADMAP.md section 3b), are
asserted on its side: its mesh pass drops -trellis, and its Transcoder
leaves its mesh active after its run.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from librempeg_tpu.codecs.mpeg4 import encoder as JE
from librempeg_tpu.core.frame import VideoFrame as JFrame
from librempeg_tpu.core.rational import Rational as JR
from librempeg_tpu.parallel import product_mesh as JPM
from librempeg_tpu.sched import pipeline as JSP
from librempeg_tpu_torch.cli.ffmpeg import main as tmain
from librempeg_tpu_torch.codecs.h264.codec import H264Encoder
from librempeg_tpu_torch.codecs.mpeg4 import encoder as TE
from librempeg_tpu_torch.core.frame import VideoFrame
from librempeg_tpu_torch.core.rational import Rational
from librempeg_tpu_torch.parallel import product_mesh as PM
from librempeg_tpu_torch.scale.scaler import get_scaler
from librempeg_tpu_torch.sched import pipeline as TSP
from test_torch_audio_slice import write_wav
from tools.mpeg4_jax_repair import repaired

W, H, N = 128, 96, 4
SPECS = ("spatial=2", "spatial=3", "data=2,spatial=3")


@pytest.fixture(autouse=True)
def _no_mesh():
    PM.set_active_mesh(None)
    PM.reset_counts()
    yield
    PM.set_active_mesh(None)


def _cpu_mesh(spec):
    n = int(np.prod(list(PM.parse_mesh_spec(spec).values())))
    return PM.make_mesh(spec, devices=["cpu"] * n)


def _planes(n, w=W, h=H):
    """A drifting texture: 3 rows and 2 columns a frame, so MVs cross the
    bands' borders."""
    rng = np.random.default_rng(5)
    gy, gx = np.mgrid[0:h + 4 * n, 0:w + 4 * n]
    base = np.clip(128 + 60 * np.sin(gx / 9.0) * np.cos(gy / 7.0)
                   + rng.normal(0, 8, gx.shape), 0, 255).astype(np.uint8)
    return [(base[3 * i:3 * i + h, 2 * i:2 * i + w].copy(),
             base[i:i + h // 2, 5 + i:5 + i + w // 2].copy(),
             base[9 + i:9 + i + h // 2, i:i + w // 2].copy())
            for i in range(n)]


def _port_bytes(trellis: int, mesh=None, planes=None) -> bytes:
    PM.set_active_mesh(mesh)
    try:
        enc = TE.Mpeg4Encoder(width=W, height=H, framerate=Rational(25, 1),
                              device="cpu", qscale=5, gop_size=12,
                              trellis=trellis)
        pkts = []
        for i, p in enumerate(planes or _planes(N)):
            pkts += enc.encode(VideoFrame(
                planes=tuple(torch.from_numpy(x) for x in p),
                format="yuv420p", width=W, height=H, pts=i,
                time_base=Rational(1, 25)))
        pkts += enc.flush()
    finally:
        PM.set_active_mesh(None)
    return b"".join(bytes(p.data) for p in pkts)


_SINGLE: dict = {}


def _single(trellis: int) -> bytes:
    if trellis not in _SINGLE:
        _SINGLE[trellis] = _port_bytes(trellis)
    return _SINGLE[trellis]


@pytest.mark.parametrize("trellis", [0, 1])
@pytest.mark.parametrize("spec", SPECS)
def test_mpeg4_mesh_bytes_are_the_single_device_bytes(spec, trellis):
    """128x96, I + 3 P at qscale 5: every P-VOP runs sharded (3 passes)
    and the stream is the single-device encoder's, with and without
    -trellis."""
    single = _single(trellis)
    PM.reset_counts()
    got = _port_bytes(trellis, _cpu_mesh(spec))
    assert PM.COUNTS["p_pass"] == N - 1
    assert got == single


def test_p_pass_shards_only_whole_mb_rows():
    """96 rows over spatial=4 are 1.5 MB rows a band: the P-VOPs take the
    single-device pass (no sharded pass), as at 1280x720 with spatial 2
    or 4."""
    got = _port_bytes(0, _cpu_mesh("spatial=4"))
    assert PM.COUNTS["p_pass"] == 0
    assert got == _single(0)
    assert [s for s in (2, 3, 4, 5, 9, 15, 45) if 720 % (16 * s) == 0] == \
        [3, 5, 9, 15, 45]


@pytest.fixture
def _jax_mesh_jitted(monkeypatch):
    """The JAX mesh pass jitted once per (qscale, search range, mesh)."""
    real = JPM.mpeg4_encode_p_sharded

    @functools.lru_cache(maxsize=None)
    def jitted(q, sr, mesh):
        return jax.jit(lambda *a: real(*a, q, sr, mesh))

    monkeypatch.setattr(JPM, "mpeg4_encode_p_sharded",
                        lambda *a: jitted(int(a[6]), a[7], a[8])(*a[:6]))
    yield
    JPM.set_active_mesh(None)


def _jax_bytes(trellis: int, spec: str | None, planes) -> bytes:
    JPM.set_active_mesh(JPM.make_mesh(spec) if spec else None)
    try:
        enc = JE.Mpeg4Encoder(width=W, height=H, framerate=JR(25, 1),
                              qscale=5, gop_size=12, trellis=trellis)
        pkts = []
        for i, p in enumerate(planes):
            pkts += enc.encode(JFrame(planes=p, format="yuv420p", width=W,
                                      height=H, pts=i, time_base=JR(1, 25)))
        pkts += enc.flush()
    finally:
        JPM.set_active_mesh(None)
    return b"".join(bytes(p.data) for p in pkts)


@pytest.mark.parametrize("trellis", [0, 1])
def test_port_bytes_are_the_repaired_jax_bytes(trellis):
    """The single-device bytes the mesh runs are held to equal the JAX
    encoder's, given the decoder's reference (repaired())."""
    with repaired():
        assert _jax_bytes(trellis, None, _planes(N)) == _single(trellis)


@pytest.mark.parametrize("spec", SPECS)
def test_jax_mesh_bytes_under_repair(spec, _jax_mesh_jitted):
    """The JAX encoder under its own mesh, given the decoder's reference,
    writes the port's single-device bytes (-trellis off: its mesh pass
    has no trellis)."""
    with repaired():
        got = _jax_bytes(0, spec, _planes(N))
    assert got == _single(0)


def test_jax_mesh_pass_drops_trellis(_jax_mesh_jitted):
    """The JAX package's fault (ROADMAP.md 3b): under a mesh its encoder
    returns from the mesh branch before it reads -trellis. The first
    frame is flat, so the I-VOP is the same with and without -trellis:
    the JAX mesh bytes with -trellis 1 are then its mesh bytes without
    it, while its single-device P-VOPs change with -trellis. The port's
    mesh keeps -trellis (its bytes are its single-device -trellis 1
    bytes)."""
    planes = [tuple(np.full_like(x, 128) for x in _planes(1)[0])] + \
        _planes(3)[1:]
    with repaired():
        mesh = {t: _jax_bytes(t, "spatial=2", planes) for t in (0, 1)}
        single = {t: _jax_bytes(t, None, planes) for t in (0, 1)}
    assert mesh[1] == mesh[0] == single[0]
    assert single[1] != single[0]
    port = {t: _port_bytes(t, _cpu_mesh("spatial=2"), planes) for t in (0, 1)}
    assert port == single


def test_resize_v_sharded_bit_identical():
    """The scaler at 256x192 -> 128x96 with spatial=4: every plane's
    vertical GEMM split over output rows (3 calls), the planes equal."""
    y, u, v = _planes(1, 256, 192)[0]
    f = VideoFrame(planes=tuple(torch.from_numpy(x) for x in (y, u, v)),
                   format="yuv420p", width=256, height=192, pts=0,
                   time_base=Rational(1, 25))
    sc = get_scaler("yuv420p", 256, 192, "yuv420p", 128, 96)
    ref = [p.clone() for p in sc.scale_frame(f).planes]
    PM.set_active_mesh(_cpu_mesh("spatial=4"))
    got = sc.scale_frame(f).planes
    assert PM.COUNTS == {"p_pass": 0, "resize_v": 3, "resize_v_whole": 0}
    for a, b in zip(ref, got):
        assert torch.equal(a, b)


def test_resize_v_runs_whole_where_rows_do_not_divide():
    """96 and 48 output rows over spatial=5: the product runs whole."""
    y, u, v = _planes(1, 256, 192)[0]
    f = VideoFrame(planes=tuple(torch.from_numpy(x) for x in (y, u, v)),
                   format="yuv420p", width=256, height=192, pts=0,
                   time_base=Rational(1, 25))
    sc = get_scaler("yuv420p", 256, 192, "yuv420p", 128, 96)
    ref = [p.clone() for p in sc.scale_frame(f).planes]
    PM.set_active_mesh(_cpu_mesh("spatial=5"))
    got = sc.scale_frame(f).planes
    assert PM.COUNTS == {"p_pass": 0, "resize_v": 0, "resize_v_whole": 3}
    for a, b in zip(ref, got):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def h264_in(tmp_path_factory):
    """6 frames 128x96 from the port's own H.264 encoder (g 6)."""
    path = tmp_path_factory.mktemp("mesh") / "in.264"
    enc = H264Encoder(width=W, height=H, device="cpu", qp=26, g=6)
    data = b""
    for i, p in enumerate(_planes(6)):
        for pkt in enc.encode(VideoFrame(planes=p, format="yuv420p",
                                         width=W, height=H, pts=i,
                                         time_base=Rational(1, 25))):
            data += bytes(pkt.data)
    path.write_bytes(data)
    return str(path)


def _transcode(src, out, mesh_spec=""):
    spec = TSP.TranscodeSpec(
        input_url=src, output_url=str(out), device="cpu", mesh=mesh_spec,
        video=TSP.StreamMap(codec="mpeg4", width=64, height=48,
                            codec_opts={"qscale": 5}))
    return TSP.Transcoder(spec)


def test_transcode_under_a_mesh_is_the_single_device_transcode(
        h264_in, tmp_path):
    """H.264 128x96 -> 64x48 MPEG-4 through Transcoder under an active
    mesh data=2,spatial=3 (set_active_mesh, explicit CPU shards): the
    scaler's 18 vertical GEMMs and the 5 P-VOPs sharded, the file the
    run's without a mesh. A Transcoder without spec.mesh leaves the
    active mesh as it found it."""
    _transcode(h264_in, tmp_path / "single.m4v").run()
    mesh = _cpu_mesh("data=2,spatial=3")
    PM.set_active_mesh(mesh)
    PM.reset_counts()
    _transcode(h264_in, tmp_path / "mesh.m4v").run()
    assert PM.active_mesh() is mesh
    assert PM.COUNTS == {"p_pass": 5, "resize_v": 18, "resize_v_whole": 0}
    a = (tmp_path / "single.m4v").read_bytes()
    assert len(a) > 0 and (tmp_path / "mesh.m4v").read_bytes() == a


def test_transcoder_resets_the_mesh_it_set(h264_in, tmp_path, monkeypatch):
    """spec.mesh is active for the run only: the mesh active before comes
    back after the run and after a run that raises. (make_mesh is given
    explicit CPU shards: the CPU has no distinct devices.)"""
    real = PM.make_mesh
    monkeypatch.setattr(PM, "make_mesh", lambda spec, devices=None,
                        device="cuda": real(spec, devices=["cpu"] * 6))
    before = _cpu_mesh("spatial=2")
    PM.set_active_mesh(before)
    tc = _transcode(h264_in, tmp_path / "a.m4v", "data=2,spatial=3")
    tc.run()
    assert PM.COUNTS["p_pass"] == 5
    assert PM.active_mesh() is before

    PM.set_active_mesh(None)
    tc = _transcode(h264_in, tmp_path / "b.m4v", "data=2,spatial=3")
    seen = []

    def broken():
        seen.append(PM.active_mesh())
        raise RuntimeError("demuxer failed")
        yield

    tc.demux.packets = broken
    with pytest.raises(RuntimeError, match="demuxer failed"):
        tc.run()
    assert seen == [tc.mesh] and tc.mesh is not None
    assert PM.active_mesh() is None


def test_jax_transcoder_never_resets_its_mesh(tmp_path):
    """The JAX package's fault (ROADMAP.md 3b): its Transcoder sets the
    active mesh from spec.mesh and leaves it set after the run, so every
    later run in the process stays sharded."""
    wav = tmp_path / "in.wav"
    write_wav(str(wav), np.zeros((2, 800), np.int16), 8000)
    spec = JSP.TranscodeSpec(input_url=str(wav),
                             output_url=str(tmp_path / "out.wav"),
                             mesh="spatial=2",
                             audio=JSP.StreamMap(codec="pcm_s16le"))
    try:
        JPM.set_active_mesh(None)
        JSP.Transcoder(spec).run()
        assert JPM.active_mesh() is not None
        assert dict(JPM.active_mesh().shape) == {"spatial": 2}
    finally:
        JPM.set_active_mesh(None)


def test_cli_mesh_needs_distinct_devices(h264_in, tmp_path):
    """-mesh takes distinct devices only: on -device cpu it raises, and a
    cuda mesh names the count this machine has."""
    with pytest.raises(ValueError, match="explicit devices"):
        tmain(["-i", h264_in, "-mesh", "spatial=3", "-device", "cpu",
               "-c:v", "mpeg4", "-y", str(tmp_path / "o.m4v")])
    with pytest.raises(ValueError, match="3 distinct cuda devices but "
                       "this machine has 0"):
        PM.make_mesh("spatial=3")
