"""The port's multi-device layer (librempeg_tpu_torch/parallel/) against
its own single-device forms and the JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices tests/conftest.py gives;
the port on meshes of explicit CPU shards (devices=["cpu"] * n: one
process drives every shard, parallel/mesh.py). Each sharded form of the
port equals its single-device form bit for bit, but for the sharded
resampler, held as the JAX test holds its own (atol 1e-4 away from the
64-sample edges). Against the JAX package: the halo stencils and the
ring exactly, the MPEG-4 stage ring within the JAX test's atol 1e-3
(float32 GEMMs summed in another order), make_sharded_step's MVs and
levels within the bounds tests/test_torch_parallel.py states for
transcode_step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from librempeg_tpu.parallel import halo as JH
from librempeg_tpu.parallel import mesh as JM
from librempeg_tpu.parallel import pipeline as JP
from librempeg_tpu.parallel.sp_audio import make_sharded_resampler as j_spr
from librempeg_tpu.parallel.stagepipe import ring_pipeline as j_ring
from librempeg_tpu.parallel.wavefront import wavefront_scan as j_wave
from librempeg_tpu.resample.resampler import Resampler as JResampler
from librempeg_tpu_torch.parallel import halo as TH
from librempeg_tpu_torch.parallel import mesh as TM
from librempeg_tpu_torch.parallel import pipeline as TP
from librempeg_tpu_torch.parallel.dryrun import dryrun_multichip
from librempeg_tpu_torch.parallel.sp_audio import make_sharded_resampler
from librempeg_tpu_torch.parallel.stagepipe import ring_pipeline
from librempeg_tpu_torch.parallel.wavefront import wavefront_scan
from librempeg_tpu_torch.resample.resampler import Resampler
from librempeg_tpu_torch.utils import testgen
from test_torch_parallel import _levels_close


def _cpu_mesh(shape, axes=("data", "spatial")):
    n = int(np.prod(shape))
    return TM.make_mesh(n, axes, shape, devices=["cpu"] * n)


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    bad = np.count_nonzero(a != b)
    assert bad == 0, f"{what}: {bad}/{a.size} differ"


def test_make_mesh_shape_and_devices():
    m = _cpu_mesh((2, 3))
    assert m.shape == {"data": 2, "spatial": 3} and m.size == 6
    assert [s.index for s in m.along("spatial", data=1)] == \
        [(1, 0), (1, 1), (1, 2)]
    assert m.shard(spatial=2).index == (0, 2)
    assert all(s.stream is None and s.device.type == "cpu"
               for s in m.shards.ravel())
    assert TM.make_mesh(devices=["cpu"] * 8).shape == \
        {"data": 2, "spatial": 4} == dict(JM.make_mesh(8).shape)
    assert TM.factor2(6) == JM.factor2(6) == (2, 3)


def test_make_mesh_refuses_to_shrink():
    """Without a list the shards need distinct devices: this machine has
    no card, and the CPU is one torch device."""
    with pytest.raises(ValueError, match="this machine has 0"):
        TM.make_mesh(2)
    with pytest.raises(ValueError, match="explicit devices"):
        TM.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="the device list has 2"):
        TM.make_mesh(4, devices=["cpu"] * 2)


@pytest.mark.parametrize("spatial", [False, True])
def test_frame_sharding_round_trip(spatial):
    m = _cpu_mesh((2, 4))
    x = torch.arange(4 * 16 * 8, dtype=torch.float32).reshape(4, 16, 8)
    sh = TM.frame_sharding(m, spatial=spatial)
    parts = sh.split(x)
    assert parts.shape == (2, 4)
    assert parts[1, 3].shape == ((2, 4, 8) if spatial else (2, 16, 8))
    assert torch.equal(sh.gather(parts, "cpu"), x)
    rep = TM.replicated(m)
    assert torch.equal(rep.split(x)[1, 2], x)
    assert torch.equal(rep.gather(rep.split(x), "cpu"), x)


def test_vblur3_matches_unsharded(rng):
    x = rng.standard_normal((2, 64, 32)).astype(np.float32)
    got = TH.row_sharded_stencil(TH.vblur3, 1, _cpu_mesh((2, 4)))(
        torch.from_numpy(x)).numpy()
    xp = np.pad(x, ((0, 0), (1, 1), (0, 0)), mode="edge")
    want = (xp[:, :-2] + 2 * xp[:, 1:-1] + xp[:, 2:]) * 0.25
    _eq(got, want, "vblur3")
    jgot = JH.row_sharded_stencil(JH.vblur3, halo=1,
                                  mesh=JM.make_mesh(8, shape=(2, 4)))(
        jnp.asarray(x))
    _eq(got, jgot, "vblur3 against the JAX package")


def test_vfir6_halfpel_row_sharded_matches_unsharded():
    """(1, 8): the half-pel 6-tap over 8 row bands with a 3-row halo, on
    int32, equal to the unsharded plane and to the JAX package's."""
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, (2, 128, 64)).astype(np.int32)
    f = TH.row_sharded_stencil(lambda xh: TH.vfir6_halfpel(xh[..., 1:, :]),
                               halo=3, mesh=_cpu_mesh((1, 8)))
    got = f(torch.from_numpy(x))
    _eq(got, TH.halfpel_plane(torch.from_numpy(x)), "sharded vs whole")
    jm = JM.make_mesh(8, shape=(1, 8))
    jf = JH.row_sharded_stencil(lambda xh: JH.vfir6_halfpel(xh[..., 1:, :]),
                                halo=3, mesh=jm)
    with jm:
        _eq(got, jf(jnp.asarray(x)), "against the JAX package")


@pytest.mark.parametrize("n_stages", [2, 4])
def test_ring_pipeline_matches_sequential(rng, n_stages):
    fns = [lambda x, k=k: x * 2.0 + float(k) for k in range(n_stages)]
    x = rng.standard_normal((6, 4, 8)).astype(np.float32)
    mesh = _cpu_mesh((n_stages, 1), ("stage", "unused"))
    got = ring_pipeline(fns, mesh, axis="stage")(torch.from_numpy(x))
    want = torch.from_numpy(x)
    for f in fns:
        want = f(want)
    _eq(got, want, "ring vs sequential")
    jm = JM.make_mesh(n_stages, axes=("stage", "unused"),
                      shape=(n_stages, 1))
    with jm:
        jgot = j_ring(fns, jm, axis="stage")(jnp.asarray(x))
    _eq(got, jgot, "ring against the JAX package")


def test_ring_pipeline_needs_one_shard_per_stage():
    with pytest.raises(AssertionError, match="one device per stage"):
        ring_pipeline([lambda x: x] * 3, _cpu_mesh((2, 1), ("stage", "u")),
                      axis="stage")


def test_ring_pipeline_real_mpeg4_stages():
    """(2, 4): the encoder's device stages (GEMM scale, transform-code
    recon, half-pel) through the ring over 'spatial' equal their
    sequential composition; against the JAX package's ring within its
    own test's atol."""
    rng = np.random.default_rng(9)
    stages = TP.mpeg4_stage_fns(64, 64, 32, 32, qscale=4.0, n_stages=4)
    micro = rng.integers(0, 256, (5, 2, 64, 64)).astype(np.float32)
    got = ring_pipeline(stages, _cpu_mesh((2, 4)), axis="spatial")(
        torch.from_numpy(micro))
    for i in range(5):
        x = torch.from_numpy(micro[i])
        for f in stages:
            x = f(x)
        _eq(got[i], x, f"microbatch {i}")
    jm = JM.make_mesh(8, shape=(2, 4))
    jst = JP.mpeg4_stage_fns(64, 64, 32, 32, qscale=4.0, n_stages=4)
    with jm:
        jgot = np.asarray(j_ring(jst, jm, axis="spatial")(jnp.asarray(micro)))
    np.testing.assert_allclose(got.numpy(), jgot, atol=1e-3)


def test_make_sharded_step_matches_single_device():
    """(4, 2): each data shard's transcode_step and the row-sharded
    half-pel equal the single-device step plus the unsharded half-pel
    exactly; against the JAX package's make_sharded_step within
    transcode_step's bounds."""
    rng = np.random.default_rng(3)
    n, h, w, dh, dw = 4, 128, 128, 64, 64
    y = rng.integers(0, 256, (n, h, w)).astype(np.float32)
    u = rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.float32)
    v = rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.float32)
    ref = rng.integers(0, 256, (n, dh, dw)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (y, u, v, ref)]
    out = TP.make_sharded_step(_cpu_mesh((4, 2)), dh, dw)(*args)
    single = TP.transcode_step(*args, dh, dw, 4.0)
    assert set(out) == set(single) | {"y_halfpel"}
    for k, t in single.items():
        _eq(out[k], t, k)
    _eq(out["y_halfpel"],
        TH.halfpel_plane(single["y"].to(torch.int32)).to(torch.uint8),
        "y_halfpel")
    jo = JP.make_sharded_step(JM.make_mesh(8, shape=(4, 2)), dst_h=dh,
                              dst_w=dw)(*(jnp.asarray(a)
                                          for a in (y, u, v, ref)))
    same = (np.asarray(jo["mv"]) == out["mv"].numpy()).all(-1).mean()
    assert same >= 0.999
    for k in "yuv":
        _levels_close(jo[f"levels_{k}"], out[f"levels_{k}"], f"levels {k}")
    hp_same = (np.asarray(jo["y_halfpel"]) == out["y_halfpel"].numpy()).mean()
    assert hp_same >= 0.99


def test_sharded_resampler_matches_single():
    """(1, 4): 48 kHz -> 44.1 kHz with the samples split over 4 shards,
    against the port's streaming resampler (process, flush) and the JAX
    package's sharded resampler, atol 1e-4 off the 64-sample edges."""
    r = Resampler(48000, 44100, channels=2, device="cpu")
    total = r.q * 25 * 4
    x = testgen.audio_mix(48000, total)
    got = make_sharded_resampler(r, _cpu_mesh((1, 4)))(
        torch.from_numpy(x)).numpy()
    single = Resampler(48000, 44100, channels=2, device="cpu")
    want = torch.cat([single.process(torch.from_numpy(x)), single.flush()],
                     dim=1).numpy()[:, :got.shape[1]]
    assert got.shape == (2, total * r.p // r.q)
    np.testing.assert_allclose(got[:, 64:-64], want[:, 64:-64], atol=1e-4)
    jm = JM.make_mesh(4, axes=("data", "spatial"), shape=(1, 4))
    with jm:
        jgot = np.asarray(j_spr(JResampler(48000, 44100, channels=2), jm)(
            jnp.asarray(x)))
    np.testing.assert_allclose(got[:, 64:-64], jgot[:, 64:-64], atol=1e-4)


def test_wavefront_matches_sequential(rng):
    g = rng.standard_normal((6, 9)).astype(np.float32)

    def f(x, up, left):
        return x + 0.5 * up + 0.25 * left

    got = wavefront_scan(f, torch.from_numpy(g)).numpy()
    want = np.zeros_like(g)
    for i in range(6):
        for j in range(9):
            up = want[i - 1, j] if i else np.float32(0)
            left = want[i, j - 1] if j else np.float32(0)
            want[i, j] = g[i, j] + np.float32(0.5) * up \
                + np.float32(0.25) * left
    _eq(got, want, "wavefront vs sequential")
    _eq(got, j_wave(f, jnp.asarray(g)), "against the JAX package")


def test_wavefront_dc_prediction_shape(rng):
    """The MPEG-4 DC prediction recurrence class runs as a wavefront."""
    dc = rng.integers(0, 255, (8, 8)).astype(np.float32)

    def pred(x, up, left):
        return x + torch.where((up - left).abs() > 0, 0.0, 0.0) + 0.0 * up

    _eq(wavefront_scan(pred, torch.from_numpy(dc)), dc, "dc placement")


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip(n):
    got = dryrun_multichip(n, devices=["cpu"] * n)
    assert got["mesh"] == dict(JM.make_mesh(n).shape)
    assert got["devices"] == ["cpu"] * n


def test_dryrun_refuses_fewer_shards():
    with pytest.raises(ValueError, match="the device list has 4"):
        dryrun_multichip(8, devices=["cpu"] * 4)
