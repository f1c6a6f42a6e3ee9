"""ops.motion's search library in the port (librempeg_tpu_torch/ops/
motion.py) held to the JAX package's (librempeg_tpu/ops/motion.py) on the
CPU, exactly, on seeded uint8-valued frames: N = 2 frames of 64x48, block
sizes 8 and 16, search ranges 2, 4 and 8, refine 1 and 3. Every MV, SAD,
prediction, SSE and SATD is equal: the SADs are float32 sums of integers
under 2^24, the coarse level of hierarchical_search divides by 16, the
bilinear weights are 0 and 0.5, and argmin takes the first minimum of the
np.mgrid raster in both. The JAX package's block_reduce_mm (a bf16 0/1
indicator GEMM, a TPU workaround) is not ported: the port sums with
block_reduce, and both give the same sums. Then the properties of
tests/test_parallel.py's TestMotion on the port alone.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from librempeg_tpu.ops import motion as J
from librempeg_tpu_torch.ops import motion as T

N, H, W = 2, 48, 64
SHIFTS = ((3, -2), (-1, 4))


def frames(seed=0, margin=12, noise=6, extra_rows=0):
    """(cur, ref) uint8-valued float32 [N, H + 2*extra_rows, W]: textured
    frames, cur the ref moved by SHIFTS[i] plus noise."""
    rng = np.random.default_rng(seed)
    hh = H + 2 * extra_rows
    yy, xx = np.mgrid[0:hh + 2 * margin, 0:W + 2 * margin]
    cur, ref = [], []
    for dy, dx in SHIFTS:
        big = (128 + 50 * np.sin(xx / 5.0 + seed) * np.cos(yy / 7.0)
               + rng.integers(-40, 41, yy.shape))
        ref.append(big[margin:margin + hh, margin:margin + W])
        c = big[margin + dy:margin + dy + hh, margin + dx:margin + dx + W]
        cur.append(c + rng.integers(-noise, noise + 1, c.shape))
    return tuple(np.clip(np.rint(np.stack(a)), 0, 255).astype(np.float32)
                 for a in (cur, ref))


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


def eq(port, jax_out):
    """Port tensor(s) equal the JAX array(s), dtype kind and values."""
    if isinstance(port, tuple):
        assert len(port) == len(jax_out)
        for a, b in zip(port, jax_out):
            eq(a, b)
        return
    a, b = port.numpy(), np.asarray(jax_out)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype.kind == b.dtype.kind, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


RANGES = [(bs, r) for bs in (8, 16) for r in (2, 4, 8)]


@pytest.mark.parametrize("bs,r", RANGES)
def test_full_search_matches_jax(bs, r):
    cur, ref = frames(bs + r)
    mv, cost = T.full_search(t(cur), t(ref), r, bs)
    jmv, jcost = J.full_search(jnp.asarray(cur), jnp.asarray(ref), r, bs)
    eq((mv, cost), (jmv, jcost))
    assert mv.dtype == torch.int32 and cost.dtype == torch.float32


@pytest.mark.parametrize("refine", (1, 3))
@pytest.mark.parametrize("bs,r", RANGES)
def test_hierarchical_search_matches_jax(bs, r, refine):
    cur, ref = frames(bs * r + refine)
    got = T.hierarchical_search(t(cur), t(ref), r, bs, refine)
    want = J.hierarchical_search(jnp.asarray(cur), jnp.asarray(ref), r, bs,
                                 refine)
    eq(got, want)


@pytest.mark.parametrize("bs,r", RANGES)
def test_ties_resolve_as_in_jax(bs, r):
    """Periodic frames (a checkerboard of 4x4 squares, flat inside), where
    displacements 4 apart and flat blocks' half-pel positions tie: every
    search takes the first minimum of the np.mgrid raster, as in JAX."""
    yy, xx = np.mgrid[0:H + 16, 0:W + 16]
    board = (96 + 64 * ((yy // 4 + xx // 4) % 2)).astype(np.float32)
    ref = np.stack([board[:H, :W], board[2:H + 2, 1:W + 1]])
    cur = np.stack([board[1:H + 1, 3:W + 3], board[4:H + 4, :W]])
    c, f = jnp.asarray(cur), jnp.asarray(ref)
    mv, cost = T.full_search(t(cur), t(ref), r, bs)
    eq((mv, cost), J.full_search(c, f, r, bs))
    assert float(cost.min()) == 0.0
    eq(T.hierarchical_search(t(cur), t(ref), r, bs, 1),
       J.hierarchical_search(c, f, r, bs, 1))
    eq(T.full_search_mc_xla(t(cur), t(ref), r, bs, 1),
       J.full_search_mc_xla(c, f, r, bs, 1))
    eq(T.halfpel_refine(t(cur), t(ref), mv, bs),
       J.halfpel_refine(c, f, jnp.asarray(mv.numpy()), bs))
    band = np.pad(ref, ((0, 0), (r + 2, r + 2), (0, 0)), mode="edge")
    eq(T.full_search_mc_hpel_prepadded(t(cur), t(band), r, bs, 0),
       J.full_search_mc_hpel_prepadded(c, jnp.asarray(band), r, bs, 0))


def test_median3x3_matches_jax():
    mv = np.random.default_rng(4).integers(-9, 10, (2, 5, 7, 2)) \
        .astype(np.int32)
    eq(T._median3x3(t(mv)), J._median3x3(jnp.asarray(mv)))


@pytest.mark.parametrize("bs,r", RANGES)
def test_motion_compensate_scan_matches_jax(bs, r):
    cur, ref = frames(bs + 2 * r)
    rng = np.random.default_rng(r)
    # MVs in range, and one block out of range (it stays 0 in both)
    mv = rng.integers(-r, r + 1, (N, H // bs, W // bs, 2)).astype(np.int32)
    mv[0, 0, 0] = (r + 1, 0)
    eq(T.motion_compensate_scan(t(ref), t(mv), bs, r),
       J.motion_compensate_scan(jnp.asarray(ref), jnp.asarray(mv), bs, r))
    band = frames(bs + 2 * r, extra_rows=r)[1]
    eq(T.motion_compensate_scan_prepadded(t(band), t(mv), bs, r),
       J.motion_compensate_scan_prepadded(jnp.asarray(band),
                                          jnp.asarray(mv), bs, r))


@pytest.mark.parametrize("step", (1, 2))
@pytest.mark.parametrize("bs,r", RANGES)
def test_full_search_mc_prepadded_matches_jax(bs, r, step):
    """A band with `vpad` real rows above and below; the unpadded
    search as well (the port's full_search_mc_xla against XLA's)."""
    cur, _ = frames(bs + r)
    _, band = frames(bs + r, extra_rows=r + 2)
    for vpad in (r, r + 2):
        rv = band[:, r + 2 - vpad:band.shape[1] - (r + 2 - vpad)]
        eq(T.full_search_mc_prepadded(t(cur), t(rv), r, bs, step, vpad),
           J.full_search_mc_prepadded(jnp.asarray(cur), jnp.asarray(rv), r,
                                      bs, step, vpad))
    ref = band[:, r + 2:-(r + 2)]
    eq(T.full_search_mc_xla(t(cur), t(ref), r, bs, step),
       J.full_search_mc_xla(jnp.asarray(cur), jnp.asarray(ref), r, bs, step))


@pytest.mark.parametrize("rounding", (0, 1))
@pytest.mark.parametrize("bs,r", RANGES)
def test_hpel_prepadded_matches_jax(bs, r, rounding):
    cur, _ = frames(bs + r + rounding)
    _, band = frames(bs + r + rounding, extra_rows=r + 2)
    mv, cost, pred = T.full_search_mc_hpel_prepadded(t(cur), t(band), r, bs,
                                                     rounding)
    eq((mv, cost, pred),
       J.full_search_mc_hpel_prepadded(jnp.asarray(cur), jnp.asarray(band),
                                       r, bs, rounding))
    # mc_hpel_vpad at the search's MVs rebuilds the search's prediction
    got = T.mc_hpel_vpad(t(band), mv, bs, r + 2, r + 2, rounding)
    eq(got, J.mc_hpel_vpad(jnp.asarray(band), jnp.asarray(mv.numpy()), bs,
                           r + 2, r + 2, rounding))
    assert torch.equal(got, pred)


@pytest.mark.parametrize("bs,r", RANGES)
def test_halfpel_refine_and_mc_match_jax(bs, r):
    cur, ref = frames(3 * bs + r)
    jmv, _ = J.full_search(jnp.asarray(cur), jnp.asarray(ref), r, bs)
    mv_i = t(jmv)
    mvh, cost = T.halfpel_refine(t(cur), t(ref), mv_i, bs)
    jmvh, jcost = J.halfpel_refine(jnp.asarray(cur), jnp.asarray(ref), jmv,
                                   bs)
    eq((mvh, cost), (jmvh, jcost))
    # every half-pel phase, not only the winners
    rng = np.random.default_rng(bs * r)
    mv_any = rng.integers(-2 * r, 2 * r + 1,
                          (N, H // bs, W // bs, 2)).astype(np.int32)
    eq(T.motion_compensate_halfpel(t(ref), t(mv_any), bs),
       J.motion_compensate_halfpel(jnp.asarray(ref), jnp.asarray(mv_any),
                                   bs))


def test_metrics_match_jax():
    """sad and satd on whole frames and 8x8 block stacks; sse where the
    exact sum is below 2^24 (a prediction residual), where JAX's float32
    sum is exact too. Past 2^24 the port gives the exact sum rounded
    once, and JAX's float32 sum stays within a few ulps of it."""
    cur, ref = frames(5)
    pred = T.motion_compensate(t(ref), T.full_search(t(cur), t(ref), 4)[0])
    p = pred.numpy()
    def blocks(x):
        return x.reshape(N, H // 8, 8, W // 8, 8).transpose(0, 1, 3, 2, 4)

    for a, b in ((cur, ref), (cur, p)):
        eq(T.sad(t(a), t(b)), J.sad(jnp.asarray(a), jnp.asarray(b)))
        eq(T.satd(t(blocks(a)), t(blocks(b))),
           J.satd(jnp.asarray(blocks(a)), jnp.asarray(blocks(b))))
    exact = float(((cur.astype(np.int64) - p.astype(np.int64)) ** 2).sum())
    assert exact < 2 ** 24
    eq(T.sse(t(cur), pred), J.sse(jnp.asarray(cur), jnp.asarray(p)))
    inv = 255 - ref
    big = float(((cur.astype(np.int64) - inv.astype(np.int64)) ** 2).sum())
    assert big > 2 ** 24
    assert float(T.sse(t(cur), t(inv))) == float(np.float32(big))
    jbig = float(J.sse(jnp.asarray(cur), jnp.asarray(inv)))
    assert abs(jbig - big) <= 4 * np.spacing(np.float32(big))


@pytest.mark.parametrize("bs", (8, 16))
def test_block_reduce_equals_block_reduce_mm(bs):
    """The sums the JAX package takes through block_reduce_mm are the
    port's block_reduce sums on the magnitudes a search produces."""
    cur, ref = frames(bs)
    d = np.abs(cur - ref)
    eq(T.block_reduce(t(d), bs), J.block_reduce_mm(jnp.asarray(d), bs))
    eq(T.block_reduce(t(d), bs), J.block_reduce(jnp.asarray(d), bs))


# -- tests/test_parallel.py's TestMotion properties, on the port -----------

@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_full_search_finds_shift(rng):
    ref = rng.integers(0, 256, (1, 64, 64)).astype(np.float32)
    cur = np.roll(np.roll(ref, 3, axis=1), -2, axis=2)
    mv, _ = T.full_search(t(cur), t(ref), search_range=4, block_size=16)
    inner = mv.numpy()[0, 1:-1, 1:-1]
    assert np.all(inner[..., 0] == -3) and np.all(inner[..., 1] == 2)


def test_hierarchical_close_to_full():
    yy, xx = np.mgrid[0:128, 0:128]
    ref = (128 + 60 * np.sin(xx / 9.0) * np.cos(yy / 11.0)
           + 30 * np.sin((xx + yy) / 17.0)).astype(np.float32)[None]
    cur = np.roll(np.roll(ref, 6, axis=1), 5, axis=2)
    mv, _ = T.hierarchical_search(t(cur), t(ref), search_range=8)
    inner = mv.numpy()[0, 1:-1, 1:-1]
    assert np.all(inner[..., 0] == -6) and np.all(inner[..., 1] == -5)


def test_motion_compensate_inverts(rng):
    ref = rng.integers(0, 256, (1, 64, 64)).astype(np.float32)
    cur = np.roll(ref, 2, axis=2)
    mv, _ = T.full_search(t(cur), t(ref), 4)
    pred = T.motion_compensate(t(ref), mv).numpy()
    inner = (slice(None), slice(16, 48), slice(16, 48))
    np.testing.assert_array_equal(pred[inner], cur[inner])
    np.testing.assert_array_equal(
        T.motion_compensate_scan(t(ref), mv, 16, 4).numpy()[inner],
        cur[inner])


def test_halfpel_zero_when_integer(rng):
    ref = rng.integers(0, 256, (1, 64, 64)).astype(np.float32)
    cur = np.roll(ref, 1, axis=1)
    mv, _ = T.full_search(t(cur), t(ref), 4)
    mvh, _ = T.halfpel_refine(t(cur), t(ref), mv)
    inner = mvh.numpy()[0, 1:-1, 1:-1]
    assert np.all(inner[..., 0] == -2) and np.all(inner[..., 1] == 0)
    pred = T.motion_compensate_halfpel(t(ref), mvh).numpy()
    np.testing.assert_array_equal(pred[0, 16:48, 16:48], cur[0, 16:48, 16:48])


def test_satd_zero_on_equal(rng):
    a = rng.integers(0, 256, (4, 8, 8)).astype(np.float32)
    assert float(T.satd(t(a), t(a)).max()) == 0
