"""The port's kernel-leg path (parallel.pipeline) and its full-search
kernel (ops.pallas.mesearch) against the JAX package's on the CPU.

The JAX full search runs its Pallas kernel in interpret mode, as the JAX
package's own tests run it. On integer-valued inputs every SAD is an
exact integer, so MVs, costs and predictions are bit-exact. On float
inputs a block cost is a float32 sum of bf16 differences taken in
another order (the JAX kernel: row sums then column sums; the port:
one reduction), so costs may differ in the last bits: MVs must agree on
>= 99.9% of blocks and costs within 1e-5 relative where they agree.

The transform steps are float32 matrix algebra whose summation order
differs between XLA and PyTorch, so a coefficient near a quantiser
threshold can round to the neighbouring level: at most 0.1% of levels
may differ. Measured on a CPU: transcode_step at 2x288x352 -> 144x256
gives equal MVs on every block, no level different and recon PSNR
148-153 dB port vs JAX; encode_inter_like on integer inputs 0.0027% of
levels and 75.7 dB. The inputs are textured noise, not testgen's
ramps: a ramp's DCT lands coefficients exactly on .5 quantiser ties
(0.5% of the chroma levels of testgen frames), where the last bit
decides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from librempeg_tpu.ops.pallas import mesearch as JMS
from librempeg_tpu.parallel import pipeline as JP
from librempeg_tpu_torch.ops.pallas import mesearch as TMS
from librempeg_tpu_torch.parallel import pipeline as TP


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    bad = np.count_nonzero(a != b)
    assert bad == 0, f"{what}: {bad}/{a.size} differ"


def _levels_close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    frac = np.count_nonzero(a != b) / a.size
    print(f"{what}: level mismatch {frac:.6f}")
    assert frac <= 1e-3, what


def _psnr(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    mse = float((d * d).mean())
    return float("inf") if mse == 0 else 10 * np.log10(255 ** 2 / mse)


def _texture(rng, n, h, w):
    """Smooth texture + noise, float32 in 0..255."""
    gy, gx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        base = 128 + 70 * np.sin(gx / (5.0 + i) + i) * np.cos(gy / 7.0)
        out.append(base + rng.normal(0, 12, (h, w)))
    return np.clip(np.stack(out), 0, 255).astype(np.float32)


def _pair(seed, n, h, w):
    """A current frame and a shifted, noisy reference."""
    rng = np.random.default_rng(seed)
    cur = _texture(rng, n, h, w)
    ref = np.roll(cur, (1, -2), (1, 2)) + rng.normal(0, 3, cur.shape)
    return cur, np.clip(ref, 0, 255).astype(np.float32)


@pytest.mark.parametrize("n,h,w,th,tw", [
    (2, 144, 256, 144, 256),        # one tile
    (2, 96, 256, 32, 128),          # 3x2 tiles per frame
])
@pytest.mark.parametrize("integer", [True, False])
def test_full_search_mc_matches_jax(n, h, w, th, tw, integer):
    cur, ref = _pair(h + w, n, h, w)
    if integer:
        cur, ref = np.round(cur), np.round(ref)
    jm, jc, jp = (np.asarray(a) for a in JMS.full_search_mc(
        jnp.asarray(cur), jnp.asarray(ref), 4, tile_h=th, tile_w=tw))
    tm, tc, tp = (a.numpy() for a in TMS.full_search_mc(
        _t(cur), _t(ref), 4, tile_h=th, tile_w=tw))
    assert tm.dtype == np.int32 and tc.dtype == tp.dtype == np.float32
    if integer:
        _eq(jm, tm, "mv")
        _eq(jc, tc, "cost")
        _eq(jp, tp, "pred")
        return
    same = (jm == tm).all(-1)
    rel = np.abs(jc - tc)[same] / np.maximum(jc[same], 1.0)
    print(f"MVs equal on {same.mean():.6f} of blocks; cost rel err "
          f"{rel.max():.2e}")
    assert same.mean() >= 0.999
    assert rel.max() <= 1e-5


def test_full_search_mc_rejects_tiles_that_do_not_divide():
    cur, ref = _pair(0, 1, 48, 96)
    with pytest.raises(ValueError):
        TMS.full_search_mc(_t(cur), _t(ref), 4, tile_h=32, tile_w=96)


@pytest.mark.parametrize("n,h,w", [
    (2, 96, 256),                   # tiles: the JAX package's Pallas path
    (1, 48, 96),                    # no tile: its XLA search
])
def test_fused_search_mc_matches_jax_on_integer_inputs(n, h, w):
    cur, ref = (np.round(a) for a in _pair(7, n, h, w))
    jo = JP.fused_search_mc(jnp.asarray(cur), jnp.asarray(ref), 4)
    to = TP.fused_search_mc(_t(cur), _t(ref), 4)
    for a, b, name in zip(jo, to, ("mv", "cost", "pred")):
        _eq(a, b.numpy(), name)


def test_encode_intra_like_matches_jax():
    rng = np.random.default_rng(3)
    y = _texture(rng, 2, 72, 128)
    jo = JP.encode_intra_like(jnp.asarray(y), 4.0)
    to = TP.encode_intra_like(_t(y), 4.0)
    _levels_close(jo["levels"], to["levels"], "intra levels")
    p = _psnr(jo["recon"], to["recon"])
    print(f"intra recon PSNR port vs JAX {p:.1f} dB")
    assert p >= 50


def test_encode_inter_like_matches_jax_on_integer_inputs():
    cur, ref = (np.round(a) for a in _pair(5, 2, 144, 256))
    jo = JP.encode_inter_like(jnp.asarray(cur), jnp.asarray(ref), 4.0)
    to = TP.encode_inter_like(_t(cur), _t(ref), 4.0)
    _eq(jo["mv"], to["mv"], "mv")
    _levels_close(jo["levels"], to["levels"], "inter levels")
    p = _psnr(jo["recon"], to["recon"])
    print(f"inter recon PSNR port vs JAX {p:.1f} dB")
    assert p >= 50


def test_transcode_step_matches_jax():
    """One step at 2x288x352 -> 144x256 (luma P, chroma intra)."""
    rng = np.random.default_rng(11)
    y = _texture(rng, 2, 288, 352)
    u, v = _texture(rng, 2, 144, 176), _texture(rng, 2, 144, 176)
    ref = rng.integers(0, 256, (2, 144, 256)).astype(np.float32)
    jo = JP.transcode_step(*(jnp.asarray(a) for a in (y, u, v, ref)),
                           dst_h=144, dst_w=256, qscale=4.0)
    to = TP.transcode_step(*(_t(a) for a in (y, u, v, ref)), 144, 256, 4.0)
    assert set(to) == set(jo)
    same = (np.asarray(jo["mv"]) == to["mv"].numpy()).all(-1).mean()
    print(f"MVs equal on {same:.6f} of blocks")
    assert same >= 0.999
    for k in "yuv":
        _levels_close(jo[f"levels_{k}"], to[f"levels_{k}"], f"levels {k}")
        p = _psnr(jo[k], to[k])
        print(f"recon {k}: PSNR port vs JAX {p:.1f} dB")
        assert to[k].shape == tuple(jo[k].shape)
        assert p >= 50
