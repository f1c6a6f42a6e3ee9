"""The port's MPEG-4 encoder device passes against the JAX package's on
the CPU.

Integer paths are bit-exact (tolerance 0): the even-pel full search and
the half-pel refinement + MC on integer-valued references, and the
sparse fetch layouts. The spec DCT/quantiser is float32 matrix algebra
whose summation order differs between XLA and PyTorch, so a coefficient
near a quantiser threshold can round to the neighbouring level: at most
0.1% of levels may differ, and each case prints its fraction. A level
that differs shifts its block's recon, so recon planes are held to
PSNR >= 40 dB against the JAX package's, the slice's recon tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from librempeg_tpu.codecs.mpeg4 import encoder as JE
from librempeg_tpu.codecs.mpeg4 import me_pallas as JMEP
from librempeg_tpu.core.frame import VideoFrame as JFrame
from librempeg_tpu.ops import motion as JM
from librempeg_tpu_torch import compat
from librempeg_tpu_torch.codecs.mpeg4 import encoder as TE
from librempeg_tpu_torch.codecs.mpeg4 import me_pallas as TMEP
from librempeg_tpu_torch.core.frame import VideoFrame as TFrame
from librempeg_tpu_torch.ops import motion as TM


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    bad = np.count_nonzero(a != b)
    assert bad == 0, f"{what}: {bad}/{a.size} differ"


def _levels_close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    frac = np.count_nonzero(a != b) / a.size
    print(f"{what}: level mismatch {frac:.6f}")
    assert frac <= 1e-3, what


def _psnr(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    mse = float((d * d).mean())
    return float("inf") if mse == 0 else 10 * np.log10(255 ** 2 / mse)


def _frames(seed, h=64, w=128, n=2):
    """Textured frames with a global shift between them."""
    rng = np.random.default_rng(seed)
    gy, gx = np.mgrid[0:h + 16, 0:w + 16]
    base = np.clip(128 + 80 * np.sin(gx / 6.0) * np.cos(gy / 9.0)
                   + rng.normal(0, 8, gx.shape), 0, 255).astype(np.uint8)
    out = []
    for i in range(n):
        y = base[2 * i:h + 2 * i, 3 * i:w + 3 * i].copy()
        u = base[i:h // 2 + i, 5:w // 2 + 5].copy()
        v = base[8:h // 2 + 8, i:w // 2 + i].copy()
        out.append((y, u, v))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_full_search_bit_exact_on_integer_refs(seed):
    (cy, _, _), (ry, _, _) = _frames(seed)
    cur, ref = cy.astype(np.float32)[None], ry.astype(np.float32)[None]
    jm, jc, jp = JM.full_search_mc_xla(jnp.asarray(cur), jnp.asarray(ref),
                                       8, 16, 2)
    tm, tc, tp = TM.full_search_mc_xla(_t(cur), _t(ref), 8, 16, 2)
    _eq(jm, tm, "mv")
    _eq(jc, tc, "cost")
    _eq(jp, tp, "pred")


@pytest.mark.parametrize("seed", [0, 1])
def test_hpel_refine_mc_bit_exact(seed):
    """The half-pel kernel's wrapper (plain version on the CPU) against
    me_pallas.hpel_refine_mc in Pallas interpret mode, as the JAX
    package's own test runs it."""
    rng = np.random.default_rng(seed)
    h, w = 64, 256
    cur_y = rng.integers(0, 256, (h, w)).astype(np.float32)
    ref_y = np.roll(cur_y, (rng.integers(-3, 4), rng.integers(-3, 4)),
                    (0, 1))
    ref_y = np.clip(ref_y + rng.integers(-2, 3, (h, w)), 0, 255) \
        .astype(np.float32)
    # fractional recon values: both packages truncate to bytes
    ref_y += rng.choice([0.0, 0.25, 0.9999], ref_y.shape).astype(np.float32)
    ref_y = np.minimum(ref_y, 255.0)
    ref_u = rng.integers(0, 256, (h // 2, w // 2)).astype(np.float32)
    ref_v = rng.integers(0, 256, (h // 2, w // 2)).astype(np.float32)
    mv_i = (rng.integers(-8, 9, (h // 16, w // 16, 2)) // 2 * 2) \
        .astype(np.int32)
    jo = JMEP.hpel_refine_mc(*(jnp.asarray(a) for a in
                               (cur_y, ref_y, ref_u, ref_v, mv_i)),
                             rnd=0, interpret=True)
    to = TMEP.hpel_refine_mc(*(_t(a) for a in
                               (cur_y, ref_y, ref_u, ref_v, mv_i)), rnd=0)
    assert to[0].dtype == torch.int32 and to[1].dtype == torch.float32
    for a, b, name in zip(jo, to, ("mv_h", "pred_y", "pred_u", "pred_v")):
        _eq(a, b, name)


def _hpel_inputs(seed, h=64, w=256):
    rng = np.random.default_rng(seed)
    cur_y = rng.integers(0, 256, (h, w)).astype(np.float32)
    ref_y = np.clip(np.roll(cur_y, (2, -1), (0, 1))
                    + rng.integers(-2, 3, (h, w)), 0, 255).astype(np.float32)
    ref_y += rng.choice([0.0, 0.5, 0.9999], ref_y.shape).astype(np.float32)
    ref_y = np.minimum(ref_y, 255.0)
    ref_u = rng.integers(0, 256, (h // 2, w // 2)).astype(np.float32)
    ref_v = rng.integers(0, 256, (h // 2, w // 2)).astype(np.float32)
    mv_i = rng.integers(-6, 7, (h // 16, w // 16, 2)).astype(np.int32)
    return cur_y, ref_y, ref_u, ref_v, mv_i


@pytest.mark.parametrize("seed,rnd", [(0, 0), (1, 1)])
def test_refine_mc_luma_matches_per_mb_pallas(seed, rnd):
    """Kernel 4b, luma: the port's refine_mc_luma (plain version on the
    CPU) against me_pallas._refine_mc_luma in interpret mode, fed the
    tiles and selectors the JAX package's hpel_refine_mc builds."""
    cur_y, ref_y, _, _, mv_i = _hpel_inputs(seed)
    h, w = cur_y.shape
    bh, bw = h // 16, w // 16
    j_mv = jnp.asarray(mv_i)
    tiles = JMEP._prep_plane(jnp.asarray(ref_y), 48)
    y0 = (jnp.arange(bh) * 16)[:, None]
    x0 = (jnp.arange(bw) * 16)[None, :]
    sy = y0 + j_mv[..., 0] - 1 + JMEP.PAD
    sx = x0 + j_mv[..., 1] - 1 + JMEP.PAD
    sel = jnp.stack([((sy >> 4) << 16) | (sx >> 7),
                     ((sy & 15) << 8) | (sx & 127),
                     j_mv[..., 0], j_mv[..., 1]],
                    axis=-1).reshape(-1).astype(jnp.int32)
    cur_b = jnp.asarray(cur_y).astype(jnp.uint8).reshape(bh, 16, bw, 16) \
        .transpose(0, 2, 1, 3)
    jpred, jmv = JMEP._refine_mc_luma(tiles, sel, cur_b, bh, bw, rnd,
                                      interpret=True)
    mv_h, pred_y = TMEP.refine_mc_luma(_t(cur_y), _t(ref_y), _t(mv_i), rnd)
    assert mv_h.dtype == torch.int32 and pred_y.dtype == torch.float32
    _eq(np.asarray(jmv)[:, 0, :2].reshape(bh, bw, 2), mv_h, "mv_h")
    _eq(np.asarray(jpred).transpose(0, 2, 1, 3).reshape(h, w), pred_y,
        "pred_y")


@pytest.mark.parametrize("seed,rnd", [(2, 0), (3, 1)])
def test_mc_chroma_matches_per_mb_pallas(seed, rnd):
    """Kernel 4b, chroma: the port's mc_chroma (plain version on the
    CPU) against me_pallas._mc_chroma in interpret mode, with the
    chroma tiles and selectors of the JAX package's hpel_refine_mc."""
    _, _, ref_u, ref_v, mv_i = _hpel_inputs(seed)
    rng = np.random.default_rng(seed)
    mv_h = (2 * mv_i + rng.integers(-2, 3, mv_i.shape)).astype(np.int32)
    hc, wc = ref_u.shape
    bh, bw = hc // 8, wc // 8
    pad = JMEP.PAD
    ct = jnp.stack([jnp.pad(jnp.asarray(p).astype(jnp.uint8),
                            ((pad, pad), (pad, pad)), mode="edge")
                    for p in (ref_u, ref_v)])
    hp, wp = ct.shape[1], ct.shape[2]
    ct = jnp.pad(ct, ((0, 0), (0, JMEP._align_up(hp, 16) + 32 - hp),
                      (0, JMEP._align_up(wp, 128) + 128 - wp)))
    ct = jnp.stack([JMEP._tile_plane(p, 32) for p in ct])
    mv_c = JMEP._chroma_mv(jnp.asarray(mv_h))
    cy = (jnp.arange(bh) * 8)[:, None] + (mv_c[..., 0] >> 1) + pad
    cx = (jnp.arange(bw) * 8)[None, :] + (mv_c[..., 1] >> 1) + pad
    selc = jnp.stack([((cy >> 4) << 16) | (cx >> 7),
                      (((cy & 15) << 24) | ((cx & 127) << 16)
                       | ((mv_c[..., 0] & 1) << 8) | (mv_c[..., 1] & 1))],
                     axis=-1).reshape(-1).astype(jnp.int32)
    jpu, jpv = JMEP._mc_chroma(ct, selc, bh, bw, rnd, interpret=True)
    tpu, tpv = TMEP.mc_chroma(_t(ref_u), _t(ref_v), _t(mv_h), rnd)
    for j, t, name in ((jpu, tpu, "pred_u"), (jpv, tpv, "pred_v")):
        assert t.dtype == torch.float32
        _eq(np.asarray(j).transpose(0, 2, 1, 3).reshape(hc, wc), t, name)


def test_encode_i_device_matches():
    y, u, v = _frames(3)[0]
    q = 5
    dl, dc = JE.T.dc_scaler(q, False), JE.T.dc_scaler(q, True)
    jo = JE._encode_i_device(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
                             q, dl, dc)
    to = TE._encode_i_device(_t(y), _t(u), _t(v), q, dl, dc)
    for k in "yuv":
        # the DC quantiser rounds dc/dc_scale to nearest, so a DC on an
        # exact .5 boundary may go either way: counted with the AC levels
        _levels_close(np.concatenate([np.ravel(jo[k][0]),
                                      np.ravel(jo[k][1])]),
                      np.concatenate([np.ravel(to[k][0]),
                                      np.ravel(to[k][1])]), f"I {k}")
        p = _psnr(jo[k][2], to[k][2])
        print(f"I recon {k}: PSNR {p:.1f} dB")
        assert p >= 40


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_p_device_matches_on_integer_refs(seed):
    """Identical MVs; levels within the float tolerance."""
    (ry, ru, rv), (y, u, v) = _frames(seed)
    refs = [a.astype(np.float32) for a in (ry, ru, rv)]
    jo = JE._encode_p_device(*(jnp.asarray(a) for a in (y, u, v, *refs)),
                             6, 8, pallas_mc=False)
    to = TE._encode_p_device(*(_t(a) for a in (y, u, v, *refs)), 6, 8)
    _eq(jo["mv"], to["mv"], "mv")
    for k in "yuv":
        _levels_close(jo[k][0], to[k][0], f"P levels {k}")
        p = _psnr(jo[k][1], to[k][1])
        print(f"P recon {k}: PSNR {p:.1f} dB")
        assert p >= 40


def test_sparse_layouts_bit_exact():
    rng = np.random.default_rng(4)
    nblk = 4096 + 64
    zz = np.zeros((nblk, 64), np.int16)
    m = rng.random((nblk, 64)) < 0.02
    zz[m] = rng.integers(-300, 301, m.sum())
    zz[:, 40:][rng.random((nblk, 24)) < 0.995] = 0
    for parts_j, parts_t in (
            (JE._sparsify_slim(jnp.asarray(zz)), TE._sparsify_slim(_t(zz))),
            (JE._sparsify_fat(jnp.asarray(zz), 1500, 9000),
             TE._sparsify_fat(_t(zz), 1500, 9000))):
        assert len(parts_j) == len(parts_t)
        for i, (a, b) in enumerate(zip(parts_j, parts_t)):
            assert b.dtype == torch.int16
            _eq(a, b, f"part {i}")


def _encode_all(enc, frames, frame_cls, to_planes):
    pkts, recon = [], []
    for i, (y, u, v) in enumerate(frames):
        f = frame_cls(planes=to_planes((y, u, v)), format="yuv420p",
                      width=y.shape[1], height=y.shape[0], pts=i)
        pkts += enc.encode(f)
        recon.append(tuple(np.asarray(p.cpu() if hasattr(p, "cpu") else p)
                           for p in enc._ref))
    return pkts, recon


def test_encoder_stream_and_state_carry():
    """Mpeg4Encoder(device="cpu") vs the JAX encoder at constant qscale
    over an I + P sequence: same packet count and key flags, recon PSNR
    port vs JAX >= 40 dB. Then the port continues mid-GOP from the JAX
    encoder's state (compat.encoder_state_from_numpy) and its next
    P-VOP matches the JAX encoder's bit for bit or within the level
    tolerance."""
    frames = _frames(5, n=5)
    h, w = frames[0][0].shape
    je = JE.Mpeg4Encoder(width=w, height=h, qscale=4, gop_size=12)
    te = TE.Mpeg4Encoder(width=w, height=h, qscale=4, gop_size=12,
                         device="cpu")
    jp, jr = _encode_all(je, frames[:4], JFrame, lambda p: p)
    tp, tr = _encode_all(te, frames[:4], TFrame,
                         lambda p: tuple(_t(a) for a in p))
    assert len(jp) == len(tp) == 4
    assert [p.flags for p in jp] == [p.flags for p in tp]
    for a, b in zip(jr, tr):
        p = min(_psnr(x, y) for x, y in zip(a, b))
        print(f"recon PSNR port vs JAX: {p:.1f} dB")
        assert p >= 40
    ce = compat.encoder_state_from_numpy(
        w, h, jr[-1], frame_idx=4, qscale=4, gop_size=12, device="cpu",
        packer={"last_sec": je._packer.last_sec})
    y, u, v = frames[4]
    jpk = je.encode(JFrame(planes=(y, u, v), format="yuv420p", width=w,
                           height=h, pts=4))[0]
    tpk = ce.encode(TFrame(planes=(_t(y), _t(u), _t(v)), format="yuv420p",
                           width=w, height=h, pts=4))[0]
    assert tpk.flags == jpk.flags == 0
    p = min(_psnr(np.asarray(a), b.numpy())
            for a, b in zip(je._ref, ce._ref))
    print(f"mid-GOP P-VOP: {len(jpk.data)} vs {len(tpk.data)} bytes, "
          f"recon PSNR {p:.1f} dB")
    assert abs(len(jpk.data) - len(tpk.data)) <= 0.01 * len(jpk.data) + 4
    assert p >= 40
