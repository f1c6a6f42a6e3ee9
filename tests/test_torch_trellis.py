"""The port's trellis (RD) quantiser against the JAX package's on the CPU.

The lattice (ops/trellis.viterbi_rl) is float32: its prefix sums of
squared coefficients are a cumsum whose summation order differs between
XLA and PyTorch, so two paths whose RD costs tie to the last bit can
resolve differently. Levels must be equal on at least 99.9% of blocks;
where a block differs, the port's RD cost (recomputed in float64 from
the levels) must be no more than the JAX package's x (1 + 1e-5): a tie,
not a worse choice. Each case prints the share of blocks that differ.
_dequant_recon is integer arithmetic and must match exactly. The I/P
device passes with trellis=True on integer references: MVs exact,
levels within the float tolerance of test_torch_mpeg4._levels_close.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from librempeg_tpu.codecs.mpeg4 import encoder as JE
from librempeg_tpu.codecs.mpeg4 import trellis as JR
from librempeg_tpu.ops import trellis as JT
from librempeg_tpu_torch.codecs.mpeg4 import encoder as TE
from librempeg_tpu_torch.codecs.mpeg4 import tables as TT
from librempeg_tpu_torch.codecs.mpeg4 import trellis as TR
from librempeg_tpu_torch.ops import trellis as TTL
from test_torch_mpeg4 import _eq, _frames, _levels_close, _psnr, _t
from tools.mpeg4_jax_repair import repaired


@pytest.fixture(autouse=True, scope="module")
def _jax_mpeg4_reference():
    """The JAX encoder with its decoder's reference, as the port's
    encoder has it (tools/mpeg4_jax_repair.py): its float recon is the
    fault the port repairs, so byte and level comparisons hold the port
    to the repaired JAX encoder."""
    with repaired():
        yield


def _coeffs(seed, nblk):
    """Zigzag-ordered DCT-like coefficients whose spread decays along
    the scan, with a share of exact zeros."""
    rng = np.random.default_rng(seed)
    scale = 400.0 / (1.0 + np.arange(64)) ** 1.1
    zz = rng.normal(0, 1, (nblk, 64)) * scale
    zz[rng.random((nblk, 64)) < 0.2] = 0.0
    return zz.astype(np.float32)


def _rd_cost(zz, levels, cands, dist_c, bidx, b0, b1, lam, first):
    """sum(distortion) + lam * sum(bits) of each block's levels, float64:
    a coded position costs its candidate's distortion and its event's
    bits (b1 for the block's last code), an uncoded one its c^2."""
    zz = zz.astype(np.float64)
    out = np.zeros(len(zz))
    for i, (z, lv) in enumerate(zip(zz, levels)):
        nz = [p for p in range(first, 64) if lv[p] != 0]
        c = float((z[first:] ** 2).sum())
        prev = first - 1
        for j, p in enumerate(nz):
            k = int(np.flatnonzero(cands[i, p] == abs(lv[p]))[0])
            c += float(dist_c[i, p, k]) - float(z[p]) ** 2
            tab = b1 if j == len(nz) - 1 else b0
            c += float(lam) * float(tab[p - prev - 1, bidx[i, p, k]])
            prev = p
        out[i] = c
    return out


def _hold(jl, tl, cost_args, what):
    jl, tl = np.asarray(jl), np.asarray(tl)
    assert jl.shape == tl.shape and tl.dtype == np.int32, what
    bad = np.flatnonzero((jl != tl).any(axis=1))
    share = len(bad) / len(jl)
    print(f"{what}: {len(bad)}/{len(jl)} blocks differ ({share:.6f})")
    assert share <= 1e-3, what
    if len(bad):
        sub = [a[bad] if isinstance(a, np.ndarray) and a.ndim >= 2
               and a.shape[0] == len(jl) else a for a in cost_args]
        cj = _rd_cost(sub[0], jl[bad], *sub[1:])
        ct = _rd_cost(sub[0], tl[bad], *sub[1:])
        print(f"{what}: RD cost port/JAX on those blocks: {ct / cj}")
        assert (ct <= cj * (1 + 1e-5)).all(), what


@pytest.mark.parametrize("first", [0, 1])
def test_viterbi_rl_matches_jax(first):
    """The generic lattice on random candidates, distortions and bit
    tables (K = 3)."""
    nblk, K = 1500, 3
    rng = np.random.default_rng(10 + first)
    zz = _coeffs(first, nblk)
    base = np.maximum(np.abs(zz) // 7, 1).astype(np.int32)
    cands = np.stack([base, base + 1, np.maximum(base - 1, 1) + 5],
                     axis=-1).astype(np.int32)
    dist_c = rng.uniform(0, 4000, (nblk, 64, K)).astype(np.float32)
    bidx = np.minimum(cands, 63).astype(np.int32)
    b0 = rng.integers(2, 31, (64, 64)).astype(np.float32)
    b1 = rng.integers(2, 31, (64, 64)).astype(np.float32)
    lam = np.float32(21.25)
    jl = JT.viterbi_rl(*(jnp.asarray(a) for a in (zz, cands, dist_c, bidx,
                                                  b0, b1)), lam, first)
    tl = TTL.viterbi_rl(*(_t(a) for a in (zz, cands, dist_c, bidx, b0, b1)),
                        lam, first)
    _hold(jl, tl.numpy(), (zz, cands, dist_c, bidx, b0, b1, lam, first),
          f"viterbi_rl first={first}")


def _rd_inputs(zz, q):
    """What quantize_rd hands the lattice, in numpy (float32 as both
    packages compute it)."""
    mag = np.abs(zz)
    l0 = np.clip(np.trunc(mag / np.float32(2.0 * q)).astype(np.int32), 0,
                 2047)
    cands = np.stack([np.maximum(l0, 1), np.maximum(l0 - 1, 1)], -1)
    dqm = TR._dequant_mag(cands, q).astype(np.float32)
    dist_c = (dqm - mag[..., None]) ** 2
    return cands, dist_c, np.minimum(cands, 63)


@pytest.mark.parametrize("intra", [True, False], ids=["intra", "inter"])
@pytest.mark.parametrize("q", [1, 2, 5, 31])
def test_quantize_rd_matches_jax(intra, q):
    first = 1 if intra else 0
    zz = _coeffs(q + 100 * intra, 1200)
    jl = JR.quantize_rd(jnp.asarray(zz), q, intra, first)
    tl = TR.quantize_rd(_t(zz), q, intra, first)
    assert not tl[:, :first].any()
    b0, b1 = (t.astype(np.float32) for t in TR._bits_tables(intra))
    jb0, jb1 = JR._bits_tables(intra)
    assert np.array_equal(jb0, b0) and np.array_equal(jb1, b1)
    lam = np.float32(np.float32(0.85) * np.float32(q)) * np.float32(q)
    _hold(jl, tl.numpy(), (zz, *_rd_inputs(zz, q), b0, b1, lam, first),
          f"quantize_rd q={q} {'intra' if intra else 'inter'}")


@pytest.mark.parametrize("q", [1, 4, 31])
def test_dequant_recon_exact(q):
    rng = np.random.default_rng(q)
    zz = rng.integers(-40, 41, (300, 64)).astype(np.int32)
    zz[rng.random(zz.shape) < 0.6] = 0
    j = JE._dequant_recon(jnp.asarray(zz), jnp.int32(q))
    t = TE._dequant_recon(_t(zz), q)
    assert t.dtype == torch.float32 and t.shape == (300, 8, 8)
    _eq(j, t, f"_dequant_recon q={q}")
    assert np.array_equal(np.asarray(TT.ZIGZAG), np.asarray(JE.T.ZIGZAG))


def test_encode_i_device_trellis_matches():
    y, u, v = _frames(6)[0]
    q = 5
    dl, dc = JE.T.dc_scaler(q, False), JE.T.dc_scaler(q, True)
    # jitted here as the encoder's packed I pass runs it (eager, the
    # JAX package compiles each op of the lattice apart: 5x slower)
    enc_i = jax.jit(JE._encode_i_device, static_argnames=("trellis",))
    jo = enc_i(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), q, dl, dc,
               trellis=True)
    to = TE._encode_i_device(_t(y), _t(u), _t(v), q, dl, dc, trellis=True)
    for k in "yuv":
        assert to[k][1].dtype == torch.int16
        _levels_close(np.concatenate([np.ravel(jo[k][0]),
                                      np.ravel(jo[k][1])]),
                      np.concatenate([np.ravel(to[k][0]),
                                      np.ravel(to[k][1])]), f"I RD {k}")
        p = _psnr(jo[k][2], to[k][2])
        print(f"I RD recon {k}: PSNR {p:.1f} dB")
        assert p >= 40


@pytest.mark.parametrize("q", [3, 8])
def test_encode_p_device_trellis_matches_on_integer_refs(q):
    (ry, ru, rv), (y, u, v) = _frames(q)
    refs = [a.astype(np.float32) for a in (ry, ru, rv)]
    jo = JE._encode_p_device(*(jnp.asarray(a) for a in (y, u, v, *refs)),
                             q, 8, trellis=True, pallas_mc=False)
    to = TE._encode_p_device(*(_t(a) for a in (y, u, v, *refs)), q, 8,
                             trellis=True)
    _eq(jo["mv"], to["mv"], "mv")
    for k in "yuv":
        _levels_close(jo[k][0], to[k][0], f"P RD levels {k} q={q}")
        p = _psnr(jo[k][1], to[k][1])
        print(f"P RD recon {k}: PSNR {p:.1f} dB")
        assert p >= 40
