"""The port's H.264 P-frame reconstruction (librempeg_tpu_torch) against
the JAX package's device_recon on the CPU.

Every comparison is bit-exact (tolerance 0): these paths are integer
arithmetic. Inputs are made with numpy from a seed; both packages get
the same arrays. The kernel wrappers are called on CPU tensors, where
they take their plain versions; the CUDA kernels themselves are
compared with those plain versions in test_torch_kernels.py and by
chip_smoke.py.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from librempeg_tpu.codecs.h264 import deblock_pallas as JDP
from librempeg_tpu.codecs.h264 import device_recon as JD
from librempeg_tpu.codecs.h264 import intra_pallas as JIP
from librempeg_tpu_torch.codecs.h264 import deblock_pallas as TDP
from librempeg_tpu_torch.codecs.h264 import device_recon as TD
from librempeg_tpu_torch.codecs.h264 import intra_pallas as TIP
from librempeg_tpu_torch.codecs.h264 import mc_pallas as TMC

MB_W, MB_H = 5, 3
NMB = MB_W * MB_H
H, W = MB_H * 16, MB_W * 16
CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "librempeg_tpu_torch", "csrc")


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    bad = np.count_nonzero(a != b)
    assert bad == 0, f"{what}: {bad}/{a.size} values differ"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _planes(rng):
    return (rng.integers(0, 256, (H, W)).astype(np.uint8),
            rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8),
            rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8))


def _entropy(rng, intra_frac=0.3):
    """Random sparse levels, qp, MB kinds and motion of one P frame."""
    total = NMB * 27 * 16
    idx = np.sort(rng.choice(total, size=total // 12, replace=False))
    vals = rng.integers(-40, 41, idx.size).astype(np.int16)
    kind = np.where(rng.random(NMB) < intra_frac,
                    rng.choice([2, 3], NMB), 0).astype(np.int32)
    return {
        "idx": idx.astype(np.int32), "vals": vals,
        "qp": rng.integers(12, 46, NMB).astype(np.int32),
        "kind": kind,
        "info": (rng.integers(0, 4, NMB)
                 | (rng.integers(0, 4, NMB) << 4)).astype(np.int32),
        "i4modes": rng.integers(0, 9, (NMB, 16)).astype(np.int8),
        "mv": rng.integers(-300, 301, (NMB, 16, 2)).astype(np.int16),
        "ref": rng.integers(0, 2, (NMB, 4)).astype(np.int8),
    }


def _refpacks(rng, n=2):
    packs = [JD.make_refpack(*(jnp.asarray(p) for p in _planes(rng)))
             for _ in range(n)]
    return [np.stack([np.asarray(p[i]) for p in packs]) for i in range(3)]


@pytest.mark.parametrize("seed", [0, 1])
def test_make_refpack_bit_exact(seed):
    y, u, v = _planes(np.random.default_rng(seed))
    for a, b, name in zip(JD.make_refpack(y, u, v),
                          TD.make_refpack(_t(y), _t(u), _t(v)),
                          ("luma4", "upad", "vpad")):
        _eq(a, b, name)


@pytest.mark.parametrize("seed", [0, 1])
def test_mc_bit_exact(seed):
    """_mc and the MC kernel's wrapper (plain version on the CPU) vs the
    JAX _mc; the MVs reach past the padded edge to hit the clamps."""
    rng = np.random.default_rng(seed)
    luma4, upad, vpad = _refpacks(rng)
    e = _entropy(rng)
    jy, ju, jv = JD._mc(jnp.asarray(luma4), jnp.asarray(upad),
                        jnp.asarray(vpad), jnp.asarray(e["mv"]),
                        jnp.asarray(e["ref"]), MB_W, MB_H)
    args = (_t(luma4), _t(upad), _t(vpad), _t(e["mv"]), _t(e["ref"]),
            MB_W, MB_H)
    ty, tu, tv = TD._mc(*args)
    _eq(jy, ty, "pred_y")
    _eq(ju, tu, "pred_u")
    _eq(jv, tv, "pred_v")
    # the wrapper's MB-tile layout is the one recon_p_frame_pred reads
    py, pu, pv = TMC.mc_predict(*args)
    assert py.dtype == torch.uint8 and py.shape == (NMB, 16, 16)
    _eq(np.asarray(jy).reshape(NMB, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4)
        .reshape(NMB, 16, 16), py, "mc_predict y")
    _eq(np.asarray(ju).reshape(NMB, 4, 4, 2, 2).transpose(0, 1, 3, 2, 4)
        .reshape(NMB, 8, 8), pu, "mc_predict u")


@pytest.mark.parametrize("fold_i16", [False, True])
def test_recon_p_frame_pred_noscan_bit_exact(fold_i16):
    rng = np.random.default_rng(7 + fold_i16)
    e = _entropy(rng)
    pred = [rng.integers(0, 256, s).astype(np.uint8)
            for s in ((NMB, 16, 16), (NMB, 8, 8), (NMB, 8, 8))]
    keys = ("idx", "vals", "qp", "kind")
    jo = JD.recon_p_frame_pred_noscan(
        *(jnp.asarray(p) for p in pred), *(jnp.asarray(e[k]) for k in keys),
        MB_W, MB_H, 2, fold_i16)
    to = TD.recon_p_frame_pred_noscan(
        *(_t(p) for p in pred), *(_t(e[k]) for k in keys), MB_W, MB_H, 2,
        fold_i16)
    for a, b, name in zip(jo, to, ("y", "u", "v", "lres_t", "cres_t")):
        _eq(a, b, name)


def _intra_case(seed):
    rng = np.random.default_rng(seed)
    e = _entropy(rng, intra_frac=0.5)
    e["kind"][[0, MB_W - 1, NMB - 1]] = [2, 3, 2]   # frame corners
    y, u, v = _planes(rng)
    lres_t = rng.integers(-30, 31, (NMB, 16, 16)).astype(np.int32)
    cres_t = rng.integers(-30, 31, (NMB, 2, 8, 8)).astype(np.int32)
    ilist = np.flatnonzero(e["kind"] >= 2).astype(np.int32)
    return e, (y, u, v), lres_t, cres_t, ilist


@pytest.mark.parametrize("seed", [0, 1])
def test_intra_scan_bit_exact(seed):
    """build_intra_scalars and the intra kernel's wrapper (plain version
    on the CPU, which runs _intra_scan) vs the JAX package's XLA intra
    scan, on chains of adjacent intra MBs including frame corners."""
    e, (y, u, v), lres_t, cres_t, ilist = _intra_case(seed)
    jscal = JIP.build_intra_scalars(
        jnp.asarray(ilist), jnp.asarray(e["kind"]), jnp.asarray(e["info"]),
        jnp.asarray(e["i4modes"]), MB_W, MB_H, len(ilist))
    tscal = TIP.build_intra_scalars(_t(ilist), _t(e["kind"]),
                                    _t(e["info"]), _t(e["i4modes"]),
                                    MB_W, MB_H)
    _eq(jscal, tscal, "scalars")

    lres = lres_t.reshape(NMB, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4) \
        .reshape(NMB, 16, 4, 4)
    cres = cres_t.reshape(NMB, 2, 2, 4, 2, 4).transpose(0, 1, 2, 4, 3, 5)
    pad = ((1, 8), (1, 8))
    jy, ju, jv = JD._intra_scan(
        jnp.pad(y, pad), jnp.pad(u, pad), jnp.pad(v, pad),
        jnp.asarray(ilist), jnp.asarray(e["kind"]), jnp.asarray(e["info"]),
        jnp.asarray(e["i4modes"]), jnp.asarray(lres), jnp.asarray(cres),
        MB_W, MB_H)
    ty, tu, tv = TIP.intra_scan_pallas(_t(y), _t(u), _t(v), tscal,
                                       _t(lres_t), _t(cres_t), MB_W, MB_H)
    _eq(np.asarray(jy)[1:H + 1, 1:W + 1], ty, "y")
    _eq(np.asarray(ju)[1:H // 2 + 1, 1:W // 2 + 1], tu, "u")
    _eq(np.asarray(jv)[1:H // 2 + 1, 1:W // 2 + 1], tv, "v")


@pytest.mark.parametrize("seed", [0, 1])
def test_bs_maps_and_edge_params_bit_exact(seed):
    rng = np.random.default_rng(seed)
    e = _entropy(rng)
    coeffs = np.zeros(NMB * 27 * 16, np.int32)
    coeffs[e["idx"]] = e["vals"]
    coeffs = coeffs.reshape(NMB, 27, 16)
    jb = JD._bs_maps(jnp.asarray(coeffs), jnp.asarray(e["mv"]),
                     jnp.asarray(e["ref"]), jnp.asarray(e["kind"]),
                     MB_W, MB_H)
    tb = TD._bs_maps(_t(coeffs), _t(e["mv"]), _t(e["ref"]), _t(e["kind"]),
                     MB_W, MB_H)
    _eq(jb[0], tb[0], "bs_v")
    _eq(jb[1], tb[1], "bs_h")
    je = JD._edge_params(jnp.asarray(e["qp"]), MB_W, MB_H, -3, 2, -2)
    te = TD._edge_params(_t(e["qp"]), MB_W, MB_H, -3, 2, -2)
    assert set(je) == set(te)
    for k in je:
        _eq(je[k], te[k], k)
    # the kernel's packed [nmb, 8, 16] parameter block
    ep = je
    jv = JDP._mbize(JDP._pack_params(jb[0], ep["lav"], ep["lbv"]),
                    MB_W, MB_H)
    P = TDP.deblock_params(_t(e["idx"]), _t(e["vals"]), _t(e["mv"]),
                           _t(e["ref"]), _t(e["qp"]), _t(e["kind"]),
                           MB_W, MB_H, -3, 2, -2)
    _eq(jv, P[:, 0:4, 0:4], "packed luma vertical")


@pytest.mark.parametrize("seed,offs", [(0, (0, 0, 0)), (1, (2, 3, -2))])
def test_deblock_frame_bit_exact(seed, offs):
    """deblock_frame (the t = mx + 2*my wavefront) and the deblock
    kernel's wrapper (plain version on the CPU) vs the JAX
    deblock_frame, with intra MBs for the bS 3/4 strong filters."""
    rng = np.random.default_rng(seed)
    e = _entropy(rng)
    # smooth planes so the filters' alpha/beta gates open
    gy, gx = np.mgrid[0:H, 0:W]
    y = np.clip(128 + 40 * np.sin(gx / 7.0) + rng.integers(-6, 7, (H, W)),
                0, 255).astype(np.uint8)
    u = y[::2, ::2].copy()
    v = (255 - y[::2, ::2]).astype(np.uint8)
    keys = ("idx", "vals", "mv", "ref", "qp", "kind")
    jo = JD.deblock_frame(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
                          *(jnp.asarray(e[k]) for k in keys), MB_W, MB_H,
                          *offs)
    targs = (*(_t(e[k]) for k in keys), MB_W, MB_H, *offs)
    to = TD.deblock_frame(_t(y), _t(u), _t(v), *targs)
    tw = TDP.deblock_frame_pallas(_t(y), _t(u), _t(v), *targs)
    assert not np.array_equal(np.asarray(jo[0]), y), "filter did nothing"
    for a, b, c, name in zip(jo, to, tw, "yuv"):
        _eq(a, b, name)
        _eq(a, c, name + " (wrapper)")


def _cu_table(src, name):
    body = re.search(name + r"[^=]*=\s*\{(.*?)\};",
                     open(os.path.join(CSRC, src)).read(), re.S).group(1)
    return [int(x) for x in re.findall(r"-?\d+", body)]


def test_kernel_source_tables_match_the_plain_versions():
    """The constant tables written into the CUDA sources are the plain
    versions' tables."""
    assert _cu_table("mc.cu", "kQM") == TD._QM.ravel().tolist()
    dec = TD._BLK4_DEC
    assert _cu_table("intra.cu", "kBlkY") == [by for by, _ in dec]
    assert _cu_table("intra.cu", "kBlkX") == [bx for _, bx in dec]
