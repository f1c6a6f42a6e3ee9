"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so the card's
machine (which has no JAX) runs it as it stands:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_kernels.py -m cuda

(--noconftest: tests/conftest.py configures JAX). Kernel results must
equal the plain versions bit for bit. Without a card the `cuda` cases
skip; the CPU cases check the wrappers' dispatch and the kernel
sources' notes.
"""
import os
import re

import numpy as np
import pytest
import torch

from librempeg_tpu_torch import kernels
from librempeg_tpu_torch.codecs.pcm import from_float, to_float
from librempeg_tpu_torch.codecs.h264 import deblock_pallas as DP
from librempeg_tpu_torch.codecs.h264 import device_recon as DR
from librempeg_tpu_torch.codecs.h264 import intra_pallas as IP
from librempeg_tpu_torch.codecs.h264 import mc_pallas as MC
from librempeg_tpu_torch.codecs.h264 import residual_pallas as RP
from librempeg_tpu_torch.codecs.mpeg4 import me_pallas as MEP
from librempeg_tpu_torch.filters import biquads as BQ
from librempeg_tpu_torch.kernels import biquad as KB
from librempeg_tpu_torch.ops import motion
from librempeg_tpu_torch.ops.pallas import mesearch as MS
from librempeg_tpu_torch.resample import dither as RD

MB_W, MB_H = 7, 4
NMB = MB_W * MB_H
H, W = MB_H * 16, MB_W * 16
CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "librempeg_tpu_torch", "csrc")


def _eq(a, b, what):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    assert a.shape == b.shape, (what, a.shape, b.shape)
    bad = np.count_nonzero(a != b)
    assert bad == 0, f"{what}: {bad}/{a.size} values differ"


def _case(seed, dev):
    """Random planes, refpacks and P-frame entropy on `dev`."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def planes():
        return (t(rng.integers(0, 256, (H, W)).astype(np.uint8)),
                t(rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8)),
                t(rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8)))

    packs = [DR.make_refpack(*planes()) for _ in range(2)]
    refs = [torch.stack([p[i] for p in packs]) for i in range(3)]
    total = NMB * 27 * 16
    idx = np.sort(rng.choice(total, size=total // 12, replace=False))
    kind = np.where(rng.random(NMB) < 0.4, rng.choice([2, 3], NMB), 0)
    kind[[0, MB_W - 1, NMB - 1]] = [2, 3, 2]
    e = {
        "idx": t(idx.astype(np.int32)),
        "vals": t(rng.integers(-40, 41, idx.size).astype(np.int16)),
        "mv": t(rng.integers(-300, 301, (NMB, 16, 2)).astype(np.int16)),
        "ref": t(rng.integers(0, 2, (NMB, 4)).astype(np.int8)),
        "qp": t(rng.integers(12, 46, NMB).astype(np.int32)),
        "kind": t(kind.astype(np.int32)),
        "info": t((rng.integers(0, 4, NMB)
                   | (rng.integers(0, 4, NMB) << 4)).astype(np.int32)),
        "i4modes": t(rng.integers(0, 9, (NMB, 16)).astype(np.int8)),
        "ilist": t(np.flatnonzero(kind >= 2).astype(np.int32)),
        "lres_t": t(rng.integers(-30, 31, (NMB, 16, 16)).astype(np.int32)),
        "cres_t": t(rng.integers(-30, 31, (NMB, 2, 8, 8)).astype(np.int32)),
    }
    return planes(), refs, e


def _hpel_case(seed, dev, h=96, w=160):
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 256, (h, w)).astype(np.float32)
    ref = np.clip(np.roll(cur, (2, -3), (0, 1))
                  + rng.integers(-2, 3, (h, w)), 0, 255).astype(np.float32)
    ref += rng.choice([0.0, 0.5, 0.9999], ref.shape).astype(np.float32)
    ref = np.minimum(ref, 255.0)
    ru = rng.integers(0, 256, (h // 2, w // 2)).astype(np.float32)
    rv = rng.integers(0, 256, (h // 2, w // 2)).astype(np.float32)
    mv = (rng.integers(-8, 9, (h // 16, w // 16, 2)) // 2 * 2)
    return [torch.from_numpy(a).to(dev)
            for a in (cur, ref, ru, rv, mv.astype(np.int32))]


def _hpel_edge_case(h, w, rnd, dev):
    """_hpel_case with integer MVs up to 14 pixels (the corners' at both
    extremes), which push windows past every frame edge (the plain
    version's 16-pixel pad still holds them)."""
    cur, ref, ru, rv, mv = _hpel_case(h * w + rnd, dev, h, w)
    rng = np.random.default_rng(w)
    mv = torch.from_numpy(rng.integers(-14, 15, mv.shape).astype(np.int32)) \
        .to(dev)
    mv[0, 0], mv[-1, -1] = torch.tensor([-14, -14]), torch.tensor([14, 14])
    return cur, ref, ru, rv, mv


def _mc_frame(mb_w, mb_h, nref, seed, dev):
    """Refpacks of `nref` random frames of mb_w x mb_h MBs and a motion
    field for them: MVs reach 80 samples past every edge (both the luma
    and the chroma clamp bind, the corners' at both extremes), the 16
    quarter-pel phases cycle over the blocks (all 16 in every MB), refs
    run from -1 to nref (both clamped) -> (luma4, upad, vpad, mv, ref)."""
    rng = np.random.default_rng(seed)
    h, w = mb_h * 16, mb_w * 16

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    packs = [DR.make_refpack(
        t(rng.integers(0, 256, (h, w)).astype(np.uint8)),
        t(rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)),
        t(rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)))
        for _ in range(nref)]
    refs = [torch.stack([p[i] for p in packs]) for i in range(3)]
    nmb = mb_w * mb_h
    big = np.array([w + 80, h + 80]) * 4
    mv = rng.integers(-big, big, (nmb, 16, 2))
    mv[0, 0], mv[-1, -1] = -big, big - 1
    mv[0, 3], mv[-1, 12] = (big[0] - 1, -big[1]), (-big[0], big[1] - 1)
    phase = np.arange(nmb * 16).reshape(nmb, 16) % 16
    mv[..., 0] = (mv[..., 0] & ~3) | (phase & 3)
    mv[..., 1] = (mv[..., 1] & ~3) | (phase >> 2)
    ref = rng.integers(-1, nref + 1, (nmb, 4))
    return (*refs, t(mv.astype(np.int16)), t(ref.astype(np.int8)))


def _fsearch_case(seed, dev, n=2, h=96, w=160, integer=True):
    rng = np.random.default_rng(seed)
    cur = rng.uniform(0, 255, (n, h, w)).astype(np.float32)
    ref = np.clip(np.roll(cur, (1, -2), (1, 2))
                  + rng.normal(0, 3, cur.shape), 0, 255).astype(np.float32)
    if integer:
        cur, ref = np.round(cur), np.round(ref)
    return [torch.from_numpy(a).to(dev) for a in (cur, ref)]


def _biquad_case(seed, c, n, dev, kind="lowpass"):
    """A biquad call's inputs: noisy audio in [-1, 1), the float32 RBJ
    coefficients of `kind` at 44.1 kHz, a carried state."""
    rng = np.random.default_rng(seed)
    x = np.clip(rng.normal(0, 0.3, (c, n)), -1, 1).astype(np.float32)
    b, a = BQ._rbj(kind, 700.0, 44100, 0.707, 4.0)
    bb = tuple(np.float32(v / a[0]) for v in b)
    aa = (np.float32(a[1] / a[0]), np.float32(a[2] / a[0]))
    z = rng.uniform(-0.05, 0.05, (c, 2)).astype(np.float32)
    return (torch.from_numpy(x).to(dev), bb, aa,
            torch.from_numpy(z).to(dev))


def _residual_case(seed, dev, mb_w=9, mb_h=15):
    """Compact rows of random dequantised blocks (more than one 120-MB
    stripe, some pad rows) -> (packed, nmb)."""
    rng = np.random.default_rng(seed)
    nmb = mb_w * mb_h
    ids = np.sort(rng.choice(nmb * 24, size=nmb * 10, replace=False))
    levels = rng.integers(-3000, 3001, (ids.size, 16)).astype(np.int16)
    packed = RP.pack_rows(ids.astype(np.int32), levels, ids.size + 3)
    return torch.from_numpy(packed).to(dev), nmb


def _shape_scan_case(seed, k, c, n, dev):
    """The shaper scan's inputs: samples in LSB units (a full-scale
    range, some at the clip), TPDF noise, the method's taps and a
    carried error history."""
    rng = np.random.default_rng(seed)
    coefs = {5: "lipshitz", 3: "f_weighted"}[k]
    x = np.clip(rng.normal(0, 9000, (c, n)), -32768, 32767)
    noise = rng.random((c, n)) - rng.random((c, n))
    err0 = rng.uniform(-0.5, 0.5, (k, c))

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    return t(x), t(noise), t(RD._SHAPER_COEFS[coefs]), t(err0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels build and run only there")
    return "cuda"


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors no wrapper launches (or builds) a kernel."""
    kernels.reset_counts()
    (y, u, v), (l4, up, vp), e = _case(0, "cpu")
    MC.mc_predict(l4, up, vp, e["mv"], e["ref"], MB_W, MB_H)
    scal = IP.build_intra_scalars(e["ilist"], e["kind"], e["info"],
                                  e["i4modes"], MB_W, MB_H)
    IP.intra_scan_pallas(y, u, v, scal, e["lres_t"], e["cres_t"], MB_W,
                         MB_H)
    DP.deblock_frame_pallas(y, u, v, e["idx"], e["vals"], e["mv"],
                            e["ref"], e["qp"], e["kind"], MB_W, MB_H)
    MEP.hpel_refine_mc(*_hpel_case(0, "cpu"))
    MS.full_search_mc(*_fsearch_case(0, "cpu"), 4)
    packed, nmb = _residual_case(0, "cpu")
    RP.expand_residual(packed, None, nmb)
    RD.shape_scan(*_shape_scan_case(0, 5, 2, 64, "cpu"))
    x, b, a, z = _biquad_case(0, 2, 64, "cpu")
    BQ.cascade(x, [(*b, *a)] * 2, torch.stack([z, z]), "s16p")
    cur, ref = _fsearch_case(0, "cpu")
    MS.full_search_mc(cur, ref, 12, *cur.shape[1:])
    assert kernels.counts() == {"mc": 0, "deblock": 0, "intra": 0,
                                "hpel": 0, "hpel_luma": 0,
                                "hpel_chroma": 0, "fsearch": 0,
                                "residual": 0, "shape_scan": 0,
                                "biquad": 0}


@pytest.mark.parametrize("name,replaces", [
    ("mc.cu", "mc_pallas.py"), ("deblock.cu", "deblock_pallas.py"),
    ("intra.cu", "intra_pallas.py"), ("hpel.cu", "me_pallas.py"),
    ("fsearch.cu", "mesearch.py"), ("residual.cu", "residual_pallas.py"),
    ("shape_scan.cu", "dither.py"), ("biquad.cu", "biquads.py")])
def test_kernel_sources_carry_their_notes(name, replaces):
    """Each source names the Pallas kernel it replaces and what bounds
    it on the card."""
    src = open(os.path.join(CSRC, name)).read()
    assert replaces in src and "Bound on the H100" in src
    assert 'extern "C" int' in src and "cudaGetLastError" in src


def test_mc_source_table_is_device_recon_qm():
    """csrc/mc.cu packs its quarter-pel plane pairs from a table that
    must equal device_recon._QM."""
    src = open(os.path.join(CSRC, "mc.cu")).read()
    body = src[src.index("kQM[16][6] = {") + 14:]
    body = body[:body.index("};")]
    rows = [[int(x) for x in r.split(",")]
            for r in re.findall(r"\{([^{}]*)\}", body)]
    assert np.array_equal(np.array(rows), DR._QM)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_mc_kernel(seed):
    dev = _card()
    _, (l4, up, vp), e = _case(seed, dev)
    args = (l4, up, vp, e["mv"], e["ref"], MB_W, MB_H)
    for a, b, n in zip(MC.mc_predict(*args), MC.mc_predict_plain(*args),
                       "yuv"):
        _eq(a, b, "mc " + n)


@pytest.mark.cuda
@pytest.mark.parametrize("nref", [1, 3])
@pytest.mark.parametrize("mb_w,mb_h", [(1, 1), (3, 2), (7, 4)])
def test_mc_kernel_frames(mb_w, mb_h, nref):
    """One thread per 4x4 block against the plain version on frames of
    1, 6 and 28 MBs, with every clamp bound and every quarter-pel phase
    present."""
    dev = _card()
    args = (*_mc_frame(mb_w, mb_h, nref, mb_w * 10 + nref, dev), mb_w, mb_h)
    got = MC.mc_predict(*args)
    want = MC.mc_predict_plain(*args)
    torch.cuda.synchronize()
    for a, b, n in zip(got, want, "yuv"):
        _eq(a, b, f"mc {mb_w}x{mb_h} nref {nref} {n}")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_intra_kernel(seed):
    dev = _card()
    (y, u, v), _, e = _case(seed, dev)
    scal = IP.build_intra_scalars(e["ilist"], e["kind"], e["info"],
                                  e["i4modes"], MB_W, MB_H)
    want = IP.intra_scan_plain(y, u, v, scal, e["lres_t"], e["cres_t"],
                               MB_W, MB_H)
    got = IP.intra_scan_pallas(y.clone(), u.clone(), v.clone(), scal,
                               e["lres_t"], e["cres_t"], MB_W, MB_H)
    for a, b, n in zip(got, want, "yuv"):
        _eq(a, b, "intra " + n)


def _intra(dev, mb_w, mb_h, seed, **kw):
    """intra_pallas.random_intra_frame on `dev` -> (planes, scal,
    lres_t, cres_t)."""
    planes, (ilist, kind, info, i4m, lres, cres) = IP.random_intra_frame(
        mb_w, mb_h, seed, **kw)
    t = [torch.from_numpy(a).to(dev) for a in (ilist, kind, info, i4m, lres,
                                                cres)]
    scal = IP.build_intra_scalars(*t[:4], mb_w, mb_h)
    return [torch.from_numpy(p).to(dev) for p in planes], scal, t[4], t[5]


@pytest.mark.cuda
@pytest.mark.parametrize("mb_w,mb_h,seed,kw", [
    (9, 6, 0, {"every_mode": True}),       # every mode, all intra
    (11, 7, 1, {"every_mode": True}),
    (13, 5, 2, {"p_intra": 0.8}),          # more intra MBs than warps
    (40, 2, 3, {"p_intra": 1.0}),          # the ring (64 slots) wraps
    (3, 150, 4, {"p_intra": 0.7})])        # 3x150 MBs
def test_intra_kernel_frames(mb_w, mb_h, seed, kw):
    """The warp-per-MB kernel against the plain raster scan."""
    dev = _card()
    planes, scal, lres_t, cres_t = _intra(dev, mb_w, mb_h, seed, **kw)
    want = IP.intra_scan_plain(*planes, scal, lres_t, cres_t, mb_w, mb_h)
    got = IP.intra_scan_pallas(*[p.clone() for p in planes], scal, lres_t,
                               cres_t, mb_w, mb_h)
    torch.cuda.synchronize()
    assert scal.shape[0] > 32 or kw.get("every_mode")
    for a, b, n in zip(got, want, "yuv"):
        _eq(a, b, f"intra {mb_w}x{mb_h} {n}")


@pytest.mark.cuda
def test_intra_kernel_repeats():
    """Calls in a row on one stream (each starts from fresh shared
    memory) give the same planes."""
    dev = _card()
    planes, scal, lres_t, cres_t = _intra(dev, 120, 4, 5, p_intra=0.5)
    outs = []
    for _ in range(3):
        outs.append(IP.intra_scan_pallas(*[p.clone() for p in planes], scal,
                                         lres_t, cres_t, 120, 4))
    torch.cuda.synchronize()
    for o in outs[1:]:
        for a, b, n in zip(o, outs[0], "yuv"):
            _eq(a, b, f"intra repeat {n}")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_deblock_kernel(seed):
    dev = _card()
    (y, u, v), _, e = _case(seed, dev)
    # smooth luma so the alpha/beta gates open
    gx = torch.arange(W, device=dev)[None, :].float()
    y = (128 + 40 * torch.sin(gx / 7.0) + (y.float() - 128) / 20) \
        .clamp(0, 255).to(torch.uint8).expand(H, W).contiguous()
    keys = ("idx", "vals", "mv", "ref", "qp", "kind")
    args = [e[k] for k in keys] + [MB_W, MB_H, 1, 2, -1]
    want = DR.deblock_frame(y, u, v, *args)
    got = DP.deblock_frame_pallas(y.clone(), u.clone(), v.clone(), *args)
    for a, b, n in zip(got, want, "yuv"):
        _eq(a, b, "deblock " + n)


def _deblock_frame(seed, dev, mb_w, mb_h):
    """deblock_pallas.random_p_frame (dense) of mb_w x mb_h MBs on `dev`
    -> (planes, the deblock's entropy arguments)."""
    planes, args = DP.random_p_frame(mb_w, mb_h, seed)
    return ([torch.from_numpy(p).to(dev) for p in planes],
            [torch.from_numpy(a).to(dev) for a in args])


@pytest.mark.cuda
@pytest.mark.parametrize("mb_w,mb_h,grid", [
    (7, 4, 1), (7, 4, 2), (7, 4, 3), (3, 150, None), (3, 150, 1),
    (3, 150, 2), (3, 150, 3)])
def test_deblock_kernel_grids(mb_w, mb_h, grid):
    """The persistent kernel with few blocks (each walks many MB rows)
    and at the wrapper's grid on a tall frame, against the plain
    version."""
    from librempeg_tpu_torch.kernels import deblock as KD

    dev = _card()
    planes, args = _deblock_frame(2, dev, mb_w, mb_h)
    want = DR.deblock_frame(*planes, *args, mb_w, mb_h, 1, 2, -1)
    P = DP.deblock_params(*args, mb_w, mb_h, 1, 2, -1)
    got = [p.clone() for p in planes]
    KD.launch(*got, P, mb_w, mb_h, grid)
    torch.cuda.synchronize()
    assert not torch.equal(want[0], planes[0]), "filter did nothing"
    for a, b, n in zip(got, want, "yuv"):
        _eq(a, b, f"deblock {mb_w}x{mb_h} grid {grid} {n}")


@pytest.mark.cuda
def test_deblock_kernel_taller_than_the_card():
    """More MB rows than blocks that fit on the card at once: the
    wrapper's grid (all blocks resident, each walking several rows)
    equals one block walking every row in order."""
    from librempeg_tpu_torch.kernels import deblock as KD

    dev = _card()
    mb_w, mb_h = 2, KD.coresident(dev) + 64
    planes, args = _deblock_frame(3, dev, mb_w, mb_h)
    P = DP.deblock_params(*args, mb_w, mb_h)
    one = [p.clone() for p in planes]
    KD.launch(*one, P, mb_w, mb_h, 1)
    full = [p.clone() for p in planes]
    KD.launch(*full, P, mb_w, mb_h)
    torch.cuda.synchronize()
    assert not torch.equal(one[0], planes[0]), "filter did nothing"
    for a, b, n in zip(full, one, "yuv"):
        _eq(a, b, f"deblock {mb_w}x{mb_h} {n}")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_hpel_kernel(seed):
    dev = _card()
    args = _hpel_case(seed, dev)
    for a, b, n in zip(MEP.hpel_refine_mc(*args),
                       MEP.hpel_refine_mc_plain(*args),
                       ("mv_h", "pred_y", "pred_u", "pred_v")):
        _eq(a, b, "hpel " + n)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_hpel_luma_and_chroma_kernels(seed):
    dev = _card()
    cur, ref, ru, rv, mv = _hpel_case(seed, dev)
    got = MEP.refine_mc_luma(cur, ref, mv)
    want = MEP.refine_mc_luma_plain(cur, ref, mv)
    for a, b, n in zip(got, want, ("mv_h", "pred_y")):
        _eq(a, b, "hpel luma " + n)
    for a, b, n in zip(MEP.mc_chroma(ru, rv, want[0], 1),
                       MEP.mc_chroma_plain(ru, rv, want[0], 1),
                       ("pred_u", "pred_v")):
        _eq(a, b, "hpel chroma " + n)


@pytest.mark.cuda
@pytest.mark.parametrize("rnd", [0, 1])
@pytest.mark.parametrize("h,w", [(96, 160), (64, 208), (48, 48)])
def test_hpel_luma_edges(h, w, rnd):
    """MVs up to 14 pixels, which push windows past every frame edge (the
    plain version's 16-pixel pad still holds them), on widths of 10, 13
    and 3 MBs (strips of 4 MBs: the last one 2 or 1 MBs long, or shorter
    than one strip)."""
    dev = _card()
    cur, ref, _, _, mv = _hpel_edge_case(h, w, rnd, dev)
    got = MEP.refine_mc_luma(cur, ref, mv, rnd)
    want = MEP.refine_mc_luma_plain(cur, ref, mv, rnd)
    for a, b, n in zip(got, want, ("mv_h", "pred_y")):
        _eq(a, b, f"hpel luma {h}x{w} rnd {rnd} {n}")


@pytest.mark.cuda
@pytest.mark.parametrize("rnd", [0, 1])
@pytest.mark.parametrize("h,w", [(96, 160), (64, 208), (48, 48), (720, 1280),
                                 (720, 1264)])
def test_hpel_fused_edges(h, w, rnd):
    """The fused kernel (all four outputs) with the luma edge cases' MVs:
    each chroma window (prefetched at the integer MV) then crosses the
    chroma planes' edges too; and at the encoder's size and 79 MBs
    wide."""
    dev = _card()
    args = _hpel_edge_case(h, w, rnd, dev)
    kernels.reset_counts()
    got = MEP.hpel_refine_mc(*args, rnd)
    assert kernels.counts()["hpel"] == 1
    want = MEP.hpel_refine_mc_plain(*args, rnd)
    for a, b, n in zip(got, want, ("mv_h", "pred_y", "pred_u", "pred_v")):
        _eq(a, b, f"hpel fused {h}x{w} rnd {rnd} {n}")


@pytest.mark.cuda
@pytest.mark.parametrize("rnd", [0, 1])
@pytest.mark.parametrize("h,w", [(96, 160), (64, 208), (48, 48), (720, 1280),
                                 (720, 1264)])
def test_hpel_chroma_edges(h, w, rnd):
    """The standalone chroma kernel at half-pel MVs up to 15 chroma
    half-pels (both chroma MV parities, past every chroma edge)."""
    dev = _card()
    _, _, ru, rv, mv = _hpel_edge_case(h, w, rnd, dev)
    rng = np.random.default_rng(h + w)
    mv_h = torch.from_numpy(rng.integers(-30, 31, mv.shape)
                            .astype(np.int32)).to(dev)
    mv_h[0, 0], mv_h[-1, -1] = torch.tensor([-30, -29]), \
        torch.tensor([30, 29])
    for a, b, n in zip(MEP.mc_chroma(ru, rv, mv_h, rnd),
                       MEP.mc_chroma_plain(ru, rv, mv_h, rnd),
                       ("pred_u", "pred_v")):
        _eq(a, b, f"hpel chroma {h}x{w} rnd {rnd} {n}")


@pytest.mark.cuda
@pytest.mark.parametrize("rnd", [0, 1])
def test_hpel_luma_flat_ties(rnd):
    """Flat planes: all 25 SADs of every MB tie, the first candidate
    (-2, -2) must win."""
    dev = _card()
    cur = torch.full((64, 96), 90.0, device=dev)
    ref = torch.full((64, 96), 90.5, device=dev)
    mv = torch.zeros((4, 6, 2), dtype=torch.int32, device=dev)
    mv[1, 2] = torch.tensor([3, -5])
    got = MEP.refine_mc_luma(cur, ref, mv, rnd)
    want = MEP.refine_mc_luma_plain(cur, ref, mv, rnd)
    for a, b, n in zip(got, want, ("mv_h", "pred_y")):
        _eq(a, b, f"hpel luma flat {n}")
    assert bool((got[0] == 2 * mv - 2).all())


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(720, 1280), (720, 1264)])
def test_hpel_luma_720p(h, w):
    """At the encoder's size (80 MBs a row, 20 whole strips) and 79 MBs
    wide (a ragged last strip)."""
    dev = _card()
    cur, ref, _, _, mv = _hpel_case(7, dev, h, w)
    for rnd in (0, 1):
        got = MEP.refine_mc_luma(cur, ref, mv, rnd)
        want = MEP.refine_mc_luma_plain(cur, ref, mv, rnd)
        for a, b, n in zip(got, want, ("mv_h", "pred_y")):
            _eq(a, b, f"hpel luma {h}x{w} rnd {rnd} {n}")


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 4, 8])
@pytest.mark.parametrize("integer", [True, False])
def test_fsearch_kernel(integer, r):
    """Bit-exact on integer inputs; on float inputs the float32 block
    sums run in another order, so MVs may differ on a near-tie and
    costs in the last bits. 3 frames of 7x5 MBs (each MB row one ragged
    strip of the kernel's 16-MB strips) and 2 frames of 10x6 MBs."""
    dev = _card()
    for n, h, w in ((3, 80, 112), (2, 96, 160)):
        cur, ref = _fsearch_case(3, dev, n, h, w, integer=integer)
        got = MS.full_search_mc(cur, ref, r)
        want = MS.full_search_mc_plain(cur, ref, r)
        if integer:
            for a, b, name in zip(got, want, ("mv", "cost", "pred")):
                _eq(a, b, f"fsearch {n}x{h}x{w} r={r} {name}")
            continue
        same = (got[0] == want[0]).all(-1)
        assert same.float().mean() >= 0.999
        rel = ((got[1] - want[1]).abs() / want[1].clamp(min=1))[same]
        assert float(rel.max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 4, 8])
def test_fsearch_kernel_ties(r):
    """Long runs of exactly tied candidates pin the first-minimum rule:
    a flat reference (every candidate of a block ties, so the MV is
    (-r, -r)) beside a textured one, over 2 strips of MBs (the second
    ragged)."""
    dev = _card()
    cur, ref = _fsearch_case(5, dev, 3, 64, 16 * 21)
    ref[:, :, :160] = 100.0
    ref[1] = 37.0
    got = MS.full_search_mc(cur, ref, r, tile_w=cur.shape[2])
    want = MS.full_search_mc_plain(cur, ref, r)
    for a, b, name in zip(got, want, ("mv", "cost", "pred")):
        _eq(a, b, f"fsearch ties r={r} {name}")
    assert bool((got[0][1] == -r).all())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_residual_kernel(seed):
    dev = _card()
    packed, nmb = _residual_case(seed, dev)
    _eq(RP.expand_residual(packed, None, nmb),
        RP.expand_residual_plain(packed, nmb), "residual")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("c,n", [(1, 1), (2, 4096), (6, 777), (40, 300)])
def test_shape_scan_kernel(k, c, n):
    """One thread per channel against the plain loop over samples, from
    a carried history; then a second call carries the first's."""
    dev = _card()
    x, noise, coefs, err0 = _shape_scan_case(c * 7 + k, k, c, n, dev)
    got = RD.shape_scan(x, noise, coefs, err0)
    want = RD.shape_scan_plain(x, noise, coefs, err0)
    torch.cuda.synchronize()
    _eq(got[0], want[0], f"shape_scan y k={k} c={c} n={n}")
    _eq(got[1], want[1], f"shape_scan hist k={k} c={c} n={n}")
    got2 = RD.shape_scan(x, noise, coefs, got[1])
    want2 = RD.shape_scan_plain(x, noise, coefs, want[1])
    _eq(got2[0], want2[0], "shape_scan y, second call")


def _eq_value(a, b, what):
    """Equal by value: -0.0 equals +0.0 and a NaN equals a NaN (the
    shaper kernel's fast rounding may give +0.0 where rint gives -0.0)."""
    a, b = a.cpu().numpy(), b.cpu().numpy()
    assert a.shape == b.shape, (what, a.shape, b.shape)
    bad = np.count_nonzero(~((a == b) | (np.isnan(a) & np.isnan(b))))
    assert bad == 0, f"{what}: {bad}/{a.size} values differ"


def _scan_check(x, noise, coefs, err0, what):
    """The kernel against the plain scan (on the CPU) by value, y and
    history -> the kernel's result."""
    got = RD.shape_scan(x, noise, coefs, err0)
    want = RD.shape_scan_plain(*(t.cpu() for t in (x, noise, coefs, err0)))
    torch.cuda.synchronize()
    _eq_value(got[0], want[0], f"shape_scan y, {what}")
    _eq_value(got[1], want[1], f"shape_scan hist, {what}")
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("c", [1, 2, 33])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 1120, 4096])
def test_shape_scan_kernel_lengths(n, c, k):
    """Whole chunks of 32 samples, a last partial one, a single sample;
    one warp and two; then a second call from the carried history."""
    dev = _card()
    x, noise, coefs, err0 = _shape_scan_case(n * 3 + c * 7 + k, k, c, n, dev)
    got = _scan_check(x, noise, coefs, err0, f"n={n} c={c} k={k}")
    _scan_check(x, noise, coefs, got[1], f"n={n} c={c} k={k}, second call")


def _scan_special(case, k, dev):
    """Inputs that take the range test's edges: (x, noise, coefs, err0)."""
    rng = np.random.default_rng(k)
    coefs = np.asarray(RD._SHAPER_COEFS[{5: "lipshitz", 3: "f_weighted"}[k]])
    err0 = np.zeros((k, 2))
    if case == "ties":
        # no feedback (zero taps) and no noise: every t is x, a tie at
        # +-(m + 0.5) for even and odd m, small and near 2^22
        m = np.concatenate([np.arange(-48, 48), 2 ** 22 - 1 - np.arange(32)])
        x = np.stack([m + 0.5, -(m + 0.5)])
        noise, coefs = np.zeros_like(x), np.zeros(k)
    elif case == "straddle":
        # a chunk whose samples cross 2^22 (-2^22 in channel 1), then
        # chunks back in range
        x = rng.normal(0, 9000, (2, 160))
        x[0, 32:64] = np.linspace(2 ** 22 - 40, 2 ** 22 + 40, 32)
        x[1, 64:96] = -np.linspace(2 ** 22 - 3, 2 ** 22 + 3, 32)
        noise = rng.random((2, 160)) - rng.random((2, 160))
    elif case == "s32":
        x = rng.uniform(-2.0 ** 31, 2.0 ** 31, (2, 300))
        noise = rng.random((2, 300)) - rng.random((2, 300))
    elif case == "mixed_lanes":
        # lane 0 in range (s16), lane 1 not (s32)
        x = np.stack([rng.normal(0, 9000, 300),
                      rng.uniform(-2.0 ** 31, 2.0 ** 31, 300)])
        noise = rng.random((2, 300)) - rng.random((2, 300))
    else:
        # NaN and +-Inf in x (lane 0 from sample 40 on, lane 1 at one
        # sample), in the noise, and in the history
        x = rng.normal(0, 9000, (2, 200))
        x[0, 40], x[1, 70], x[1, 150] = np.nan, np.inf, -np.inf
        noise = rng.random((2, 200)) - rng.random((2, 200))
        if case == "nan_noise":
            noise[1, 100] = np.nan
        if case == "nan_history":
            err0[1, 1] = np.nan

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    return t(x), t(noise), t(coefs), t(err0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("case", ["ties", "straddle", "s32", "mixed_lanes",
                                  "nan_inf", "nan_noise", "nan_history"])
def test_shape_scan_kernel_range_edges(case, k):
    """The fast rounding's range test at its edges, by value against the
    plain scan, then a second call from the carried history."""
    dev = _card()
    x, noise, coefs, err0 = _scan_special(case, k, dev)
    got = _scan_check(x, noise, coefs, err0, f"{case} k={k}")
    _scan_check(x, noise, coefs, got[1], f"{case} k={k}, second call")


def _residual_rows(ids, seed, nmb, pad=0):
    """Packed rows for the given ascending ids (random levels) plus `pad`
    pad rows, on the card."""
    rng = np.random.default_rng(seed)
    ids = np.asarray(ids, np.int32)
    levels = rng.integers(-3000, 3001, (ids.size, 16)).astype(np.int16)
    return torch.from_numpy(RP.pack_rows(ids, levels, ids.size + pad)).cuda()


def _residual_check(packed, nmb, what):
    """The kernel against the plain version, into memory that held NaN
    (each float of the output must be written)."""
    junk = torch.full((RP.out_rows(nmb), 384), float("nan"), device="cuda")
    del junk
    _eq(RP.expand_residual(packed, None, nmb),
        RP.expand_residual_plain(packed, nmb), f"residual {what}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k0", "one_row", "first_last_mb",
                                  "pad_ids", "nmb7", "pad_only"])
def test_residual_kernel_cases(case):
    _card()
    nmb = 130                   # not a multiple of 120
    if case == "k0":
        packed = torch.zeros((0, 24), dtype=torch.int16, device="cuda")
    elif case == "one_row":
        packed, nmb = _residual_rows([17], 1, 3), 3
    elif case == "first_last_mb":
        packed = _residual_rows(np.r_[0:24, (nmb - 1) * 24:nmb * 24], 2, nmb)
    elif case == "pad_ids":
        # ids of nmb*24 and beyond (below PAD_ID) and PAD_ID rows, last
        ids = np.r_[np.sort(np.random.default_rng(3).choice(
            nmb * 24, 700, replace=False)), nmb * 24, nmb * 24 + 5]
        packed = _residual_rows(ids, 3, nmb, pad=9)
    elif case == "nmb7":
        packed, nmb = _residual_rows(np.arange(0, 7 * 24, 3), 4, 7, pad=2), 7
    else:
        packed = _residual_rows([], 5, nmb, pad=11)
    _residual_check(packed, nmb, case)


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.02, 0.25, 0.9])
def test_residual_kernel_1080p_subsets(density):
    """Random ascending subsets of the blocks of a 120x68-MB frame."""
    _card()
    nmb = 120 * 68
    ids = np.flatnonzero(np.random.default_rng(6).random(nmb * 24) < density)
    _residual_check(_residual_rows(ids, 6, nmb, pad=5), nmb,
                    f"120x68 density {density}")


@pytest.mark.cuda
def test_residual_kernel_refuses_misaligned_rows():
    """The kernel loads each row as three 16-byte words."""
    _card()
    flat = torch.zeros(10 * 24 + 1, dtype=torch.int16, device="cuda")
    with pytest.raises(ValueError, match="aligned"):
        RP.expand_residual(flat[1:].view(10, 24), None, 5)


def _jpeg_planes(w, h, seed):
    """Seeded yuvj420p planes: a smooth pattern plus noise."""
    rng = np.random.default_rng(seed)
    out = []
    for ph, pw in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        gy, gx = np.mgrid[0:ph, 0:pw]
        base = 128 + 60 * np.sin(gx / 7.0) * np.cos(gy / 5.0)
        out.append(torch.from_numpy(np.clip(
            base + rng.normal(0, 8, (ph, pw)), 0, 255).astype(np.uint8)))
    return tuple(out)


@pytest.mark.cuda
@pytest.mark.parametrize("w,h,quality", [(38, 30, 75), (1920, 1088, 91),
                                         (1920, 1088, 4)])
def test_jpeg_decode_on_cuda_equals_the_cpu(w, h, quality):
    """The JPEG decoder's dequant, integer IDCT and placement on the
    card: bit-exact with the plain path on the CPU."""
    from librempeg_tpu_torch.codecs.jpeg.decoder import decode_jpeg
    from librempeg_tpu_torch.codecs.jpeg.encoder import encode_jpeg
    from librempeg_tpu_torch.core.frame import VideoFrame

    dev = _card()
    f = VideoFrame(planes=_jpeg_planes(w, h, 0), format="yuvj420p",
                   width=w, height=h)
    jpg = encode_jpeg(f, quality=quality, device=dev)
    a = decode_jpeg(jpg, device="cpu")
    b = decode_jpeg(jpg, device=dev)
    for x, y in zip(a.planes, b.planes):
        assert y.is_cuda and torch.equal(x, y.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["psnr", "ssim"])
def test_metric_on_cuda_equals_the_cpu(metric):
    """psnr within 1e-3 dB (mse within 1e-5 relative), ssim within 1e-5,
    of the same two-input graph on the CPU, at 1920x1088."""
    from librempeg_tpu_torch.core.frame import VideoFrame
    from librempeg_tpu_torch.core.rational import Rational
    from librempeg_tpu_torch.filters import GraphRunner, StreamProps

    dev = _card()
    props = StreamProps(media="video", width=1920, height=1088,
                        pix_fmt="yuv420p", frame_rate=Rational(25, 1),
                        time_base=Rational(1, 25))
    stats = {}
    for d in ("cpu", dev):
        g = GraphRunner(f"[in][in2]{metric}", [props, props])
        for i in range(3):
            main, ref = (VideoFrame(
                planes=tuple(p.to(d) for p in _jpeg_planes(1920, 1088, s)),
                format="yuv420p", width=1920, height=1088, pts=i,
                time_base=Rational(1, 25)) for s in (i, 100 + i))
            g.push(ref, 1)
            g.push(main, 0)
        stats[d] = next(n.filter.stats for n in g.graph.nodes
                        if n.filter.NAME == metric)
    for a, b in zip(stats["cpu"], stats[dev]):
        for k in a:
            tol = (1e-5 * a[k] if k.startswith("mse") else
                   1e-3 if k.startswith("psnr") else 1e-5)
            assert abs(a[k] - b[k]) <= tol, (k, a[k], b[k])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lowpass", "highpass", "equalizer",
                                  "bass", "allpass"])
@pytest.mark.parametrize("c,n", [(1, 1), (2, 1023), (2, 127), (6, 5000),
                                 (9, 300), (2, 0)])
def test_biquad_kernel(kind, c, n):
    """A run of one stage: equal by value to the plain recurrence over
    one call and over two calls carrying the state (1-9 channels, so one
    and two blocks; lengths off the kernel's block and handover
    sizes)."""
    dev = _card()
    x, b, a, z = _biquad_case(11, c, n, dev, kind)
    coefs = [(*b, *a)]
    y, zk = KB.launch(x, coefs, z[None], "flt")
    yp, zp = KB.biquad_plain(x, b, a, z)
    _eq(y, yp, f"biquad {kind} {c}x{n} y")
    _eq(zk[0], zp, f"biquad {kind} {c}x{n} z")
    h = n // 3
    y1, z1 = KB.launch(x[:, :h].contiguous(), coefs, z[None], "flt")
    y2, z2 = KB.launch(x[:, h:].contiguous(), coefs, z1, "flt")
    _eq(torch.cat([y1, y2], 1), yp, f"biquad {kind} {c}x{n} in two calls")
    _eq(z2[0], zp, f"biquad {kind} {c}x{n} state after two calls")


_BIQUAD_KINDS = ("highpass", "lowpass", "equalizer", "bass", "allpass",
                 "treble", "bandpass", "bandreject")


def _cascade_case(seed, s, c, n, dev, fmt):
    """A run's inputs: s stages of mixed kinds, frequencies and gains
    (boosts that drive the integer formats past full scale), samples on
    the format's grid, carried states."""
    rng = np.random.default_rng(seed)
    coefs = []
    for i in range(s):
        b, a = BQ._rbj(_BIQUAD_KINDS[(seed + i) % len(_BIQUAD_KINDS)],
                       float(rng.uniform(60, 12000)), 44100, 0.707,
                       float(rng.uniform(-6, 9)))
        coefs.append(tuple(np.float32(v / a[0]) for v in b)
                     + (np.float32(a[1] / a[0]), np.float32(a[2] / a[0])))
    x = torch.from_numpy(np.clip(rng.normal(0, 0.4, (c, n)), -1, 1)
                         .astype(np.float32))
    if fmt != "fltp":
        x = to_float(from_float(x, fmt), fmt)
    z = rng.uniform(-0.05, 0.05, (s, c, 2)).astype(np.float32)
    return x.to(dev), coefs, torch.from_numpy(z).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("c", [1, 2, 6, 9])
@pytest.mark.parametrize("n", [0, 1, 127, 1023, 5000])
def test_biquad_cascade_kernel(s, c, n):
    """A run of s stages in one launch equal by value to
    biquad_cascade_plain, in one call and in two calls carrying the
    states (one or more blocks of channels; lengths off the kernel's
    lag, block and handover sizes; the sample format varies with the
    case)."""
    dev = _card()
    fmt = ("s16p", "fltp", "u8", "s32p")[(s + c + n) % 4]
    x, coefs, z = _cascade_case(100 * s + 10 * c + n % 7, s, c, n, dev, fmt)
    kernels.reset_counts()
    y, zk = KB.launch(x, coefs, z, fmt)
    assert kernels.counts()["biquad"] == 1
    yp, zp = KB.biquad_cascade_plain(x, coefs, z, fmt)
    what = f"biquad run of {s}, {c}x{n} {fmt}"
    _eq(y, yp, f"{what} y")
    _eq(zk, zp, f"{what} z")
    h = n // 3
    y1, z1 = KB.launch(x[:, :h].contiguous(), coefs, z, fmt)
    y2, z2 = KB.launch(x[:, h:].contiguous(), coefs, z1, fmt)
    _eq(torch.cat([y1, y2], 1), yp, f"{what} in two calls")
    _eq(z2, zp, f"{what} states after two calls")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["u8", "s16p", "s32", "fltp", "dbl"])
@pytest.mark.parametrize("s", [4, 40])
def test_biquad_cascade_kernel_formats(fmt, s):
    """Every sample format's round trip between stages, and a run longer
    than one launch takes (split into launches of the same kernel)."""
    dev = _card()
    x, coefs, z = _cascade_case(s, s, 3, 1500, dev, fmt)
    kernels.reset_counts()
    y, zk = KB.launch(x, coefs, z, fmt)
    assert kernels.counts()["biquad"] == -(-s // KB.SMAX)
    yp, zp = KB.biquad_cascade_plain(x, coefs, z, fmt)
    _eq(y, yp, f"biquad run of {s} {fmt} y")
    _eq(zk, zp, f"biquad run of {s} {fmt} z")


@pytest.mark.cuda
@pytest.mark.parametrize("q", [3, 5, 7])
def test_mpeg4_quantisers_match_the_cpu(q):
    """The MPEG-4 quantisers divide once on the card, as on the CPU and
    in the JAX package: on the spec DCT coefficients of the bench
    asset's first two frames scaled to 1280x720, computed once on the
    CPU and copied to the card, the intra DC and AC levels, the inter
    levels and the trellis's first levels equal the CPU's."""
    dev = _card()
    from librempeg_tpu_torch.codecs.h264.codec import H264Decoder
    from librempeg_tpu_torch.codecs.mpeg4 import encoder as ME
    from librempeg_tpu_torch.codecs.mpeg4 import tables as MT
    from librempeg_tpu_torch.codecs.mpeg4 import trellis as MTR
    from librempeg_tpu_torch.formats.api import open_input
    from librempeg_tpu_torch.ops import dct8x8
    from librempeg_tpu_torch.scale import get_scaler

    demux = open_input(os.path.join(os.path.dirname(os.path.dirname(CSRC)),
                                    "assets", "bench_1080p.264"))
    dec = H264Decoder(demux.streams[0].codecpar, device=dev, prefetch=0)
    frames = []
    for pkt in demux.packets():
        frames += dec.decode(pkt)
        if len(frames) >= 2:
            break
    frames += dec.flush()
    demux.close()
    sc = get_scaler("yuv420p", frames[0].width, frames[0].height, "yuv420p",
                    1280, 720)
    planes = [[p.to(torch.float32) for p in sc.scale_planes(
        tuple(p.cpu() for p in f.planes), device="cpu")] for f in frames[:2]]
    intra = torch.cat([ME._fdct_spec(dct8x8.to_blocks(p))
                       for p in planes[0]])
    inter = torch.cat([ME._fdct_spec(dct8x8.to_blocks(a - b))
                       for a, b in zip(planes[1], planes[0])])
    got = {}
    for d in ("cpu", dev):
        ci, cn = intra.to(d), inter.to(d)
        dc, ac, _ = ME._quant_intra(ci, q, MT.dc_scaler(q, False))
        lv, _ = ME._quant_inter(cn, q)
        got[d] = (dc, ac, lv, MTR._base_levels(ci.abs(), q))
    for name, a, b in zip(("intra DC", "intra AC", "inter", "trellis l0"),
                          got["cpu"], got[dev]):
        _eq(b, a, f"qscale {q} {name} levels")


@pytest.mark.cuda
@pytest.mark.parametrize("r", [8, 9, 12, 16])
def test_fsearch_kernel_minterpolate_shape(r):
    """minterpolate's search on 1088x1920 integer luma planes (a
    drifting pattern) through mesearch.full_search_mc with the frame as
    one tile, as minterpolate calls it, equal to the
    plain search; r = 8 and the instances past 8 (8-MB strips)."""
    dev = _card()
    gy, gx = np.mgrid[0:1088, 0:1920]
    rng = np.random.default_rng(r)
    base = 128 + 70 * np.sin(gx / 23.0) * np.cos(gy / 17.0)
    ref = np.clip(base + rng.normal(0, 9, base.shape), 0, 255).round()
    cur = np.roll(ref, (3, -r + 1), (0, 1))
    ref_t, cur_t = (torch.from_numpy(a.astype(np.float32))[None].to(dev)
                    for a in (ref, cur))
    got = MS.full_search_mc(cur_t, ref_t, r, 1088, 1920)
    want = motion.full_search_mc_xla(cur_t, ref_t, r, 16, 1)
    for a, b, name in zip(got, want, ("mv", "cost", "pred")):
        _eq(a, b, f"fsearch 1088x1920 r={r} {name}")
