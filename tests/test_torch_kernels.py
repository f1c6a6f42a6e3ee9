"""The port's four CUDA kernels against their plain PyTorch versions.

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

import numpy as np
import pytest
import torch

from librempeg_tpu_torch import kernels
from librempeg_tpu_torch.codecs.h264 import deblock_pallas as DP
from librempeg_tpu_torch.codecs.h264 import device_recon as DR
from librempeg_tpu_torch.codecs.h264 import intra_pallas as IP
from librempeg_tpu_torch.codecs.h264 import mc_pallas as MC
from librempeg_tpu_torch.codecs.mpeg4 import me_pallas as MEP

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
    assert kernels.counts() == {"mc": 0, "deblock": 0, "intra": 0,
                                "hpel": 0}


@pytest.mark.parametrize("name,replaces", [
    ("mc.cu", "mc_pallas.py"), ("deblock.cu", "deblock_pallas.py"),
    ("intra.cu", "intra_pallas.py"), ("hpel.cu", "me_pallas.py")])
def test_kernel_sources_carry_their_notes(name, replaces):
    """Each source names the Pallas kernel it replaces and what bounds
    it on the card."""
    src = open(os.path.join(CSRC, name)).read()
    assert replaces in src and "Bound on the H100" in src
    assert 'extern "C" int' in src and "cudaGetLastError" in src


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


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_hpel_kernel(seed):
    dev = _card()
    args = _hpel_case(seed, dev)
    for a, b, n in zip(MEP.hpel_refine_mc(*args),
                       MEP.hpel_refine_mc_plain(*args),
                       ("mv_h", "pred_y", "pred_u", "pred_v")):
        _eq(a, b, "hpel " + n)
