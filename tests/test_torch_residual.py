"""The port's H.264 residual expansion (codecs.h264.residual_pallas)
against the JAX package's on the CPU: the host packer's outputs equal
the JAX package's, and expand_residual (its plain version here) equals
the JAX kernel in Pallas interpret mode and device_recon._residuals
bit for bit. Inputs come from the JAX package's own test generator.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from librempeg_tpu.codecs.h264 import residual_pallas as JRP
from librempeg_tpu_torch import kernels
from librempeg_tpu_torch.codecs.h264 import device_recon as TDR
from librempeg_tpu_torch.codecs.h264 import residual_pallas as TRP
from test_h264_residual_pallas import _random_coeffs


def _case(seed, mb_w, mb_h, qp_lo, qp_hi, density=0.008, cqo=0, kind=None):
    rng = np.random.default_rng(seed)
    nmb = mb_w * mb_h
    qp = rng.integers(qp_lo, qp_hi, nmb).astype(np.int32)
    co = _random_coeffs(rng, nmb, qp, density=density, chroma_qp_off=cqo)
    if kind is None:
        kind = rng.integers(0, 4, nmb).astype(np.int32)
    return co, qp, kind


def _reference(co, qp, kind, cqo):
    """device_recon._residuals in expand_residual's layout."""
    lres, cres = TDR._residuals(torch.from_numpy(co), torch.from_numpy(qp),
                                cqo, len(qp),
                                is_i16=torch.from_numpy(kind) == 3)
    return TRP.spatial_from_residuals(lres, cres).numpy()


@pytest.mark.parametrize("mb_w,mb_h,qp_lo,qp_hi,cqo,all_i16", [
    (30, 5, 0, 20, 0, False),       # 150 MBs: crosses a stripe boundary
    (30, 5, 20, 40, 0, False),
    (30, 5, 40, 52, 0, False),
    (8, 4, 10, 45, 4, True),        # chroma QP offset, all Intra_16x16
])
def test_expand_residual_matches_jax(mb_w, mb_h, qp_lo, qp_hi, cqo,
                                     all_i16):
    nmb = mb_w * mb_h
    kind = np.full(nmb, 3, np.int32) if all_i16 else None
    co, qp, kind = _case(qp_lo + cqo, mb_w, mb_h, qp_lo, qp_hi,
                         density=0.01 if all_i16 else 0.008, cqo=cqo,
                         kind=kind)
    jpk, joff, jok = JRP.pack_residual_host(co, qp, kind, cqo, mb_w, mb_h)
    tpk, toff, tok = TRP.pack_residual_host(co, qp, kind, cqo, mb_w, mb_h)
    assert jok and tok
    assert np.array_equal(jpk, tpk) and np.array_equal(joff, toff)
    want = np.asarray(JRP.expand_residual(jnp.asarray(jpk),
                                          jnp.asarray(joff), nmb))
    kernels.reset_counts()
    got = TRP.expand_residual(torch.from_numpy(tpk), torch.from_numpy(toff),
                              nmb)
    assert kernels.counts()["residual"] == 0
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy()[:nmb].astype(np.int64),
                          _reference(co, qp, kind, cqo))


def test_pack_residual_host_window_overflow():
    """Every block coded: a stripe overflows the TPU kernel's window, in
    both packages; the windowless rows still expand exactly."""
    mb_w, mb_h = 120, 2
    co, qp, kind = _case(7, mb_w, mb_h, 26, 27, density=0.9,
                         kind=np.zeros(240, np.int32))
    # keep the 2x2 chroma DC sums within the int16 rows, as a stream
    # does (8.5.12.1)
    co[:, 17:19] = np.clip(co[:, 17:19], -8, 8)
    assert JRP.pack_residual_host(co, qp, kind, 0, mb_w, mb_h)[2] is False
    assert TRP.pack_residual_host(co, qp, kind, 0, mb_w, mb_h) == \
        (None, None, False)
    ids, levels = TRP.compact_rows(co, qp, kind, 0, mb_w, mb_h)
    assert np.all(np.diff(ids) > 0)
    got = TRP.expand_residual(torch.from_numpy(TRP.pack_rows(ids, levels)),
                              None, mb_w * mb_h)
    assert np.array_equal(got.numpy().astype(np.int64),
                          _reference(co, qp, kind, 0))


def test_pad_rows_and_partial_stripes():
    """Pad rows (ids >= nmb*24) add nothing; a partial last stripe is
    zero past nmb."""
    mb_w, mb_h = 7, 3
    nmb = mb_w * mb_h
    co, qp, kind = _case(9, mb_w, mb_h, 10, 40, density=0.05)
    ids, levels = TRP.compact_rows(co, qp, kind, 0, mb_w, mb_h)
    packed = TRP.pack_rows(ids, levels, len(ids) + 5)
    got = TRP.expand_residual(torch.from_numpy(packed), None, nmb).numpy()
    assert got.shape == (TRP.out_rows(nmb), 384) == (120, 384)
    assert not got[nmb:].any()
    assert np.array_equal(got[:nmb].astype(np.int64),
                          _reference(co, qp, kind, 0))
