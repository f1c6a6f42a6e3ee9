"""The input contract of the residual kernel (csrc/residual.cu), on the
CPU: a block finds its rows by a search of the ids, so the packers must
emit ascending ids with the pad rows at the tail, in both packages; and
the plain version, which the kernel is held to, writes zeros wherever no
row lands (no rows, pad rows only, the rows past nmb).
"""
import numpy as np
import pytest
import torch

from librempeg_tpu.codecs.h264 import residual_pallas as JRP
from librempeg_tpu_torch.codecs.h264 import residual_pallas as TRP
from test_h264_residual_pallas import _random_coeffs


def _case(seed, mb_w, mb_h, density):
    rng = np.random.default_rng(seed)
    nmb = mb_w * mb_h
    qp = rng.integers(10, 45, nmb).astype(np.int32)
    co = _random_coeffs(rng, nmb, qp, density=density)
    kind = rng.integers(0, 4, nmb).astype(np.int32)
    return co, qp, kind


def _ids(packed):
    p = np.asarray(packed).astype(np.int64)
    return p[:, 16] + 32768 * p[:, 17]


def _ascending_pad_tail(ids, nmb):
    real = ids < nmb * 24
    k = int(real.sum())
    assert real[:k].all() and not real[k:].any(), "pad rows not at the tail"
    assert np.all(np.diff(ids[:k]) > 0), "ids do not ascend"
    assert np.all(ids[k:] >= nmb * 24)


@pytest.mark.parametrize("mb_w,mb_h,density", [
    (30, 5, 0.008), (7, 3, 0.05), (120, 2, 0.02)])
def test_packers_emit_ascending_ids_pad_last(mb_w, mb_h, density):
    nmb = mb_w * mb_h
    co, qp, kind = _case(mb_w + mb_h, mb_w, mb_h, density)
    ids, levels = TRP.compact_rows(co, qp, kind, 0, mb_w, mb_h)
    _ascending_pad_tail(_ids(TRP.pack_rows(ids, levels, len(ids) + 7)), nmb)
    for rp in (TRP, JRP):
        packed, _, ok = rp.pack_residual_host(co, qp, kind, 0, mb_w, mb_h)
        if ok:
            _ascending_pad_tail(_ids(packed), nmb)


@pytest.mark.parametrize("rows", ["none", "pad_only"])
def test_plain_zeros_without_rows(rows):
    nmb = 130
    packed = np.zeros((0, 24), np.int16) if rows == "none" else \
        TRP.pack_rows(np.zeros(0, np.int32), np.zeros((0, 16), np.int16), 9)
    out = TRP.expand_residual_plain(torch.from_numpy(packed), nmb)
    assert out.shape == (TRP.out_rows(nmb), 384) == (240, 384)
    assert out.dtype == torch.float32 and not out.any()


def test_plain_zeros_past_nmb():
    """Every block of every MB coded: the rows [nmb, out_rows(nmb)) stay
    zero, the rows below do not."""
    mb_w, mb_h = 13, 5
    nmb = mb_w * mb_h
    rng = np.random.default_rng(3)
    ids = np.arange(nmb * 24, dtype=np.int32)
    levels = rng.integers(-3000, 3001, (ids.size, 16)).astype(np.int16)
    packed = torch.from_numpy(TRP.pack_rows(ids, levels, ids.size + 4))
    out = TRP.expand_residual_plain(packed, nmb)
    assert out.shape == (120, 384)
    assert not out[nmb:].any()
    assert bool(out[:nmb].abs().sum(1).gt(0).all())
