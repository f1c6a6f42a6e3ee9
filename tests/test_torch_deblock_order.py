"""Schedules of the plain H.264 deblock (device_recon.deblock_frame).

The deblock kernel (csrc/deblock.cu) does not run the MB diagonals of
the plain version: each thread block walks whole MB rows, runs an MB's
vertical edges, then its horizontal ones, and lets the horizontal edges
of MB x in row y wait until row y-1 has run the vertical edges of MB
x+1 (the row's end at its last MB). These tests run the plain version
in such schedules, given as data, on the CPU: every schedule the
kernel's wait allows gives the planes of the diagonal order bit for
bit, and a schedule that drops the top-right part of the wait does
not. Inputs are made with numpy from a seed.
"""
import numpy as np
import pytest
import torch

from librempeg_tpu_torch.codecs.h264 import deblock_pallas as DP
from librempeg_tpu_torch.codecs.h264 import device_recon as DR

MB_W, MB_H = 6, 5
NMB = MB_W * MB_H


def _frame(seed=0):
    """A random P frame whose filters' gates open (the dense
    deblock_pallas.random_p_frame)."""
    planes, args = DP.random_p_frame(MB_W, MB_H, seed)
    return ([torch.from_numpy(p) for p in planes],
            [torch.from_numpy(a) for a in args])


def _deblock(order):
    planes, args = _frame()
    return DR.deblock_frame(*planes, *args, MB_W, MB_H, 0, 0, 0,
                            order=order)


def kernel_order(rng, max_group: int):
    """A schedule the kernel's wait allows. Row y's steps are V(0),
    H(0), V(1), H(1), ...; H(x) of row y > 0 runs once row y-1 has done
    V(x+1), or its whole row when x is the last MB. Each group takes a
    random set of rows whose next step is ready and of one pass, as
    thread blocks that happen to run at once."""
    done = [0] * MB_H                   # steps done per row
    order = []
    while min(done) < 2 * MB_W:
        ready = {"v": [], "h": []}
        for row in range(MB_H):
            k = done[row]
            if k == 2 * MB_W:
                continue
            x = k // 2
            if k % 2 and row > 0 and done[row - 1] < min(2 * x + 3,
                                                         2 * MB_W):
                continue
            ready["vh"[k % 2]].append(row)
        pas = rng.choice([p for p in "vh" if ready[p]])
        rows = rng.permutation(ready[pas])[:rng.integers(1, max_group + 1)]
        order.append((pas, [int(r) * MB_W + done[r] // 2 for r in rows]))
        for r in rows:
            done[r] += 1
    return order


def _single(mbs):
    return [(p, [m]) for m in mbs for p in "vh"]


def _same(a, b):
    return all(torch.equal(p, q) for p, q in zip(a, b))


def test_wavefront_order_covers_each_pass_once():
    order = DR.wavefront_order(MB_W, MB_H)
    assert len(order) == 2 * (MB_W + 2 * MB_H - 2)
    for p in "vh":
        mbs = sorted(m for q, g in order if q == p for m in g)
        assert mbs == list(range(NMB))


@pytest.mark.parametrize("seed,max_group", [(0, 1), (1, 1), (2, 3), (3, 3),
                                            (4, MB_H)])
def test_kernel_schedules_equal_the_diagonals(seed, max_group):
    """The kernel's wait is sufficient: any schedule it allows gives the
    planes of the diagonal order."""
    order = kernel_order(np.random.default_rng(seed), max_group)
    assert sorted(m for p, g in order if p == "h" for m in g) \
        == list(range(NMB))
    want = _deblock(None)
    assert not torch.equal(want[0], _frame()[0][0]), "filter did nothing"
    assert _same(_deblock(order), want)


def test_raster_order_equals_the_diagonals():
    """The spec's own order, one MB per group."""
    assert _same(_deblock(_single(range(NMB))), _deblock(None))


def test_schedule_without_the_top_right_wait_differs():
    """The wait's top-right part is necessary: run the MBs on the
    diagonals t = mx + my, bottom row first, so MB (x, y) filters before
    MB (x+1, y-1), whose left edge changes pixels above MB (x, y). Left
    and top neighbours still come first."""
    mbs = [my * MB_W + t - my for t in range(MB_W + MB_H - 1)
           for my in reversed(range(MB_H)) if 0 <= t - my < MB_W]
    assert sorted(mbs) == list(range(NMB))
    got, want = _deblock(_single(mbs)), _deblock(None)
    assert not torch.equal(got[0], want[0])
