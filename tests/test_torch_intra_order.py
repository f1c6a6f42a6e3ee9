"""Schedules of the plain H.264 intra scan (device_recon._intra_scan).

The intra kernel (csrc/intra.cu) does not rebuild the listed MBs in
raster order: one warp takes each MB and waits only for those of its
left, top-left, top and top-right neighbours (top-right when it lies in
the frame) that are intra, so MBs whose waits are met run at the same
time. These tests run the plain version in such schedules, given as
data, on the CPU: every schedule the kernel's wait allows (MBs of one
group read the planes as they stood before the group) gives the planes
of the raster order bit for bit, and a schedule that drops the top-right
or the top-left part of the wait does not. Inputs are made with numpy
from a seed.
"""
import numpy as np
import pytest
import torch

from librempeg_tpu_torch.codecs.h264 import intra_pallas as IP


def _frame(mb_w, mb_h, seed, **kw):
    """intra_pallas.random_intra_frame on the CPU -> (planes, scal,
    lres_t, cres_t, the listed MBs)."""
    planes, args = IP.random_intra_frame(mb_w, mb_h, seed, **kw)
    return _tensors(planes, args, mb_w, mb_h)


def _tensors(planes, args, mb_w, mb_h):
    ilist, kind, info, i4m, lres, cres = (torch.from_numpy(a) for a in args)
    scal = IP.build_intra_scalars(ilist, kind, info, i4m, mb_w, mb_h)
    return ([torch.from_numpy(p) for p in planes], scal, lres, cres,
            ilist.tolist())


def _scan(case, mb_w, mb_h, order=None):
    planes, scal, lres, cres, _ = case
    return IP.intra_scan_plain(*planes, scal, lres, cres, mb_w, mb_h,
                               order=order)


def waits(m, mb_w, drop=()):
    """The MBs the kernel lets MB m wait for: L, TL, T and TR (in the
    frame), less the parts named in `drop`."""
    my, mx = divmod(m, mb_w)
    out = {}
    if mx > 0:
        out["L"] = m - 1
    if my > 0:
        if mx > 0:
            out["TL"] = m - mb_w - 1
        out["T"] = m - mb_w
        if mx + 1 < mb_w:
            out["TR"] = m - mb_w + 1
    return [n for k, n in out.items() if k not in drop]


def kernel_order(mbs, mb_w, rng, max_group, drop=()):
    """A schedule the wait allows: each group takes a random set of the
    MBs whose intra neighbours are all done, as warps that happen to run
    at once (max_group None: every such MB)."""
    intra, done, order = set(mbs), set(), []
    while len(done) < len(mbs):
        ready = [m for m in mbs if m not in done
                 and all(n in done for n in waits(m, mb_w, drop)
                         if n in intra)]
        k = len(ready) if max_group is None else \
            int(rng.integers(1, max_group + 1))
        group = [int(m) for m in rng.permutation(ready)[:k]]
        order.append(group)
        done.update(group)
    return order


def allowed(order, mbs, mb_w, drop=()):
    """Whether the wait (less `drop`) allows the schedule: each MB's
    intra neighbours ran in earlier groups."""
    intra, done = set(mbs), set()
    for group in order:
        if any(n in intra and n not in done
               for m in group for n in waits(m, mb_w, drop)):
            return False
        done.update(group)
    return True


def _same(a, b):
    return all(torch.equal(p, q) for p, q in zip(a, b))


CASES = [(6, 5, 0, {"every_mode": True}), (8, 5, 1, {"p_intra": 0.6}),
         (5, 7, 2, {"every_mode": True}), (9, 4, 3, {"p_intra": 1.0})]


@pytest.mark.parametrize("mb_w,mb_h,seed,kw", CASES)
@pytest.mark.parametrize("max_group", [1, 3, None])
def test_kernel_schedules_equal_raster(mb_w, mb_h, seed, kw, max_group):
    """The wait is sufficient: any schedule it allows gives the planes of
    the raster order."""
    case = _frame(mb_w, mb_h, seed, **kw)
    mbs = case[4]
    order = kernel_order(mbs, mb_w, np.random.default_rng(seed + 10),
                         max_group)
    assert sorted(m for g in order for m in g) == mbs
    assert allowed(order, mbs, mb_w)
    want = _scan(case, mb_w, mb_h)
    assert not torch.equal(want[0], case[0][0]), "nothing rebuilt"
    assert _same(_scan(case, mb_w, mb_h, order), want)


@pytest.mark.parametrize("mb_w,mb_h,seed,kw", CASES)
def test_dependent_steps_count_the_levels(mb_w, mb_h, seed, kw):
    """intra_pallas.dependent_steps (chip_smoke's step count) is the
    number of groups when every ready MB runs at once."""
    mbs = _frame(mb_w, mb_h, seed, **kw)[4]
    order = kernel_order(mbs, mb_w, np.random.default_rng(0), None)
    assert IP.dependent_steps(mbs, mb_w) == len(order)


def _pair(mb_w, mb_h, a, b, kind_b, info_b=0, mode5=0):
    """A frame whose only intra MBs are a (I16x16, DC) and b."""
    planes, (_, kind, info, i4m, lres, cres) = IP.random_intra_frame(
        mb_w, mb_h, 7, p_intra=0.0)
    kind[:] = 0
    kind[a], kind[b] = 3, kind_b
    info[a], info[b] = 2 | (0 << 4), info_b
    i4m[b] = 2
    i4m[b, 3] = mode5              # raster (0, 3): decode-order block 5
    ilist = np.array(sorted([a, b]), np.int32)
    return _tensors(planes, (ilist, kind, info, i4m, lres, cres), mb_w,
                    mb_h)


@pytest.mark.parametrize("mode5", [3, 7])
def test_schedule_without_the_top_right_wait_differs(mode5):
    """The wait's top-right part is necessary: an I4x4 MB b whose block 5
    predicts diagonally down-left (3) or vertical-left (7) reads the
    bottom row of the intra MB a to its top-right. Without the top-right
    wait b may run first, and then reads a's samples before a is
    rebuilt."""
    mb_w, mb_h = 4, 3
    a, b = 2, 5                              # (2, 0) and (1, 1)
    case = _pair(mb_w, mb_h, a, b, 2, mode5=mode5)
    order = [[b], [a]]
    assert allowed(order, [a, b], mb_w, drop=("TR",))
    assert not allowed(order, [a, b], mb_w)
    assert not _same(_scan(case, mb_w, mb_h, order), _scan(case, mb_w, mb_h))


@pytest.mark.parametrize("info_b", [3 | (0 << 4), 0 | (3 << 4)])
def test_schedule_without_the_top_left_wait_differs(info_b):
    """The wait's top-left part is necessary: an I16x16 MB b in luma or
    chroma plane mode reads the corner sample of the intra MB a to its
    top-left."""
    mb_w, mb_h = 4, 3
    a, b = 0, 5                              # (0, 0) and (1, 1)
    case = _pair(mb_w, mb_h, a, b, 3, info_b=info_b)
    order = [[b], [a]]
    assert allowed(order, [a, b], mb_w, drop=("TL",))
    assert not allowed(order, [a, b], mb_w)
    assert not _same(_scan(case, mb_w, mb_h, order), _scan(case, mb_w, mb_h))
