"""Generic run-length Viterbi lattice for RD (trellis) quantization.

Port of librempeg_tpu/ops/trellis.py, shared by the MPEG-4/H.263 coder
(codecs/mpeg4/trellis.py) and, once ported, the JPEG encoder: both
entropy-code (run, level[, last]) events over zigzag-ordered
coefficients, so one dense DP applies with codec-specific candidate
levels, distortions and bit-cost tables.

The lattice mirrors the reference trellis quantizer's structure
(mpegvideo_enc.c:3923 dct_quantize_trellis_c): the state over the 64
zigzag positions is a [nblk, 65] cost tensor (state s = "last nonzero at
position s-1", s = 0 = "nothing coded"), every block's trellis runs in
parallel with no survivor pruning, with dual continuation/termination
lattices (the argmin under not-last bit costs need not be the argmin
under last-code costs), then a vectorized backpointer walk.

The JAX package's lax.scan becomes a Python loop of eager tensor ops
over the 64 positions; the operation order, the float32 _INF and the
first-minimum argmin over the flattened [nblk, 65 * K] axis are the JAX
package's (torch.argmin returns the first minimum, like jnp.argmin).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_INF = 1e18
_SCAN_BLOCK = 16


def _prefix_sums(x: torch.Tensor) -> torch.Tensor:
    """[nblk, n] (n a multiple of 16) -> [nblk, n + 1] prefix sums
    (0, x0, x0 + x1, ...) in float32.

    The lattice takes differences of these sums, so their rounding
    decides near-ties. XLA computes jnp.cumsum as a blocked scan: a
    running sum inside blocks of 16, plus the running sum of the block
    totals before each block. This follows the same association (exact
    on the CPU, where torch.cumsum runs left to right), so the port's
    prefix sums equal the JAX package's there."""
    nblk, n = x.shape
    inner = torch.cumsum(x.reshape(nblk, n // _SCAN_BLOCK, _SCAN_BLOCK),
                         dim=-1)
    outer = torch.cumsum(inner[..., -1], dim=-1)
    before = torch.cat([torch.zeros_like(outer[:, :1]), outer[:, :-1]], 1)
    return torch.cat([torch.zeros_like(x[:, :1]),
                      (inner + before[..., None]).reshape(nblk, n)], 1)


@functools.lru_cache(maxsize=None)
def _lattice_np(first: int):
    """Per position (rows) and state (columns): the run of zeros since
    the state's last code, clipped to the tables, and whether the state
    can code at that position -- [64, 65] int64 and bool."""
    states = np.arange(65)
    prev_idx = np.where(states == 0, first - 1, states - 1)
    run = np.arange(64)[:, None] - prev_idx[None, :] - 1
    valid = (states[None, :] <= np.arange(64)[:, None]) & (run >= 0) \
        & (run < 64) & (np.arange(64)[:, None] >= first)
    return np.clip(run, 0, 63), valid, np.clip(prev_idx + 1, 0, 64)


_LATTICE: dict = {}


def _lattice(first: int, dev):
    """_lattice_np's tables on `dev`, uploaded once."""
    key = (first, str(dev))
    hit = _LATTICE.get(key)
    if hit is None:
        hit = _LATTICE[key] = tuple(torch.as_tensor(a, device=dev)
                                    for a in _lattice_np(first))
    return hit


def viterbi_rl(zz: torch.Tensor, cands: torch.Tensor, dist_c: torch.Tensor,
               bidx: torch.Tensor, b0_tab: torch.Tensor, b1_tab: torch.Tensor,
               lam: float, first: int) -> torch.Tensor:
    """Minimize ``sum(distortion) + lam * sum(bits)`` over run-length
    coded zigzag coefficients.

    zz      [nblk, 64] float32 coefficients (sign source + zero cost c^2)
    cands   [nblk, 64, K] int32 candidate magnitudes (>= 1)
    dist_c  [nblk, 64, K] float32 distortion when coding that candidate
    bidx    [nblk, 64, K] int column index into the bit tables
    b0_tab  [64, C] float32 bits of a (run, col) event, not last
    b1_tab  [64, C] float32 bits of a (run, col) event as the LAST code
    lam     float32 scalar (a Python float or numpy float32)
    first   first codable position (1 skips the DC slot)

    Returns int32 [nblk, 64] signed levels.
    """
    nblk, _, K = cands.shape
    dev = zz.device
    f32 = torch.float32
    lam = torch.tensor(float(lam), dtype=f32, device=dev)
    sgn = torch.where(zz < 0, -1, 1).to(torch.int32)

    zsq = (zz * zz).to(f32)
    zpre = _prefix_sums(zsq)                                   # [nblk, 65]

    runc_all, valid_all, prev_next = _lattice(first, dev)
    zprev = zpre[:, prev_next]                                 # [nblk, 65]
    cost = torch.full((nblk, 65), _INF, dtype=f32, device=dev)
    cost[:, 0] = 0.0
    ar = torch.arange(nblk, device=dev)
    inf = torch.tensor(_INF, dtype=f32, device=dev)

    bp, lev, lcost, lbp, llev = [], [], [], [], []
    for pos in range(64):
        runc = runc_all[pos]                                   # [65]
        # zeros skipped between prev+1 .. pos-1
        zskip = zpre[:, pos][:, None] - zprev
        base = torch.where(valid_all[pos][None, :], cost + zskip,
                           inf)                                # [nblk, 65]
        lc = bidx[:, pos, :].long()                            # [nblk, K]
        bits0 = b0_tab[runc[None, :, None], lc[:, None, :]]    # [nblk, 65, K]
        bits1 = b1_tab[runc[None, :, None], lc[:, None, :]]
        body = base[..., None] + dist_c[:, pos, None, :]
        cpos = cands[:, pos, :]
        # continuation lattice (this code is not last)
        flat = (body + lam * bits0).reshape(nblk, -1)
        best = torch.argmin(flat, dim=1)
        bcost = flat[ar, best]
        bp.append((best // K).to(torch.int32))
        lev.append(cpos[ar, best % K].to(torch.int32))
        cost[:, pos + 1] = bcost
        # termination lattice (this code is last; add trailing zeros)
        tailz = zpre[:, 64] - zpre[:, pos + 1]                 # [nblk]
        flatl = (body + lam * bits1).reshape(nblk, -1)
        bestl = torch.argmin(flatl, dim=1)
        lcost.append(flatl[ar, bestl] + tailz)
        lbp.append((bestl // K).to(torch.int32))
        llev.append(cpos[ar, bestl % K].to(torch.int32))
    # stacked [64 steps, nblk]; step i wrote continuation state i+1 and
    # the best "ends exactly at position i" cost
    bp, lev, lcost, lbp, llev = (torch.stack(x) for x in
                                 (bp, lev, lcost, lbp, llev))

    bestpos = torch.argmin(lcost, dim=0)                       # [nblk]
    bestcost = lcost[bestpos, ar]
    uncoded = zpre[:, 64] - zpre[:, first]
    coded = bestcost < uncoded

    # seed the traceback with the last coefficient, then follow the
    # continuation lattice's backpointers
    pos64 = torch.arange(64, device=dev)[None, :]
    out = torch.where(
        (pos64 == bestpos[:, None]) & coded[:, None],
        (llev[bestpos, ar] * sgn[ar, bestpos])[:, None],
        torch.zeros((nblk, 64), dtype=torch.int32, device=dev))
    cur = torch.where(coded, lbp[bestpos, ar], 0)
    for _ in range(64):
        active = cur > 0
        pos = (cur - 1).clamp(0, 63).long()
        level = lev[pos, ar] * sgn[ar, pos]
        onehot = (pos64 == pos[:, None]) & active[:, None]
        out = torch.where(onehot, level[:, None], out)
        cur = torch.where(active, bp[pos, ar], cur)
    return out.to(torch.int32)
