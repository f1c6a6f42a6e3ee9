"""Block motion estimation and compensation (the encoder's search).

Port of the parts of librempeg_tpu/ops/motion.py that the MPEG-4 P-VOP
path runs: the integer full search (full_search_mc_xla, XLA in the JAX
package, plain tensor code here) and the half-pel refinement and
compensation (_hpel_refine, mc_hpel), which are the plain version of
the half-pel kernel (codecs/mpeg4/me_pallas.py).

Numerics of the integer search: like the JAX package it casts the
current and reference planes to bf16 and takes the difference in bf16.
The JAX package then sums each block through a bf16 q/r split of its
row sums (block_reduce_mm, a matrix-unit trick); here the bf16
differences are summed in float32, which is exact for the magnitudes a
16x16 block produces. The two agree exactly on integer-valued
references; on the encoder's float recon planes a row sum whose
remainder needs more than bf16's 8 significant bits can round in the JAX
package, so rare ties and near-ties may resolve differently.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def block_reduce(x: torch.Tensor, bs: int) -> torch.Tensor:
    """Sum over bs x bs tiles: [..., H, W] -> [..., H//bs, W//bs]."""
    *lead, h, w = x.shape
    return x.reshape(*lead, h // bs, bs, w // bs, bs).sum(dim=(-3, -1))


def _edge_pad(x: torch.Tensor, py: int, px: int) -> torch.Tensor:
    """Replicate-pad the last two axes of [N, H, W]."""
    if x.dtype.is_floating_point:
        return F.pad(x[:, None], (px, px, py, py), mode="replicate")[:, 0]
    return F.pad(x[:, None].float(), (px, px, py, py),
                 mode="replicate")[:, 0].to(x.dtype)


def full_search_mc_xla(cur: torch.Tensor, ref: torch.Tensor,
                       search_range: int = 8, block_size: int = 16,
                       step: int = 1):
    """Exhaustive integer search over the candidate lattice
    [-r, r] step `step` (raster order, first minimum wins) + motion
    compensation. cur/ref [N, H, W].

    Returns (mv [N, bh, bw, 2] int32 (dy, dx), cost [N, bh, bw] f32,
    pred [N, H, W] f32)."""
    n, h, w = cur.shape
    bs, r = block_size, search_range
    curb = cur.to(torch.bfloat16)
    ref_pad = _edge_pad(ref.to(torch.float32), r, r).to(torch.bfloat16)
    offs = list(range(-r, r + 1, step))
    costs = []
    for dy in offs:
        for dx in offs:
            shifted = ref_pad[:, r + dy:r + dy + h, r + dx:r + dx + w]
            diff = (curb - shifted).abs()
            costs.append(block_reduce(diff.to(torch.float32), bs))
    costs = torch.stack(costs)                     # [C, N, bh, bw]
    cost, best = costs.min(dim=0)
    # min() does not promise the first index on ties: take the first
    # candidate whose cost equals the minimum (strict-< scan order)
    ar = torch.arange(costs.shape[0], device=cur.device)[:, None, None, None]
    best = torch.where(costs == cost[None], ar, costs.shape[0]).amin(dim=0)
    off = torch.tensor(offs, dtype=torch.int32, device=cur.device)
    mv = torch.stack([off[best // len(offs)], off[best % len(offs)]], -1)
    # prediction: the winning block of the bf16 reference
    bh, bw = h // bs, w // bs
    by = (torch.arange(bh, device=cur.device) * bs)[None, :, None]
    bx = (torch.arange(bw, device=cur.device) * bs)[None, None, :]
    win = _gather_windows(ref_pad, by + mv[..., 0] + r, bx + mv[..., 1] + r,
                          bs)
    pred = win.permute(0, 1, 3, 2, 4).reshape(n, h, w).to(torch.float32)
    return mv, cost, pred


def _gather_windows(ref_pad, oy, ox, win):
    """[N, Hp, Wp] + per-block top-left (padded coords) -> block windows
    [N, bh, bw, win, win]."""
    n = ref_pad.shape[0]
    ar = torch.arange(win, device=ref_pad.device)
    iy = oy.long()[..., None, None] + ar[None, None, None, :, None]
    ix = ox.long()[..., None, None] + ar[None, None, None, None, :]
    nidx = torch.arange(n, device=ref_pad.device)[:, None, None, None, None]
    return ref_pad[nidx, iy, ix]


def _hpel_refine(cur, ref_pad, pad_y, pad_x, mv_i, rounding, bs):
    """Half-pel refinement around per-block integer winners.

    cur [N, H, W]; ref_pad int-valued [N, H+2py, W+2px]; mv_i
    [N, bh, bw, 2] (pixel units, |mv| <= pad-1). Interpolation follows
    the decoder's integer half-pel rules ((a+b+1-rnd)>>1 /
    (4-sum+2-rnd)>>2), candidates in (dy, dx) raster order over
    [-2, 2], first minimum wins.
    Returns (mv half-pel [N, bh, bw, 2], cost f32, pred f32)."""
    n, h, w = cur.shape
    bh, bw = h // bs, w // bs
    rr = 2
    win = bs + 2 * rr - 1
    dev = cur.device
    by = (torch.arange(bh, device=dev) * bs)[None, :, None]
    bx = (torch.arange(bw, device=dev) * bs)[None, None, :]
    oy = by + mv_i[..., 0] + pad_y - 1
    ox = bx + mv_i[..., 1] + pad_x - 1
    wd = _gather_windows(ref_pad.to(torch.int32), oy, ox, win)
    curb = cur.reshape(n, bh, bs, bw, bs).permute(0, 1, 3, 2, 4) \
        .to(torch.int32)
    r1, r2 = 1 - rounding, 2 - rounding

    def sub(dy, dx):
        return wd[..., 1 + dy:1 + dy + bs, 1 + dx:1 + dx + bs]

    best_cost = torch.full((n, bh, bw), 2 ** 31 - 1, dtype=torch.int32,
                           device=dev)
    best_d = torch.zeros((n, bh, bw, 2), dtype=torch.int32, device=dev)
    best_pred = torch.zeros((n, bh, bw, bs, bs), dtype=torch.int32,
                            device=dev)
    for dy in range(-rr, rr + 1):
        for dx in range(-rr, rr + 1):
            ody, odx = dy >> 1, dx >> 1
            fy, fx = dy & 1, dx & 1
            a = sub(ody, odx)
            if fy == 0 and fx == 0:
                p = a
            elif fy == 0:
                p = (a + sub(ody, odx + 1) + r1) >> 1
            elif fx == 0:
                p = (a + sub(ody + 1, odx) + r1) >> 1
            else:
                p = (a + sub(ody, odx + 1) + sub(ody + 1, odx)
                     + sub(ody + 1, odx + 1) + r2) >> 2
            sad = (curb - p).abs().sum(dim=(-2, -1), dtype=torch.int32)
            take = sad < best_cost
            best_cost = torch.where(take, sad, best_cost)
            d = torch.tensor([dy, dx], dtype=torch.int32, device=dev)
            best_d = torch.where(take[..., None], d, best_d)
            best_pred = torch.where(take[..., None, None], p, best_pred)
    mv_h = 2 * mv_i + best_d
    pred = best_pred.permute(0, 1, 3, 2, 4).reshape(n, h, w)
    return mv_h, best_cost.to(torch.float32), pred.to(torch.float32)


def mc_hpel(ref: torch.Tensor, mv_h: torch.Tensor, block_size: int,
            pad: int, rounding: int = 0) -> torch.Tensor:
    """Half-pel motion compensation at per-block half-pel MVs
    (decoder-exact integer interpolation). ref [N, H, W]; mv_h
    [N, bh, bw, 2]; |mv_h| <= 2*(pad-1)."""
    n, h, w = ref.shape
    bs = block_size
    bh, bw = h // bs, w // bs
    dev = ref.device
    ref_pad = _edge_pad(ref.to(torch.float32), pad, pad).to(torch.int32)
    iy = mv_h[..., 0] >> 1
    ix = mv_h[..., 1] >> 1
    fy = (mv_h[..., 0] & 1)[..., None, None]
    fx = (mv_h[..., 1] & 1)[..., None, None]
    by = (torch.arange(bh, device=dev) * bs)[None, :, None]
    bx = (torch.arange(bw, device=dev) * bs)[None, None, :]
    wd = _gather_windows(ref_pad, by + iy + pad, bx + ix + pad, bs + 1)
    r1, r2 = 1 - rounding, 2 - rounding
    a = wd[..., :bs, :bs]
    b = wd[..., :bs, 1:]
    c = wd[..., 1:, :bs]
    d = wd[..., 1:, 1:]
    p = torch.where(fy == 0, torch.where(fx == 0, a, (a + b + r1) >> 1),
                    torch.where(fx == 0, (a + c + r1) >> 1,
                                (a + b + c + d + r2) >> 2))
    return p.permute(0, 1, 3, 2, 4).reshape(n, h, w).to(torch.float32)
