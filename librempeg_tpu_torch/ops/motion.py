"""Block motion estimation and compensation.

Port of librempeg_tpu/ops/motion.py, the package's motion-estimation
library: the integer searches (full_search, full_search_mc_xla and its
vertically pre-padded form, hierarchical_search), the half-pel
refinements and compensations (_hpel_refine, mc_hpel, the B-VOP search
full_search_mc_hpel and their pre-padded forms; halfpel_refine and
motion_compensate_halfpel, bilinear), motion_compensate and its
candidate-scan forms, and the sad/sse/satd metrics. Plain tensor code
on whatever device the tensors live on: the JAX `lax.scan`s over
candidates are loops of vectorised ops here, in the same candidate
order (np.mgrid raster, the first minimum wins). The full-search
kernel's wrapper is ops/pallas/mesearch.full_search_mc; the half-pel
kernel's plain versions are _hpel_refine and mc_hpel.

Numerics of full_search_mc_xla: like the JAX package it casts the
current and reference planes to bf16 and takes the difference in bf16.
The JAX package then sums each block through a bf16 q/r split of its
row sums (block_reduce_mm, a matrix-unit workaround for the TPU); here
the bf16 differences are summed in float32 by block_reduce, which is
exact for the magnitudes a 16x16 block produces. The two agree exactly
on integer-valued references; on the encoder's float recon planes a row
sum whose remainder needs more than bf16's 8 significant bits can round
in the JAX package, so rare ties and near-ties may resolve differently.
On uint8-valued inputs every other result is exact in float32 too
(block SADs stay under 2^24, the coarse level divides by 16 and the
bilinear weights are 0 and 0.5); sad and sse sum in float64 and round
once, so their value does not depend on the summation order.
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


def _candidate_costs(cur: torch.Tensor, ref_pad: torch.Tensor,
                     cands, pad: int, bs: int) -> torch.Tensor:
    """SAD of every candidate displacement (dy, dx) of `cands`, in order.
    cur [N, H, W]; ref_pad [N, H+2p, W+2p] -> [C, N, bh, bw] float."""
    n, h, w = cur.shape
    return torch.stack([
        block_reduce((cur - ref_pad[:, pad + dy:pad + dy + h,
                                    pad + dx:pad + dx + w]).abs(), bs)
        for dy, dx in cands])


def _first_argmin(costs: torch.Tensor):
    """(min, index of its first occurrence) over dim 0: min() does not
    promise the first index on ties, argmin's first-minimum rule does
    (strict-< scan order)."""
    cost = costs.amin(dim=0)
    ar = torch.arange(costs.shape[0], device=costs.device)
    ar = ar.view(-1, *([1] * (costs.dim() - 1)))
    best = torch.where(costs == cost[None], ar, costs.shape[0]).amin(dim=0)
    return cost, best


def _lattice(r: int, step: int = 1) -> list[tuple[int, int]]:
    """np.mgrid[-r:r+1:step, -r:r+1:step] raster order, (dy, dx)."""
    offs = range(-r, r + 1, step)
    return [(dy, dx) for dy in offs for dx in offs]


def full_search(cur: torch.Tensor, ref: torch.Tensor,
                search_range: int = 8, block_size: int = 16):
    """Exhaustive integer-pel search in float32 over the reference
    edge-padded by search_range.

    Returns (mv [N, bh, bw, 2] int32 (dy, dx), cost [N, bh, bw])."""
    cur = cur.to(torch.float32)
    r = search_range
    ref_pad = _edge_pad(ref.to(torch.float32), r, r)
    cands = _lattice(r)
    cost, best = _first_argmin(
        _candidate_costs(cur, ref_pad, cands, r, block_size))
    table = torch.tensor(cands, dtype=torch.int32, device=cur.device)
    return table[best], cost


def _search_mc(cur, ref_pad, oy, ox, offs, bs):
    """The integer search over a bf16 reference already padded so that
    displacement (0, 0) sits at (oy, ox): candidates `offs` x `offs` in
    raster order. Returns (mv, cost, pred) as full_search_mc_xla."""
    n, h, w = cur.shape
    curb = cur.to(torch.bfloat16)
    costs = torch.stack([
        block_reduce((curb - ref_pad[:, oy + dy:oy + dy + h,
                                     ox + dx:ox + dx + w]).abs()
                     .to(torch.float32), bs)
        for dy in offs for dx in offs])            # [C, N, bh, bw]
    cost, best = _first_argmin(costs)
    off = torch.tensor(offs, dtype=torch.int32, device=cur.device)
    mv = torch.stack([off[best // len(offs)], off[best % len(offs)]], -1)
    # prediction: the winning block of the bf16 reference
    bh, bw = h // bs, w // bs
    by = (torch.arange(bh, device=cur.device) * bs)[None, :, None]
    bx = (torch.arange(bw, device=cur.device) * bs)[None, None, :]
    win = _gather_windows(ref_pad, by + mv[..., 0] + oy,
                          bx + mv[..., 1] + ox, bs)
    pred = win.permute(0, 1, 3, 2, 4).reshape(n, h, w).to(torch.float32)
    return mv, cost, pred


def full_search_mc_xla(cur: torch.Tensor, ref: torch.Tensor,
                       search_range: int = 8, block_size: int = 16,
                       step: int = 1):
    """Exhaustive integer search over the candidate lattice
    [-r, r] step `step` (raster order, first minimum wins) + motion
    compensation. cur/ref [N, H, W].

    Returns (mv [N, bh, bw, 2] int32 (dy, dx), cost [N, bh, bw] f32,
    pred [N, H, W] f32)."""
    r = search_range
    ref_pad = _edge_pad(ref.to(torch.float32), r, r).to(torch.bfloat16)
    return _search_mc(cur, ref_pad, r, r, list(range(-r, r + 1, step)),
                      block_size)


def full_search_mc_prepadded(cur: torch.Tensor, ref_vpad: torch.Tensor,
                             search_range: int = 8,
                             block_size: int = 16, step: int = 1,
                             vpad: int | None = None):
    """full_search_mc_xla over a VERTICALLY pre-padded reference (rows
    already extended by `vpad` (default search_range) real neighbour
    rows, e.g. a halo exchange); horizontal padding stays replicate.
    Equal to the unsharded search on the corresponding band."""
    r = search_range
    vpad = r if vpad is None else vpad
    ref_pad = _edge_pad(ref_vpad.to(torch.float32), 0, r) \
        .to(torch.bfloat16)
    return _search_mc(cur, ref_pad, vpad, r, list(range(-r, r + 1, step)),
                      block_size)


def motion_compensate(ref: torch.Tensor, mv: torch.Tensor,
                      block_size: int = 16) -> torch.Tensor:
    """The prediction frame from per-block integer MVs over the
    reference edge-padded by 64. ref [N, H, W]; mv [N, bh, bw, 2]
    (dy, dx), |mv| <= 64 -> pred [N, H, W] in ref's dtype."""
    n, h, w = ref.shape
    bs, pad = block_size, 64
    bh, bw = h // bs, w // bs
    ref_pad = _edge_pad(ref, pad, pad)
    by = (torch.arange(bh, device=ref.device) * bs)[None, :, None]
    bx = (torch.arange(bw, device=ref.device) * bs)[None, None, :]
    blocks = _gather_windows(ref_pad, by + mv[..., 0] + pad,
                             bx + mv[..., 1] + pad, bs)
    return blocks.permute(0, 1, 3, 2, 4).reshape(n, h, w)


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


def full_search_mc_hpel(cur: torch.Tensor, ref: torch.Tensor,
                        search_range: int = 8, block_size: int = 16,
                        rounding: int = 0, step: int = 2):
    """Integer full search (full_search_mc_xla) + half-pel refinement
    (_hpel_refine) over the reference edge-padded by search_range + 2
    and truncated to integers. The B-VOP search: plain tensor code.

    Returns (mv [N, bh, bw, 2] int32 HALF-PEL units, cost f32, pred
    f32); the prediction is decoder-exact for vop_rounding_type
    `rounding`."""
    mv_i, _, _ = full_search_mc_xla(cur, ref, search_range, block_size,
                                    step)
    pad = search_range + 2
    ref_pad = _edge_pad(ref.to(torch.float32), pad, pad).to(torch.int32)
    return _hpel_refine(cur, ref_pad, pad, pad, mv_i, rounding, block_size)


def full_search_mc_hpel_prepadded(cur: torch.Tensor, ref_vpad: torch.Tensor,
                                  search_range: int = 8,
                                  block_size: int = 16,
                                  rounding: int = 0, step: int = 2):
    """Integer pre-padded search + half-pel refinement over a band whose
    reference carries a (search_range+2)-row halo."""
    r = search_range
    mv_i, _, _ = full_search_mc_prepadded(cur, ref_vpad, r, block_size,
                                          step, vpad=r + 2)
    ref_pad = _edge_pad(ref_vpad.to(torch.float32), 0, r + 2) \
        .to(torch.int32)
    return _hpel_refine(cur, ref_pad, r + 2, r + 2, mv_i, rounding,
                        block_size)


def _mc_hpel_padded(ref_pad, mv_h, bs, pad_y, pad_x, rounding):
    """Half-pel MC from an int32 reference padded by (pad_y, pad_x)."""
    n, hp, wp = ref_pad.shape
    h, w = hp - 2 * pad_y, wp - 2 * pad_x
    bh, bw = h // bs, w // bs
    dev = ref_pad.device
    iy = mv_h[..., 0] >> 1
    ix = mv_h[..., 1] >> 1
    fy = (mv_h[..., 0] & 1)[..., None, None]
    fx = (mv_h[..., 1] & 1)[..., None, None]
    by = (torch.arange(bh, device=dev) * bs)[None, :, None]
    bx = (torch.arange(bw, device=dev) * bs)[None, None, :]
    wd = _gather_windows(ref_pad, by + iy + pad_y, bx + ix + pad_x, bs + 1)
    r1, r2 = 1 - rounding, 2 - rounding
    a = wd[..., :bs, :bs]
    b = wd[..., :bs, 1:]
    c = wd[..., 1:, :bs]
    d = wd[..., 1:, 1:]
    p = torch.where(fy == 0, torch.where(fx == 0, a, (a + b + r1) >> 1),
                    torch.where(fx == 0, (a + c + r1) >> 1,
                                (a + b + c + d + r2) >> 2))
    return p.permute(0, 1, 3, 2, 4).reshape(n, h, w).to(torch.float32)


def mc_hpel(ref: torch.Tensor, mv_h: torch.Tensor, block_size: int,
            pad: int, rounding: int = 0) -> torch.Tensor:
    """Half-pel motion compensation at per-block half-pel MVs
    (decoder-exact integer interpolation). ref [N, H, W]; mv_h
    [N, bh, bw, 2]; |mv_h| <= 2*(pad-1)."""
    ref_pad = _edge_pad(ref.to(torch.float32), pad, pad).to(torch.int32)
    return _mc_hpel_padded(ref_pad, mv_h, block_size, pad, pad, rounding)


def mc_hpel_vpad(ref_vpad: torch.Tensor, mv_h: torch.Tensor,
                 block_size: int, pad_y: int, pad_x: int,
                 rounding: int = 0) -> torch.Tensor:
    """mc_hpel over a vertically pre-padded reference band (halo rows
    already exchanged); horizontal padding stays replicate-local."""
    ref_pad = _edge_pad(ref_vpad.to(torch.float32), 0, pad_x) \
        .to(torch.int32)
    return _mc_hpel_padded(ref_pad, mv_h, block_size, pad_y, pad_x,
                           rounding)


def _median3x3(mv: torch.Tensor) -> torch.Tensor:
    """Per-component 3x3 median over the block grid [N, bh, bw, 2]."""
    _, bh, bw, _ = mv.shape
    p = F.pad(mv.permute(0, 3, 1, 2).to(torch.float32), (1, 1, 1, 1),
              mode="replicate").permute(0, 2, 3, 1)
    stack = torch.stack([p[:, dy:dy + bh, dx:dx + bw]
                         for dy in range(3) for dx in range(3)])
    # of nine values torch.median's lower median is the middle one
    return stack.median(dim=0).values.to(mv.dtype)


def hierarchical_search(cur: torch.Tensor, ref: torch.Tensor,
                        search_range: int = 16, block_size: int = 16,
                        refine: int = 3):
    """Coarse-to-fine search: full search at 1/4 resolution, a 3x3
    vector median of the coarse field, then a +/-refine full-resolution
    refinement around the upscaled winner, clamped to the range.

    Returns (mv [N, bh, bw, 2] int32, cost [N, bh, bw] of the refined
    winner before the clamp)."""
    cur = cur.to(torch.float32)
    ref = ref.to(torch.float32)
    n, h, w = cur.shape
    bs = block_size
    cur4 = block_reduce(cur, 4) / 16.0
    ref4 = block_reduce(ref, 4) / 16.0
    mv4, _ = full_search(cur4, ref4, max(1, search_range // 4), bs // 4)
    base_mv = _median3x3(mv4) * 4                          # [N, bh, bw, 2]

    deltas = _lattice(refine)
    pad = search_range + refine + 4
    ref_pad = _edge_pad(ref, pad, pad)
    bh, bw = h // bs, w // bs
    dev = cur.device
    by = (torch.arange(bh, device=dev) * bs)[None, :, None]
    bx = (torch.arange(bw, device=dev) * bs)[None, None, :]
    cur_blocks = cur.reshape(n, bh, bs, bw, bs).permute(0, 1, 3, 2, 4)
    costs = torch.stack([
        (cur_blocks - _gather_windows(
            ref_pad, by + base_mv[..., 0] + dy + pad,
            bx + base_mv[..., 1] + dx + pad, bs)).abs().sum(dim=(-2, -1))
        for dy, dx in deltas])                             # [C, N, bh, bw]
    cost, best = _first_argmin(costs)
    table = torch.tensor(deltas, dtype=torch.int32, device=dev)
    mv = (base_mv + table[best]).clamp(-search_range, search_range)
    return mv.to(torch.int32), cost


def motion_compensate_scan_prepadded(ref_vpad: torch.Tensor,
                                     mv: torch.Tensor, block_size: int,
                                     search_range: int) -> torch.Tensor:
    """The prediction from per-block integer MVs |mv| <= search_range,
    over a vertically pre-padded reference [N, H+2r, W] (halo-exchanged
    band; horizontal padding stays replicate): each candidate of the
    (2r+1)^2 lattice fills the blocks whose MV it is; a block whose MV
    is out of range stays 0."""
    n, hp, w = ref_vpad.shape
    bs, r = block_size, search_range
    h = hp - 2 * r
    ref_pad = _edge_pad(ref_vpad, 0, r)
    pred = torch.zeros((n, h, w), dtype=ref_vpad.dtype,
                       device=ref_vpad.device)
    for dy, dx in _lattice(r):
        take = (mv[..., 0] == dy) & (mv[..., 1] == dx)
        take = take.repeat_interleave(bs, 1).repeat_interleave(bs, 2)
        pred = torch.where(take, ref_pad[:, r + dy:r + dy + h,
                                         r + dx:r + dx + w], pred)
    return pred


def motion_compensate_scan(ref: torch.Tensor, mv: torch.Tensor,
                           block_size: int, search_range: int
                           ) -> torch.Tensor:
    """motion_compensate for MVs within search_range, as a scan of the
    displacement lattice (motion_compensate_scan_prepadded over the
    reference edge-padded by search_range)."""
    r = search_range
    return motion_compensate_scan_prepadded(_edge_pad(ref, r, 0), mv,
                                            block_size, r)


_PAD_HALF = 68


def _sample_half(ref_pad, oy2, ox2, bs):
    """Bilinear blocks at half-pel top-left positions (oy2, ox2), in
    half-pel units of the padded reference."""
    n = ref_pad.shape[0]
    fy = (oy2 % 2).to(torch.float32)[..., None, None] * 0.5
    fx = (ox2 % 2).to(torch.float32)[..., None, None] * 0.5
    ar = torch.arange(bs, device=ref_pad.device)
    iy = (oy2 // 2).long()[..., None, None] + ar[None, None, None, :, None]
    ix = (ox2 // 2).long()[..., None, None] + ar[None, None, None, None, :]
    nidx = torch.arange(n, device=ref_pad.device)[:, None, None, None, None]
    top = ref_pad[nidx, iy, ix] * (1 - fx) + ref_pad[nidx, iy, ix + 1] * fx
    bot = ref_pad[nidx, iy + 1, ix] * (1 - fx) \
        + ref_pad[nidx, iy + 1, ix + 1] * fx
    return top * (1 - fy) + bot * fy


def halfpel_refine(cur: torch.Tensor, ref: torch.Tensor,
                   mv_int: torch.Tensor, block_size: int = 16):
    """Half-pel refinement: the 9 half-pel positions around each integer
    MV (raster order, first minimum wins), bilinear with weights 0 and
    0.5 (hpeldsp put_pixels, no rounding).

    Returns (mv_halfpel [N, bh, bw, 2] in half-pel units, cost)."""
    cur = cur.to(torch.float32)
    n, h, w = cur.shape
    bs, pad = block_size, _PAD_HALF
    bh, bw = h // bs, w // bs
    ref_pad = _edge_pad(ref.to(torch.float32), pad, pad)
    cur_blocks = cur.reshape(n, bh, bs, bw, bs).permute(0, 1, 3, 2, 4)
    dev = cur.device
    by = (torch.arange(bh, device=dev) * bs)[None, :, None]
    bx = (torch.arange(bw, device=dev) * bs)[None, None, :]
    deltas = _lattice(1)
    costs = torch.stack([
        (cur_blocks - _sample_half(
            ref_pad, (by + mv_int[..., 0] + pad) * 2 + dy,
            (bx + mv_int[..., 1] + pad) * 2 + dx, bs)).abs()
        .sum(dim=(-2, -1)) for dy, dx in deltas])
    cost, best = _first_argmin(costs)
    table = torch.tensor(deltas, dtype=torch.int32, device=dev)
    return (mv_int * 2 + table[best]).to(torch.int32), cost


def motion_compensate_halfpel(ref: torch.Tensor, mv_half: torch.Tensor,
                              block_size: int = 16) -> torch.Tensor:
    """Prediction from half-pel MVs (bilinear)."""
    n, h, w = ref.shape
    bs, pad = block_size, _PAD_HALF
    bh, bw = h // bs, w // bs
    ref_pad = _edge_pad(ref.to(torch.float32), pad, pad)
    dev = ref.device
    by = (torch.arange(bh, device=dev) * bs)[None, :, None]
    bx = (torch.arange(bw, device=dev) * bs)[None, None, :]
    blocks = _sample_half(ref_pad, by * 2 + mv_half[..., 0] + 2 * pad,
                          bx * 2 + mv_half[..., 1] + 2 * pad, bs)
    return blocks.permute(0, 1, 3, 2, 4).reshape(n, h, w)


def sad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Whole-tensor SAD (me_cmp 'sad' metric), float32: summed in
    float64 and rounded once."""
    d = a.to(torch.float64) - b.to(torch.float64)
    return d.abs().sum().to(torch.float32)


def sse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Whole-tensor sum of squared differences, float32: summed in
    float64 and rounded once."""
    d = a.to(torch.float64) - b.to(torch.float64)
    return (d * d).sum().to(torch.float32)


def _hadamard8(device) -> torch.Tensor:
    h = torch.ones((1, 1), dtype=torch.float32)
    while h.shape[0] < 8:
        h = torch.cat([torch.cat([h, h], 1), torch.cat([h, -h], 1)])
    return h.to(device)


def satd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of absolute Hadamard-transformed differences over 8x8 blocks
    (me_cmp 'satd'/hadamard8_diff metric), batched [..., 8, 8]."""
    hm = _hadamard8(a.device)
    d = a.to(torch.float32) - b.to(torch.float32)
    return (hm @ d @ hm.T).abs().sum(dim=(-2, -1))
