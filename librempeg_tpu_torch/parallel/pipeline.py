"""The batched transcode step: the device compute of the kernel leg.

Port of the single-device part of librempeg_tpu/parallel/pipeline.py:
over a batch of yuv420 frames, scale (separable GEMM resize), then code
the luma as a P frame (fused integer search + MC, 8x8 DCT, quantise,
in-loop recon) and the chroma as intra blocks. The JAX package jits the
step into one program; here it runs eagerly, and the search is the
full-search kernel (ops/pallas/mesearch.py) on a CUDA tensor.

The resize products are float32 torch.matmul with TF32 off (device.py)
in place of the JAX package's HIGHEST-precision einsums; the DCT is
ops.dct8x8's. jnp.round and torch.round both round half to even.

The multi-device forms: make_sharded_step runs each data shard's step
on its own device (the full-search kernel once per data shard) and the
half-pel 6-tap of the recon row-sharded over 'spatial' with a halo
(parallel/halo.py); mpeg4_stage_fns gives the encoder's device stages
for the ring pipeline (parallel/stagepipe.py).
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.ops import dct8x8, fir
from librempeg_tpu_torch.ops.pallas.mesearch import full_search_mc
from librempeg_tpu_torch.parallel.halo import (halfpel_plane,
                                               row_sharded_stencil,
                                               vfir6_halfpel)
from librempeg_tpu_torch.parallel.mesh import Mesh, from_shard, to_shard


def _quant_tables(qscale: float):
    """Flat quantizer (MPEG-4 style qscale*2 for AC, 8 for intra DC)."""
    q = np.full((8, 8), 2.0 * qscale, np.float32)
    q[0, 0] = 8.0
    return q


def encode_intra_like(y: torch.Tensor, qscale: float) -> dict:
    """Intra path: fdct -> quant -> dequant -> idct (reconstruction)."""
    q = torch.as_tensor(_quant_tables(qscale), device=y.device)
    blocks = dct8x8.to_blocks(y.to(torch.float32) - 128.0)
    levels = torch.round(dct8x8.fdct(blocks) / q)
    recon_blocks = dct8x8.idct(levels * q) + 128.0
    n, h, w = y.shape
    recon = dct8x8.from_blocks(recon_blocks, h, w)
    return {"levels": levels, "recon": recon.clamp(0.0, 255.0)}


def _pick_tile(size: int, target: int, align: int) -> int | None:
    """Largest divisor of `size` that is <= target and align-divisible."""
    best = None
    for d in range(align, min(size, target) + 1, align):
        if size % d == 0:
            best = d
    return best


def fused_search_mc(cur: torch.Tensor, ref: torch.Tensor,
                    search_range: int):
    """Fused ME+MC. The JAX package takes its Pallas kernel when the
    frame tiles cleanly and an XLA search otherwise; the port's kernel
    needs no tiles, so a frame that does not tile is one tile."""
    n, h, w = cur.shape
    th = _pick_tile(h, 160, 16) or h
    tw = _pick_tile(w, 512, 128) or w
    return full_search_mc(cur, ref, search_range, tile_h=th, tile_w=tw)


def encode_inter_like(cur: torch.Tensor, ref: torch.Tensor, qscale: float,
                      search_range: int = 4, search=fused_search_mc) -> dict:
    """P-frame path: fused ME+MC (`search`) -> residual transform ->
    recon.

    MVs are integer-pel, matching the reference encoder's cheapest ME
    setting."""
    mv, _, pred = search(cur, ref, search_range)
    resid = cur.to(torch.float32) - pred
    q = torch.as_tensor(_quant_tables(qscale), device=cur.device)
    levels = torch.round(dct8x8.fdct(dct8x8.to_blocks(resid)) / q)
    rec_resid = dct8x8.idct(levels * q)
    n, h, w = cur.shape
    recon = pred + dct8x8.from_blocks(rec_resid, h, w)
    return {"mv": mv, "levels": levels, "recon": recon.clamp(0.0, 255.0)}


def resize_clip(x: torch.Tensor, dst_h: int, dst_w: int) -> torch.Tensor:
    """Bicubic resize of [N, H, W] float32 planes, clipped to 0..255."""
    h, w = x.shape[-2], x.shape[-1]
    x = fir.resize_v(x, fir.resize_matrix(h, dst_h, "bicubic"))
    x = fir.resize_h(x, fir.resize_matrix(w, dst_w, "bicubic"))
    return x.clamp(0.0, 255.0)


def transcode_step(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   ref_y: torch.Tensor, dst_h: int, dst_w: int,
                   qscale: float = 4.0, search=fused_search_mc) -> dict:
    """Full device transcode step over a batch of yuv420 frames.

    y: [N, H, W]; u, v: [N, H/2, W/2]; ref_y: [N, dst_h, dst_w]
    (the previous reconstructed scaled luma, for P-frame coding).
    `search` is the luma's fused search (make_sharded_step splits it)."""
    f32 = torch.float32
    sy = resize_clip(y.to(f32), dst_h, dst_w)
    su = resize_clip(u.to(f32), dst_h // 2, dst_w // 2)
    sv = resize_clip(v.to(f32), dst_h // 2, dst_w // 2)

    enc = encode_inter_like(sy, ref_y.to(f32), qscale, search=search)
    enc_u = encode_intra_like(su, qscale)
    enc_v = encode_intra_like(sv, qscale)
    return {
        "y": enc["recon"], "u": enc_u["recon"], "v": enc_v["recon"],
        "mv": enc["mv"],
        "levels_y": enc["levels"],
        "levels_u": enc_u["levels"], "levels_v": enc_v["levels"],
    }


def make_sharded_step(mesh: Mesh, dst_h: int, dst_w: int,
                      qscale: float = 4.0):
    """Multi-device transcode step: the batch split over 'data' for the
    full search (the kernel once per data shard, on shard (d, 0)), then a
    row-sharded production stencil over 'spatial' with halo exchange:
    the H.264 vertical half-pel 6-tap of the reconstructed luma (the
    h-plane the next frame's sub-pel search reads), integer-exact.
    Returns step(y, u, v, ref_y) -> transcode_step's dict plus
    "y_halfpel" (uint8), every output on y's device.

    The step's products (the resize GEMMs, the DCTs) run whole on the
    caller's device, by the rule product_mesh.py states for the scaler:
    cuBLAS picks a GEMM's algorithm by its shape, and on the H100 a data
    shard's products gave other bits than the whole batch's (chip_smoke's
    mesh phase), where the search is per frame in any batch."""
    # asymmetric taps: the half-pel between rows r, r+1 reads r-2..r+3,
    # so with a symmetric 3-row halo the filter takes xh[1:]
    halfpel = row_sharded_stencil(lambda xh: vfir6_halfpel(xh[..., 1:, :]),
                                  halo=3, mesh=mesh)
    n_data = mesh.shape.get("data", 1)

    def search(cur, ref, search_range):
        n = cur.shape[0]
        if n % n_data:
            raise ValueError(f"batch of {n} does not split over "
                             f"data={n_data}")
        k = n // n_data
        parts = []
        for d in range(n_data):
            sh = mesh.shard(data=d)
            a, b = (to_shard(t[d * k:(d + 1) * k], sh) for t in (cur, ref))
            with sh.ctx():
                o = fused_search_mc(a, b, search_range)
            parts.append([from_shard(t, sh, cur.device) for t in o])
        return tuple(torch.cat(ts) for ts in zip(*parts))

    def step(y, u, v, ref_y):
        out = transcode_step(y, u, v, ref_y, dst_h, dst_w, qscale,
                             search=search)
        out["y_halfpel"] = halfpel(out["y"].to(torch.int32)) \
            .to(torch.uint8)
        return out

    return step


def mpeg4_stage_fns(src_h: int, src_w: int, dst_h: int, dst_w: int,
                    qscale: float = 4.0, n_stages: int = 2):
    """The MPEG-4 encoder's device stages as ring-pipeline stage fns over
    [N, src_h, src_w] float32 luma batches: scale (GEMM resize), then
    intra transform coding with in-loop recon; a third stage (depth > 2)
    takes the half-pel interpolation of the recon, further ones are the
    identity. Stage I/O keeps the source shape (padded with zeros), as
    the ring requires."""
    mv = fir.resize_matrix(src_h, dst_h, "bicubic")
    mh = fir.resize_matrix(src_w, dst_w, "bicubic")

    def pad(x):
        return torch.nn.functional.pad(
            x, (0, src_w - x.shape[-1], 0, src_h - x.shape[-2]))

    def scale_stage(x):
        x = torch.matmul(fir._mat(mv, x), x)
        x = torch.matmul(x, fir._mat(mh, x).T)
        return pad(x.clamp(0.0, 255.0))

    def code_stage(x):
        return pad(encode_intra_like(x[:, :dst_h, :dst_w], qscale)["recon"])

    def halfpel_stage(x):
        sub = x[:, :dst_h, :dst_w].to(torch.int32)
        return pad(halfpel_plane(sub).to(torch.float32))

    stages = [scale_stage, code_stage, halfpel_stage]
    while len(stages) < n_stages:
        stages.append(lambda x: x)
    return stages[:max(2, n_stages)]
