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
The multi-device forms (make_sharded_step, mpeg4_stage_fns) are not
ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.ops import dct8x8, fir
from librempeg_tpu_torch.ops.pallas.mesearch import full_search_mc


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
                      search_range: int = 4) -> dict:
    """P-frame path: fused ME+MC -> residual transform -> recon.

    MVs are integer-pel, matching the reference encoder's cheapest ME
    setting."""
    mv, _, pred = fused_search_mc(cur, ref, search_range)
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
                   qscale: float = 4.0) -> dict:
    """Full device transcode step over a batch of yuv420 frames.

    y: [N, H, W]; u, v: [N, H/2, W/2]; ref_y: [N, dst_h, dst_w]
    (the previous reconstructed scaled luma, for P-frame coding)."""
    f32 = torch.float32
    sy = resize_clip(y.to(f32), dst_h, dst_w)
    su = resize_clip(u.to(f32), dst_h // 2, dst_w // 2)
    sv = resize_clip(v.to(f32), dst_h // 2, dst_w // 2)

    enc = encode_inter_like(sy, ref_y.to(f32), qscale)
    enc_u = encode_intra_like(su, qscale)
    enc_v = encode_intra_like(sv, qscale)
    return {
        "y": enc["recon"], "u": enc_u["recon"], "v": enc_v["recon"],
        "mv": enc["mv"],
        "levels_y": enc["levels"],
        "levels_u": enc_u["levels"], "levels_v": enc_v["levels"],
    }
