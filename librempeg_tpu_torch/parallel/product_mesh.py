"""Product-pipeline device mesh: the -mesh option's machinery.

Port of librempeg_tpu/parallel/product_mesh.py. It holds the session's
active mesh and the two sharded forms the transcode runs under it: the
scaler's vertical GEMM split over output rows (resize_v_sharded), and
the MPEG-4 encoder's P-VOP pass over row bands with a search-range halo
(mpeg4_encode_p_sharded). Each equals the single-device form bit for
bit: an output row of the GEMM is contracted at full input length, and
once a band holds its halo rows every macroblock's search, prediction,
transform and reconstruction is the single-device pass's.

The JAX package shards over 'spatial' only and replicates over 'data'
(its shard_map specs leave 'data' unnamed); the port runs each band
once, on the shard at data index 0.

Which shapes shard: a P pass when the coded height divides by
16 * spatial (whole MB rows a band), the scaler when its output rows
divide by spatial; otherwise the product runs whole on the caller's
device, as in the JAX package. At a 1280x720 output only spatial in
{3, 5, 9, 15, 45} shards the P pass (720 / 16 = 45 MB rows), while
spatial 2 and 4 leave it whole. On CUDA the scaler's product runs whole
too: cuBLAS picks a GEMM's algorithm by its shape, and on the H100 a
band of 240 of 720 output rows gave other bits than the whole product
(chip_smoke's mesh phase); the CPU's bands are the whole product's.
The P pass keeps its bands on CUDA: its DCT is float64 rounded once to
float32 and its IDCT is exact, so a band's shape moves no level.

COUNTS records the sharded calls (and the resize_v calls that ran whole
under a mesh), so a run can show that it went through these forms.
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.parallel import mesh as M

_ACTIVE: M.Mesh | None = None

#: sharded P passes, sharded resize_v calls, resize_v calls run whole
#: under an active mesh (rows that do not divide, or on CUDA), since the
#: last reset
COUNTS = {"p_pass": 0, "resize_v": 0, "resize_v_whole": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def parse_mesh_spec(spec: str) -> dict[str, int]:
    """'data=2,spatial=4' -> {'data': 2, 'spatial': 4}."""
    out = {}
    for part in spec.split(","):
        if not part.strip():
            continue
        k, _, v = part.partition("=")
        out[k.strip()] = int(v)
    if not out:
        raise ValueError(f"bad mesh spec: {spec!r}")
    return out


def make_mesh(spec: str, devices=None, device="cuda") -> M.Mesh:
    """The mesh a spec names: distinct devices of `device`'s type unless
    `devices` lists them (see mesh.make_mesh)."""
    axes = parse_mesh_spec(spec)
    shape = tuple(axes.values())
    n = int(np.prod(shape))
    return M.make_mesh(n, tuple(axes), shape, device=device,
                       devices=devices)


def set_active_mesh(mesh: M.Mesh | None) -> None:
    global _ACTIVE
    _ACTIVE = mesh


def active_mesh() -> M.Mesh | None:
    return _ACTIVE


def spatial_size(mesh: M.Mesh | None = None) -> int:
    m = mesh or _ACTIVE
    if m is None or "spatial" not in m.axis_names:
        return 1
    return m.shape["spatial"]


# ---------------------------------------------------------------------------
# sharded scaler: vertical resize with output rows split over 'spatial'
# ---------------------------------------------------------------------------

def resize_v_sharded(x: torch.Tensor, m: np.ndarray, mesh: M.Mesh
                     ) -> torch.Tensor:
    """[..., H, W] x [H', H] -> [..., H', W], the H' output rows split
    over 'spatial'. Each shard takes the whole input and contracts its
    rows at full length; the bands are gathered on x's device. Whole on
    the caller's device where the rows do not divide, and on CUDA (see
    the module docstring)."""
    from librempeg_tpu_torch.ops.fir import _mat

    shards = mesh.along("spatial")
    n, dst = len(shards), m.shape[0]
    if dst % n or x.is_cuda:
        COUNTS["resize_v_whole"] += 1
        return torch.matmul(_mat(m, x), x)
    k = dst // n
    bands = []
    for s, sh in enumerate(shards):
        xs = M.to_shard(x, sh)
        with sh.ctx():
            y = torch.matmul(_mat(m, xs)[s * k:(s + 1) * k], xs)
        bands.append(M.from_shard(y, sh, x.device))
    COUNTS["resize_v"] += 1
    return torch.cat(bands, dim=-2)


# ---------------------------------------------------------------------------
# sharded MPEG-4 encode pass: row bands + search-range halo
# ---------------------------------------------------------------------------

def band_halo(search_range: int) -> int:
    """Luma halo rows of a band: the search reaches search_range rows
    and the half-pel refinement and its taps two more; rounded up to
    whole MB rows, since the half-pel kernel codes whole MBs of the
    planes it is given (the chroma takes half)."""
    return 16 * -(-(search_range + 2) // 16)


def _edge_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    """[H, W] -> [H + 2 pad, W], the first and last rows replicated."""
    return torch.cat([x[:1].expand(pad, -1), x, x[-1:].expand(pad, -1)])


def mpeg4_encode_p_sharded(y, u, v, ry, ru, rv, qscale: int,
                           search_range: int, mesh: M.Mesh,
                           trellis: bool = False) -> dict:
    """The P-VOP pass (codecs/mpeg4/encoder._encode_p_device) over
    'spatial' row bands.

    The picture is split into bands of whole MB rows. Each band takes its
    current rows, its reference rows plus band_halo(search_range) rows
    above and below (half that for the chroma), taken from the planes
    edge-replicated at the picture's top and bottom (what the
    single-device pass's clamp and pad read there), and its current
    chroma rows. On its shard it runs the integer search
    (ops.motion.full_search_mc_xla) and the half-pel kernel over its
    rows and halo, then the float64 spec DCT and the quantiser (or the
    trellis, whose blocks are independent) and the decoder's
    reconstruction over its own MBs. The bands' MVs, zigzag levels and
    recon are concatenated in raster order on y's device, in
    _encode_p_device's layout."""
    from librempeg_tpu_torch.codecs.mpeg4.encoder import _encode_p_device

    shards = mesh.along("spatial")
    n = len(shards)
    h = y.shape[0]
    if h % (16 * n):
        raise ValueError(f"{h} rows do not split into whole MB rows over "
                         f"spatial={n}")
    halo = band_halo(search_range)
    rows, rows_c, hc = h // n, h // (2 * n), halo // 2
    ry_p, ru_p, rv_p = (_edge_rows(ry, halo), _edge_rows(ru, hc),
                        _edge_rows(rv, hc))
    y_p = _edge_rows(y, halo)
    outs = []
    for s, sh in enumerate(shards):
        r0, c0 = s * rows, s * rows_c
        args = [M.to_shard(t, sh) for t in (
            y_p[r0:r0 + rows + 2 * halo], u[c0:c0 + rows_c],
            v[c0:c0 + rows_c], ry_p[r0:r0 + rows + 2 * halo],
            ru_p[c0:c0 + rows_c + 2 * hc], rv_p[c0:c0 + rows_c + 2 * hc])]
        with sh.ctx():
            o = _encode_p_device(*args, qscale, search_range, trellis,
                                 halo=halo)
        outs.append(o)

    def gather(get):
        return [M.from_shard(get(o), sh, y.device)
                for o, sh in zip(outs, shards)]

    out = {"mv": torch.cat(gather(lambda o: o["mv"]))}
    for p in "yuv":
        out[p] = (torch.cat(gather(lambda o: o[p][0])),
                  torch.cat(gather(lambda o: o[p][1])))
    COUNTS["p_pass"] += 1
    return out
