"""Sequence-parallel audio resampling.

Port of librempeg_tpu/parallel/sp_audio.py: the sample axis is split
over the shards of a mesh axis, each shard resamples its span after
taking the bank's halo of samples from its ring neighbours (zeros at
the stream's ends), the overlap-save structure made multi-device. The
halo exchange is a copy between shards (mesh.py's device model); the
product is the port's resampler GEMM (resample/resampler._resample_gemm)
over its bank matrix. The JAX package replicates the span over the
mesh's other axes; the port runs it once, on the shards at index 0 of
them.
"""
from __future__ import annotations

import torch

from librempeg_tpu_torch.parallel.mesh import Mesh, from_shard, to_shard
from librempeg_tpu_torch.resample.resampler import Resampler, _resample_gemm


def make_sharded_resampler(r: Resampler, mesh: Mesh, axis: str = "spatial"):
    """Returns fn(x: [C, S]) -> [C, S * p // q] on x's device, the
    sample axis split over `axis`. S must be divisible by q * axis size;
    the output equals r.process(x) then r.flush() of a fresh Resampler,
    but for the float sums' order."""
    L, p = r._m.shape
    q = r.q
    left = r.left_pad
    right = L - q - left           # samples needed beyond the local span
    shards = mesh.along(axis)
    n = len(shards)

    def fn(x: torch.Tensor) -> torch.Tensor:
        c, total = x.shape
        if total % (q * n):
            raise ValueError(f"{total} samples do not split into whole "
                             f"periods of {q} over {axis}={n}")
        span = total // n
        if max(left, right) > span:
            raise ValueError(f"a span of {span} samples is shorter than "
                             f"the bank's halo")
        xs = x.to(torch.float32)
        blocks = [to_shard(xs[:, i * span:(i + 1) * span], sh)
                  for i, sh in enumerate(shards)]
        outs = []
        for i, sh in enumerate(shards):
            # left_pad samples from the left neighbour, `right` from the
            # right one; zeros at the stream's ends
            lo = to_shard(blocks[i - 1][:, -left:], sh, shards[i - 1]) \
                if left and i else None
            hi = to_shard(blocks[i + 1][:, :right], sh, shards[i + 1]) \
                if right > 0 and i < n - 1 else None
            m = to_shard(r._m, sh)
            with sh.ctx():
                parts = [blocks[i]]
                if left:
                    parts.insert(0, lo if lo is not None
                                 else blocks[i].new_zeros((c, left)))
                if right > 0:
                    parts.append(hi if hi is not None
                                 else blocks[i].new_zeros((c, right)))
                y = _resample_gemm(torch.cat(parts, dim=1), m, q, span // q)
            outs.append(from_shard(y, sh, x.device))
        return torch.cat(outs, dim=1)

    return fn
