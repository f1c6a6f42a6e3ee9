"""Cross-device stage pipelining (pipeline parallelism).

Port of librempeg_tpu/parallel/stagepipe.py: pipeline stages live on
successive shards along a mesh axis and microbatches of frames flow
through the ring, so stage s works on microbatch m while stage s-1
already works on microbatch m+1 (a GPipe-style schedule). The JAX
package runs it as one shard_map'ed fori_loop in which every device
selects its stage with lax.switch and hands its output on with
ppermute; here one process issues each step's stages on their shards'
streams and the hand-off is a copy to the next shard (mesh.py's device
model). A stage whose microbatch index is out of range at a step (the
ring filling and draining) is not run; the JAX package runs it on zeros
and drops the result. The JAX package replicates the pipeline over the
mesh's other axes; the port runs it once, on the shards at index 0 of
them.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from librempeg_tpu_torch.parallel.mesh import Mesh, from_shard, to_shard


def ring_pipeline(stage_fns: Sequence[Callable[[torch.Tensor],
                                               torch.Tensor]],
                  mesh: Mesh, axis: str = "stage"):
    """Build a pipelined map over microbatches.

    stage_fns: one function per pipeline stage (each [mb, ...] -> the
    same shape). Returns fn(x: [n_micro, mb, ...]) -> [n_micro, mb, ...]
    on x's device, each microbatch passed through all stages in order,
    stage s on the s-th shard along `axis`."""
    n_stages = len(stage_fns)
    assert mesh.shape[axis] == n_stages, (
        f"pipeline needs exactly one device per stage: axis {axis} has "
        f"{mesh.shape[axis]} devices for {n_stages} stages "
        f"(pad with identity stages)")
    shards = mesh.along(axis)

    def run(x: torch.Tensor) -> torch.Tensor:
        n_micro = x.shape[0]
        carry = [None] * n_stages        # the input waiting at each stage
        outputs = [None] * n_micro
        for t in range(n_micro + n_stages - 1):
            done = [None] * n_stages
            for s, sh in enumerate(shards):
                m = t - s                # the microbatch stage s takes
                if not 0 <= m < n_micro:
                    continue
                inp = to_shard(x[m], sh) if s == 0 else carry[s]
                with sh.ctx():
                    done[s] = stage_fns[s](inp)
            # hand off over the ring; the last stage's output is finished
            for s, out in enumerate(done):
                if out is None:
                    continue
                if s == n_stages - 1:
                    outputs[t - s] = from_shard(out, shards[s], x.device)
                else:
                    carry[s + 1] = to_shard(out, shards[s + 1], shards[s])
        return torch.stack(outputs)

    return run
