"""Filter chains of the slice.

Port of GraphRunner from librempeg_tpu/filters/graph.py, for linear
chains of single-input, single-output filters (the null/scale chains
the transcode inserts). Frames are pushed through the chain in order;
the JAX package's FusedChain jit has no counterpart, since PyTorch runs
eagerly.
"""
from __future__ import annotations

from typing import Any

from librempeg_tpu_torch.core.errors import Unsupported
from librempeg_tpu_torch.filters.filter import StreamProps, find_filter
from librempeg_tpu_torch.filters.parser import parse_description

Frame = Any


class GraphRunner:
    """One input chain -> one output.

    graph = GraphRunner("scale=1280:720", src_props)
    for out in graph.push(frame): ...
    for out in graph.finish(): ...
    """

    def __init__(self, description: str, src_props: StreamProps):
        chains = parse_description(description)
        if len(chains) != 1 or any(f.in_labels or f.out_labels
                                   for f in chains[0]):
            raise Unsupported("filter graph: only one linear chain of "
                              "filters is ported")
        self.filters = [find_filter(f.name)(f.args) for f in chains[0]]
        props = [src_props]
        for f in self.filters:
            props = f.configure(props)
        self._out_props = props[0]

    @property
    def output_props(self) -> StreamProps:
        return self._out_props

    def _run(self, frames, step):
        for f in self.filters:
            nxt = []
            for fr in frames:
                nxt.extend(fr2 for _, fr2 in f.filter_frame(fr))
            nxt.extend(fr2 for _, fr2 in step(f))
            frames = nxt
        return frames

    def push(self, frame: Frame) -> list[Frame]:
        return self._run([frame], lambda f: ())

    def finish(self) -> list[Frame]:
        return self._run([], lambda f: f.flush())
