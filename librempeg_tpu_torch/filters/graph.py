"""Filter graph: links, negotiation, scheduling.

Port of librempeg_tpu/filters/graph.py (analog of AVFilterGraph,
libavfilter/avfiltergraph.c:1605 avfilter_graph_config; scheduling FSM
avfilter.c:1507; endpoints buffersrc.c/buffersink.c), all of it but the
device fusion: the JAX package's FusedChain and _FusedAdapter compile
a run of PURE filters into one jax.jit program, and PyTorch runs
eagerly, so each filter here runs as its own node. configure still
marks the chains the JAX package fuses (video2.mark_fused), whose float
filters then take XLA's fused forms, and the runs of biquad filters
(biquads.mark_runs), each of which runs in one kernel launch a frame.

Simplifications vs the reference, by design:
* Scheduling is synchronous topological push (the reference's activate
  FSM exists to bound memory across threads; here frames are immutable
  tensors and stages are device calls, so a direct dataflow walk is
  correct).
* Negotiation is forward-propagating after a two-phase format pass
  (filters/negotiate.py): each filter fixes its output props from its
  inputs; explicit `format`/`aformat`/`scale`/`aresample` filters (and
  converters the negotiation inserts) do conversions.
* Multi-input filters that declare FRAMESYNC (overlay, psnr, ssim) get
  pts-aligned delivery: pad 0 is the primary, each secondary holds its
  last frame at or before the primary's time.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any

from librempeg_tpu_torch.core.errors import EndOfStream, InvalidData
from librempeg_tpu_torch.core.rational import NOPTS
from librempeg_tpu_torch.filters.filter import (
    Filter,
    PadDesc,
    SourceFilter,
    StreamProps,
    find_filter,
)
from librempeg_tpu_torch.filters.biquads import mark_runs
from librempeg_tpu_torch.filters.video2 import mark_fused

Frame = Any


@dataclass
class Link:
    src: "Node"
    src_pad: int
    dst: "Node | None" = None
    dst_pad: int = 0
    queue: deque = field(default_factory=deque)
    props: StreamProps | None = None
    eof: bool = False
    neg_fmt: str | None = None     # negotiated pixel/sample format
    held: object = None            # framesync: last consumed secondary


class Node:
    def __init__(self, filt: Filter, name: str = ""):
        self.filter = filt
        self.name = name or filt.NAME
        self.in_links: list[Link | None] = [None] * len(filt.INPUTS)
        self.out_links: list[Link | None] = [None] * len(filt.OUTPUTS)

    def __repr__(self):
        return f"<Node {self.name}>"


class FilterGraph:
    """Build with add()/link(), or from a graph description string."""

    def __init__(self):
        self.nodes: list[Node] = []
        self._configured = False

    # -- construction -------------------------------------------------
    def add(self, name: str, args: str = "", **opts) -> Node:
        node = Node(find_filter(name)(args, **opts))
        self.nodes.append(node)
        return node

    def add_instance(self, filt: Filter, name: str = "") -> Node:
        node = Node(filt, name)
        self.nodes.append(node)
        return node

    def link(self, src: Node, src_pad: int, dst: Node, dst_pad: int) -> None:
        ln = Link(src=src, src_pad=src_pad, dst=dst, dst_pad=dst_pad)
        if src.out_links[src_pad] is not None:
            raise InvalidData(f"{src}: output pad {src_pad} already linked")
        if dst.in_links[dst_pad] is not None:
            raise InvalidData(f"{dst}: input pad {dst_pad} already linked")
        src.out_links[src_pad] = ln
        dst.in_links[dst_pad] = ln

    # -- configuration ------------------------------------------------
    def _topo(self) -> list[Node]:
        order: list[Node] = []
        seen: set[int] = set()

        def visit(n: Node):
            if id(n) in seen:
                return
            seen.add(id(n))
            for ln in n.in_links:
                if ln is not None:
                    visit(ln.src)
            order.append(n)

        for n in self.nodes:
            visit(n)
        return order

    def configure(self) -> None:
        """Negotiate link properties (avfilter_graph_config analog):
        two-phase format resolution with converter auto-insertion
        (filters/negotiate.py), then the forward property pass."""
        from librempeg_tpu_torch.filters.negotiate import negotiate

        negotiate(self)
        for n in self._topo():
            in_props = []
            for ln in n.in_links:
                if ln is None:
                    raise InvalidData(f"{n}: unconnected input pad")
                if ln.props is None:
                    raise InvalidData(f"{n}: upstream props not set")
                in_props.append(ln.props)
            # converters must land on the negotiated downstream format
            if n.filter.CONVERTS and n.out_links and \
                    n.out_links[0] is not None and \
                    n.out_links[0].neg_fmt:
                n.filter._forced_format = n.out_links[0].neg_fmt
            outs = n.filter.configure(in_props)
            for pad, ln in enumerate(n.out_links):
                if ln is not None:
                    ln.props = outs[pad]
        mark_fused(self._topo())
        mark_runs(self._topo())
        self._configured = True

    # -- execution ----------------------------------------------------
    def _deliver(self, node: Node, outputs) -> None:
        for pad, frame in outputs:
            ln = node.out_links[pad]
            if ln is not None and ln.dst is not None:
                ln.queue.append(frame)

    def _ready(self, node: Node) -> bool:
        links = [ln for ln in node.in_links if ln is not None]
        if not links:
            return False
        if len(links) == 1:
            return bool(links[0].queue)
        # multi-input: need one frame on every non-EOF input
        return all(ln.queue or ln.eof for ln in links) and any(
            ln.queue for ln in links)

    @staticmethod
    def _ts(frame) -> float:
        if frame.pts is None or frame.pts == NOPTS:
            return 0.0
        tb = frame.time_base
        if tb is not None and getattr(tb, "valid", False) and tb.num:
            return frame.pts * tb.num / tb.den
        return float(frame.pts)

    def _run_framesync(self, node: Node, final: bool = False) -> bool:
        """pts-aligned delivery for FRAMESYNC filters (framesync.c
        analog): pad 0 is the primary; each secondary supplies its most
        recent frame with ts <= the primary's ts (hold-last), falling
        back to its first frame before coverage starts."""
        progress = False
        prim = node.in_links[0]
        secs = [ln for ln in node.in_links[1:] if ln is not None]
        while prim.queue:
            t = self._ts(prim.queue[0])
            ready = True
            frames = [None] * len(node.in_links)
            for ln in secs:
                # advance: consume frames that are superseded at time t
                while (len(ln.queue) >= 2
                       and self._ts(ln.queue[1]) <= t):
                    ln.held = ln.queue.popleft()
                if ln.queue and self._ts(ln.queue[0]) <= t:
                    ln.held = ln.queue.popleft() if (
                        len(ln.queue) >= 2 or ln.eof or final) \
                        else ln.queue[0]
                cur = ln.held if ln.held is not None else (
                    ln.queue[0] if ln.queue else None)
                if cur is None:
                    if ln.eof or final:
                        ready = False  # nothing ever arrived: drop sync
                        break
                    return progress    # wait for secondary data
                frames[node.in_links.index(ln)] = cur
            if not ready:
                break
            frames[0] = prim.queue.popleft()
            self._deliver(node, node.filter.filter_frames(frames))
            progress = True
        return progress

    def run(self, final: bool = False) -> None:
        """Drain every runnable node (one sweep to fixpoint)."""
        if not self._configured:
            self.configure()
        progress = True
        order = self._topo()
        while progress:
            progress = False
            for node in order:
                links = [ln for ln in node.in_links if ln is not None]
                if not links:
                    continue
                if len(links) > 1 and node.filter.FRAMESYNC:
                    progress |= self._run_framesync(node, final)
                    continue
                if len(links) == 1:
                    while links[0].queue:
                        frame = links[0].queue.popleft()
                        self._deliver(node, node.filter.filter_frame(frame, 0))
                        progress = True
                else:
                    while self._ready(node):
                        for pad, ln in enumerate(node.in_links):
                            if ln is None:
                                continue
                            if ln.queue:
                                frame = ln.queue.popleft()
                                self._deliver(
                                    node, node.filter.filter_frame(frame, pad))
                        progress = True

    def flush(self) -> None:
        if not self._configured:
            self.configure()
        self.run()
        for node in self._topo():
            for ln in node.in_links:
                if ln is not None:
                    ln.eof = True
            if node.filter.FRAMESYNC and len(
                    [x for x in node.in_links if x is not None]) > 1:
                self._run_framesync(node, final=True)
                for ln in node.in_links:   # drop unsynced stragglers
                    if ln is not None:
                        ln.queue.clear()
            else:
                # multi-input nodes only fire in run() when EVERY pad
                # has a frame; at EOF the stragglers must still be
                # delivered or tail frames vanish.
                for pad, ln in enumerate(node.in_links):
                    if ln is None:
                        continue
                    while ln.queue:
                        self._deliver(node, node.filter.filter_frame(
                            ln.queue.popleft(), pad))
            self._deliver(node, node.filter.flush())
            self.run(final=True)

    def pump_sources(self) -> bool:
        """Request one frame from every in-graph source filter. Returns
        False when all sources hit EOF."""
        if not self._configured:
            self.configure()
        got = False
        for node in self.nodes:
            f = node.filter
            if isinstance(f, SourceFilter) and not isinstance(
                    f, BufferSource) and not getattr(node, "src_eof", False):
                try:
                    frame = f.request_frame()
                except EndOfStream:
                    node.src_eof = True
                    continue
                ln = node.out_links[0]
                if ln is not None:
                    ln.queue.append(frame)
                got = True
        self.run()
        return got


class BufferSource(SourceFilter):
    """App -> graph frame injection (buffersrc.c analog)."""

    NAME = "buffer"
    OUTPUTS = (None,)

    def __init__(self, props: StreamProps):
        Filter.__init__(self)
        self._props = props
        self.OUTPUTS = (PadDesc("default", props.media),)
        self.out_props = [props]

    def configure(self, in_props):
        self.out_props = [self._props]
        return self.out_props


class BufferSink(Filter):
    """Graph -> app frame extraction (buffersink.c analog)."""

    NAME = "buffersink"
    OUTPUTS = ()

    def __init__(self, media: str = "video"):
        Filter.__init__(self)
        self.INPUTS = (PadDesc("default", media),)
        self.frames: deque = deque()

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = []
        return []

    def filter_frame(self, frame, pad=0):
        self.frames.append(frame)
        return []

    @property
    def props(self) -> StreamProps:
        return self.in_props[0]


class GraphRunner:
    """A graph description with one or more buffer sources and one sink.

    graph = GraphRunner("scale=1280:720", src_props)
    graph = GraphRunner("[in][in2]psnr", [main_props, ref_props])
    graph = GraphRunner("showwaves=s=1280x240", audio_props)
    for out in graph.push(frame, input_index): ...
    for out in graph.finish(): ...

    The sink takes its media from the last filter's output pad, so a
    graph whose media changes (showwaves: audio in, video out) needs no
    more than its description.
    """

    def __init__(self, description: str, src_props: StreamProps | list,
                 sample_fmt: str | None = None):
        """sample_fmt: the integer sample format the graph's consumer
        (an audio encoder) quantises to, None for a float consumer; a
        filter that requantises (aresample's dither_method) binds it
        before negotiation."""
        from librempeg_tpu_torch.filters.parser import build_graph

        if isinstance(src_props, StreamProps):
            src_props = [src_props]
        self.graph = FilterGraph()
        self.sources = [self.graph.add_instance(BufferSource(p), f"in{i}")
                        for i, p in enumerate(src_props)]
        (self.entry_nodes, self.exit_node, self.exit_pad) = build_graph(
            self.graph, description, self.sources)
        media = (self.exit_node.filter.OUTPUTS[self.exit_pad].media
                 if self.exit_node.filter.OUTPUTS else src_props[0].media)
        self.sink = BufferSink(media)
        sink_node = self.graph.add_instance(self.sink, "out")
        self.graph.link(self.exit_node, self.exit_pad, sink_node, 0)
        for node in self.graph.nodes:
            bind = getattr(node.filter, "bind_sample_fmt", None)
            if bind is not None:
                bind(sample_fmt)
        self.graph.configure()

    @property
    def output_props(self) -> StreamProps:
        return self.sink.props

    def push(self, frame: Frame, input_index: int = 0) -> list[Frame]:
        self.sources[input_index].out_links[0].queue.append(frame)
        self.graph.run()
        out = list(self.sink.frames)
        self.sink.frames.clear()
        return out

    def finish(self) -> list[Frame]:
        self.graph.flush()
        out = list(self.sink.frames)
        self.sink.frames.clear()
        return out
