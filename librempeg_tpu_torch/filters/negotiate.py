"""Two-phase link format negotiation (avfiltergraph.c:1605 analog,
re-architected for static graphs).

A copy of librempeg_tpu/filters/negotiate.py (host code, no JAX) with
its imports rewritten.

Phase 1 groups links into format variables: every chain of links joined
through a non-converting filter must carry ONE format, so constraints
propagate both directions (a `format=rgb24` downstream of `overlay`
reaches back through the overlay to its upstream inputs). Converting
filters (CONVERTS=True: scale/format/aformat/aresample) are group
boundaries. Phase 2 intersects each group's constraints (declared
in_formats/out_formats plus hard endpoint formats); an empty
intersection auto-inserts a converter on the offending link and
negotiation reruns. Chosen formats are pinned on the links, and
converters are forced to produce them (`_forced_format`).

Formats are pix_fmts for video links and sample_fmts for audio links.
"""
from __future__ import annotations

from librempeg_tpu_torch.core.errors import InvalidData


class _Group:
    def __init__(self):
        self.links = []
        self.allowed = None        # None = unconstrained, else set
        self.hard = []             # fixed formats (sources/sinks)
        self.constraints = []      # (link, set) in discovery order
        self.pref_order = None     # declared order of the 1st constraint

    def intersect(self, fmts, link):
        if fmts is None:
            return True
        order = list(fmts)
        fmts = set(order)
        self.constraints.append((link, fmts))
        if self.pref_order is None:
            self.pref_order = order     # first constrainer's preference
        if self.allowed is None:
            self.allowed = fmts
            return True
        new = self.allowed & fmts
        if not new:
            return False
        self.allowed = new
        return True


def _fmt_of(props):
    return props.pix_fmt if props.media == "video" else props.sample_fmt


def negotiate(graph) -> int:
    """Assign `neg_fmt` to every link; returns the number of converters
    auto-inserted. Call before the forward configure pass."""
    inserted = 0
    for _ in range(len(graph.nodes) * 2 + 4):     # bounded reruns
        conflict = _negotiate_once(graph)
        if conflict is None:
            return inserted
        _insert_converter(graph, conflict)
        inserted += 1
    raise InvalidData("format negotiation did not converge")


def _link_list(graph):
    links = []
    for node in graph.nodes:
        for ln in node.out_links:
            if ln is not None and ln not in links:
                links.append(ln)
    return links


def _negotiate_once(graph):
    """One grouping+intersection pass. Returns None on success or the
    link where constraints conflict."""
    links = _link_list(graph)
    # union-find over links
    parent = {id(ln): ln for ln in links}

    def find(ln):
        while parent[id(ln)] is not ln:
            parent[id(ln)] = parent[id(parent[id(ln)])]
            ln = parent[id(ln)]
        return ln

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra is not rb:
            parent[id(ra)] = rb

    for node in graph.nodes:
        f = node.filter
        if f.CONVERTS:
            continue
        pads = [ln for ln in list(node.in_links) + list(node.out_links)
                if ln is not None]
        for a, b in zip(pads, pads[1:]):
            if (a.props is None or b.props is None
                    or a.props.media == b.props.media):
                union(a, b)

    groups: dict[int, _Group] = {}
    for ln in links:
        g = groups.setdefault(id(find(ln)), _Group())
        g.links.append(ln)

    from librempeg_tpu_torch.filters.graph import BufferSink, BufferSource

    for g in groups.values():
        for ln in g.links:
            src_f = ln.src.filter if ln.src is not None else None
            dst_f = ln.dst.filter if ln.dst is not None else None
            if isinstance(src_f, BufferSource):
                fmt = _fmt_of(src_f._props)
                if fmt:
                    g.hard.append(fmt)
                    if not g.intersect({fmt}, ln):
                        return ln
            elif src_f is not None:
                pad = list(ln.src.out_links).index(ln)
                if not g.intersect(src_f.out_formats(pad), ln):
                    return ln
            if dst_f is not None and not isinstance(dst_f, BufferSink):
                pad = list(ln.dst.in_links).index(ln)
                if not g.intersect(dst_f.in_formats(pad), ln):
                    return ln
        # choose the concrete format
        if g.allowed is None:
            chosen = g.hard[0] if g.hard else None
        else:
            hard_ok = [h for h in g.hard if h in g.allowed]
            if hard_ok:
                chosen = hard_ok[0]
            else:
                # honor the first constrainer's declared preference order
                # (e.g. overlay prefers yuv420p, never gray) rather than
                # an arbitrary alphabetical pick
                pref = [f for f in (g.pref_order or []) if f in g.allowed]
                chosen = pref[0] if pref else sorted(g.allowed)[0]
            if g.hard and not hard_ok:
                # a fixed source format conflicts with the constraints:
                # converter needed right after the source
                return g.constraints[0][0] if g.constraints else g.links[0]
        for ln in g.links:
            ln.neg_fmt = chosen
    return None


def _insert_converter(graph, link) -> None:
    """Insert a format/aformat converter node on `link` (the
    auto-insertion of avfiltergraph.c, but at the precise conflict)."""
    from librempeg_tpu_torch.filters.filter import find_filter
    from librempeg_tpu_torch.filters.graph import Link

    if link.dst is not None and link.dst.filter.INPUTS:
        media = link.dst.filter.INPUTS[link.dst_pad].media
    elif link.props is not None:
        media = link.props.media
    else:
        media = "video"
    if media == "video":
        conv = find_filter("autoformat")()
    else:
        conv = find_filter("aresample")()
    node = graph.add_instance(conv, name=f"auto_conv_{id(link) & 0xffff}")
    # splice: src -> conv -> dst
    dst, dst_pad = link.dst, link.dst_pad
    link.dst = node
    link.dst_pad = 0
    node.in_links[0] = link
    nl = Link(src=node, src_pad=0, dst=dst, dst_pad=dst_pad)
    nl.props = link.props.copy() if link.props is not None else None
    node.out_links[0] = nl
    dst.in_links[dst_pad] = nl
