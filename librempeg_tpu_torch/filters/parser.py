"""Filter graph description parser.

Analog of libavfilter/graphparser.c: the textual
language ``[in]scale=640:480,format=rgb24[mid];[mid][logo]overlay[out]``
— chains separated by ';', filters by ',', links in '[...]' labels,
filter arguments after '='. Escaping: '\\' quotes the next char inside
arguments.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from librempeg_tpu_torch.core.errors import InvalidData


@dataclass
class ParsedFilter:
    name: str
    args: str
    in_labels: list[str] = field(default_factory=list)
    out_labels: list[str] = field(default_factory=list)


def parse_description(desc: str) -> list[list[ParsedFilter]]:
    """Parse into chains of filters."""
    chains: list[list[ParsedFilter]] = []
    for chain_str in _split_unescaped(desc.strip(), ";"):
        chain_str = chain_str.strip()
        if not chain_str:
            continue
        chain: list[ParsedFilter] = []
        for filt_str in _split_unescaped(chain_str, ","):
            chain.append(_parse_filter(filt_str.strip()))
        chains.append(chain)
    return chains


def _split_unescaped(s: str, sep: str) -> list[str]:
    out, cur, esc, depth = [], [], False, 0
    for ch in s:
        if esc:
            cur.append(ch)
            esc = False
        elif ch == "\\":
            cur.append(ch)
            esc = True
        elif ch == "'":
            depth ^= 1
            cur.append(ch)
        elif ch == sep and not depth:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out


def _parse_filter(s: str) -> ParsedFilter:
    in_labels = []
    while s.startswith("["):
        end = s.index("]")
        in_labels.append(s[1:end])
        s = s[end + 1:].strip()
    out_labels = []
    while s.endswith("]"):
        start = s.rindex("[")
        out_labels.insert(0, s[start + 1:-1])
        s = s[:start].strip()
    if "=" in s:
        name, args = s.split("=", 1)
    else:
        name, args = s, ""
    name = name.strip()
    if not name:
        raise InvalidData(f"empty filter name in {s!r}")
    # strip quoting
    args = args.replace("'", "")
    return ParsedFilter(name, args, in_labels, out_labels)


def build_graph(graph, description: str, sources: list):
    """Instantiate a parsed description into `graph`.

    sources: list of source Nodes (their outputs feed unlabeled/["in"/
    "0:v"-style] dangling chain inputs, in order).
    Returns (entry_nodes, exit_node, exit_pad) where exit is the single
    dangling output (or labeled [out]).
    """
    chains = parse_description(description)
    if not chains:
        raise InvalidData("empty filter graph")

    labels: dict[str, tuple] = {}   # label -> (node, pad) pending output
    src_iter = iter(sources)
    dangling_out = []
    entry_nodes = []

    def next_source():
        try:
            return next(src_iter)
        except StopIteration:
            raise InvalidData("filter graph needs more inputs than given")

    for chain in chains:
        prev: tuple | None = None
        for i, pf in enumerate(chain):
            node = graph.add(pf.name, pf.args)
            n_in = len(node.filter.INPUTS)
            # connect inputs
            wired = 0
            if pf.in_labels:
                for pad, lbl in enumerate(pf.in_labels):
                    if lbl in labels and labels[lbl][0] != "want_in":
                        s_node, s_pad = labels.pop(lbl)
                        graph.link(s_node, s_pad, node, pad)
                    else:
                        # maybe an output defined by a later chain, maybe
                        # a graph input — resolved after all chains
                        labels[lbl] = ("want_in", node, pad)
                    wired += 1
            if prev is not None and wired < n_in:
                graph.link(prev[0], prev[1], node, wired)
                wired += 1
            while wired < n_in:
                src = next_source()
                graph.link(src, 0, node, wired)
                wired += 1
            if prev is None and n_in:
                entry_nodes.append(node)
            # outputs
            if pf.out_labels:
                for pad, lbl in enumerate(pf.out_labels):
                    pending = labels.get(lbl)
                    if pending and pending[0] == "want_in":
                        _, d_node, d_pad = pending
                        labels.pop(lbl)
                        graph.link(node, pad, d_node, d_pad)
                    else:
                        labels[lbl] = (node, pad)
                prev = None
                if i == len(chain) - 1:
                    continue
                raise InvalidData(
                    f"filter {pf.name}: labeled outputs mid-chain")
            else:
                if len(node.filter.OUTPUTS) > 0:
                    prev = (node, 0)
                else:
                    prev = None
        if prev is not None:
            dangling_out.append(prev)

    # unresolved input labels are graph inputs, wired to sources in order
    for lbl in list(labels):
        v = labels[lbl]
        if isinstance(v[0], str) and v[0] == "want_in":
            _, d_node, d_pad = v
            labels.pop(lbl)
            src = next_source()
            graph.link(src, 0, d_node, d_pad)

    # resolve the exit: labeled [out] wins, else the single dangling output
    if "out" in labels and not isinstance(labels["out"][0], str):
        exit_node, exit_pad = labels.pop("out")
    elif len(dangling_out) == 1:
        exit_node, exit_pad = dangling_out[0]
    elif len(dangling_out) == 0 and len(labels) == 1:
        (exit_node, exit_pad), = [v for v in labels.values()
                                  if not isinstance(v[0], str)]
    else:
        raise InvalidData(
            f"cannot determine graph output (dangling={len(dangling_out)}, "
            f"labels={list(labels)})")
    return entry_nodes, exit_node, exit_pad
