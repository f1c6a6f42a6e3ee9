"""More video filters: blurs, point ops, deinterlace, drawing.

Port of librempeg_tpu/filters/video2.py (vf_gblur.c, vf_boxblur.c,
vf_eq.c, vf_negate.c, vf_drawbox.c, vf_yadif.c's non-temporal mode,
vf_lut.c's lutyuv): plain tensor code on the frame's device.

Float forms. The JAX package runs a filter alone as eager jnp calls,
each rounding its result, and a chain of two or more PURE filters as
one XLA program (Filter.fused, set by mark_fused, which
FilterGraph.configure calls), whose CPU code folds constants and fuses
a multiply feeding an add into one multiply-add with one rounding:
eq's luma becomes fma(x - 128, c, 128 + b), gblur's sum fma(x0, k0,
k1*x1) and then fma(xt, kt, sum) tap by tap (tests/test_torch_filters2.py
reads these off the JAX package). The port takes the form the JAX
package takes in the same graph, an FMA computed as the float64 sum of
the exact float64 product and the addend, rounded once to float32
(_fma), so that the CPU and the card give the JAX package's samples.

boxblur takes the exact box mean: the uint8 samples summed in int32,
then one float32 division and floor(+0.5). The JAX package sums in a
float32 summed-area table, whose prefix sums pass 2^24 at 1920x1088 and
lose their low bits (ROADMAP section 3).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from librempeg_tpu_torch.core.eval_expr import eval_expr
from librempeg_tpu_torch.core.options import Option, OptionTable
from librempeg_tpu_torch.filters.filter import Filter, register_filter
from librempeg_tpu_torch.ops.fdiv import fdiv


def _fma(a, b, c) -> torch.Tensor:
    """float32 a * b + c with one rounding (computed in float64; see the
    module docstring)."""
    f64 = torch.float64
    a = a.to(f64) if isinstance(a, torch.Tensor) else float(a)
    b = b.to(f64) if isinstance(b, torch.Tensor) else float(b)
    c = c.to(f64) if isinstance(c, torch.Tensor) else float(c)
    return (a * b + c).to(torch.float32)


def mark_fused(nodes) -> None:
    """Set Filter.fused on every filter of a maximal run of two or more
    PURE 1-in/1-out video filters among a configured graph's nodes, in
    topological order: the chains the JAX package compiles into one XLA
    program (its graph's _fuse_chains; every such chain of the ported
    filters traces), whose float filters take the fused forms above."""
    used: set[int] = set()
    for node in nodes:
        ln = node.in_links[0] if len(node.in_links) == 1 else None
        if (id(node) in used or not node.filter.PURE
                or len(node.out_links) != 1 or ln is None
                or ln.props is None or ln.props.media != "video"):
            continue
        chain = [node]
        while True:
            ln = chain[-1].out_links[0]
            nxt = ln.dst if ln is not None else None
            if (nxt is None or not nxt.filter.PURE
                    or len(nxt.in_links) != 1 or len(nxt.out_links) != 1
                    or nxt.out_links[0] is None):
                break
            chain.append(nxt)
        used.update(id(n) for n in chain)
        if len(chain) >= 2:
            for n in chain:
                n.filter.fused = True


def _quant(y: torch.Tensor) -> torch.Tensor:
    """floor(y + 0.5) clipped to uint8 (the JAX package's _apply_planes)."""
    return torch.floor(y + 0.5).clamp(0, 255).to(torch.uint8)


def _apply_planes(frame, fn, luma_only=False):
    planes = []
    for i, p in enumerate(frame.planes):
        if luma_only and i > 0:
            planes.append(p)
            continue
        planes.append(_quant(fn(torch.as_tensor(p).to(torch.float32), i)))
    return frame.replace(planes=tuple(planes))


def _edge_pad2(x: torch.Tensor, r: int) -> torch.Tensor:
    return F.pad(x[None, None], (r, r, r, r), mode="replicate")[0, 0]


@register_filter
class GBlurFilter(Filter):
    NAME = "gblur"
    DESCRIPTION = "Apply Gaussian blur."
    PURE = True
    OPT_ORDER = ("sigma",)
    OPTIONS = OptionTable(
        Option("sigma", float, 0.5, min=0.0, max=1024.0),
        Option("steps", int, 1, min=1, max=6),
    )

    def filter_frame(self, frame, pad=0):
        sigma = self.opts["sigma"]
        if sigma <= 0:
            return [(0, frame)]
        radius = max(1, int(math.ceil(sigma * 3)))
        xs = np.arange(-radius, radius + 1)
        k = np.exp(-xs ** 2 / (2 * sigma * sigma)).astype(np.float32)
        k /= k.sum()
        taps = [float(t) for t in k]

        def tap_sum(win):
            """sum of taps[t] * win(t) over t, in the JAX sum's order"""
            if not self.fused:
                acc = win(0) * taps[0]
                for t in range(1, len(taps)):
                    acc = acc + win(t) * taps[t]
                return acc
            acc = _fma(win(0), taps[0], win(1) * taps[1])
            for t in range(2, len(taps)):
                acc = _fma(win(t), taps[t], acc)
            return acc

        def blur(x, i):
            h, w = x.shape
            xp = _edge_pad2(x, radius)
            # rows, then columns
            x1 = tap_sum(lambda t: xp[:, t:t + w])
            return tap_sum(lambda t: x1[t:t + h])

        return [(0, _apply_planes(frame, blur))]


@register_filter
class BoxBlurFilter(Filter):
    NAME = "boxblur"
    DESCRIPTION = "Blur the input with a box kernel."
    PURE = True
    OPT_ORDER = ("luma_radius",)
    OPTIONS = OptionTable(
        Option("luma_radius", str, "2", alias="lr"),
    )

    def filter_frame(self, frame, pad=0):
        r = int(eval_expr(str(self.opts["luma_radius"]),
                          {"w": frame.width, "h": frame.height}))
        if r <= 0:
            return [(0, frame)]
        n = 2 * r + 1
        planes = []
        for p in frame.planes:
            x = torch.as_tensor(p)
            h, w = x.shape
            # an edge-padded window sum in int32: at most n * n * 255
            xp = _edge_pad2(x.to(torch.float32), r).to(torch.int32)
            rows = xp.unfold(1, n, 1).sum(-1, dtype=torch.int32)
            s = rows.unfold(0, n, 1).sum(-1, dtype=torch.int32)
            planes.append(_quant(fdiv(s.to(torch.float32), float(n * n))))
        return [(0, frame.replace(planes=tuple(planes)))]


@register_filter
class EqFilter(Filter):
    NAME = "eq"
    DESCRIPTION = "Adjust brightness, contrast, saturation."
    PURE = True
    OPTIONS = OptionTable(
        Option("contrast", float, 1.0, min=-1000.0, max=1000.0),
        Option("brightness", float, 0.0, min=-1.0, max=1.0),
        Option("saturation", float, 1.0, min=0.0, max=3.0),
    )

    def filter_frame(self, frame, pad=0):
        c = float(np.float32(self.opts["contrast"]))
        b = float(np.float32(self.opts["brightness"] * 255.0))
        s = float(np.float32(self.opts["saturation"]))

        def fn(x, i):
            if not self.fused:
                if i == 0:
                    return (x - 128.0) * c + 128.0 + b
                return (x - 128.0) * s + 128.0
            if i == 0:
                return _fma(x - 128.0, c, float(np.float32(128.0 + b)))
            return _fma(x - 128.0, s, 128.0)

        return [(0, _apply_planes(frame, fn))]


@register_filter
class NegateFilter(Filter):
    NAME = "negate"
    DESCRIPTION = "Negate input video."
    PURE = True

    def filter_frame(self, frame, pad=0):
        return [(0, _apply_planes(frame, lambda x, i: 255.0 - x))]


@register_filter
class DrawBoxFilter(Filter):
    NAME = "drawbox"
    DESCRIPTION = "Draw a colored box on the input."
    OPT_ORDER = ("x", "y", "width", "height", "color", "thickness")
    OPTIONS = OptionTable(
        Option("x", str, "0"),
        Option("y", str, "0"),
        Option("width", str, "0", alias="w"),
        Option("height", str, "0", alias="h"),
        Option("color", str, "black", alias="c"),
        Option("thickness", int, 3, alias="t", min=1, max=64),
    )

    def filter_frame(self, frame, pad=0):
        from librempeg_tpu_torch.filters.video import _parse_color

        v = {"iw": frame.width, "ih": frame.height, "in_w": frame.width,
             "in_h": frame.height}
        x0 = int(eval_expr(str(self.opts["x"]), v))
        y0 = int(eval_expr(str(self.opts["y"]), v))
        w = int(eval_expr(str(self.opts["width"]), v)) or frame.width
        h = int(eval_expr(str(self.opts["height"]), v)) or frame.height
        t = self.opts["thickness"]
        fill = _parse_color(self.opts["color"], frame.format)
        d = frame.desc
        planes = []
        for i, p in enumerate(frame.planes):
            sx = d.planes[i].log2_chroma_w
            sy = d.planes[i].log2_chroma_h
            px, py = x0 >> sx, y0 >> sy
            pw, ph = w >> sx, h >> sy
            pt = max(1, t >> sx)
            arr = torch.as_tensor(p)
            yy = torch.arange(arr.shape[0], device=arr.device)[:, None]
            xx = torch.arange(arr.shape[1], device=arr.device)[None, :]
            inside = ((yy >= py) & (yy < py + ph)
                      & (xx >= px) & (xx < px + pw))
            interior = ((yy >= py + pt) & (yy < py + ph - pt)
                        & (xx >= px + pt) & (xx < px + pw - pt))
            val = fill[i] if i < len(fill) else 0
            planes.append(torch.where(inside & ~interior,
                                      torch.tensor(val, dtype=torch.uint8,
                                                   device=arr.device), arr))
        return [(0, frame.replace(planes=tuple(planes)))]


@register_filter
class DeinterlaceFilter(Filter):
    NAME = "yadif"
    DESCRIPTION = "Deinterlace (spatial check, send_frame mode)."
    PURE = True
    OPTIONS = OptionTable(
        Option("mode", int, 0, min=0, max=3),
    )

    def filter_frame(self, frame, pad=0):
        if not frame.interlaced:
            return [(0, frame)]

        def deint(x, i):
            # keep the top field, interpolate the bottom field's lines
            interp = (torch.roll(x, 1, 0) + torch.roll(x, -1, 0)) * 0.5
            rows = torch.arange(x.shape[0], device=x.device)[:, None]
            return torch.where(rows % 2 == 1, interp, x)

        out = _apply_planes(frame, deint)
        return [(0, out.replace(interlaced=False))]


@register_filter
class LutYuvFilter(Filter):
    NAME = "lutyuv"
    DESCRIPTION = "Apply expressions to YUV components."
    OPTIONS = OptionTable(
        Option("y", str, "val"),
        Option("u", str, "val"),
        Option("v", str, "val"),
    )

    def filter_frame(self, frame, pad=0):
        # 256-entry tables from the expressions, built on the host
        tables = [np.array([
            np.clip(eval_expr(self.opts[key], {"val": t, "maxval": 255,
                                               "minval": 0}), 0, 255)
            for t in range(256)], np.uint8) for key in ("y", "u", "v")]
        planes = []
        for i, p in enumerate(frame.planes):
            p = torch.as_tensor(p)
            t = torch.from_numpy(tables[min(i, 2)]).to(p.device)
            planes.append(t[p.long()])
        return [(0, frame.replace(planes=tuple(planes)))]
