"""drawtext filter with a built-in TrueType rasterizer.

Port of librempeg_tpu/filters/drawtext.py. The reference's
vf_drawtext.c renders through freetype; here glyph outlines come from
the port's own TrueType reader (filters/_ttf.py: the tables the JAX
package reads through fontTools, which the port does not need), get
flattened to polygons and scanline-filled with the nonzero winding
rule at 4x supersampling, then box-downsampled to an antialiased
coverage map. Rendering happens once per unique text string (frame
counters and timestamps re-render per frame); blending is a plain
alpha composite onto the yuv/gray planes with chroma subsampling.

Text expansion supports the common vf_drawtext sequences: %{n} (frame
index), %{pts} / %{pts\\:hms}, and %% for a literal percent.

The coverage is rendered on the host, as in the JAX package; the blend
runs on the frame's device over the touched rectangle only (blend),
with the JAX package's float32 operations one at a time and in its
order, so the planes are bit-exact with its host blend.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from librempeg_tpu_torch.core.eval_expr import eval_expr
from librempeg_tpu_torch.core.options import Option, OptionTable
from librempeg_tpu_torch.filters import _ttf
from librempeg_tpu_torch.filters.filter import Filter, register_filter

_DEFAULT_FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf"
_SS = 4                                     # supersampling factor


def font_path(fontfile: str) -> str:
    """The font drawtext reads: `fontfile`, else the default font (as
    the JAX package falls back); neither present raises."""
    for path in (fontfile, _DEFAULT_FONT):
        if path and os.path.exists(path):
            return path
    raise FileNotFoundError(f"drawtext: no font at {fontfile!r} nor at the "
                            f"default {_DEFAULT_FONT!r}")


def _glyph_contours(font: _ttf.TrueTypeFont, ch: str):
    """Flattened contours (list of [N, 2] arrays in font units) plus
    the advance width for one character."""
    gid = font.glyph_id(ch)
    advance = font.advances[gid]
    glyph = font.glyph(gid)
    contours = []
    if glyph.number_of_contours > 0:
        contours = _outline(glyph, 0, 0)
    elif glyph.is_composite():
        for sub_id, dx, dy in glyph.components:
            sub = font.glyph(sub_id)
            if sub.number_of_contours <= 0:
                continue
            contours += _outline(sub, dx, dy)
    return contours, advance


def _outline(glyph: _ttf.Glyph, dx: int, dy: int) -> list:
    """A simple glyph's contours, offset by (dx, dy), flattened."""
    out, start = [], 0
    for end in glyph.end_pts:
        pts = [((glyph.coords[i][0] + dx, glyph.coords[i][1] + dy),
                bool(glyph.flags[i]))
               for i in range(start, end + 1)]
        out.append(_flatten_quadratic(pts))
        start = end + 1
    return out


def _flatten_quadratic(pts, steps=8):
    """TrueType contour (points + on-curve flags) -> polyline. Implied
    on-curve midpoints between consecutive off-curve points."""
    # normalize to start on-curve
    n = len(pts)
    if n == 0:
        return np.zeros((0, 2))
    onidx = next((i for i, (_, on) in enumerate(pts) if on), None)
    if onidx is None:                        # all off-curve: midpoints
        mids = [(((pts[i][0][0] + pts[(i + 1) % n][0][0]) / 2,
                  (pts[i][0][1] + pts[(i + 1) % n][0][1]) / 2), True)
                for i in range(n)]
        inter = []
        for i in range(n):
            inter.append(mids[i])
            inter.append(pts[(i + 1) % n])
        pts = inter
        n = len(pts)
        onidx = 0
    pts = pts[onidx:] + pts[:onidx]
    out = [pts[0][0]]
    i = 1
    t = np.linspace(0.0, 1.0, steps + 1)[1:]
    closed = pts + [pts[0]]
    while i < len(closed):
        p, on = closed[i]
        if on:
            out.append(p)
            i += 1
        else:
            # quadratic: previous on (or implied), control p, next
            nxt, non = closed[i + 1] if i + 1 < len(closed) else \
                closed[0]
            if not non:
                nxt = ((p[0] + nxt[0]) / 2, (p[1] + nxt[1]) / 2)
                step = 1
            else:
                step = 2
            p0 = np.array(out[-1], np.float64)
            p1 = np.array(p, np.float64)
            p2 = np.array(nxt, np.float64)
            curve = ((1 - t)[:, None] ** 2 * p0
                     + 2 * ((1 - t) * t)[:, None] * p1
                     + (t ** 2)[:, None] * p2)
            out.extend(map(tuple, curve))
            i += step
    return np.array(out, np.float64)


def _rasterize(contours, scale, w, h, ox, oy):
    """Nonzero-winding scanline fill at supersampled resolution;
    contours in font units, y-up. Returns [h, w] float coverage."""
    W, H = w * _SS, h * _SS
    cov = np.zeros((H, W), np.float32)
    segs = []
    for c in contours:
        if len(c) < 2:
            continue
        p = c * scale * _SS
        p[:, 0] += ox * _SS
        p[:, 1] = H - (p[:, 1] + oy * _SS)   # flip to y-down
        a = p
        b = np.roll(p, -1, axis=0)
        segs.append((a, b))
    if not segs:
        return np.zeros((h, w), np.float32)
    A = np.concatenate([s[0] for s in segs])
    B = np.concatenate([s[1] for s in segs])
    ys = np.arange(H) + 0.5
    # for each scanline, crossings with winding direction
    y0 = A[:, 1]
    y1 = B[:, 1]
    for yi, y in enumerate(ys):
        m = ((y0 <= y) & (y1 > y)) | ((y1 <= y) & (y0 > y))
        if not m.any():
            continue
        xa, xb = A[m, 0], B[m, 0]
        ya, yb = y0[m], y1[m]
        xs = xa + (y - ya) * (xb - xa) / (yb - ya)
        wind = np.where(yb > ya, 1, -1)
        order = np.argsort(xs)
        xs = xs[order]
        acc = np.cumsum(wind[order])
        inside = acc != 0
        row = cov[yi]
        for k in range(len(xs) - 1):
            if inside[k]:
                a = max(int(np.ceil(xs[k] - 0.5)), 0)
                b = min(int(np.ceil(xs[k + 1] - 0.5)), W)
                if b > a:
                    row[a:b] = 1.0
    # box downsample
    cov = cov.reshape(h, _SS, w, _SS).mean(axis=(1, 3))
    return cov


@functools.lru_cache(maxsize=512)
def _glyph_bitmap(fontfile: str, ch: str, size: int):
    """Rendered coverage bitmap + metrics for one glyph at `size` px.
    Returns (cov [gh, gw], advance_px, ascent_px)."""
    font = _ttf.load(fontfile)
    upm = font.units_per_em
    asc = font.ascent
    desc = font.descent
    scale = size / upm
    contours, advance = _glyph_contours(font, ch)
    gw = max(int(np.ceil(advance * scale)), 1)
    gh = max(int(np.ceil((asc - desc) * scale)), 1)
    oy = -desc * scale                       # baseline offset from bottom
    cov = _rasterize(contours, scale, gw, gh, 0.0, oy)
    return cov, gw, int(round(asc * scale))


def render_text(text: str, fontfile: str, size: int) -> np.ndarray:
    """[h, w] float32 coverage map for a text line (no wrapping)."""
    glyphs = [_glyph_bitmap(fontfile, ch, size) for ch in text]
    if not glyphs:
        return np.zeros((1, 1), np.float32)
    h = max(g[0].shape[0] for g in glyphs)
    w = sum(g[1] for g in glyphs)
    out = np.zeros((h, max(w, 1)), np.float32)
    x = 0
    for cov, adv, _asc in glyphs:
        gh, gw = cov.shape
        out[:gh, x:x + gw] = np.maximum(out[:gh, x:x + gw], cov)
        x += adv
    return out


def _expand(text: str, frame, n: int) -> str:
    out = []
    i = 0
    while i < len(text):
        c = text[i]
        if c == "%" and i + 1 < len(text):
            if text[i + 1] == "%":
                out.append("%")
                i += 2
                continue
            if text[i + 1] == "{":
                j = text.find("}", i)
                body = text[i + 2:j]
                key = body.split(":")[0].split("\\")[0]
                if key == "n":
                    out.append(str(n))
                elif key == "pts":
                    t = 0.0
                    if frame.pts is not None and frame.time_base.num:
                        t = frame.pts * frame.time_base.num \
                            / frame.time_base.den
                    if "hms" in body:
                        out.append("%02d:%02d:%06.3f" %
                                   (t // 3600, (t // 60) % 60, t % 60))
                    else:
                        out.append("%.6f" % t)
                else:
                    out.append("%{" + body + "}")
                i = j + 1
                continue
        out.append(c)
        i += 1
    return "".join(out)


@register_filter
class DrawTextFilter(Filter):
    NAME = "drawtext"
    DESCRIPTION = "Draw text (built-in TrueType rasterizer)."
    OPT_ORDER = ("text", "x", "y", "fontsize", "fontcolor")
    OPTIONS = OptionTable(
        Option("text", str, ""),
        Option("x", str, "0"),
        Option("y", str, "0"),
        Option("fontsize", int, 16, min=4, max=512),
        Option("fontcolor", str, "white"),
        Option("fontfile", str, _DEFAULT_FONT),
        Option("box", int, 0, min=0, max=1),
        Option("boxcolor", str, "black"),
        Option("alpha", float, 1.0, min=0.0, max=1.0),
    )

    def configure(self, in_props):
        self._n = 0
        self._cache = (None, None)
        return super().configure(in_props)

    def filter_frame(self, frame, pad=0):
        from librempeg_tpu_torch.filters.video import _parse_color

        text = _expand(self.opts["text"], frame, self._n)
        self._n += 1
        if not text:
            return [(0, frame)]
        ff = font_path(self.opts["fontfile"])
        if self._cache[0] == text:
            cov = self._cache[1]
        else:
            cov = render_text(text, ff, self.opts["fontsize"])
            self._cache = (text, cov)
        v = {"w": frame.width, "h": frame.height,
             "text_w": cov.shape[1], "text_h": cov.shape[0],
             "tw": cov.shape[1], "th": cov.shape[0]}
        x0 = int(eval_expr(str(self.opts["x"]), v))
        y0 = int(eval_expr(str(self.opts["y"]), v))
        color = _parse_color(self.opts["fontcolor"], frame.format)
        boxcolor = _parse_color(self.opts["boxcolor"], frame.format)
        alpha = self.opts["alpha"]
        d = frame.desc
        planes = []
        for i, p in enumerate(frame.planes):
            sx = d.planes[i].log2_chroma_w
            sy = d.planes[i].log2_chroma_h
            c = cov[::1 << sy, ::1 << sx]
            px, py = x0 >> sx, y0 >> sy
            ph, pw = p.shape[:2]
            ch, cw = c.shape
            # clip to plane
            cx0, cy0 = max(px, 0), max(py, 0)
            cx1 = min(px + cw, pw)
            cy1 = min(py + ch, ph)
            if cx1 <= cx0 or cy1 <= cy0:
                planes.append(p)
                continue
            # the coverage terms on the host, as the JAX package has them
            sub = c[cy0 - py:cy1 - py, cx0 - px:cx1 - px] * alpha
            val = float(color[i] if i < len(color) else 0)
            if self.opts["box"]:
                bval = float(boxcolor[i] if i < len(boxcolor) else 0)
                t = sub / max(alpha, 1e-9) * alpha
                steps = [(1 - alpha, bval * alpha), (1 - t, val, t)]
            else:
                steps = [(1 - sub, val, sub)]
            planes.append(blend(p, (cy0, cy1, cx0, cx1), steps))
        return [(0, frame.replace(planes=tuple(planes)))]


def blend(plane: torch.Tensor, rect, steps) -> torch.Tensor:
    """A copy of `plane` (uint8, on its device) whose rectangle rect =
    (y0, y1, x0, x1) is composited in float32 through `steps`, each
    (keep, value, weight): region = region * keep + value * weight,
    where keep and weight are float32 host arrays of the rectangle's
    shape or Python numbers (a step of two numbers is region * keep +
    value), then + 0.5, clipped to 0..255 and truncated. One eager op
    at a time, in the JAX package's order: each rounds once, as numpy's
    does, where a fused lerp or addcmul would round differently."""
    y0, y1, x0, x1 = rect
    out = torch.as_tensor(plane).clone()
    dev = out.device
    region = out[y0:y1, x0:x1].to(torch.float32)

    def arg(a):
        if isinstance(a, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
                .to(dev)
        return a

    for step in steps:
        if len(step) == 2:
            keep, add = step
            region = region * arg(keep) + add
        else:
            keep, value, weight = step
            region = region * arg(keep) + value * arg(weight)
    out[y0:y1, x0:x1] = (region + 0.5).clamp(0, 255).to(torch.uint8)
    return out
