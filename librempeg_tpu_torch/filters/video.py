"""Video filters.

Port of librempeg_tpu/filters/video.py, the analogs of the reference's
vf_* family: scale (vf_scale.c wrapping swscale), format, the
negotiation's autoformat, null, crop (vf_crop.c), pad (vf_pad.c),
hflip/vflip/transpose, fps (vf_fps.c), trim (f_trim), setpts (f_setpts)
and overlay (vf_overlay.c with framesync alignment).

Per-pixel work is the scaler (scale/scaler.py) or plain tensor ops on
the frame's device; expression options (crop x/y, pad, setpts) use
core.eval_expr like the reference. fps, trim and setpts are host
timestamp logic, their arithmetic unchanged from the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.core.errors import InvalidData
from librempeg_tpu_torch.core.eval_expr import eval_expr
from librempeg_tpu_torch.core.frame import VideoFrame
from librempeg_tpu_torch.core.options import Option, OptionTable
from librempeg_tpu_torch.core.pixfmt import get as get_pixfmt
from librempeg_tpu_torch.core.rational import NOPTS, Rational
from librempeg_tpu_torch.filters.filter import (
    Filter,
    PadDesc,
    register_filter,
)
from librempeg_tpu_torch.scale import get_scaler


@register_filter
class NullFilter(Filter):
    NAME = "null"
    DESCRIPTION = "Pass the source unchanged to the output."
    PURE = True


@register_filter
class ScaleFilter(Filter):
    NAME = "scale"
    DESCRIPTION = "Scale the input video size and/or convert pixel format."
    PURE = True
    CONVERTS = True
    OPT_ORDER = ("width", "height")
    OPTIONS = OptionTable(
        Option("width", str, "0", alias="w"),
        Option("height", str, "0", alias="h"),
        Option("flags", str, "bicubic"),
        Option("format", str, ""),  # optional output pix_fmt
    )

    def configure(self, in_props):
        self.in_props = in_props
        p = in_props[0]
        v = {"iw": p.width, "ih": p.height, "in_w": p.width,
             "in_h": p.height, "a": p.width / max(1, p.height)}
        w = int(eval_expr(str(self.opts["width"]) or "0", v))
        h = int(eval_expr(str(self.opts["height"]) or "0", v))
        if w <= 0 and h <= 0:
            w, h = p.width, p.height
        elif w <= 0:
            w = max(1, round(p.width * h / p.height))
            if w % 2 and p.width % 2 == 0:
                w += 1
        elif h <= 0:
            h = max(1, round(p.height * w / p.width))
            if h % 2 and p.height % 2 == 0:
                h += 1
        out = p.copy()
        out.width, out.height = w, h
        if self.opts["format"]:
            out.pix_fmt = self.opts["format"]
        elif getattr(self, "_forced_format", ""):
            out.pix_fmt = self._forced_format
        self.out_props = [out]
        return self.out_props

    def filter_frame(self, frame: VideoFrame, pad=0):
        o = self.out_props[0]
        if (frame.width, frame.height, frame.format) == \
                (o.width, o.height, o.pix_fmt):
            return [(0, frame)]
        s = get_scaler(frame.format, frame.width, frame.height,
                       o.pix_fmt or frame.format, o.width, o.height,
                       kernel=self.opts["flags"])
        return [(0, s.scale_frame(frame))]


@register_filter
class FormatFilter(Filter):
    NAME = "format"
    DESCRIPTION = "Convert the input video to one of the specified formats."
    PURE = True
    CONVERTS = True
    OPT_ORDER = ("pix_fmts",)
    OPTIONS = OptionTable(Option("pix_fmts", str, ""))

    def _fmts(self) -> list[str]:
        return [f for f in self.opts["pix_fmts"].replace("|", ":").split(":")
                if f]

    def out_formats(self, pad: int = 0):
        return tuple(self._fmts()) or None

    def configure(self, in_props):
        self.in_props = in_props
        out = in_props[0].copy()
        fmts = self._fmts()
        if not fmts:
            raise InvalidData("format: no pix_fmts given")
        if out.pix_fmt not in fmts:
            out.pix_fmt = fmts[0]
        self._target = out.pix_fmt
        self.out_props = [out]
        return self.out_props

    def filter_frame(self, frame: VideoFrame, pad=0):
        if frame.format == self._target:
            return [(0, frame)]
        s = get_scaler(frame.format, frame.width, frame.height,
                       self._target, frame.width, frame.height)
        return [(0, s.scale_frame(frame))]


@register_filter
class AutoFormatFilter(Filter):
    """Converter the negotiator auto-inserts on a conflicted link: emits
    the link's negotiated format (avfiltergraph.c auto-scale analog)."""

    NAME = "autoformat"
    DESCRIPTION = "Convert to the negotiated pixel format (auto-inserted)."
    PURE = True
    CONVERTS = True

    def configure(self, in_props):
        self.in_props = in_props
        out = in_props[0].copy()
        if getattr(self, "_forced_format", ""):
            out.pix_fmt = self._forced_format
        self._target = out.pix_fmt
        self.out_props = [out]
        return self.out_props

    def filter_frame(self, frame: VideoFrame, pad=0):
        if frame.format == self._target:
            return [(0, frame)]
        s = get_scaler(frame.format, frame.width, frame.height,
                       self._target, frame.width, frame.height)
        return [(0, s.scale_frame(frame))]


@register_filter
class CropFilter(Filter):
    NAME = "crop"
    DESCRIPTION = "Crop the input video."
    PURE = True
    OPT_ORDER = ("out_w", "out_h", "x", "y")
    OPTIONS = OptionTable(
        Option("out_w", str, "iw", alias="w"),
        Option("out_h", str, "ih", alias="h"),
        Option("x", str, "(in_w-out_w)/2"),
        Option("y", str, "(in_h-out_h)/2"),
    )

    def configure(self, in_props):
        self.in_props = in_props
        p = in_props[0]
        v = {"iw": p.width, "ih": p.height, "in_w": p.width, "in_h": p.height}
        w = int(eval_expr(str(self.opts["out_w"]), v))
        h = int(eval_expr(str(self.opts["out_h"]), v))
        v.update(out_w=w, out_h=h, ow=w, oh=h)
        x = int(eval_expr(str(self.opts["x"]), v))
        y = int(eval_expr(str(self.opts["y"]), v))
        d = get_pixfmt(p.pix_fmt)
        # chroma-align
        x &= ~((1 << d.log2_chroma_w) - 1)
        y &= ~((1 << d.log2_chroma_h) - 1)
        self._rect = (x, y, w, h)
        out = p.copy()
        out.width, out.height = w, h
        self.out_props = [out]
        return self.out_props

    def filter_frame(self, frame: VideoFrame, pad=0):
        x, y, w, h = self._rect
        d = frame.desc
        planes = []
        for i, p in enumerate(frame.planes):
            sx = x >> d.planes[i].log2_chroma_w
            sy = y >> d.planes[i].log2_chroma_h
            ph, pw = d.plane_shape(i, h, w)
            planes.append(p[sy:sy + ph, sx:sx + pw])
        return [(0, frame.replace(planes=tuple(planes), width=w, height=h))]


@register_filter
class PadFilter(Filter):
    NAME = "pad"
    DESCRIPTION = "Pad the input video."
    PURE = True
    OPT_ORDER = ("width", "height", "x", "y")
    OPTIONS = OptionTable(
        Option("width", str, "iw", alias="w"),
        Option("height", str, "ih", alias="h"),
        Option("x", str, "(ow-iw)/2"),
        Option("y", str, "(oh-ih)/2"),
        Option("color", str, "black"),
    )

    def configure(self, in_props):
        self.in_props = in_props
        p = in_props[0]
        v = {"iw": p.width, "ih": p.height, "in_w": p.width, "in_h": p.height}
        w = int(eval_expr(str(self.opts["width"]), v))
        h = int(eval_expr(str(self.opts["height"]), v))
        v.update(ow=w, oh=h, out_w=w, out_h=h)
        x = int(eval_expr(str(self.opts["x"]), v))
        y = int(eval_expr(str(self.opts["y"]), v))
        self._geom = (x, y, w, h)
        out = p.copy()
        out.width, out.height = w, h
        self.out_props = [out]
        return self.out_props

    def filter_frame(self, frame: VideoFrame, pad=0):
        x, y, w, h = self._geom
        d = frame.desc
        fill = _parse_color(self.opts["color"], frame.format)
        planes = []
        for i, p in enumerate(frame.planes):
            p = torch.as_tensor(p)
            ph, pw = d.plane_shape(i, h, w)
            sx = x >> d.planes[i].log2_chroma_w
            sy = y >> d.planes[i].log2_chroma_h
            val = torch.as_tensor(fill[i], dtype=p.dtype, device=p.device)
            arr = val[:p.shape[2]] if p.dim() == 3 else val
            arr = arr.expand((ph, pw) + tuple(p.shape[2:])).clone()
            arr[sy:sy + p.shape[0], sx:sx + p.shape[1]] = p
            planes.append(arr)
        return [(0, frame.replace(planes=tuple(planes), width=w, height=h))]


def _parse_color(name: str, fmt: str):
    """Per-plane fill values for a named color."""
    colors = {"black": (0, 0, 0), "white": (255, 255, 255),
              "red": (255, 0, 0), "green": (0, 255, 0),
              "blue": (0, 0, 255), "gray": (128, 128, 128)}
    rgb = colors.get(name)
    if rgb is None and name.startswith("0x"):
        v = int(name, 16)
        rgb = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
    if rgb is None:
        rgb = (0, 0, 0)
    d = get_pixfmt(fmt)
    if d.is_rgb:
        return [rgb + (255,)]
    r, g, b = rgb
    y = 0.299 * r + 0.587 * g + 0.114 * b
    if d.default_range.name != "JPEG":
        y = y * 219 / 255 + 16
    u = (b - y) * 0.564 + 128
    v = (r - y) * 0.713 + 128
    return [int(y), int(np.clip(u, 0, 255)), int(np.clip(v, 0, 255)), 255]


@register_filter
class HFlipFilter(Filter):
    NAME = "hflip"
    DESCRIPTION = "Horizontally flip the input video."
    PURE = True

    def filter_frame(self, frame: VideoFrame, pad=0):
        return [(0, frame.replace(
            planes=tuple(torch.as_tensor(p).flip(1) for p in frame.planes)))]


@register_filter
class VFlipFilter(Filter):
    NAME = "vflip"
    DESCRIPTION = "Vertically flip the input video."
    PURE = True

    def filter_frame(self, frame: VideoFrame, pad=0):
        return [(0, frame.replace(
            planes=tuple(torch.as_tensor(p).flip(0) for p in frame.planes)))]


@register_filter
class TransposeFilter(Filter):
    NAME = "transpose"
    DESCRIPTION = "Transpose rows with columns."
    PURE = True
    OPT_ORDER = ("dir",)
    OPTIONS = OptionTable(
        Option("dir", int, 0, min=0, max=3,
               help="0=ccw+vflip 1=cw 2=ccw 3=cw+vflip"),
    )
    # the JAX package's mapping (video.py:318-320): after the swap, 0
    # flips nothing, 1 the columns, 2 the rows, 3 both
    _FLIPS = {0: (), 1: (1,), 2: (0,), 3: (0, 1)}

    def configure(self, in_props):
        self.in_props = in_props
        out = in_props[0].copy()
        out.width, out.height = in_props[0].height, in_props[0].width
        self.out_props = [out]
        return self.out_props

    def filter_frame(self, frame: VideoFrame, pad=0):
        flips = self._FLIPS[self.opts["dir"]]

        def tr(p):
            t = torch.as_tensor(p).transpose(0, 1)
            return t.flip(flips) if flips else t

        return [(0, frame.replace(
            planes=tuple(tr(p) for p in frame.planes),
            width=frame.height, height=frame.width))]


@register_filter
class FpsFilter(Filter):
    NAME = "fps"
    DESCRIPTION = "Force constant framerate."
    OPT_ORDER = ("fps",)
    OPTIONS = OptionTable(Option("fps", str, "25"))

    def configure(self, in_props):
        self.in_props = in_props
        out = in_props[0].copy()
        fps = self.opts["fps"]
        if "/" in str(fps):
            n, d = str(fps).split("/")
            self._rate = Rational(int(n), int(d))
        else:
            self._rate = Rational.from_float(float(fps))
        out.frame_rate = self._rate
        out.time_base = Rational(self._rate.den, self._rate.num)
        self.out_props = [out]
        self._next_out = 0
        self._last: VideoFrame | None = None
        return self.out_props

    def filter_frame(self, frame: VideoFrame, pad=0):
        out_tb = self.out_props[0].time_base
        outs = []
        if frame.pts == NOPTS:
            return [(0, frame)]
        # emit copies of the previous frame until its interval is covered
        in_t = frame.pts * frame.time_base.num / frame.time_base.den
        self._last_t = in_t
        while self._last is not None and \
                self._next_out * out_tb.num / out_tb.den <= in_t - 1e-9:
            outs.append((0, self._last.replace(pts=self._next_out,
                                               time_base=out_tb)))
            self._next_out += 1
        self._last = frame
        return outs

    def flush(self):
        out_tb = self.out_props[0].time_base
        outs = []
        # emit pending output frames whose start falls inside the input's
        # time span (the reference's fps filter EOF behavior)
        while self._last is not None and \
                self._next_out * out_tb.num / out_tb.den <= \
                getattr(self, "_last_t", 0.0) + 1e-9:
            outs.append((0, self._last.replace(pts=self._next_out,
                                               time_base=out_tb)))
            self._next_out += 1
        self._last = None
        return outs


@register_filter
class TrimFilter(Filter):
    NAME = "trim"
    DESCRIPTION = "Pick one continuous section from the input."
    OPTIONS = OptionTable(
        Option("start", float, 0.0),
        Option("end", float, float("inf")),
        Option("start_frame", int, -1),
        Option("end_frame", int, -1),
    )

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        self._n = 0
        return self.out_props

    def filter_frame(self, frame: VideoFrame, pad=0):
        idx = self._n
        self._n += 1
        sf, ef = self.opts["start_frame"], self.opts["end_frame"]
        if sf >= 0 or ef >= 0:
            if sf >= 0 and idx < sf:
                return []
            if ef >= 0 and idx >= ef:
                return []
            return [(0, frame)]
        t = (frame.pts * frame.time_base.num / frame.time_base.den
             if frame.pts != NOPTS else 0.0)
        if self.opts["start"] <= t < self.opts["end"]:
            return [(0, frame)]
        return []


@register_filter
class SetPtsFilter(Filter):
    NAME = "setpts"
    DESCRIPTION = "Set PTS from an expression of input PTS."
    OPT_ORDER = ("expr",)
    OPTIONS = OptionTable(Option("expr", str, "PTS"))

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        self._n = 0
        self._start = None
        return self.out_props

    def filter_frame(self, frame: VideoFrame, pad=0):
        pts = frame.pts
        if self._start is None:
            self._start = pts if pts != NOPTS else 0
        v = {"PTS": pts if pts != NOPTS else 0, "N": self._n,
             "STARTPTS": self._start,
             "TB": frame.time_base.num / frame.time_base.den}
        self._n += 1
        new = int(eval_expr(self.opts["expr"], v))
        return [(0, frame.replace(pts=new))]


@register_filter
class OverlayFilter(Filter):
    NAME = "overlay"
    DESCRIPTION = "Overlay a video on top of the input."
    INPUTS = (PadDesc("main", "video"), PadDesc("overlay", "video"))
    FRAMESYNC = True
    #: planar formats the blend operates in (negotiation converts rgb
    #: etc. upstream automatically -- avfiltergraph auto-insert analog)
    _FORMATS = ("yuv420p", "yuvj420p", "yuv422p", "yuv444p", "gray")

    def in_formats(self, pad: int = 0):
        return self._FORMATS
    OPT_ORDER = ("x", "y")
    OPTIONS = OptionTable(
        Option("x", str, "0"),
        Option("y", str, "0"),
    )

    def configure(self, in_props):
        self.in_props = in_props
        main = in_props[0]
        v = {"W": main.width, "H": main.height,
             "w": in_props[1].width, "h": in_props[1].height,
             "main_w": main.width, "main_h": main.height,
             "overlay_w": in_props[1].width, "overlay_h": in_props[1].height}
        self._x = int(eval_expr(str(self.opts["x"]), v))
        self._y = int(eval_expr(str(self.opts["y"]), v))
        self.out_props = [main.copy()]
        self._pending: list = [None, None]
        return self.out_props

    def filter_frame(self, frame: VideoFrame, pad=0):
        self._pending[pad] = frame
        if self._pending[0] is None:
            return []
        if self._pending[1] is None:
            return []
        main, over = self._pending[0], self._pending[1]
        self._pending[0] = None  # keep overlay frame for repeated use
        return [(0, self._blend(main, over))]

    def filter_frames(self, frames):
        return [(0, self._blend(frames[0], frames[1]))]

    def _blend(self, main: VideoFrame, over: VideoFrame) -> VideoFrame:
        # operate in main's format; convert overlay if needed
        if over.format != main.format:
            s = get_scaler(over.format, over.width, over.height,
                           main.format, over.width, over.height)
            over = s.scale_frame(over)
        x, y = self._x, self._y
        d = main.desc
        planes = []
        for i, p in enumerate(main.planes):
            base = torch.as_tensor(p)
            op = torch.as_tensor(over.planes[i]).to(base.device)
            sx = x >> d.planes[i].log2_chroma_w
            sy = y >> d.planes[i].log2_chroma_h
            h = min(op.shape[0], base.shape[0] - sy)
            w = min(op.shape[1], base.shape[1] - sx)
            base = base.clone()
            base[sy:sy + h, sx:sx + w] = op[:h, :w]
            planes.append(base)
        return main.replace(planes=tuple(planes))

    def flush(self):
        return []
