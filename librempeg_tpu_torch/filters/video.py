"""Video filters of the slice: null, scale and format.

Port of NullFilter, ScaleFilter and FormatFilter from
librempeg_tpu/filters/video.py (vf_null.c / vf_scale.c / vf_format.c
analogs). Size expressions use core.eval_expr like the reference; the
pixel work is the scaler (scale/scaler.py).
"""
from __future__ import annotations

from librempeg_tpu_torch.core.errors import InvalidData
from librempeg_tpu_torch.core.eval_expr import eval_expr
from librempeg_tpu_torch.core.frame import VideoFrame
from librempeg_tpu_torch.core.options import Option, OptionTable
from librempeg_tpu_torch.filters.filter import Filter, register_filter
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
