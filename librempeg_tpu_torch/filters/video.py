"""Video filters of the slice: null and scale.

Port of NullFilter and ScaleFilter from librempeg_tpu/filters/video.py
(vf_null.c / vf_scale.c analogs). Size expressions use core.eval_expr
like the reference; the pixel work is the planar scaler.
"""
from __future__ import annotations

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
