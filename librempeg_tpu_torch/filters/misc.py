"""Stream fan-out and utility filters: split/asplit, apad, channelsplit,
pan, adelay, asetpts.

Port of librempeg_tpu/filters/misc.py (f_split.c, af_apad.c,
af_channelsplit.c, af_pan.c, af_adelay.c, f_setpts's audio side): the
option and timestamp logic is host code carried over; samples stay
tensors on the frame's device. pan's gain matrix is built on the host
and applied on the samples' device in the order of the JAX package's
numpy float32 matmul (OpenBLAS on the CPU): the first input's rounded
product, then each later input as a fused multiply-add (computed as a
float64 sum rounded once to float32).
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.codecs.pcm import from_float, to_float
from librempeg_tpu_torch.core.errors import InvalidData
from librempeg_tpu_torch.core.eval_expr import eval_expr
from librempeg_tpu_torch.core.frame import AudioFrame
from librempeg_tpu_torch.core.options import Option, OptionTable
from librempeg_tpu_torch.core.rational import NOPTS
from librempeg_tpu_torch.core.samplefmt import ChannelLayout
from librempeg_tpu_torch.filters.filter import Filter, PadDesc, register_filter
from librempeg_tpu_torch.filters.video2 import _fma


class _SplitBase(Filter):
    OPT_ORDER = ("outputs",)
    OPTIONS = OptionTable(Option("outputs", int, 2, min=1, max=16))
    MEDIA = "video"

    def __init__(self, args: str = "", **kwargs):
        super().__init__(args, **kwargs)
        n = self.opts["outputs"]
        self.INPUTS = (PadDesc("default", self.MEDIA),)
        self.OUTPUTS = tuple(PadDesc(f"out{i}", self.MEDIA)
                             for i in range(n))

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy() for _ in self.OUTPUTS]
        return self.out_props

    def filter_frame(self, frame, pad=0):
        return [(i, frame) for i in range(len(self.OUTPUTS))]


@register_filter
class SplitFilter(_SplitBase):
    NAME = "split"
    DESCRIPTION = "Pass the input to N video outputs."
    MEDIA = "video"


@register_filter
class ASplitFilter(_SplitBase):
    NAME = "asplit"
    DESCRIPTION = "Pass the input to N audio outputs."
    MEDIA = "audio"


def _silence(frame: AudioFrame, n: int) -> torch.Tensor:
    d = torch.as_tensor(frame.data)
    return torch.zeros((frame.nb_channels, n), dtype=d.dtype,
                       device=d.device)


@register_filter
class APadFilter(Filter):
    NAME = "apad"
    DESCRIPTION = "Pad the end of an audio stream with silence."
    INPUTS = (PadDesc("default", "audio"),)
    OUTPUTS = (PadDesc("default", "audio"),)
    OPTIONS = OptionTable(
        Option("pad_len", int, 0, min=0),
        Option("whole_len", int, 0, min=0),
    )

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        self._seen = 0
        self._last = None
        return self.out_props

    def filter_frame(self, frame: AudioFrame, pad=0):
        self._seen += frame.nb_samples
        self._last = frame
        return [(0, frame)]

    def flush(self):
        if self._last is None:
            return []
        n = self.opts["pad_len"]
        if self.opts["whole_len"]:
            n = max(0, self.opts["whole_len"] - self._seen)
        if n == 0:
            return []
        f = self._last
        return [(0, f.replace(data=_silence(f, n), pts=f.pts + f.nb_samples))]


@register_filter
class ChannelSplitFilter(Filter):
    NAME = "channelsplit"
    DESCRIPTION = "Split audio into per-channel streams."
    INPUTS = (PadDesc("default", "audio"),)

    def __init__(self, args: str = "", **kwargs):
        super().__init__(args, **kwargs)
        self.OUTPUTS = (PadDesc("c0", "audio"), PadDesc("c1", "audio"))

    def configure(self, in_props):
        self.in_props = in_props
        nch = in_props[0].layout.nb_channels if in_props[0].layout else 2
        self.OUTPUTS = tuple(PadDesc(f"c{i}", "audio") for i in range(nch))
        outs = []
        for _ in range(nch):
            p = in_props[0].copy()
            p.layout = ChannelLayout.default(1)
            outs.append(p)
        self.out_props = outs
        return self.out_props

    def filter_frame(self, frame: AudioFrame, pad=0):
        data = torch.as_tensor(frame.data)
        return [(i, frame.replace(data=data[i:i + 1],
                                  layout=ChannelLayout.default(1)))
                for i in range(data.shape[0])]


@register_filter
class PanFilter(Filter):
    """Channel remix via gain expressions: pan=stereo|c0=c0+c1|c1=0.5*c1."""

    NAME = "pan"
    DESCRIPTION = "Remix channels with gains."
    INPUTS = (PadDesc("default", "audio"),)
    OUTPUTS = (PadDesc("default", "audio"),)
    OPTIONS = OptionTable(Option("args", str, "stereo"))

    def __init__(self, args: str = "", **kwargs):
        # pan's argument is a raw spec ("mono|c0=..."), not key=value
        Filter.__init__(self, "", **kwargs)
        self.opts["args"] = args or "stereo"

    def configure(self, in_props):
        self.in_props = in_props
        spec = self.opts["args"]
        parts = spec.split("|")
        layout = ChannelLayout.from_string(parts[0])
        in_ch = in_props[0].layout.nb_channels if in_props[0].layout else 2
        m = np.zeros((layout.nb_channels, in_ch), np.float32)
        for term in parts[1:]:
            if "=" not in term:
                raise InvalidData(f"pan: bad term {term!r}")
            dst, expr = term.split("=", 1)
            di = int(dst.strip().lstrip("c"))
            # expression like "0.5*c0+0.5*c1": evaluate gains by probing
            for si in range(in_ch):
                vars_ = {f"c{k}": 1.0 if k == si else 0.0
                         for k in range(in_ch)}
                m[di, si] = eval_expr(expr.replace(" ", ""), vars_)
        self._m = m
        out = in_props[0].copy()
        out.layout = layout
        self.out_props = [out]
        return self.out_props

    def filter_frame(self, frame: AudioFrame, pad=0):
        x = to_float(torch.as_tensor(frame.data), frame.sample_fmt)
        rows = []
        for g in self._m:
            acc = x[0] * float(g[0])
            for k in range(1, x.shape[0]):
                acc = _fma(x[k], float(g[k]), acc)
            rows.append(acc)
        return [(0, frame.replace(
            data=from_float(torch.stack(rows), frame.sample_fmt),
            layout=self.out_props[0].layout))]


@register_filter
class ADelayFilter(Filter):
    NAME = "adelay"
    DESCRIPTION = "Delay audio by prepending silence."
    INPUTS = (PadDesc("default", "audio"),)
    OUTPUTS = (PadDesc("default", "audio"),)
    OPT_ORDER = ("delays",)
    OPTIONS = OptionTable(Option("delays", str, "0",
                                 help="delay in ms (all channels)"))

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        self._emitted = False
        return self.out_props

    def filter_frame(self, frame: AudioFrame, pad=0):
        if self._emitted:
            return [(0, frame)]
        self._emitted = True
        ms = float(str(self.opts["delays"]).split("|")[0] or 0)
        n = int(ms * frame.sample_rate / 1000)
        if n == 0:
            return [(0, frame)]
        pts0 = frame.pts if frame.pts != NOPTS else 0
        return [(0, frame.replace(data=_silence(frame, n), pts=pts0)),
                (0, frame.replace(pts=pts0 + n))]


@register_filter
class ASetPtsFilter(Filter):
    NAME = "asetpts"
    DESCRIPTION = "Set audio PTS from an expression."
    INPUTS = (PadDesc("default", "audio"),)
    OUTPUTS = (PadDesc("default", "audio"),)
    OPT_ORDER = ("expr",)
    OPTIONS = OptionTable(Option("expr", str, "PTS"))

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        self._n = 0
        return self.out_props

    def filter_frame(self, frame: AudioFrame, pad=0):
        pts = frame.pts if frame.pts != NOPTS else 0
        v = {"PTS": pts, "N": self._n, "S": frame.nb_samples,
             "SR": frame.sample_rate}
        self._n += 1
        return [(0, frame.replace(pts=int(eval_expr(self.opts["expr"],
                                                    v))))]
