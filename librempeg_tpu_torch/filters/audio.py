"""Audio filters: anull, aformat, aresample, volume, atrim, amix.

Port of librempeg_tpu/filters/audio.py (af_aformat.c, af_aresample.c
wrapping swresample, af_volume.c, f_trim.c, af_amix.c analogs).
Frames carry tensors; a converting filter builds its resample.Swr on
the device of the first frame it sees, so the samples stay where the
decoder put them. aresample also takes swresample's dither_method
(the JAX package's filter does not; its Swr does), so that
`-af aresample=48000:dither_method=lipshitz -c:a pcm_s16le` requantises
through the noise shaper: the encoder's integer format is negotiated
onto the dithering aresample (GraphRunner's sample_fmt), and a float
input reaches it through an inserted conversion to that format. amix
sums its inputs' float32 samples in input order on the first input's
device, as the JAX package's numpy code does.
"""
from __future__ import annotations

import torch

from librempeg_tpu_torch.codecs.pcm import from_float, to_float
from librempeg_tpu_torch.core.errors import Unsupported
from librempeg_tpu_torch.core.eval_expr import eval_expr
from librempeg_tpu_torch.core.frame import AudioFrame
from librempeg_tpu_torch.core.options import Option, OptionTable
from librempeg_tpu_torch.core.rational import NOPTS, Rational
from librempeg_tpu_torch.core.samplefmt import ChannelLayout
from librempeg_tpu_torch.filters.filter import Filter, PadDesc, register_filter
from librempeg_tpu_torch.ops.fdiv import fdiv
from librempeg_tpu_torch.resample import DITHER_METHODS, Swr


@register_filter
class ANullFilter(Filter):
    NAME = "anull"
    DESCRIPTION = "Pass the audio source unchanged."
    PURE = True
    INPUTS = (PadDesc("default", "audio"),)
    OUTPUTS = (PadDesc("default", "audio"),)


class _SwrFilter(Filter):
    """A filter that runs one Swr, made on the first frame's device from
    the arguments configure() leaves in _swr_args (None: pass-through)."""

    INPUTS = (PadDesc("default", "audio"),)
    OUTPUTS = (PadDesc("default", "audio"),)
    CONVERTS = True

    _swr_args: dict | None = None
    _swr: Swr | None = None

    def filter_frame(self, frame: AudioFrame, pad=0):
        if self._swr_args is None:
            return [(0, frame)]
        if self._swr is None:
            dev = (frame.data.device if isinstance(frame.data, torch.Tensor)
                   else "cpu")
            self._swr = Swr(device=dev, **self._swr_args)
        return [(0, self._swr.convert_frame(frame))]

    def flush(self):
        if self._swr is None:
            return []
        f = self._swr.flush_frame()
        return [(0, f)] if f.nb_samples else []


@register_filter
class AFormatFilter(_SwrFilter):
    NAME = "aformat"
    DESCRIPTION = "Convert audio to the specified formats."
    OPTIONS = OptionTable(
        Option("sample_fmts", str, "", alias="f"),
        Option("sample_rates", str, "", alias="r"),
        Option("channel_layouts", str, "", alias="cl"),
    )

    def configure(self, in_props):
        self.in_props = in_props
        out = in_props[0].copy()
        if self.opts["sample_fmts"]:
            out.sample_fmt = self.opts["sample_fmts"].split("|")[0]
        if self.opts["sample_rates"]:
            out.sample_rate = int(self.opts["sample_rates"].split("|")[0])
        if self.opts["channel_layouts"]:
            out.layout = ChannelLayout.from_string(
                self.opts["channel_layouts"].split("|")[0])
        self.out_props = [out]
        p = in_props[0]
        if (out.sample_rate != p.sample_rate or out.sample_fmt != p.sample_fmt
                or (out.layout and p.layout
                    and out.layout.nb_channels != p.layout.nb_channels)):
            self._swr_args = dict(
                in_rate=p.sample_rate, out_rate=out.sample_rate,
                in_layout=p.layout or 2,
                out_layout=out.layout or p.layout or 2,
                in_fmt=p.sample_fmt or "fltp",
                out_fmt=out.sample_fmt or "fltp")
        return self.out_props


@register_filter
class AResampleFilter(_SwrFilter):
    NAME = "aresample"
    DESCRIPTION = "Resample audio data."
    OPT_ORDER = ("sample_rate",)
    OPTIONS = OptionTable(
        Option("sample_rate", int, 0, min=0, max=768000),
        Option("filter_size", int, 32, min=4, max=512),
        Option("cutoff", float, 0.0, min=0.0, max=1.0),
        # swresample's dither_method (libswresample/options.c): applied
        # where the resampled floats are requantised to an integer format
        Option("dither_method", str, "none", choices=DITHER_METHODS),
    )

    #: the integer sample format a dithering aresample resamples in and
    #: writes: the encoder's, bound by GraphRunner (bind_sample_fmt)
    dither_fmt: str | None = None

    def bind_sample_fmt(self, fmt: str | None) -> None:
        """Take the integer sample format the graph's consumer quantises
        to. With a dither_method, that format becomes this filter's
        input and output (negotiation converts the input to it, as an
        aformat in front would), so the Swr requantises its resampled
        output through the ditherer. Without one there is nothing to
        dither, which is refused rather than ignored."""
        method = self.opts["dither_method"]
        if method == "none":
            return
        if fmt is None:
            raise Unsupported(
                f"aresample: dither_method={method} needs an integer "
                "sample format after it (an encoder such as pcm_s16le, "
                "flac or adpcm_ms)")
        self.dither_fmt = fmt

    def in_formats(self, pad: int = 0):
        return (self.dither_fmt,) if self.dither_fmt else None

    def out_formats(self, pad: int = 0):
        return (self.dither_fmt,) if self.dither_fmt else None

    def configure(self, in_props):
        self.in_props = in_props
        p = in_props[0]
        out = p.copy()
        rate = self.opts["sample_rate"] or p.sample_rate
        in_fmt = p.sample_fmt or "fltp"
        # a converter negotiation inserted lands on its link's format
        out_fmt = (self.dither_fmt or getattr(self, "_forced_format", "")
                   or in_fmt)
        out.sample_rate = rate
        out.sample_fmt = out_fmt
        out.time_base = Rational(1, rate)
        self.out_props = [out]
        if rate != p.sample_rate or out_fmt != in_fmt:
            self._swr_args = dict(
                in_rate=p.sample_rate, out_rate=rate,
                in_layout=p.layout or 2,
                in_fmt=in_fmt, out_fmt=out_fmt,
                filter_size=self.opts["filter_size"],
                cutoff=self.opts["cutoff"],
                dither=self.opts["dither_method"])
        return self.out_props


@register_filter
class VolumeFilter(Filter):
    NAME = "volume"
    DESCRIPTION = "Change input volume."
    PURE = True
    INPUTS = (PadDesc("default", "audio"),)
    OUTPUTS = (PadDesc("default", "audio"),)
    OPT_ORDER = ("volume",)
    OPTIONS = OptionTable(Option("volume", str, "1.0"))

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        vol = str(self.opts["volume"])
        if vol.endswith("dB"):
            self._gain = 10 ** (float(vol[:-2]) / 20)
        else:
            self._gain = float(eval_expr(vol))
        return self.out_props

    def filter_frame(self, frame: AudioFrame, pad=0):
        x = to_float(frame.data, frame.sample_fmt)
        y = from_float(x * self._gain, frame.sample_fmt)
        return [(0, frame.replace(data=y))]


@register_filter
class ATrimFilter(Filter):
    NAME = "atrim"
    DESCRIPTION = "Pick one continuous section from the audio input."
    INPUTS = (PadDesc("default", "audio"),)
    OUTPUTS = (PadDesc("default", "audio"),)
    OPTIONS = OptionTable(
        Option("start", float, 0.0),
        Option("end", float, float("inf")),
    )

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        return self.out_props

    def filter_frame(self, frame: AudioFrame, pad=0):
        rate = frame.sample_rate
        s0 = int(self.opts["start"] * rate)
        s1 = (int(self.opts["end"] * rate)
              if self.opts["end"] != float("inf") else 1 << 62)
        pts = frame.pts if frame.pts != NOPTS else 0
        f_start, f_end = pts, pts + frame.nb_samples
        lo = max(s0, f_start)
        hi = min(s1, f_end)
        if lo >= hi:
            return []
        if lo == f_start and hi == f_end:
            return [(0, frame)]
        data = frame.data[:, lo - f_start:hi - f_start]
        return [(0, frame.replace(data=data, pts=lo))]


@register_filter
class AMixFilter(Filter):
    NAME = "amix"
    DESCRIPTION = "Mix several audio streams."
    INPUTS = (PadDesc("in0", "audio"), PadDesc("in1", "audio"))
    OUTPUTS = (PadDesc("default", "audio"),)
    OPTIONS = OptionTable(
        Option("inputs", int, 2, min=2, max=32),
        Option("normalize", bool, True),
    )

    def __init__(self, args: str = "", **kwargs):
        super().__init__(args, **kwargs)
        n = self.opts["inputs"]
        self.INPUTS = tuple(PadDesc(f"in{i}", "audio") for i in range(n))
        self._bufs: list = [None] * n
        self._dev = None

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        return self.out_props

    def _frame(self, mix, n):
        pts = getattr(self, "_next_pts", 0)
        self._next_pts = pts + n
        return AudioFrame(data=from_float(mix, self._fmt),
                          sample_rate=self._rate, sample_fmt=self._fmt,
                          layout=self._layout, pts=pts)

    def filter_frame(self, frame: AudioFrame, pad=0):
        x = to_float(torch.as_tensor(frame.data), frame.sample_fmt)
        if self._dev is None:
            self._dev = x.device
        x = x.to(self._dev)
        b = self._bufs[pad]
        self._bufs[pad] = x if b is None or not b.numel() else \
            torch.cat([b, x], 1)
        self._fmt = frame.sample_fmt
        self._rate = frame.sample_rate
        self._layout = frame.layout
        if not all(b is not None and b.numel() for b in self._bufs):
            return []
        n = min(b.shape[1] for b in self._bufs)
        mix = self._bufs[0][:, :n]
        for b in self._bufs[1:]:
            mix = mix + b[:, :n]
        if self.opts["normalize"]:
            mix = fdiv(mix, float(len(self._bufs)))
        self._bufs = [b[:, n:] for b in self._bufs]
        return [(0, self._frame(mix, n))]

    def flush(self):
        live = [b for b in self._bufs if b is not None and b.numel()]
        if not live:
            return []
        n = max(b.shape[1] for b in live)
        acc = torch.zeros((live[0].shape[0], n), dtype=torch.float32,
                          device=self._dev)
        for b in live:
            acc[:, :b.shape[1]] += b
        if self.opts["normalize"]:
            acc = fdiv(acc, float(len(self._bufs)))
        self._bufs = [None] * len(self._bufs)
        return [(0, self._frame(acc, n))]
