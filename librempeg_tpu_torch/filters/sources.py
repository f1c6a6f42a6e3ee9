"""Source filters: testsrc2, color, sine.

A copy of librempeg_tpu/filters/sources.py (vsrc_testsrc.c's testsrc2,
vsrc_color, asrc_sine.c analogs) with its imports rewritten: host code
whose frames hold CPU tensors (the JAX package's numpy arrays, wrapped),
which the graph's filters and the lavfi device take like any frame.
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.core.errors import EndOfStream
from librempeg_tpu_torch.core.frame import AudioFrame, VideoFrame
from librempeg_tpu_torch.core.options import Option, OptionTable
from librempeg_tpu_torch.core.rational import Rational
from librempeg_tpu_torch.core.samplefmt import ChannelLayout
from librempeg_tpu_torch.filters.filter import (
    PadDesc,
    SourceFilter,
    StreamProps,
    register_filter,
)
from librempeg_tpu_torch.utils import testgen


@register_filter
class TestSrc2Filter(SourceFilter):
    NAME = "testsrc2"
    DESCRIPTION = "Generate another test pattern."
    OUTPUTS = (PadDesc("default", "video"),)
    OPTIONS = OptionTable(
        Option("size", str, "320x240", alias="s"),
        Option("rate", str, "25", alias="r"),
        Option("duration", float, float("inf"), alias="d"),
    )

    def configure(self, in_props):
        w, h = self.opts["size"].split("x")
        self._w, self._h = int(w), int(h)
        r = str(self.opts["rate"])
        self._rate = (Rational(*map(int, r.split("/"))) if "/" in r
                      else Rational(int(float(r)), 1))
        self._n = 0
        p = StreamProps(media="video", width=self._w, height=self._h,
                        pix_fmt="yuv420p", frame_rate=self._rate,
                        time_base=Rational(self._rate.den, self._rate.num))
        self.out_props = [p]
        return self.out_props

    def request_frame(self) -> VideoFrame:
        t = self._n * self._rate.den / self._rate.num
        if t >= self.opts["duration"]:
            raise EndOfStream
        f = testgen.video_frame_yuv420(self._w, self._h, self._n, self._rate)
        self._n += 1
        return f.to_device("cpu")


@register_filter
class ColorFilter(SourceFilter):
    NAME = "color"
    DESCRIPTION = "Provide a uniformly colored input."
    OUTPUTS = (PadDesc("default", "video"),)
    OPTIONS = OptionTable(
        Option("color", str, "black", alias="c"),
        Option("size", str, "320x240", alias="s"),
        Option("rate", str, "25", alias="r"),
        Option("duration", float, float("inf"), alias="d"),
    )

    def configure(self, in_props):
        w, h = self.opts["size"].split("x")
        self._w, self._h = int(w), int(h)
        r = str(self.opts["rate"])
        self._rate = (Rational(*map(int, r.split("/"))) if "/" in r
                      else Rational(int(float(r)), 1))
        self._n = 0
        from librempeg_tpu_torch.filters.video import _parse_color

        fill = _parse_color(self.opts["color"], "yuv420p")
        self._planes = (
            np.full((self._h, self._w), fill[0], np.uint8),
            np.full((self._h // 2, self._w // 2), fill[1], np.uint8),
            np.full((self._h // 2, self._w // 2), fill[2], np.uint8),
        )
        p = StreamProps(media="video", width=self._w, height=self._h,
                        pix_fmt="yuv420p", frame_rate=self._rate,
                        time_base=Rational(self._rate.den, self._rate.num))
        self.out_props = [p]
        return self.out_props

    def request_frame(self) -> VideoFrame:
        t = self._n * self._rate.den / self._rate.num
        if t >= self.opts["duration"]:
            raise EndOfStream
        f = VideoFrame(planes=tuple(torch.from_numpy(p)
                                    for p in self._planes),
                       format="yuv420p", width=self._w, height=self._h,
                       pts=self._n,
                       time_base=Rational(self._rate.den, self._rate.num))
        self._n += 1
        return f


@register_filter
class SineFilter(SourceFilter):
    NAME = "sine"
    DESCRIPTION = "Generate sine wave audio."
    OUTPUTS = (PadDesc("default", "audio"),)
    OPTIONS = OptionTable(
        Option("frequency", float, 440.0, alias="f"),
        Option("sample_rate", int, 44100, alias="r"),
        Option("duration", float, float("inf"), alias="d"),
        Option("samples_per_frame", int, 1024),
    )

    def configure(self, in_props):
        self._pos = 0
        rate = self.opts["sample_rate"]
        p = StreamProps(media="audio", sample_rate=rate, sample_fmt="s16p",
                        layout=ChannelLayout.default(1),
                        time_base=Rational(1, rate))
        self.out_props = [p]
        return self.out_props

    def request_frame(self) -> AudioFrame:
        rate = self.opts["sample_rate"]
        n = self.opts["samples_per_frame"]
        if self._pos / rate >= self.opts["duration"]:
            raise EndOfStream
        if self.opts["duration"] != float("inf"):
            n = min(n, int(self.opts["duration"] * rate) - self._pos)
            if n <= 0:
                raise EndOfStream
        t = (np.arange(n) + self._pos) / rate
        x = np.sin(2 * np.pi * self.opts["frequency"] * t)
        s16 = np.clip(np.rint(x * 0.5 * 32768), -32768, 32767
                      ).astype(np.int16)[None, :]
        f = AudioFrame(data=torch.from_numpy(s16), sample_rate=rate,
                       sample_fmt="s16p",
                       layout=ChannelLayout.default(1), pts=self._pos)
        self._pos += n
        return f
