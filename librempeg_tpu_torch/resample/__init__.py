"""Audio resample/convert engine (libswresample analog).

Port of librempeg_tpu/resample/__init__.py. `Swr` mirrors
swr_convert's pipeline (libswresample/swresample.c:591
swr_convert_internal): input format -> float32 planar -> rematrix ->
resample -> output format (with dither on narrowing). Samples stay
tensors on `device` throughout: convert and convert_frame take and
return tensors where the JAX package returns numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.codecs.pcm import from_float, to_float
from librempeg_tpu_torch.core.frame import AudioFrame
from librempeg_tpu_torch.core.rational import NOPTS, Rational, rescale
from librempeg_tpu_torch.core.samplefmt import ChannelLayout
from librempeg_tpu_torch.device import resolve
from librempeg_tpu_torch.resample.dither import DITHER_METHODS, Ditherer
from librempeg_tpu_torch.resample.rematrix import apply_matrix, build_matrix
from librempeg_tpu_torch.resample.resampler import Resampler

__all__ = ["Swr", "Resampler", "build_matrix", "Ditherer",
           "DITHER_METHODS"]


class Swr:
    """Streaming sample-rate/format/layout converter on `device`."""

    def __init__(self, in_rate: int, out_rate: int,
                 in_layout: ChannelLayout | int = 2,
                 out_layout: ChannelLayout | int | None = None,
                 in_fmt: str = "fltp", out_fmt: str = "fltp",
                 dither: bool | str = False, device="cuda",
                 **resample_opts):
        if isinstance(in_layout, int):
            in_layout = ChannelLayout.default(in_layout)
        if out_layout is None:
            out_layout = in_layout
        elif isinstance(out_layout, int):
            out_layout = ChannelLayout.default(out_layout)
        self.device = resolve(device)
        self.in_rate, self.out_rate = in_rate, out_rate
        self.in_layout, self.out_layout = in_layout, out_layout
        self.in_fmt, self.out_fmt = in_fmt, out_fmt
        self.dither = dither
        self.matrix = (None if in_layout.nb_channels == out_layout.nb_channels
                       and in_layout.mask == out_layout.mask
                       else build_matrix(in_layout, out_layout))
        self.resampler = (None if in_rate == out_rate else
                          Resampler(in_rate, out_rate,
                                    out_layout.nb_channels,
                                    device=self.device, **resample_opts))
        self._next_pts = 0
        # dither: False/None -> off, True -> TPDF, or a method name
        # from DITHER_METHODS (swr dither_method option analog)
        method = ("triangular" if dither is True else dither) or None
        self._ditherer = (Ditherer(method) if method and method != "none"
                          else None)

    def set_compensation(self, sample_delta: int,
                         compensation_distance: int) -> None:
        """swr_set_compensation: soft-adjust the effective ratio (see
        Resampler.set_compensation). Activates a unity resampler if
        none is configured, like the reference does."""
        if self.resampler is None:
            self.resampler = Resampler(self.in_rate, self.out_rate,
                                       self.out_layout.nb_channels,
                                       device=self.device)
        self.resampler.set_compensation(sample_delta,
                                        compensation_distance)

    def convert(self, samples, final: bool = False) -> torch.Tensor:
        """[in_ch, n] in in_fmt -> [out_ch, m] in out_fmt, on the device."""
        if not isinstance(samples, torch.Tensor):
            samples = torch.from_numpy(np.ascontiguousarray(samples))
        x = to_float(samples.to(self.device), self.in_fmt)
        if self.matrix is not None:
            x = apply_matrix(x, self.matrix)
        if self.resampler is not None:
            x = self.resampler.process(x, final=final)
        if (self._ditherer is not None
                and self.out_fmt.rstrip("p") in ("s16", "s32", "u8")):
            return self._ditherer.apply(x, self.out_fmt)
        return from_float(x, self.out_fmt)

    def convert_frame(self, frame: AudioFrame, final: bool = False) -> AudioFrame:
        out = self.convert(frame.data, final=final)
        if frame.pts != NOPTS:
            pts = rescale(frame.pts * frame.time_base.num * self.out_rate,
                          1, frame.time_base.den)
        else:
            pts = self._next_pts
        self._next_pts = pts + out.shape[1]
        return AudioFrame(
            data=out, sample_rate=self.out_rate, sample_fmt=self.out_fmt,
            layout=self.out_layout, pts=pts,
            time_base=Rational(1, self.out_rate),
        )

    def flush_frame(self) -> AudioFrame:
        out = (self.resampler.flush() if self.resampler is not None
               else torch.zeros((self.out_layout.nb_channels, 0),
                                dtype=torch.float32, device=self.device))
        out = from_float(out, self.out_fmt)
        pts = self._next_pts
        self._next_pts += out.shape[1]
        return AudioFrame(
            data=out, sample_rate=self.out_rate, sample_fmt=self.out_fmt,
            layout=self.out_layout, pts=pts,
            time_base=Rational(1, self.out_rate),
        )
