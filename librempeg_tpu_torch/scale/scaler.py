"""Video scaling: the direct planar YUV path.

Port of the direct planar path of librempeg_tpu/scale/scaler.py
(Scaler._plan, :151-169): Y, U and V are resized in their own domains by
separable float32 GEMMs (ops/fir) and stored with floor(x + 0.5).
Conversions that need a colour-space change (the RGB 4:4:4 path,
ops/colorspace) are not ported yet and raise Unsupported.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from librempeg_tpu_torch.core import pixfmt as pf
from librempeg_tpu_torch.core.errors import Unsupported
from librempeg_tpu_torch.core.frame import VideoFrame
from librempeg_tpu_torch.ops.fir import resize_plane
from librempeg_tpu_torch.ops.firdesign import SCALER_KERNEL_NAMES


def _round_store(x: torch.Tensor) -> torch.Tensor:
    """floor(x + 0.5), clamped to 0..255, as uint8."""
    return torch.floor(x + 0.5).clamp(0.0, 255.0).to(torch.uint8)


def _load_scaled(x, device) -> torch.Tensor:
    """An 8-bit plane as float32 on `device` (the 0..255 working
    domain)."""
    return torch.as_tensor(x, device=device).to(torch.float32)


@dataclass(frozen=True)
class ScalerSpec:
    src_fmt: str
    src_w: int
    src_h: int
    dst_fmt: str
    dst_w: int
    dst_h: int
    kernel: str = "bicubic"


class Scaler:
    """Scaling plan for one (src, dst) signature, planar YUV only."""

    def __init__(self, src_fmt: str, src_w: int, src_h: int,
                 dst_fmt: str, dst_w: int, dst_h: int,
                 kernel: str = "bicubic"):
        if kernel not in SCALER_KERNEL_NAMES:
            raise Unsupported(f"unknown scaler kernel {kernel!r}")
        self.spec = ScalerSpec(src_fmt, src_w, src_h, dst_fmt, dst_w,
                               dst_h, kernel)
        sd = self.src_desc = pf.get(src_fmt)
        dd = self.dst_desc = pf.get(dst_fmt)
        self._dst_full = dd.default_range == pf.ColorRange.JPEG
        if (sd.is_rgb or dd.is_rgb or sd.nb_planes != 3
                or dd.nb_planes != 3 or sd.bit_depth != 8
                or dd.bit_depth != 8
                or (sd.default_range == pf.ColorRange.JPEG)
                != self._dst_full):
            raise Unsupported(
                f"scale: {src_fmt} -> {dst_fmt} is not ported yet (only "
                "8-bit planar YUV without a range change)")

    def scale_planes(self, planes, device=None):
        """Tuple of plane tensors (optional leading batch dims) -> the
        resized, rounded planes on `device` (default: the first plane's
        device)."""
        s, dd = self.spec, self.dst_desc
        if device is None:
            device = planes[0].device if isinstance(
                planes[0], torch.Tensor) else "cpu"
        out = []
        for i, p in enumerate(planes):
            ph, pw = dd.plane_shape(i, s.dst_h, s.dst_w)
            x = resize_plane(_load_scaled(p, device), ph, pw, s.kernel)
            out.append(_round_store(x))
        return tuple(out)

    def scale_frame(self, frame: VideoFrame) -> VideoFrame:
        return frame.replace(
            planes=self.scale_planes(frame.planes),
            format=self.spec.dst_fmt, width=self.spec.dst_w,
            height=self.spec.dst_h,
            color_range="jpeg" if self._dst_full else "mpeg")


@functools.lru_cache(maxsize=64)
def get_scaler(src_fmt: str, src_w: int, src_h: int,
               dst_fmt: str, dst_w: int, dst_h: int,
               kernel: str = "bicubic") -> Scaler:
    """Cached scaler lookup (sws_getCachedContext analog)."""
    return Scaler(src_fmt, src_w, src_h, dst_fmt, dst_w, dst_h, kernel)
