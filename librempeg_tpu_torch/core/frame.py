"""Media frames over tensors.

Port of librempeg_tpu/core/frame.py. A frame holds its planes as torch
tensors (or numpy arrays before upload) plus static metadata. There is
no pytree registration: PyTorch runs eagerly, so frames never cross a
tracing boundary. ``to_device`` takes an explicit device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from librempeg_tpu_torch.core import pixfmt as _pixfmt
from librempeg_tpu_torch.core.rational import NOPTS, Rational


class PictType:
    NONE = "?"
    I = "I"  # noqa: E741
    P = "P"
    B = "B"


def _to_tensor(p, device) -> torch.Tensor:
    if isinstance(p, torch.Tensor):
        return p.to(device)
    return torch.from_numpy(np.ascontiguousarray(p)).to(device)


def _to_numpy(p) -> np.ndarray:
    if isinstance(p, torch.Tensor):
        return p.detach().cpu().numpy()
    return np.asarray(p)


@dataclass(frozen=True)
class VideoFrame:
    """One video frame: per-plane dense tensors + metadata.

    Plane shapes follow the format descriptor (yuv420p 1080x1920 ->
    ((1080, 1920), (540, 960), (540, 960)))."""

    planes: tuple[Any, ...]
    format: str
    width: int
    height: int
    pts: int = NOPTS
    time_base: Rational = Rational(1, 25)
    duration: int = 0
    pict_type: str = PictType.NONE
    key_frame: bool = True
    color_range: str = "unspecified"
    sample_aspect_ratio: Rational = Rational(0, 1)
    interlaced: bool = False
    side_data: dict = field(default_factory=dict, compare=False)

    @property
    def desc(self) -> _pixfmt.PixFmtDesc:
        return _pixfmt.get(self.format)

    def replace(self, **kw) -> "VideoFrame":
        return dataclasses.replace(self, **kw)

    def to_device(self, device) -> "VideoFrame":
        """Planes as tensors on `device` (hwframe upload analog)."""
        return self.replace(planes=tuple(_to_tensor(p, device)
                                         for p in self.planes))

    def to_host(self) -> "VideoFrame":
        return self.replace(planes=tuple(_to_numpy(p) for p in self.planes))

    def validate(self) -> "VideoFrame":
        d = self.desc
        if len(self.planes) != d.nb_planes:
            raise ValueError(f"{self.format}: expected {d.nb_planes} "
                             f"planes, got {len(self.planes)}")
        for i, p in enumerate(self.planes):
            ph, pw = d.plane_shape(i, self.height, self.width)
            ncomp = len(d.planes[i].components)
            want = (ph, pw) if ncomp == 1 else (ph, pw, ncomp)
            if tuple(p.shape) != want:
                raise ValueError(f"{self.format} plane {i}: expected "
                                 f"shape {want}, got {tuple(p.shape)}")
        return self

    @property
    def end_pts(self) -> int:
        if self.pts == NOPTS:
            return NOPTS
        return self.pts + self.duration


@dataclass(frozen=True)
class AudioFrame:
    """A block of planar audio, `data` shaped [channels, nb_samples]."""

    data: Any
    sample_rate: int
    sample_fmt: str = "fltp"
    layout: Any = None
    pts: int = NOPTS
    time_base: Rational = Rational(0, 1)
    side_data: dict = field(default_factory=dict, compare=False)

    def __post_init__(self):
        if not self.time_base.valid or self.time_base.num == 0:
            object.__setattr__(self, "time_base",
                               Rational(1, self.sample_rate))

    @property
    def nb_channels(self) -> int:
        return int(self.data.shape[0])

    @property
    def nb_samples(self) -> int:
        return int(self.data.shape[1])

    def replace(self, **kw) -> "AudioFrame":
        return dataclasses.replace(self, **kw)

    def to_device(self, device) -> "AudioFrame":
        return self.replace(data=_to_tensor(self.data, device))

    def to_host(self) -> "AudioFrame":
        return self.replace(data=_to_numpy(self.data))
