"""Audio sample formats and channel layouts.

Analog of libavutil/samplefmt.{c,h} and channel_layout.h.

Copy of librempeg_tpu/core/samplefmt.py (no framework code). Audio
lives as tensors shaped [channels, samples] (planar) whatever the
container's format; codecs/pcm converts between the sample formats and
float32, and resample.Swr narrows back to integer formats.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SampleFmt:
    name: str
    dtype: "np.dtype"
    planar: bool
    bits: int
    is_float: bool


_FORMATS: dict[str, SampleFmt] = {}


def _reg(name: str, dtype, planar: bool, bits: int, is_float: bool) -> SampleFmt:
    f = SampleFmt(name, np.dtype(dtype), planar, bits, is_float)
    _FORMATS[name] = f
    return f


U8 = _reg("u8", np.uint8, False, 8, False)
S16 = _reg("s16", np.int16, False, 16, False)
S32 = _reg("s32", np.int32, False, 32, False)
S64 = _reg("s64", np.int64, False, 64, False)
FLT = _reg("flt", np.float32, False, 32, True)
DBL = _reg("dbl", np.float64, False, 64, True)
U8P = _reg("u8p", np.uint8, True, 8, False)
S16P = _reg("s16p", np.int16, True, 16, False)
S32P = _reg("s32p", np.int32, True, 32, False)
S64P = _reg("s64p", np.int64, True, 64, False)
FLTP = _reg("fltp", np.float32, True, 32, True)
DBLP = _reg("dblp", np.float64, True, 64, True)


def get(name: str) -> SampleFmt:
    try:
        return _FORMATS[name]
    except KeyError:
        raise ValueError(f"unknown sample format {name!r}") from None


def exists(name: str) -> bool:
    return name in _FORMATS


# ---------------------------------------------------------------------------
# Channel layouts (subset of channel_layout.h masks; same bit positions)
# ---------------------------------------------------------------------------

CH_FRONT_LEFT = 1 << 0
CH_FRONT_RIGHT = 1 << 1
CH_FRONT_CENTER = 1 << 2
CH_LOW_FREQUENCY = 1 << 3
CH_BACK_LEFT = 1 << 4
CH_BACK_RIGHT = 1 << 5
CH_FRONT_LEFT_OF_CENTER = 1 << 6
CH_FRONT_RIGHT_OF_CENTER = 1 << 7
CH_BACK_CENTER = 1 << 8
CH_SIDE_LEFT = 1 << 9
CH_SIDE_RIGHT = 1 << 10

LAYOUTS: dict[str, int] = {
    "mono": CH_FRONT_CENTER,
    "stereo": CH_FRONT_LEFT | CH_FRONT_RIGHT,
    "2.1": CH_FRONT_LEFT | CH_FRONT_RIGHT | CH_LOW_FREQUENCY,
    "3.0": CH_FRONT_LEFT | CH_FRONT_RIGHT | CH_FRONT_CENTER,
    "4.0": CH_FRONT_LEFT | CH_FRONT_RIGHT | CH_FRONT_CENTER | CH_BACK_CENTER,
    "quad": CH_FRONT_LEFT | CH_FRONT_RIGHT | CH_BACK_LEFT | CH_BACK_RIGHT,
    "5.0": CH_FRONT_LEFT | CH_FRONT_RIGHT | CH_FRONT_CENTER | CH_SIDE_LEFT | CH_SIDE_RIGHT,
    "5.1": CH_FRONT_LEFT | CH_FRONT_RIGHT | CH_FRONT_CENTER | CH_LOW_FREQUENCY
           | CH_SIDE_LEFT | CH_SIDE_RIGHT,
    "7.1": CH_FRONT_LEFT | CH_FRONT_RIGHT | CH_FRONT_CENTER | CH_LOW_FREQUENCY
           | CH_BACK_LEFT | CH_BACK_RIGHT | CH_SIDE_LEFT | CH_SIDE_RIGHT,
}


@dataclass(frozen=True)
class ChannelLayout:
    """Channel layout: count + optional positional mask (AVChannelLayout)."""

    nb_channels: int
    mask: int = 0

    @staticmethod
    def from_string(s: str) -> "ChannelLayout":
        if s in LAYOUTS:
            m = LAYOUTS[s]
            return ChannelLayout(bin(m).count("1"), m)
        if s.endswith("c") and s[:-1].isdigit():
            return ChannelLayout.default(int(s[:-1]))
        if s.isdigit():
            return ChannelLayout.default(int(s))
        raise ValueError(f"unknown channel layout {s!r}")

    @staticmethod
    def default(nb_channels: int) -> "ChannelLayout":
        """Default layout for a channel count (av_channel_layout_default)."""
        for m in LAYOUTS.values():
            if bin(m).count("1") == nb_channels:
                return ChannelLayout(nb_channels, m)
        return ChannelLayout(nb_channels, 0)

    @property
    def name(self) -> str:
        for k, v in LAYOUTS.items():
            if v == self.mask and self.mask:
                return k
        return f"{self.nb_channels}c"

    def channels(self) -> list[int]:
        """Bit positions of each channel, in order."""
        if not self.mask:
            return list(range(self.nb_channels))
        return [i for i in range(64) if self.mask >> i & 1]


MONO = ChannelLayout.from_string("mono")
STEREO = ChannelLayout.from_string("stereo")
