"""Audio sample formats and channel layouts.

Analog of libavutil/samplefmt.{c,h} and channel_layout.h.

Copy of librempeg_tpu/core/samplefmt.py (no framework code). Audio
lives as tensors shaped [channels, samples] (planar) whatever the
container's format; codecs/pcm converts between the sample formats and
float32, and resample.Swr narrows back to integer formats.
"""
from __future__ import annotations

import re
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
# Channel layouts: libavutil 57's AVChannelLayout of a native (mask) or
# unspecified order, its channel_layout_map and av_channel_layout_*
# rules (channel_layout.c); tests/test_torch_channel_layouts.py holds
# them to tests/data/torch_port/libav_layouts.json
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

#: av_channel_name of each channel bit (AVChannel); "" where libavutil
#: names it USR<bit>
CHANNEL_NAMES = ("FL", "FR", "FC", "LFE", "BL", "BR", "FLC", "FRC", "BC",
                 "SL", "SR", "TC", "TFL", "TFC", "TFR", "TBL", "TBC",
                 "TBR") + ("",) * 11 + (
                 "DL", "DR", "WL", "WR", "SDL", "SDR", "LFE2", "TSL",
                 "TSR", "BFC", "BFL", "BFR")

#: libavutil's channel_layout_map, in its order (the AV_CH_LAYOUT_*
#: masks); av_channel_layout_default(n) is the first layout of n
#: channels here
LAYOUTS: dict[str, int] = {
    "mono": 0x4,
    "stereo": 0x3,
    "2.1": 0xB,
    "3.0": 0x7,
    "3.0(back)": 0x103,
    "4.0": 0x107,
    "quad": 0x33,
    "quad(side)": 0x603,
    "3.1": 0xF,
    "5.0": 0x37,
    "5.0(side)": 0x607,
    "4.1": 0x10F,
    "5.1": 0x3F,
    "5.1(side)": 0x60F,
    "6.0": 0x707,
    "6.0(front)": 0x6C3,
    "hexagonal": 0x137,
    "6.1": 0x70F,
    "6.1(back)": 0x13F,
    "6.1(front)": 0x6CB,
    "7.0": 0x637,
    "7.0(front)": 0x6C7,
    "7.1": 0x63F,
    "7.1(wide)": 0xFF,
    "7.1(wide-side)": 0x6CF,
    "octagonal": 0x737,
    "hexadecagonal": 0x18003F737,
    "downmix": 0x60000000,
    "22.2": 0x1F80003FFFF,
}


def _channel_name(bit: int) -> str:
    return (CHANNEL_NAMES[bit] if bit < len(CHANNEL_NAMES) else "") \
        or f"USR{bit}"


@dataclass(frozen=True)
class ChannelLayout:
    """Channel layout (AVChannelLayout): a channel count and a mask of
    channel bits in native order, or mask 0 for an unspecified order."""

    nb_channels: int
    mask: int = 0

    @staticmethod
    def from_mask(mask: int) -> "ChannelLayout":
        return ChannelLayout(bin(mask).count("1"), mask)

    @staticmethod
    def from_string(s: str) -> "ChannelLayout":
        """av_channel_layout_from_string: a layout name, channel names
        joined by "+", a mask ("0x3f", or a decimal number, as libavutil
        57 still reads it), "<n>c" (the default layout of n channels),
        or "<n>C" / "<n> channels" (n channels in no known order)."""
        if s in LAYOUTS:
            return ChannelLayout.from_mask(LAYOUTS[s])
        names = s.split("+")
        if all(n and n in CHANNEL_NAMES for n in names):
            return ChannelLayout.from_mask(
                sum(1 << CHANNEL_NAMES.index(n) for n in set(names)))
        m = re.fullmatch(r"0[xX]([0-9a-fA-F]+)|(\d+)", s)
        mask = (int(m[1], 16) if m[1] else int(m[2])) if m else 0
        if mask:
            return ChannelLayout.from_mask(mask)
        m = re.fullmatch(r"(\d+)(c|C| channels)", s)
        if m and int(m[1]):
            n = int(m[1])
            if m[2] != "c":
                return ChannelLayout(n)
            if ChannelLayout.default(n).mask:
                return ChannelLayout.default(n)
        raise ValueError(f"unknown channel layout {s!r}")

    @staticmethod
    def default(nb_channels: int) -> "ChannelLayout":
        """av_channel_layout_default: the first layout of channel_layout_map
        with this many channels, else the count in no known order."""
        for m in LAYOUTS.values():
            if bin(m).count("1") == nb_channels:
                return ChannelLayout(nb_channels, m)
        return ChannelLayout(nb_channels, 0)

    @property
    def name(self) -> str:
        """av_channel_layout_describe."""
        if not self.mask:
            return f"{self.nb_channels} channels"
        for k, v in LAYOUTS.items():
            if v == self.mask:
                return k
        return (f"{self.nb_channels} channels ("
                + "+".join(map(_channel_name, self.channels())) + ")")

    def channels(self) -> list[int]:
        """Bit positions of each channel, in order."""
        if not self.mask:
            return list(range(self.nb_channels))
        return [i for i in range(64) if self.mask >> i & 1]


MONO = ChannelLayout.from_string("mono")
STEREO = ChannelLayout.from_string("stereo")
