"""Typed side-data wrappers.

Analog of libavutil/frame.h's AVFrameSideDataType and
libavcodec/packet.h's AVPacketSideDataType: instead of opaque byte
blobs keyed by enum, side data here is typed dataclasses stored in the
frame/packet `side_data` dict under their `KEY`. `set_side_data` /
`get_side_data` enforce the type mapping; unknown keys still pass
through as raw entries (the reference's unregistered-type behavior).

A copy of librempeg_tpu/core/sidedata.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from librempeg_tpu_torch.core.rational import Rational


@dataclass(frozen=True)
class DisplayMatrix:
    """Rotation/flip hint (AV_FRAME_DATA_DISPLAYMATRIX)."""

    KEY = "display_matrix"
    rotation_degrees: float = 0.0
    hflip: bool = False
    vflip: bool = False


@dataclass(frozen=True)
class ReplayGain:
    """Loudness normalization gains (AV_FRAME_DATA_REPLAYGAIN)."""

    KEY = "replaygain"
    track_gain_db: float = 0.0
    track_peak: float = 0.0
    album_gain_db: float = 0.0
    album_peak: float = 0.0


@dataclass(frozen=True)
class AudioServiceType:
    """AV_PKT_DATA_AUDIO_SERVICE_TYPE."""

    KEY = "audio_service_type"
    service: str = "main"   # main|effects|visually_impaired|...


@dataclass(frozen=True)
class SkipSamples:
    """Encoder delay/padding trim (AV_PKT_DATA_SKIP_SAMPLES)."""

    KEY = "skip_samples"
    start: int = 0
    end: int = 0


@dataclass(frozen=True)
class ContentLightLevel:
    """HDR content light level (AV_FRAME_DATA_CONTENT_LIGHT_LEVEL)."""

    KEY = "content_light_level"
    max_cll: int = 0
    max_fall: int = 0


@dataclass(frozen=True)
class MasteringDisplayMetadata:
    """SMPTE 2086 (AV_FRAME_DATA_MASTERING_DISPLAY_METADATA)."""

    KEY = "mastering_display"
    primaries: tuple = ()           # ((rx,ry),(gx,gy),(bx,by))
    white_point: tuple = ()
    min_luminance: float = 0.0
    max_luminance: float = 0.0


@dataclass(frozen=True)
class CropRect:
    """Container cropping (AV_FRAME_DATA_CROP_*)."""

    KEY = "crop"
    top: int = 0
    bottom: int = 0
    left: int = 0
    right: int = 0


@dataclass(frozen=True)
class Timecode:
    """SMPTE timecode (AV_FRAME_DATA_S12M_TIMECODE)."""

    KEY = "timecode"
    hours: int = 0
    minutes: int = 0
    seconds: int = 0
    frames: int = 0
    drop: bool = False
    rate: Rational = Rational(25, 1)

    def __str__(self):
        sep = ";" if self.drop else ":"
        return (f"{self.hours:02d}:{self.minutes:02d}:"
                f"{self.seconds:02d}{sep}{self.frames:02d}")


_TYPES = {cls.KEY: cls for cls in (
    DisplayMatrix, ReplayGain, AudioServiceType, SkipSamples,
    ContentLightLevel, MasteringDisplayMetadata, CropRect, Timecode)}


def side_data_types() -> dict:
    return dict(_TYPES)


def set_side_data(obj, value) -> None:
    """Attach typed side data to a frame/packet (av_frame_new_side_data).
    `value` must be one of the registered dataclasses."""
    key = getattr(type(value), "KEY", None)
    if key is None or key not in _TYPES:
        raise TypeError(f"not a registered side-data type: {type(value)}")
    obj.side_data[key] = value


def get_side_data(obj, cls):
    """Fetch typed side data or None (av_frame_get_side_data)."""
    v = obj.side_data.get(cls.KEY)
    if v is not None and not isinstance(v, cls):
        raise TypeError(f"side_data[{cls.KEY!r}] holds {type(v)}")
    return v


def skip_side_data(pkt, skip: int) -> tuple[int, int]:
    """The start skip and end discard a packet's SkipSamples side data
    sets, as libavcodec's decode.c reads AV_PKT_DATA_SKIP_SAMPLES: side
    data replaces the skip still pending; a packet without keeps it and
    discards nothing."""
    sd = get_side_data(pkt, SkipSamples)
    if sd is None:
        return skip, 0
    return max(0, sd.start), sd.end


def trim(pcm, skip: int, discard: int):
    """decode.c's discard_samples on one decoded frame [ch, n]: drop up
    to `skip` samples from its start, then `discard` from its end where
    that many are left (all of them drop the frame). Returns the frame,
    the samples dropped from its start and the skip still pending."""
    drop = min(skip, pcm.shape[1])
    pcm = pcm[:, drop:]
    if 0 < discard <= pcm.shape[1]:
        pcm = pcm[:, :pcm.shape[1] - discard]
    return pcm, drop, skip - drop
