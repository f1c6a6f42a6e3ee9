"""Filter base classes.

Analog of libavfilter's AVFilter/AVFilterContext/AVFilterPad
(libavfilter/avfilter.h; activate model avfilter.c:1507).

TPU-first structure: filters declare whether they are PURE — a
stateless per-frame device transform exposed as `device_op(planes) ->
planes` plus static metadata mapping. The graph compiler fuses every
maximal chain of pure filters into ONE jitted device program per shape
signature (the XLA realization of the reference's ff_filter_activate
pipeline; swscale's SwsOp compiler applied to whole graphs). Stateful
filters (fps, trim, overlay alignment, sources/sinks) run at graph
level on the host and delimit fusion segments.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from librempeg_tpu_torch.core.errors import EndOfStream, NotFound, TryAgain
from librempeg_tpu_torch.core.frame import AudioFrame, VideoFrame
from librempeg_tpu_torch.core.options import OptionedObject

Frame = Any


@dataclass
class PadDesc:
    name: str
    media: str  # "video" | "audio"


@dataclass
class StreamProps:
    """Negotiated properties of a link (AVFilterLink's format fields)."""

    media: str = "video"
    # video
    width: int = 0
    height: int = 0
    pix_fmt: str = ""
    frame_rate: Any = None       # Rational
    sample_aspect_ratio: Any = None
    color_range: str = "unspecified"
    # audio
    sample_rate: int = 0
    sample_fmt: str = ""
    layout: Any = None
    time_base: Any = None

    def copy(self) -> "StreamProps":
        import dataclasses

        return dataclasses.replace(self)


class Filter(OptionedObject):
    """Base filter.

    Subclasses declare NAME, INPUTS, OUTPUTS and implement:
      * query_formats(in_props) -> out_props   (negotiation)
      * filter_frame(frame, pad) -> list[(out_pad, frame)]
      * flush() -> list[(out_pad, frame)]      (EOF drain)
    Pure filters also set PURE=True and implement device_op.
    """

    NAME = ""
    DESCRIPTION = ""
    INPUTS: Sequence[PadDesc] = (PadDesc("default", "video"),)
    OUTPUTS: Sequence[PadDesc] = (PadDesc("default", "video"),)
    PURE = False
    #: True when the filter can change the pixel/sample format between
    #: input and output (scale/format/aformat/aresample) — negotiation
    #: groups end at converters (avfiltergraph.c two-phase analog)
    CONVERTS = False
    #: True for N-input filters whose inputs the graph aligns by pts
    #: before delivery (framesync.c analog); such filters implement
    #: filter_frames(frames) instead of per-pad filter_frame
    FRAMESYNC = False
    #: declared order of positional (shorthand) options
    OPT_ORDER: Sequence[str] = ()
    #: set by filters/video2.mark_fused on a PURE filter in a chain of
    #: two or more, which the JAX package compiles into one XLA program;
    #: the float filters then take XLA's fused forms (video2)
    fused = False

    def in_formats(self, pad: int = 0):
        """Supported input pixel/sample formats (None = unconstrained)."""
        return None

    def out_formats(self, pad: int = 0):
        """Producible output formats. None means: same as input for
        non-converting filters, unconstrained for converters."""
        return None

    def filter_frames(self, frames: list):
        """FRAMESYNC delivery: one pts-aligned frame per input pad."""
        raise NotImplementedError

    def __init__(self, args: str = "", **kwargs):
        from librempeg_tpu_torch.core.options import apply_positional, parse_opt_string

        opts = parse_opt_string(args) if args else {}
        opts = apply_positional(opts, list(self.OPT_ORDER))
        opts.update(kwargs)
        super().__init__(**opts)
        self.in_props: list[StreamProps] = []
        self.out_props: list[StreamProps] = []

    # negotiation -----------------------------------------------------
    def configure(self, in_props: list[StreamProps]) -> list[StreamProps]:
        """Fix output properties given negotiated inputs."""
        self.in_props = in_props
        self.out_props = [p.copy() for p in in_props[:len(self.OUTPUTS)]]
        if not self.out_props and self.OUTPUTS:
            self.out_props = [StreamProps(media=self.OUTPUTS[0].media)]
        return self.out_props

    # processing ------------------------------------------------------
    def filter_frame(self, frame: Frame, pad: int = 0):
        return [(0, frame)]

    def flush(self):
        return []


class SourceFilter(Filter):
    """Filter with no inputs; graph pulls with request_frame()."""

    INPUTS: Sequence[PadDesc] = ()

    def request_frame(self) -> Frame:
        """Produce the next frame or raise EndOfStream."""
        raise EndOfStream


# registry ------------------------------------------------------------

_FILTERS: dict[str, type[Filter]] = {}


def register_filter(cls: type[Filter]) -> type[Filter]:
    _FILTERS[cls.NAME] = cls
    return cls


def _ensure_registered():
    from librempeg_tpu_torch.filters import (  # noqa: F401
        audio,
        biquads,
        color,
        drawtext,
        loudness,
        metrics,
        misc,
        misc2,
        sources,
        subtitles,
        video,
        video2,
        video3,
    )


def find_filter(name: str) -> type[Filter]:
    _ensure_registered()
    try:
        return _FILTERS[name]
    except KeyError:
        raise NotFound(f"filter {name!r} not found") from None


def filters() -> dict[str, type[Filter]]:
    _ensure_registered()
    return dict(_FILTERS)
