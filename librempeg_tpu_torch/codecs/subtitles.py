"""Text subtitle codecs: SubRip (SRT) and ASS/SSA decode + SRT encode.

The subtitle codec class the reference implements across srtdec.c /
assdec.c / srtenc.c: packets carry one cue each; decoding yields
SubtitleCue objects (plain text plus the original markup), encoding
emits the SRT payload form. ASS override blocks ({\\...}) and the
\\N/\\n/\\h escapes are normalized to plain text; SRT's HTML-ish tags
are preserved in `markup` and stripped in `text`.

Behavioral reference: libavcodec/srtdec.c:116,
assdec.c, srtenc.c.

A copy of librempeg_tpu/codecs/subtitles.py (host code) with its imports
rewritten to the port's modules.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

from librempeg_tpu_torch.codecs.api import (
    CodecInfo,
    Decoder,
    Encoder,
    register_decoder,
    register_encoder,
)
from librempeg_tpu_torch.core.packet import Packet
from librempeg_tpu_torch.core.rational import NOPTS, Rational
from librempeg_tpu_torch.device import resolve


@dataclass
class SubtitleCue:
    """One decoded subtitle event."""

    text: str                      # plain text (markup stripped)
    markup: str = ""               # original payload text
    pts: int = NOPTS
    duration: int = 0
    time_base: Rational = field(default_factory=lambda: Rational(1, 1000))

    @property
    def media(self) -> str:        # duck-typing with frames
        return "subtitle"


_TAG_RE = re.compile(r"<[^>]+>")
_ASS_OVERRIDE_RE = re.compile(r"\{\\[^}]*\}")


def _strip_srt(text: str) -> str:
    return _TAG_RE.sub("", text)


def _ass_event_text(line: str) -> str:
    """Text field of an ASS event (mkv: 'ReadOrder,Layer,Style,Name,
    MarginL,MarginR,MarginV,Effect,Text'; file form starts 'Dialogue:'
    with Start/End in place of ReadOrder)."""
    if line.startswith("Dialogue:"):
        parts = line[9:].split(",", 9)
        text = parts[9] if len(parts) > 9 else ""
    else:
        parts = line.split(",", 8)
        text = parts[8] if len(parts) > 8 else line
    text = _ASS_OVERRIDE_RE.sub("", text)
    text = text.replace("\\N", "\n").replace("\\n", "\n")
    return text.replace("\\h", " ")


class _TextDecoder(Decoder):
    """A text subtitle decoder: cues are host strings, and the device
    only follows the port's policy (a decoder builds on the card unless
    the caller names the CPU; without a card a CUDA request raises)."""

    def __init__(self, params=None, device="cuda", **opts):
        super().__init__(params, **opts)
        self.device = resolve(device)


@register_decoder
class SubripDecoder(_TextDecoder):
    INFO = CodecInfo(name="subrip", long_name="SubRip subtitle",
                     codec_type="subtitle")
    ALIASES = ("srt",)

    def decode(self, pkt: Packet):
        raw = bytes(pkt.data).decode("utf-8", "replace").strip("\x00")
        return [SubtitleCue(text=_strip_srt(raw).strip(), markup=raw,
                            pts=pkt.pts, duration=pkt.duration or 0,
                            time_base=pkt.time_base)]

    def flush(self):
        return []


@register_decoder
class AssDecoder(_TextDecoder):
    INFO = CodecInfo(name="ass", long_name="ASS/SSA subtitle",
                     codec_type="subtitle")
    ALIASES = ("ssa",)

    def decode(self, pkt: Packet):
        raw = bytes(pkt.data).decode("utf-8", "replace").strip("\x00")
        return [SubtitleCue(text=_ass_event_text(raw).strip(),
                            markup=raw, pts=pkt.pts,
                            duration=pkt.duration or 0,
                            time_base=pkt.time_base)]

    def flush(self):
        return []


@register_encoder
class SubripEncoder(Encoder):
    INFO = CodecInfo(name="subrip", long_name="SubRip subtitle",
                     codec_type="subtitle")

    def __init__(self, **opts):
        super().__init__(**opts)
        self.time_base = Rational(1, 1000)

    def codec_parameters(self):
        from librempeg_tpu_torch.formats.api import CodecParameters

        return CodecParameters(codec_type="subtitle", codec_id="subrip")

    def encode(self, cue) -> list[Packet]:
        data = cue.text.encode("utf-8")
        pts = cue.pts
        dur = cue.duration
        if cue.time_base.valid and cue.time_base.num and pts != NOPTS:
            pts = pts * 1000 * cue.time_base.num // cue.time_base.den
            dur = dur * 1000 * cue.time_base.num // cue.time_base.den
        return [Packet(data=data, pts=pts, dts=pts, duration=dur,
                       time_base=Rational(1, 1000))]

    def flush(self):
        return []


def load_cues(url: str, device="cuda") -> list[SubtitleCue]:
    """Parse a subtitle FILE into cues (the vf_subtitles input path:
    open the file with the demuxer, decode every packet); `device` is
    the decoder's (see _TextDecoder)."""
    from librempeg_tpu_torch.codecs.api import find_decoder
    from librempeg_tpu_torch.formats.api import open_input

    demux = open_input(url)
    subs = [s for s in demux.streams
            if s.codecpar.codec_type == "subtitle"]
    if not subs:
        raise ValueError(f"{url}: no subtitle stream")
    st = subs[0]
    dec = find_decoder(st.codecpar.codec_id)(st.codecpar, device=device)
    cues = []
    for pkt in demux.packets():
        if pkt.stream_index != st.index:
            continue
        cues.extend(dec.decode(pkt))
    demux.close()
    cues.sort(key=lambda c: c.pts if c.pts != NOPTS else 0)
    return cues
