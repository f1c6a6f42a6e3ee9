"""SubRip (.srt) subtitle demuxer + muxer.

Analog of libavformat/srtdec.c / srtenc.c — adds the
subtitle media type to the framework (packets carry UTF-8 text with
pts/duration in milliseconds).

A copy of librempeg_tpu/formats/srt.py (host code) with its imports
rewritten to the port's modules.
"""
from __future__ import annotations

import re

from librempeg_tpu_torch.core.errors import EndOfStream, InvalidData
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import Rational
from librempeg_tpu_torch.formats.api import (
    CodecParameters,
    Demuxer,
    Muxer,
    Stream,
    register_demuxer,
    register_muxer,
)

_TIME_RE = re.compile(
    rb"(\d+):(\d+):(\d+)[,.](\d+)\s*-->\s*(\d+):(\d+):(\d+)[,.](\d+)")


def _ts_ms(h, m, s, ms) -> int:
    return ((int(h) * 60 + int(m)) * 60 + int(s)) * 1000 + int(ms)


@register_demuxer
class SrtDemuxer(Demuxer):
    NAME = "srt"
    LONG_NAME = "SubRip subtitle"
    EXTENSIONS = ("srt",)

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        head = buf[:512].lstrip(b"\xef\xbb\xbf \r\n")
        if re.match(rb"\d+\s*\r?\n\d+:\d+:\d+[,.]\d+\s*-->", head):
            return 90
        return 0

    def read_header(self, io):
        data = io.read(1 << 26)
        if data.startswith(b"\xef\xbb\xbf"):
            data = data[3:]
        self._cues = []
        for block in re.split(rb"\r?\n\r?\n", data):
            block = block.strip()
            if not block:
                continue
            lines = re.split(rb"\r?\n", block)
            ti = 0
            if lines and lines[0].strip().isdigit():
                ti = 1
            if ti >= len(lines):
                continue
            m = _TIME_RE.match(lines[ti].strip())
            if not m:
                continue
            start = _ts_ms(*m.groups()[:4])
            end = _ts_ms(*m.groups()[4:])
            text = b"\n".join(lines[ti + 1:])
            self._cues.append((start, end, text))
        par = CodecParameters(codec_type="subtitle", codec_id="subrip")
        self.streams = [Stream(index=0, codecpar=par,
                               time_base=Rational(1, 1000))]
        if self._cues:
            self.streams[0].duration = self._cues[-1][1]
        self._idx = 0

    def read_packet(self) -> Packet:
        if self._idx >= len(self._cues):
            raise EndOfStream
        start, end, text = self._cues[self._idx]
        self._idx += 1
        return Packet(data=text, pts=start, dts=start,
                      duration=end - start, flags=PktFlags.KEY,
                      time_base=Rational(1, 1000))


@register_muxer
class SrtMuxer(Muxer):
    NAME = "srt"
    LONG_NAME = "SubRip subtitle"
    EXTENSIONS = ("srt",)
    INTERLEAVE = False
    SUPPORTED_TYPES = ("subtitle",)

    def write_header(self):
        super().write_header()
        self._count = 0

    @staticmethod
    def _fmt(ms: int) -> bytes:
        h, ms = divmod(ms, 3600000)
        m, ms = divmod(ms, 60000)
        s, ms = divmod(ms, 1000)
        return b"%02d:%02d:%02d,%03d" % (h, m, s, ms)

    def write_packet(self, pkt: Packet):
        self._count += 1
        st = self.streams[pkt.stream_index]
        tb = pkt.time_base if pkt.time_base.valid and pkt.time_base.num \
            else st.time_base
        start = pkt.pts * 1000 * tb.num // tb.den
        end = (pkt.pts + pkt.duration) * 1000 * tb.num // tb.den
        self.io.write(b"%d\r\n" % self._count)
        self.io.write(self._fmt(start) + b" --> " + self._fmt(end) + b"\r\n")
        self.io.write(bytes(pkt.data).replace(b"\n", b"\r\n"))
        self.io.write(b"\r\n\r\n")
