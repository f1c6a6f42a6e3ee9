"""Codec parser registry (libavcodec/parsers.c + av_parser API analog).

A parser turns an unframed byte stream into codec frames/access units.
The split logic lives with each codec (raw-ES demuxers, flac frame
sync); this registry exposes it uniformly: feed bytes incrementally,
collect complete frames, flush the tail.

A copy of librempeg_tpu/codecs/parsers.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

from typing import Callable

from librempeg_tpu_torch.core.errors import NotFound

#: name -> split(data) -> (frames, consumed_bytes)
_PARSERS: dict[str, Callable] = {}


def register_parser(name: str):
    def deco(fn):
        _PARSERS[name] = fn
        return fn

    return deco


def find_parser(name: str) -> "Parser":
    if name not in _PARSERS:
        raise NotFound(f"parser {name!r} not found")
    return Parser(_PARSERS[name])


def parsers() -> dict[str, Callable]:
    return dict(_PARSERS)


class Parser:
    """Incremental framing driver (av_parser_parse2 loop shape)."""

    def __init__(self, split: Callable):
        self._split = split
        self._buf = bytearray()

    def parse(self, data: bytes) -> list[bytes]:
        self._buf += data
        frames, consumed = self._split(bytes(self._buf), final=False)
        del self._buf[:consumed]
        return frames

    def flush(self) -> list[bytes]:
        frames, _ = self._split(bytes(self._buf), final=True)
        self._buf.clear()
        return frames


def _split_on_marks(data: bytes, marks: list[int], final: bool):
    """Frames start at each mark; the last frame is complete only when
    `final` (or when a later mark bounds it)."""
    if not marks:
        return [], 0
    frames = []
    for i, m in enumerate(marks[:-1]):
        frames.append(data[m:marks[i + 1]])
    if final:
        frames.append(data[marks[-1]:])
        return frames, len(data)
    return frames, marks[-1]


@register_parser("mpeg4video")
def _parse_mpeg4(data: bytes, final: bool):
    """Access units start at VOP startcodes; leading config (VOS/VOL)
    attaches to the first VOP (m4vdec.c behavior)."""
    marks = []
    pos = 0
    while True:
        pos = data.find(b"\x00\x00\x01\xb6", pos)
        if pos < 0:
            break
        marks.append(pos)
        pos += 4
    if marks and marks[0] > 0:
        marks[0] = 0                 # config headers join first AU
    return _split_on_marks(data, marks, final)


@register_parser("h264")
def _parse_h264(data: bytes, final: bool):
    """AUs end after a slice NAL (1/5): an AU starts at the first
    startcode and at every startcode following a slice."""
    positions = []                   # (startcode offset, nal type)
    i = 0
    n = len(data)
    while True:
        j = data.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        sc = j - 1 if j > 0 and data[j - 1] == 0 else j
        if j + 3 < n:
            positions.append((sc, data[j + 3] & 0x1F))
        i = j + 3
    if not positions:
        return [], 0
    marks = [positions[0][0]]
    for k in range(1, len(positions)):
        if positions[k - 1][1] in (1, 5):
            marks.append(positions[k][0])
    return _split_on_marks(data, marks, final)


@register_parser("mjpeg")
def _parse_mjpeg(data: bytes, final: bool):
    """Frames are SOI..EOI spans (jpeg marker scan)."""
    frames = []
    pos = 0
    consumed = 0
    while True:
        soi = data.find(b"\xff\xd8", pos)
        if soi < 0:
            break
        eoi = data.find(b"\xff\xd9", soi + 2)
        if eoi < 0:
            break
        frames.append(data[soi:eoi + 2])
        pos = consumed = eoi + 2
    if final:
        consumed = len(data)
    return frames, consumed


@register_parser("flac")
def _parse_flac(data: bytes, final: bool):
    """Frames start at the 14-bit sync 0b11111111111110 (flac_parser.c
    sync scan; CRC validation happens in the decoder)."""
    marks = []
    pos = 0
    while pos + 2 <= len(data):
        if data[pos] == 0xFF and (data[pos + 1] & 0xFC) == 0xF8:
            marks.append(pos)
            pos += 2
        else:
            pos += 1
    return _split_on_marks(data, marks, final)
