"""Container layer public API: probe, demux, mux.

Analog of libavformat's core (libavformat/avformat.h:1335
AVFormatContext; demux.c:1590 av_read_frame; mux.c:1223
av_interleaved_write_frame; format.c probe scoring).

Shape of the API:

    ctx = open_input("in.wav")           # probe + read header
    for pkt in ctx.packets(): ...        # av_read_frame loop
    out = open_output("out.wav")
    out.add_stream(...); out.write_header()
    out.write(pkt)                       # interleaves by dts
    out.write_trailer()
"""
from __future__ import annotations

import heapq
import os
from dataclasses import dataclass, field
from typing import Any, Iterator

from librempeg_tpu_torch.core.errors import EndOfStream, InvalidData, NotFound
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import NOPTS, Rational, compare_ts
from librempeg_tpu_torch.formats.io import IOContext, MemoryIO, open_io

PROBE_SCORE_MAX = 100
PROBE_SCORE_EXTENSION = 50


@dataclass
class CodecParameters:
    """Stream codec parameters (AVCodecParameters analog)."""

    codec_type: str = "unknown"      # "video" | "audio" | "subtitle" | "data"
    codec_id: str = ""               # codec name, e.g. "pcm_s16le", "mjpeg"
    extradata: bytes = b""
    bit_rate: int = 0
    # audio
    sample_rate: int = 0
    nb_channels: int = 0
    sample_fmt: str = ""
    block_align: int = 0
    frame_size: int = 0
    # video
    width: int = 0
    height: int = 0
    pix_fmt: str = ""
    framerate: Rational = Rational(0, 1)
    sample_aspect_ratio: Rational = Rational(0, 1)
    extra: dict = field(default_factory=dict)


@dataclass
class Stream:
    index: int
    codecpar: CodecParameters
    time_base: Rational = Rational(1, 90000)
    duration: int = NOPTS
    nb_frames: int = 0
    start_time: int = NOPTS
    metadata: dict = field(default_factory=dict)
    avg_frame_rate: Rational = Rational(0, 1)


class Demuxer:
    """Base demuxer. Subclasses set NAME/EXTENSIONS and implement
    read_header/read_packet (and probe/read_seek when applicable)."""

    NAME = ""
    LONG_NAME = ""
    EXTENSIONS: tuple[str, ...] = ()

    def __init__(self):
        self.streams: list[Stream] = []
        self.metadata: dict[str, str] = {}
        self.io: IOContext | None = None
        self.duration: int = NOPTS  # in TIME_BASE (microseconds)

    # subclass interface ----------------------------------------------
    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        """Return a confidence score 0..PROBE_SCORE_MAX for this format."""
        return 0

    def read_header(self, io: IOContext) -> None:
        raise NotImplementedError

    def read_packet(self) -> Packet:
        """Return the next packet or raise EndOfStream."""
        raise NotImplementedError

    def read_seek(self, stream_index: int, ts: int) -> None:
        """Position so the next packets start at the last KEY packet
        with pts <= ts on `stream_index`.

        Format-specific demuxers override this with real index lookups
        (mp4 stss, mkv cues, ...); this generic fallback -- the
        ff_seek_frame_binary role (libavformat/seek.c:290) for formats
        without one -- re-parses from byte 0 and scans packets,
        retaining everything from the chosen keyframe onward so
        interleaved audio stays aligned. O(file), always correct, and
        only used when -ss is requested on an index-less container.
        """
        self.generic_seek(stream_index, ts)

    def generic_seek(self, stream_index: int, ts: int) -> None:
        from collections import deque

        seekable = getattr(self.io, "seekable", False)
        if callable(seekable):
            seekable = seekable()
        if self.io is None or not seekable:
            raise NotImplementedError(
                f"{self.NAME}: cannot seek unseekable input")
        self.io.seek(0)
        self._replay = deque()
        self.streams = []
        self.read_header(self.io)
        self.on_restore()
        queue: deque = deque()
        have_key = False
        while True:
            try:
                pkt = self.read_packet()
            except EndOfStream:
                break
            if pkt.stream_index == stream_index:
                t = pkt.pts if pkt.pts != NOPTS else pkt.dts
                is_key = bool(pkt.flags & PktFlags.KEY)
                if is_key and (t == NOPTS or t <= ts or not have_key):
                    queue.clear()
                    have_key = True
                queue.append(pkt)
                if have_key and t != NOPTS and t >= ts:
                    break
            elif have_key:
                queue.append(pkt)
        self._replay = queue
        # shadow read_packet on the instance so callers drain the
        # retained packets before live demuxing resumes
        if not getattr(self, "_replay_wrapped", False):
            inner = self.read_packet

            def _rp():
                if self._replay:
                    return self._replay.popleft()
                return inner()

            self.read_packet = _rp
            self._replay_wrapped = True

    def tell_resume(self) -> int:
        """Byte offset a checkpoint should seek to on restore. Demuxers
        with internal read-ahead buffers override this to report the
        offset of the first *unconsumed* byte, not the raw io position."""
        return self.io.tell()

    def on_restore(self) -> None:
        """Called after a checkpoint restore seeks the io: drop any
        internal read-ahead state so reading resumes at the io position."""

    # public ----------------------------------------------------------
    def packets(self) -> Iterator[Packet]:
        while True:
            try:
                yield self.read_packet()
            except EndOfStream:
                return

    def close(self) -> None:
        if self.io is not None:
            self.io.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Muxer:
    """Base muxer. write() interleaves packets by dts across streams
    before handing them to write_packet (mux.c interleaving contract)."""

    NAME = ""
    SUPPORTED_TYPES = ("video", "audio")
    LONG_NAME = ""
    EXTENSIONS: tuple[str, ...] = ()
    # formats that need global interleaving; raw single-stream ones don't
    INTERLEAVE = True

    def __init__(self, io: IOContext):
        self.io = io
        self.streams: list[Stream] = []
        self.metadata: dict[str, str] = {}
        self._queue: list[tuple[Any, int, Packet]] = []  # (key, seq, pkt)
        self._seq = 0
        self._header_written = False
        import threading

        self._wlock = threading.RLock()

    def add_stream(self, codecpar: CodecParameters,
                   time_base: Rational | None = None) -> Stream:
        st = Stream(index=len(self.streams), codecpar=codecpar,
                    time_base=time_base or Rational(1, 90000))
        self.streams.append(st)
        return st

    # subclass interface ----------------------------------------------
    def write_header(self) -> None:
        self._header_written = True

    def write_packet(self, pkt: Packet) -> None:
        raise NotImplementedError

    def write_trailer(self) -> None:
        pass

    # public ----------------------------------------------------------
    def write(self, pkt: Packet) -> None:
        """Submit a packet; interleaved delivery by dts (av_interleaved_
        write_frame). Packets within a stream must have monotonic dts.
        Thread-safe: the transcode pipeline's fetch/pack worker and the
        main loop may both submit."""
        with self._wlock:
            if not self._header_written:
                self.write_header()
            if not self.INTERLEAVE or len(self.streams) <= 1:
                self.write_packet(pkt)
                return
            self._queue.append((self._seq, pkt))
            self._seq += 1
            # flush every packet that can no longer be preempted: all
            # streams have something queued, emit smallest dts first
            self._drain(final=False)

    def _drain(self, final: bool) -> None:
        while self._queue:
            queued_streams = {p.stream_index for _, p in self._queue}
            if not final and len(queued_streams) < len(self.streams):
                return
            best = min(
                range(len(self._queue)),
                key=lambda i: self._cmp_key(self._queue[i]),
            )
            _, pkt = self._queue.pop(best)
            self.write_packet(pkt)

    def _cmp_key(self, item):
        seq, p = item
        st = self.streams[p.stream_index]
        ts = p.dts if p.dts != NOPTS else p.pts
        tb = p.time_base if p.time_base.valid and p.time_base.num else st.time_base
        # order by time then arrival
        return (ts * tb.num / tb.den if ts != NOPTS else float("-inf"), seq)

    def finish(self) -> None:
        if not self._header_written:
            self.write_header()
        self._drain(final=True)
        self.write_trailer()
        self.io.flush()

    def close(self) -> None:
        self.finish()
        self.io.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- registries -------------------------------------------------------------

_DEMUXERS: dict[str, type[Demuxer]] = {}
_MUXERS: dict[str, type[Muxer]] = {}


def register_demuxer(cls: type[Demuxer]) -> type[Demuxer]:
    _DEMUXERS[cls.NAME] = cls
    return cls


def register_muxer(cls: type[Muxer]) -> type[Muxer]:
    _MUXERS[cls.NAME] = cls
    return cls


def demuxers() -> dict[str, type[Demuxer]]:
    _ensure_registered()
    return dict(_DEMUXERS)


def muxers() -> dict[str, type[Muxer]]:
    _ensure_registered()
    return dict(_MUXERS)


def _ensure_registered() -> None:
    """Import the port's container modules (H.264 ES in, AVI out)."""
    from librempeg_tpu_torch.formats import avi, rawes  # noqa: F401


def probe_format(buf: bytes, filename: str = "") -> tuple[type[Demuxer] | None, int]:
    """Score all demuxers on a probe buffer (av_probe_input_format)."""
    _ensure_registered()
    best, best_score = None, 0
    for cls in _DEMUXERS.values():
        score = cls.probe(buf, filename)
        if score > best_score:
            best, best_score = cls, score
    return best, best_score


def open_input(url: str, format: str | None = None, **demux_opts) -> Demuxer:
    """Open and probe an input (avformat_open_input +
    avformat_find_stream_info). demux_opts go to the demuxer constructor
    (e.g. rawvideo's pix_fmt/width/height — the AVDictionary options of
    the reference)."""
    _ensure_registered()
    if format is not None:
        try:
            cls = _DEMUXERS[format]
        except KeyError:
            raise NotFound(f"unknown input format {format!r}") from None
        if getattr(cls, "URL_IS_GRAPH", False):
            # virtual device (lavfi): the "url" IS the input description
            io = MemoryIO(url.encode())
        else:
            io = open_io(url, "r")
    else:
        io = open_io(url, "r")
        buf = io.peek(4096)
        cls, score = probe_format(buf, url)
        if cls is None:
            raise InvalidData(f"{url}: could not determine input format")
    d = cls(**demux_opts)
    d.io = io
    d.read_header(io)
    return d


def open_input_bytes(data: bytes, format: str | None = None,
                     **demux_opts) -> Demuxer:
    _ensure_registered()
    io = MemoryIO(data)
    if format is not None:
        cls = _DEMUXERS[format]
    else:
        cls, _ = probe_format(io.peek(4096))
        if cls is None:
            raise InvalidData("could not determine input format")
    d = cls(**demux_opts)
    d.io = io
    d.read_header(io)
    return d


def guess_format(url: str = "", format: str | None = None) -> type[Muxer]:
    """Select a muxer by explicit name or output extension
    (av_guess_format)."""
    _ensure_registered()
    if format is not None:
        try:
            return _MUXERS[format]
        except KeyError:
            raise NotFound(f"unknown output format {format!r}") from None
    ext = os.path.splitext(url)[1].lstrip(".").lower()
    for cls in _MUXERS.values():
        if ext in cls.EXTENSIONS:
            return cls
    raise NotFound(f"cannot guess output format for {url!r}")


def open_output(url: str, format: str | None = None) -> Muxer:
    cls = guess_format(url, format)
    if "%" in url and cls.NAME == "image2":
        # patterned image sequence: the muxer opens per-frame files itself
        io = MemoryIO()
        io.url = url
        return cls(io)
    return cls(open_io(url, "w"))


def open_output_bytes(format: str) -> Muxer:
    cls = guess_format("", format)
    return cls(MemoryIO())
