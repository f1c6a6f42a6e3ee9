"""Codec layer public API.

Analog of libavcodec's push/pull contract
(libavcodec/avcodec.h:95-151; decode.c:729
avcodec_send_packet, encode.c:518 avcodec_send_frame) and the codec
registry (allcodecs.c, FFCodec vtable codec_internal.h:127).

Decoders/encoders are classes with a declarative descriptor; the
send/receive state machine (buffering, draining, EOF) lives here once,
like the reference's decode.c/encode.c engines.

TPU-batching: decoders may implement `decode_batch(packets) ->
frames` to amortize one device program over many frames; the base class
exposes it through the same per-frame API while `librempeg_tpu_torch.sched`
feeds whole batches.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Iterable

from librempeg_tpu_torch.core.errors import EndOfStream, NotFound, TryAgain
from librempeg_tpu_torch.core.frame import AudioFrame, VideoFrame
from librempeg_tpu_torch.core.options import OptionedObject
from librempeg_tpu_torch.core.packet import Packet
from librempeg_tpu_torch.core.rational import Rational

Frame = Any  # VideoFrame | AudioFrame


@dataclass
class CodecInfo:
    name: str
    long_name: str = ""
    codec_type: str = "video"        # "video" | "audio"
    capabilities: set = field(default_factory=set)  # {"delay", "batch"}


class Decoder(OptionedObject):
    """Base decoder: packet(s) in, frame(s) out.

    Subclasses implement `decode(pkt) -> list[Frame]` and optionally
    `flush() -> list[Frame]` for codecs with delay.
    """

    INFO: CodecInfo

    def __init__(self, params=None, **opts):
        super().__init__(**opts)
        self.params = params  # CodecParameters from the demuxer
        self._out: deque[Frame] = deque()
        self._draining = False
        self._eof_sent = False
        if params is not None:
            self.configure(params)

    # subclass interface ----------------------------------------------
    def configure(self, params) -> None:
        """Apply stream parameters/extradata before decoding."""

    def decode(self, pkt: Packet) -> list[Frame]:
        raise NotImplementedError

    def flush(self) -> list[Frame]:
        return []

    # public state machine (avcodec_send_packet/receive_frame) --------
    def send_packet(self, pkt: Packet | None) -> None:
        if self._draining:
            raise EndOfStream("decoder is draining")
        if pkt is None:
            self._draining = True
            self._out.extend(self.flush())
            return
        self._out.extend(self.decode(pkt))

    def receive_frame(self) -> Frame:
        if self._out:
            return self._out.popleft()
        if self._draining:
            raise EndOfStream
        raise TryAgain

    def frames(self, packets: Iterable[Packet]):
        """Convenience: full decode loop over a packet iterable."""
        for pkt in packets:
            self.send_packet(pkt)
            while True:
                try:
                    yield self.receive_frame()
                except TryAgain:
                    break
        self.send_packet(None)
        while True:
            try:
                yield self.receive_frame()
            except EndOfStream:
                return

    def reset(self) -> None:
        """Discard internal state (avcodec_flush_buffers analog)."""
        self._out.clear()
        self._draining = False


class Encoder(OptionedObject):
    """Base encoder: frame(s) in, packet(s) out.

    Subclasses implement `encode(frame) -> list[Packet]` and optionally
    `flush() -> list[Packet]`.
    """

    INFO: CodecInfo

    def __init__(self, **opts):
        super().__init__(**opts)
        self._out: deque[Packet] = deque()
        self._draining = False
        self.time_base: Rational = Rational(0, 1)

    def encode(self, frame: Frame) -> list[Packet]:
        raise NotImplementedError

    def flush(self) -> list[Packet]:
        return []

    def codec_parameters(self):
        """CodecParameters describing the produced stream (for muxers)."""
        raise NotImplementedError

    def send_frame(self, frame: Frame | None) -> None:
        if self._draining:
            raise EndOfStream("encoder is draining")
        if frame is None:
            self._draining = True
            self._out.extend(self.flush())
            return
        self._out.extend(self.encode(frame))

    def receive_packet(self) -> Packet:
        if self._out:
            return self._out.popleft()
        if self._draining:
            raise EndOfStream
        raise TryAgain

    def packets(self, frames: Iterable[Frame]):
        for f in frames:
            self.send_frame(f)
            while True:
                try:
                    yield self.receive_packet()
                except TryAgain:
                    break
        self.send_frame(None)
        while True:
            try:
                yield self.receive_packet()
            except EndOfStream:
                return
