"""Raw video container (fixed-size frames, no headers).

Analog of libavformat/rawvideodec.c + the rawvideo muxer:
demux needs explicit pix_fmt/size/rate parameters (like `-f rawvideo
-pix_fmt ... -s WxH` in the reference CLI).

A copy of librempeg_tpu/formats/rawvideo.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

from librempeg_tpu_torch.core import pixfmt as pf
from librempeg_tpu_torch.core.errors import EndOfStream
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


@register_demuxer
class RawVideoDemuxer(Demuxer):
    NAME = "rawvideo"
    LONG_NAME = "raw video"
    EXTENSIONS = ("yuv", "rgb", "raw")

    def __init__(self, pix_fmt: str = "yuv420p", width: int = 0,
                 height: int = 0, framerate: Rational = Rational(25, 1)):
        super().__init__()
        self._fmt = pix_fmt
        self._w, self._h = width, height
        self._rate = framerate

    def read_header(self, io):
        if not self._w or not self._h:
            from librempeg_tpu_torch.core.errors import InvalidData

            raise InvalidData("rawvideo demuxer needs width/height")
        par = CodecParameters(
            codec_type="video", codec_id="rawvideo",
            width=self._w, height=self._h, pix_fmt=self._fmt,
            framerate=self._rate)
        self.streams = [Stream(index=0, codecpar=par,
                               time_base=Rational(self._rate.den,
                                                  self._rate.num))]
        self._frame_size = pf.get(self._fmt).buffer_size(self._h, self._w)
        self._idx = 0

    def read_packet(self) -> Packet:
        data = self.io.read(self._frame_size)
        if len(data) < self._frame_size:
            raise EndOfStream
        pkt = Packet(data=data, pts=self._idx, dts=self._idx, duration=1,
                     flags=PktFlags.KEY,
                     time_base=self.streams[0].time_base)
        self._idx += 1
        return pkt


@register_muxer
class RawVideoMuxer(Muxer):
    NAME = "rawvideo"
    LONG_NAME = "raw video"
    EXTENSIONS = ("yuv", "rgb", "raw")
    INTERLEAVE = False

    def write_packet(self, pkt: Packet):
        self.io.write(pkt.data)
