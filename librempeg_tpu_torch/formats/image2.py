"""image2: image files / sequences as a video stream.

A copy of librempeg_tpu/formats/image2.py (host code, no JAX) with its
imports rewritten and an unused pattern regex left out. Analog of libavformat/img2dec.c / img2enc.c --
"%03d" patterned sequences and single images, with codec sniffing by
content.
"""
from __future__ import annotations

import glob
import os
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

_EXT_CODEC = {
    "jpg": "mjpeg", "jpeg": "mjpeg", "mjpeg": "mjpeg", "jfif": "mjpeg",
    "png": "png",
}


def codec_for_path(path: str) -> str | None:
    """The image codec a file name's extension names (img2enc.c's
    ff_guess_image2_codec), or None."""
    return _EXT_CODEC.get(os.path.splitext(path)[1][1:].lower())


def sniff_image_codec(buf: bytes) -> str | None:
    if buf.startswith(b"\x89PNG\r\n\x1a\n"):
        return "png"
    if buf.startswith(b"\xff\xd8\xff"):
        return "mjpeg"
    return None


@register_demuxer
class Image2Demuxer(Demuxer):
    NAME = "image2"
    LONG_NAME = "image2 sequence"
    EXTENSIONS = ("jpg", "jpeg", "png")

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        return 50 if sniff_image_codec(buf) else 0

    def __init__(self, framerate: Rational = Rational(25, 1)):
        super().__init__()
        self._rate = framerate
        self._files: list[str] = []
        self._idx = 0

    def read_header(self, io):
        url = io.url
        path = url[len("file:"):] if url.startswith("file:") else url
        if "%" in path:
            # patterned sequence: expand %0Nd
            pat = re.sub(r"%(0?\d*)d", "*", path)
            self._files = sorted(glob.glob(pat))
            if not self._files:
                raise InvalidData(f"image2: no files match {path}")
            with open(self._files[0], "rb") as fh:
                head = fh.read(32)
        else:
            self._files = [path] if os.path.exists(path) else []
            head = io.peek(32)
        codec = sniff_image_codec(head)
        if codec is None:
            raise InvalidData("image2: unrecognized image codec")
        par = CodecParameters(codec_type="video", codec_id=codec,
                              framerate=self._rate)
        self.streams = [Stream(index=0, codecpar=par,
                               time_base=Rational(self._rate.den,
                                                  self._rate.num))]
        self._single_io = not self._files or len(self._files) == 1

    def read_packet(self) -> Packet:
        if self._files:
            if self._idx >= len(self._files):
                raise EndOfStream
            with open(self._files[self._idx], "rb") as fh:
                data = fh.read()
        else:
            if self._idx > 0:
                raise EndOfStream
            data = self.io.read(1 << 30)
            if not data:
                raise EndOfStream
        pkt = Packet(data=data, pts=self._idx, dts=self._idx, duration=1,
                     flags=PktFlags.KEY,
                     time_base=self.streams[0].time_base)
        self._idx += 1
        return pkt


@register_muxer
class Image2Muxer(Muxer):
    NAME = "image2"
    LONG_NAME = "image2 sequence"
    EXTENSIONS = ("jpg", "jpeg", "png")
    INTERLEAVE = False

    def write_header(self):
        super().write_header()
        self._idx = 1
        url = self.io.url
        self._path = url[len("file:"):] if url.startswith("file:") else url
        self._pattern = "%" in self._path

    def write_packet(self, pkt: Packet):
        if self._pattern:
            with open(self._path % self._idx, "wb") as fh:
                fh.write(pkt.data)
            self._idx += 1
        else:
            self.io.write(pkt.data)
