"""GIF container: demuxer (decoded-frame packets) + animated muxer.

Analog of libavformat/gifdec.c (lavf side) + gif muxer:
GIF87a/89a headers, global/local color tables, graphic control
extensions (frame delay), image descriptors with LZW data. The demuxer
emits rgb24 rawvideo packets (frames fully composited, like the
reference's gif decoder output); the muxer quantizes rgb24 to a
uniform palette with ordered dithering.

A copy of librempeg_tpu/formats/gif.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

import struct

import numpy as np

from librempeg_tpu_torch.codecs.gif import lzw_decode, lzw_encode, make_palette, quantize
from librempeg_tpu_torch.core.errors import EndOfStream, InvalidData
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import Rational
from librempeg_tpu_torch.formats.api import (
    PROBE_SCORE_MAX,
    CodecParameters,
    Demuxer,
    Muxer,
    Stream,
    register_demuxer,
    register_muxer,
)


@register_demuxer
class GifDemuxer(Demuxer):
    NAME = "gif"
    LONG_NAME = "CompuServe GIF"
    EXTENSIONS = ("gif",)

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        return PROBE_SCORE_MAX if buf[:6] in (b"GIF87a", b"GIF89a") else 0

    def read_header(self, io):
        data = io.read(1 << 30)
        if data[:6] not in (b"GIF87a", b"GIF89a"):
            raise InvalidData("not a GIF")
        w, h, flags, bg, _ar = struct.unpack("<HHBBB", data[6:13])
        pos = 13
        gct = None
        if flags & 0x80:
            n = 2 << (flags & 7)
            gct = np.frombuffer(data[pos:pos + 3 * n], np.uint8
                                ).reshape(n, 3)
            pos += 3 * n
        self._frames = []
        delay_cs = 10
        canvas = np.zeros((h, w, 3), np.uint8)
        if gct is not None:
            canvas[:] = gct[bg % len(gct)]
        transparent = -1
        while pos < len(data):
            b = data[pos]
            if b == 0x3B:               # trailer
                break
            if b == 0x21:               # extension
                label = data[pos + 1]
                pos += 2
                if label == 0xF9 and data[pos] >= 4:
                    _sz = data[pos]
                    gflags, delay_cs, tidx = struct.unpack(
                        "<BHB", data[pos + 1:pos + 5])
                    transparent = tidx if gflags & 1 else -1
                while pos < len(data) and data[pos]:
                    pos += 1 + data[pos]
                pos += 1
            elif b == 0x2C:             # image descriptor
                (ix, iy, iw, ih, iflags) = struct.unpack(
                    "<HHHHB", data[pos + 1:pos + 10])
                pos += 10
                pal = gct
                if iflags & 0x80:
                    n = 2 << (iflags & 7)
                    pal = np.frombuffer(data[pos:pos + 3 * n], np.uint8
                                        ).reshape(n, 3)
                    pos += 3 * n
                interlaced = bool(iflags & 0x40)
                mcs = data[pos]
                pos += 1
                lzw = bytearray()
                while pos < len(data) and data[pos]:
                    n = data[pos]
                    lzw += data[pos + 1:pos + 1 + n]
                    pos += 1 + n
                pos += 1
                if pal is None:
                    raise InvalidData("GIF: no color table")
                idx = lzw_decode(bytes(lzw), mcs, iw * ih)
                if len(idx) < iw * ih:
                    idx = np.pad(idx, (0, iw * ih - len(idx)))
                idx = idx.reshape(ih, iw)
                if interlaced:
                    de = np.zeros_like(idx)
                    order = (list(range(0, ih, 8)) + list(range(4, ih, 8))
                             + list(range(2, ih, 4)) + list(range(1, ih, 2)))
                    de[np.array(order)] = idx
                    idx = de
                region = canvas[iy:iy + ih, ix:ix + iw]
                px = pal[np.minimum(idx, len(pal) - 1)]
                if transparent >= 0:
                    mask = (idx != transparent)[..., None]
                    region[:] = np.where(mask, px, region)
                else:
                    region[:] = px
                self._frames.append((canvas.copy(), max(1, delay_cs)))
            else:
                pos += 1
        par = CodecParameters(codec_type="video", codec_id="rawvideo",
                              width=w, height=h, pix_fmt="rgb24")
        self.streams = [Stream(index=0, codecpar=par,
                               time_base=Rational(1, 100))]
        self._idx = 0
        self._pts = 0

    def read_packet(self) -> Packet:
        if self._idx >= len(self._frames):
            raise EndOfStream
        frame, delay = self._frames[self._idx]
        pkt = Packet(data=frame.tobytes(), pts=self._pts, dts=self._pts,
                     duration=delay, flags=PktFlags.KEY,
                     time_base=Rational(1, 100))
        self._idx += 1
        self._pts += delay
        return pkt


@register_muxer
class GifMuxer(Muxer):
    NAME = "gif"
    LONG_NAME = "CompuServe GIF"
    EXTENSIONS = ("gif",)
    INTERLEAVE = False

    def write_header(self):
        super().write_header()
        par = self.streams[0].codecpar
        if par.codec_id != "rawvideo" or par.pix_fmt != "rgb24":
            raise InvalidData("gif muxer expects rgb24 rawvideo packets")
        io = self.io
        io.write(b"GIF89a")
        io.write(struct.pack("<HHBBB", par.width, par.height,
                             0x80 | 7, 0, 0))
        self._pal = make_palette()
        io.write(self._pal.tobytes())
        # netscape loop extension
        io.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")
        self._w, self._h = par.width, par.height

    def write_packet(self, pkt: Packet):
        st = self.streams[pkt.stream_index]
        tb = pkt.time_base if pkt.time_base.valid and pkt.time_base.num \
            else st.time_base
        delay_cs = max(2, pkt.duration * 100 * tb.num // tb.den)
        rgb = np.frombuffer(pkt.data, np.uint8).reshape(
            self._h, self._w, 3)
        idx = quantize(rgb)
        io = self.io
        io.write(b"\x21\xf9\x04" + struct.pack("<BHB", 0, delay_cs, 0)
                 + b"\x00")
        io.write(b"\x2c" + struct.pack("<HHHHB", 0, 0, self._w, self._h, 0))
        io.write(bytes([8]))            # LZW min code size
        lzw = lzw_encode(idx, 8)
        for i in range(0, len(lzw), 255):
            chunk = lzw[i:i + 255]
            io.write(bytes([len(chunk)]) + chunk)
        io.write(b"\x00")

    def write_trailer(self):
        self.io.write(b"\x3b")
