"""YUV4MPEG2 (.y4m) demuxer + muxer.

Analog of libavformat/yuv4mpegdec.c / yuv4mpegenc.c —
the standard raw-video interchange container used throughout FATE.

A copy of librempeg_tpu/formats/yuv4mpeg.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

from librempeg_tpu_torch.core import pixfmt as pf
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

_MAGIC = b"YUV4MPEG2 "

_C_TO_FMT = {
    b"420jpeg": "yuv420p", b"420mpeg2": "yuv420p", b"420paldv": "yuv420p",
    b"420": "yuv420p", b"422": "yuv422p", b"444": "yuv444p",
    b"mono": "gray", b"411": "yuv411p", b"440": "yuv440p",
    b"420p10": "yuv420p10le", b"422p10": "yuv422p10le",
    b"444p10": "yuv444p10le",
}
_FMT_TO_C = {
    "yuv420p": b"420mpeg2", "yuv422p": b"422", "yuv444p": b"444",
    "gray": b"mono", "yuv411p": b"411", "yuv440p": b"440",
    "yuv420p10le": b"420p10", "yuv422p10le": b"422p10",
    "yuv444p10le": b"444p10",
}


@register_demuxer
class Y4mDemuxer(Demuxer):
    NAME = "yuv4mpegpipe"
    LONG_NAME = "YUV4MPEG pipe"
    EXTENSIONS = ("y4m",)

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        return PROBE_SCORE_MAX if buf.startswith(_MAGIC) else 0

    def read_header(self, io):
        line = bytearray()
        while len(line) < 256:
            b = io.read(1)
            if not b or b == b"\n":
                break
            line += b
        if not bytes(line).startswith(_MAGIC.strip()):
            raise InvalidData("not a YUV4MPEG2 stream")
        w = h = 0
        rate = Rational(25, 1)
        sar = Rational(0, 1)
        fmt = "yuv420p"
        interlaced = False
        for tok in bytes(line).split(b" ")[1:]:
            if not tok:
                continue
            key, val = tok[:1], tok[1:]
            if key == b"W":
                w = int(val)
            elif key == b"H":
                h = int(val)
            elif key == b"F":
                n, d = val.split(b":")
                rate = Rational(int(n), int(d))
            elif key == b"A":
                n, d = val.split(b":")
                sar = Rational(int(n), int(d))
            elif key == b"C":
                fmt = _C_TO_FMT.get(val, None)
                if fmt is None:
                    raise InvalidData(f"y4m: unknown colorspace {val!r}")
            elif key == b"I":
                interlaced = val not in (b"p",)
        if not w or not h:
            raise InvalidData("y4m: missing dimensions")
        par = CodecParameters(codec_type="video", codec_id="rawvideo",
                              width=w, height=h, pix_fmt=fmt,
                              framerate=rate, sample_aspect_ratio=sar)
        st = Stream(index=0, codecpar=par,
                    time_base=Rational(rate.den, rate.num))
        st.avg_frame_rate = rate
        self.streams = [st]
        self._frame_size = pf.get(fmt).buffer_size(h, w)
        self._idx = 0
        self._interlaced = interlaced

    def read_packet(self) -> Packet:
        # FRAME header line
        line = bytearray()
        while len(line) < 128:
            b = self.io.read(1)
            if not b:
                raise EndOfStream
            if b == b"\n":
                break
            line += b
        if not bytes(line).startswith(b"FRAME"):
            raise InvalidData(f"y4m: bad frame header {bytes(line)[:16]!r}")
        data = self.io.read(self._frame_size)
        if len(data) < self._frame_size:
            raise EndOfStream
        pkt = Packet(data=data, pts=self._idx, dts=self._idx, duration=1,
                     flags=PktFlags.KEY,
                     time_base=self.streams[0].time_base)
        self._idx += 1
        return pkt


@register_muxer
class Y4mMuxer(Muxer):
    NAME = "yuv4mpegpipe"
    LONG_NAME = "YUV4MPEG pipe"
    EXTENSIONS = ("y4m",)
    INTERLEAVE = False

    def write_header(self):
        super().write_header()
        par = self.streams[0].codecpar
        c = _FMT_TO_C.get(par.pix_fmt)
        if c is None:
            raise InvalidData(f"y4m: unsupported pix_fmt {par.pix_fmt}")
        rate = par.framerate if par.framerate.num else Rational(25, 1)
        sar = par.sample_aspect_ratio
        hdr = b"YUV4MPEG2 W%d H%d F%d:%d Ip A%d:%d C%s\n" % (
            par.width, par.height, rate.num, rate.den,
            sar.num, max(sar.den, 1) if sar.num else 0, c)
        # match the reference: A0:0 when unknown
        if not sar.num:
            hdr = hdr.replace(b" A0:1 ", b" A0:0 ")
        self.io.write(hdr)

    def write_packet(self, pkt: Packet):
        self.io.write(b"FRAME\n")
        self.io.write(pkt.data)
