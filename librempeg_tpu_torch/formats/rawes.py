"""Raw video elementary-stream containers: h264 (annex-B) in, mjpeg in
and out.

Copies of the H.264 demuxer and the MJPEG muxer and demuxer of
librempeg_tpu/formats/rawes.py (host code, no JAX), imports rewritten.

Analog of libavformat/rawenc.c (one-call passthrough
muxers) and rawdec.c/m4vdec.c/mjpegdec.c's startcode-splitting demuxers.
Demuxers split the byte stream into access units on codec startcodes;
leading configuration headers (SPS/PPS, VOL) become extradata AND stay
inline in the first packet (like the reference's raw demuxers, which
leave streams untouched and let the decoder parse in-band config).
"""
from __future__ import annotations

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


@register_muxer
class MJpegESMuxer(Muxer):
    """Concatenate packet payloads (rawenc.c ff_raw_write_packet)."""

    NAME = "mjpeg"
    LONG_NAME = "raw MJPEG video"
    EXTENSIONS = ("mjpeg", "mjpg")
    INTERLEAVE = False

    def write_packet(self, pkt: Packet):
        self.io.write(pkt.data)


class _RawESDemuxer(Demuxer):
    """Whole-stream read + startcode split into one packet per frame."""

    CODEC_ID = ""

    def __init__(self, framerate: Rational = Rational(25, 1)):
        super().__init__()
        self._rate = framerate

    def read_header(self, io):
        data = io.read(1 << 30)
        if not data:
            raise InvalidData(f"{self.NAME}: empty input")
        self._dims = (0, 0)
        extradata, frames = self._split(data)
        if not frames:
            raise InvalidData(f"{self.NAME}: no frames found")
        self._frames = frames
        par = CodecParameters(codec_type="video", codec_id=self.CODEC_ID,
                              framerate=self._rate, extradata=extradata,
                              width=self._dims[0], height=self._dims[1],
                              pix_fmt="yuv420p" if self._dims[0] else "")
        self.streams = [Stream(index=0, codecpar=par,
                               time_base=Rational(self._rate.den,
                                                  self._rate.num))]
        self._idx = 0

    def _split(self, data: bytes) -> tuple[bytes, list[bytes]]:
        raise NotImplementedError

    def read_packet(self) -> Packet:
        if self._idx >= len(self._frames):
            raise EndOfStream
        i = self._idx
        self._idx += 1
        return Packet(data=self._frames[i], pts=i, dts=i, duration=1,
                      flags=PktFlags.KEY,
                      time_base=self.streams[0].time_base)


@register_demuxer
class H264Demuxer(_RawESDemuxer):
    NAME = "h264"
    LONG_NAME = "raw H.264 video (annex B)"
    EXTENSIONS = ("h264", "264", "avc")
    CODEC_ID = "h264"

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        # annex-B startcode followed by an SPS/AUD/slice NAL
        for sc in (b"\x00\x00\x00\x01", b"\x00\x00\x01"):
            if buf.startswith(sc) and len(buf) > len(sc):
                if buf[len(sc)] & 0x1F in (1, 5, 6, 7, 9):
                    return 51
        return 0

    def _split(self, data: bytes) -> tuple[bytes, list[bytes]]:
        from librempeg_tpu_torch.codecs.h264.parse import (
            NalUnit,
            parse_sps,
            split_annexb,
        )

        # group NALs into access units: an AU ends after a slice (1/5)
        frames: list[bytes] = []
        extradata = bytearray()
        cur = bytearray()
        seen_slice = False
        self._dims = (0, 0)
        for nal in split_annexb(data):
            ntype = nal[0] & 0x1F
            if ntype in (7, 8) and not frames and not seen_slice:
                extradata += b"\x00\x00\x00\x01" + nal
                if ntype == 7 and self._dims == (0, 0):
                    try:
                        sps = parse_sps(NalUnit.parse(nal).rbsp)
                        self._dims = (sps.width, sps.height)
                    except Exception:
                        pass
            if ntype in (1, 5):
                cur += b"\x00\x00\x00\x01" + nal
                frames.append(bytes(cur))
                cur = bytearray()
                seen_slice = True
            else:
                cur += b"\x00\x00\x00\x01" + nal
        return bytes(extradata), frames


@register_demuxer
class MJpegESDemuxer(_RawESDemuxer):
    NAME = "mjpeg"
    LONG_NAME = "raw MJPEG video"
    EXTENSIONS = ("mjpeg", "mjpg")
    CODEC_ID = "mjpeg"

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        if buf.startswith(b"\xff\xd8\xff") and filename.endswith(
                ("mjpeg", "mjpg")):
            return 51
        return 0

    def _split(self, data: bytes) -> tuple[bytes, list[bytes]]:
        frames = []
        pos = 0
        while True:
            soi = data.find(b"\xff\xd8", pos)
            if soi < 0:
                break
            eoi = data.find(b"\xff\xd9", soi + 2)
            if eoi < 0:
                break
            frames.append(data[soi:eoi + 2])
            pos = eoi + 2
        return b"", frames
