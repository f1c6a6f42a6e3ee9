"""Raw video elementary-stream containers: h264 and hevc (annex-B),
m4v, mjpeg and MPEG-1/2 video in and out.

A copy of librempeg_tpu/formats/rawes.py (host code, no JAX), imports
rewritten. HevcDemuxer differs: it ends an access unit before the first
slice segment of the next picture (first_slice_segment_in_pic_flag), not
after every slice segment, so a picture coded as several slice segments
is one packet, as libavcodec/hevc/parser.c makes it.

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


class _RawESMuxer(Muxer):
    """Concatenate packet payloads (rawenc.c ff_raw_write_packet)."""

    INTERLEAVE = False
    CODEC_ID = ""

    def write_header(self):
        super().write_header()
        self._first = True

    def write_packet(self, pkt: Packet):
        if self._first:
            self._first = False
            extra = bytes(self.streams[pkt.stream_index].codecpar.extradata)
            # prepend out-of-band config unless already inline
            if extra and not bytes(pkt.data).startswith(extra):
                self.io.write(extra)
        self.io.write(pkt.data)


@register_muxer
class H264Muxer(_RawESMuxer):
    NAME = "h264"
    LONG_NAME = "raw H.264 video (annex B)"
    EXTENSIONS = ("h264", "264", "avc")


@register_muxer
class HevcMuxer(_RawESMuxer):
    NAME = "hevc"
    LONG_NAME = "raw HEVC video (annex B)"
    EXTENSIONS = ("hevc", "265", "h265")


@register_muxer
class M4VMuxer(_RawESMuxer):
    NAME = "m4v"
    LONG_NAME = "raw MPEG-4 video"
    EXTENSIONS = ("m4v",)


@register_muxer
class MJpegESMuxer(_RawESMuxer):
    NAME = "mjpeg"
    LONG_NAME = "raw MJPEG video"
    EXTENSIONS = ("mjpeg", "mjpg")


@register_muxer
class MpegVideoMuxer(_RawESMuxer):
    NAME = "mpegvideo"
    LONG_NAME = "raw MPEG-1/2 video"
    EXTENSIONS = ("m1v", "m2v", "mpgv")


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


#: NAL types that end or trail the picture before them (H.265 7.4.2.4.4:
#: end of sequence, end of bitstream, filler data, suffix SEI); every
#: other non-VCL NAL after a picture's last slice segment opens the next
#: access unit
_HEVC_SUFFIX_NALS = (36, 37, 38, 40)


@register_demuxer
class HevcDemuxer(_RawESDemuxer):
    """Raw HEVC annex-B ES (libavformat/hevcdec.c analog): one packet
    per picture. An access unit starts at the first slice segment of a
    picture (first_slice_segment_in_pic_flag, the first bit after the
    NAL header), together with the parameter sets and prefix SEI in
    front of it."""

    NAME = "hevc"
    LONG_NAME = "raw HEVC video (annex B)"
    EXTENSIONS = ("hevc", "265", "h265")
    CODEC_ID = "hevc"

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        for sc in (b"\x00\x00\x00\x01", b"\x00\x00\x01"):
            if buf.startswith(sc) and len(buf) > len(sc) + 1:
                nt = (buf[len(sc)] >> 1) & 0x3F
                # forbidden_zero + VPS/SPS/PPS/AUD/IRAP/trailing slice
                if buf[len(sc)] & 0x80 == 0 and \
                        nt in (32, 33, 34, 35, 19, 20, 21, 0, 1):
                    return 51
        return 0

    def _split(self, data: bytes) -> tuple[bytes, list[bytes]]:
        from librempeg_tpu_torch.codecs.hevc import ps as PS

        frames: list[bytes] = []
        extradata = bytearray()
        cur = bytearray()               # the open picture's NALs
        head = bytearray()              # non-VCL NALs since its last slice
        seen_slice = False
        self._dims = (0, 0)
        for ntype, nal in PS.split_nals(data, raw=True):
            if ntype in (32, 33, 34) and not frames and not seen_slice:
                extradata += b"\x00\x00\x00\x01" + nal
                if ntype == 33 and self._dims == (0, 0):
                    from librempeg_tpu_torch.codecs.h264.parse import \
                        remove_emulation_prevention
                    try:
                        sps = PS.parse_sps(
                            remove_emulation_prevention(nal[2:]))
                        self._dims = (sps.width, sps.height)
                    except Exception:
                        pass
            unit = b"\x00\x00\x00\x01" + nal
            if ntype < 32:              # VCL: a slice segment
                if nal[2] & 0x80 and cur:   # first of the next picture
                    frames.append(bytes(cur))
                    cur = bytearray()
                cur += head + unit
                head = bytearray()
                seen_slice = True
            elif ntype in _HEVC_SUFFIX_NALS and cur and not head:
                cur += unit
            else:
                head += unit
        if cur:
            frames.append(bytes(cur + head))
        return bytes(extradata), frames


@register_demuxer
class M4VDemuxer(_RawESDemuxer):
    NAME = "m4v"
    LONG_NAME = "raw MPEG-4 video"
    EXTENSIONS = ("m4v",)
    CODEC_ID = "mpeg4"

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        # VOS (B0) / VO (B5) / VOL (20..2F) startcodes
        if buf[:3] == b"\x00\x00\x01" and len(buf) > 3 and \
                (buf[3] in (0xB0, 0xB5) or 0x20 <= buf[3] <= 0x2F):
            return 51
        return 0

    def _split(self, data: bytes) -> tuple[bytes, list[bytes]]:
        # split before each VOP startcode 00 00 01 B6; everything before
        # the first VOP is configuration (VOS/VO/VOL) -> extradata
        marks = []
        pos = 0
        while True:
            pos = data.find(b"\x00\x00\x01\xb6", pos)
            if pos < 0:
                break
            marks.append(pos)
            pos += 4
        if not marks:
            return b"", []
        extradata = data[:marks[0]]
        frames = []
        for i, m in enumerate(marks):
            end = marks[i + 1] if i + 1 < len(marks) else len(data)
            head = extradata if i == 0 else b""
            frames.append(head + data[m:end])
        return extradata, frames


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


@register_demuxer
class Mpeg12ESDemuxer(_RawESDemuxer):
    """Raw MPEG-1/2 video ES: one packet per coded picture (the
    mpegvideo raw demuxer analog, libavformat/mpegvideodec.c)."""

    NAME = "mpegvideo"
    LONG_NAME = "raw MPEG-1/2 video"
    EXTENSIONS = ("m1v", "m2v", "mpgv")
    CODEC_ID = "mpeg2video"

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        if buf.startswith(b"\x00\x00\x01\xb3"):
            return 51
        return 0

    def _split(self, data: bytes) -> tuple[bytes, list[bytes]]:
        # split at picture starts; sequence/GOP headers prepend to the
        # following picture
        frames: list[bytes] = []
        extradata = b""
        # find all start codes
        idx = []
        i = data.find(b"\x00\x00\x01")
        while i != -1:
            idx.append(i)
            i = data.find(b"\x00\x00\x01", i + 3)
        starts = []                 # byte offsets where pictures begin
        pending = 0                 # offset of pending seq/gop prefix
        have_prefix = False
        for k, off in enumerate(idx):
            code = data[off + 3] if off + 3 < len(data) else 0xFF
            if code in (0xB3, 0xB8):
                if not have_prefix:
                    pending = off
                    have_prefix = True
            elif code == 0x00:      # picture header
                starts.append(pending if have_prefix else off)
                have_prefix = False
            elif code == 0xB7:      # sequence end: drop
                pass
        if not extradata and starts and starts[0] > 0:
            extradata = data[:starts[0]]
        for k, st in enumerate(starts):
            end = starts[k + 1] if k + 1 < len(starts) else len(data)
            frames.append(data[st:end])
        if self._dims == (0, 0):
            seq = data.find(b"\x00\x00\x01\xb3")
            if seq != -1 and seq + 7 < len(data):
                w = (data[seq + 4] << 4) | (data[seq + 5] >> 4)
                h = ((data[seq + 5] & 15) << 8) | data[seq + 6]
                self._dims = (w, h)
        return extradata, frames

    def read_packet(self) -> Packet:
        # key flag from picture_coding_type; pts from the GOP-relative
        # temporal_reference (display order), dts in coding order
        pkt = super().read_packet()
        d = pkt.data
        if not hasattr(self, "_gop_base"):
            self._gop_base = 0
            self._coded = 0
        flags = 0
        p = d.find(b"\x00\x00\x01\x00")
        if p != -1 and p + 5 < len(d):
            tref = (d[p + 4] << 2) | (d[p + 5] >> 6)
            ptype = (d[p + 5] >> 3) & 7
            if ptype == 1:
                flags = PktFlags.KEY
            if b"\x00\x00\x01\xb8" in d[:p] or \
                    d[:4] == b"\x00\x00\x01\xb3":
                self._gop_base = self._coded
            pkt.pts = self._gop_base + tref
        self._coded += 1
        pkt.flags = flags
        return pkt
