"""AVI container: demuxer + muxer.

Analog of libavformat/avidec.c + avienc.c: RIFF 'AVI '
with hdrl (avih/strl/strh/strf), movi data chunks ('NNdc'/'NNwb') and
the idx1 index.
"""
from __future__ import annotations

import struct

from librempeg_tpu_torch.core.errors import EndOfStream, InvalidData
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import NOPTS, Rational
from librempeg_tpu_torch.formats.api import (
    PROBE_SCORE_MAX,
    CodecParameters,
    Demuxer,
    Muxer,
    Stream,
    register_demuxer,
    register_muxer,
)
from librempeg_tpu_torch.formats.wav import _CODEC_TO_TAG, _TAG_TO_CODEC

_FOURCC_TO_CODEC = {
    b"MJPG": "mjpeg", b"mjpg": "mjpeg", b"jpeg": "mjpeg",
    b"mp4v": "mpeg4", b"MP4V": "mpeg4", b"XVID": "mpeg4", b"xvid": "mpeg4",
    b"DIVX": "mpeg4", b"DX50": "mpeg4", b"FMP4": "mpeg4",
    b"H264": "h264", b"h264": "h264", b"avc1": "h264", b"X264": "h264",
    b"png ": "png", b"MPNG": "png",
    b"\x00\x00\x00\x00": "rawvideo", b"DIB ": "rawvideo",
}
_CODEC_TO_FOURCC = {
    "mjpeg": b"MJPG", "mpeg4": b"FMP4", "h264": b"H264", "png": b"MPNG",
    "rawvideo": b"\x00\x00\x00\x00",
}

# raw pixel formats ride biCompression fourccs (reference raw.c
# ff_raw_pix_fmt_tags); BI_RGB (0) + biBitCount carries the rgb cases
_PIXFMT_TO_RAW_FOURCC = {
    "yuv420p": (b"I420", 12), "yuvj420p": (b"I420", 12),
    "yuv422p": (b"Y42B", 16), "yuv444p": (b"444P", 24),
    "yuyv422": (b"YUY2", 16), "uyvy422": (b"UYVY", 16),
    "gray": (b"Y800", 8),
    "bgr24": (b"\x00\x00\x00\x00", 24),
    "bgra": (b"\x00\x00\x00\x00", 32),
}
_RAW_FOURCC_TO_PIXFMT = {
    b"I420": "yuv420p", b"IYUV": "yuv420p", b"YV12": "yuv420p",
    b"Y42B": "yuv422p", b"444P": "yuv444p",
    b"YUY2": "yuyv422", b"UYVY": "uyvy422",
    b"Y800": "gray", b"GREY": "gray",
}


@register_demuxer
class AviDemuxer(Demuxer):
    NAME = "avi"
    LONG_NAME = "AVI (Audio Video Interleaved)"
    EXTENSIONS = ("avi",)

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        if len(buf) >= 12 and buf[:4] == b"RIFF" and buf[8:12] in (
                b"AVI ", b"AVIX"):
            return PROBE_SCORE_MAX
        return 0

    def read_header(self, io):
        if io.read_exact(4) != b"RIFF":
            raise InvalidData("not a RIFF file")
        io.rl32()
        if io.read_exact(4) != b"AVI ":
            raise InvalidData("not an AVI file")
        self._movi_start = None
        self._frame_counts = {}
        while True:
            hdr = io.read(8)
            if len(hdr) < 8:
                break
            tag = hdr[:4]
            size = struct.unpack("<I", hdr[4:])[0]
            if tag == b"LIST":
                ltype = io.read_exact(4)
                if ltype == b"hdrl":
                    self._parse_hdrl(io, size - 4)
                elif ltype == b"movi":
                    self._movi_start = io.tell()
                    self._movi_size = size - 4
                    break
                else:
                    io.skip(size - 4 + (size & 1))
            else:
                io.skip(size + (size & 1))
        if self._movi_start is None:
            raise InvalidData("AVI: no movi list")
        self._pos_in_movi = 0
        self._counters = [0] * len(self.streams)

    def _parse_hdrl(self, io, size):
        end = io.tell() + size
        stream_idx = 0
        while io.tell() < end:
            hdr = io.read(8)
            if len(hdr) < 8:
                return
            tag = hdr[:4]
            sz = struct.unpack("<I", hdr[4:])[0]
            if tag == b"LIST":
                io.read_exact(4)  # strl
                continue
            body = io.read_exact(sz + (sz & 1))[:sz]
            if tag == b"strh":
                (fcc_type, fcc_handler) = struct.unpack("<4s4s", body[:8])
                (scale, rate) = struct.unpack("<II", body[20:28])
                length = struct.unpack("<I", body[32:36])[0]
                self._cur = {
                    "type": fcc_type, "handler": fcc_handler,
                    "scale": scale or 1, "rate": rate or 25,
                    "length": length,
                }
            elif tag == b"strf":
                cur = getattr(self, "_cur", None)
                if cur is None:
                    continue
                if cur["type"] == b"vids":
                    (_bisize, w, h, _planes, bitcount, compr) = struct.unpack(
                        "<IiiHH4s", body[:20])
                    codec = _FOURCC_TO_CODEC.get(compr) or \
                        _FOURCC_TO_CODEC.get(cur["handler"], "rawvideo")
                    if codec == "rawvideo":
                        pix = _RAW_FOURCC_TO_PIXFMT.get(
                            compr, "bgra" if bitcount == 32 else "bgr24")
                    else:
                        pix = "yuv420p"
                    par = CodecParameters(
                        codec_type="video", codec_id=codec,
                        width=w, height=abs(h), pix_fmt=pix,
                        framerate=Rational(cur["rate"], cur["scale"]))
                    tb = Rational(cur["scale"], cur["rate"])
                elif cur["type"] == b"auds":
                    (wtag, channels, srate, _brate, balign, bits) = \
                        struct.unpack("<HHIIHH", body[:16])
                    codec = _TAG_TO_CODEC.get((wtag, bits), "pcm_s16le")
                    par = CodecParameters(
                        codec_type="audio", codec_id=codec,
                        sample_rate=srate, nb_channels=channels,
                        block_align=balign or 1)
                    tb = Rational(1, srate)
                else:
                    continue
                st = Stream(index=stream_idx, codecpar=par, time_base=tb)
                if cur["length"]:
                    st.duration = cur["length"]
                self.streams.append(st)
                stream_idx += 1

    def read_packet(self) -> Packet:
        io = self.io
        while True:
            if self._pos_in_movi >= self._movi_size:
                raise EndOfStream
            hdr = io.read(8)
            if len(hdr) < 8:
                raise EndOfStream
            self._pos_in_movi += 8
            tag = hdr[:4]
            size = struct.unpack("<I", hdr[4:])[0]
            if tag == b"LIST":
                io.read(4)
                self._pos_in_movi += 4
                continue
            data = io.read_exact(size + (size & 1))[:size]
            self._pos_in_movi += size + (size & 1)
            if not tag[:2].isdigit():
                continue
            sidx = int(tag[:2])
            if sidx >= len(self.streams):
                continue
            st = self.streams[sidx]
            count = self._counters[sidx]
            if st.codecpar.codec_type == "audio" and st.codecpar.block_align:
                dur = len(data) // st.codecpar.block_align
            else:
                dur = 1
            pkt = Packet(data=data, pts=count, dts=count, duration=dur,
                         stream_index=sidx, flags=PktFlags.KEY,
                         time_base=st.time_base)
            self._counters[sidx] += dur
            return pkt


@register_muxer
class AviMuxer(Muxer):
    NAME = "avi"
    LONG_NAME = "AVI (Audio Video Interleaved)"
    EXTENSIONS = ("avi",)

    def write_header(self):
        super().write_header()
        io = self.io
        io.write(b"RIFF")
        self._riff_size_pos = io.tell()
        io.wl32(0)
        io.write(b"AVI ")

        # hdrl
        hdrl = bytearray()
        vpar = next((s.codecpar for s in self.streams
                     if s.codecpar.codec_type == "video"), None)
        vrate = (vpar.framerate if vpar and vpar.framerate.num
                 else Rational(25, 1))
        avih = struct.pack(
            "<IIIIIIIIIIIIII",
            int(1_000_000 * vrate.den // vrate.num),  # us per frame
            0, 0, 0x10,           # max bytes/s, padding, flags (HASINDEX)
            0,                    # total frames (patched in trailer)
            0,                    # initial frames
            len(self.streams),
            0,                    # suggested buffer size
            vpar.width if vpar else 0,
            vpar.height if vpar else 0,
            0, 0, 0, 0)           # reserved
        for st in self.streams:
            par = st.codecpar
            if par.codec_type == "video":
                rate = par.framerate if par.framerate.num else Rational(25, 1)
                # strh: flags, prio, lang, init_frames, scale, rate, start,
                # length, bufsize, quality, sample_size + rcFrame
                strh = (b"vids"
                        + _CODEC_TO_FOURCC.get(par.codec_id, b"\0\0\0\0")
                        + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0,
                                      rate.den, rate.num, 0, 0, 0,
                                      0xFFFFFFFF, 0)
                        + struct.pack("<hhhh", 0, 0, par.width, par.height))
                if par.codec_id == "rawvideo":
                    vtag, bits = _PIXFMT_TO_RAW_FOURCC.get(
                        par.pix_fmt or "yuv420p", (b"I420", 12))
                else:
                    vtag, bits = _CODEC_TO_FOURCC.get(
                        par.codec_id, b"\0\0\0\0"), 24
                strf = struct.pack(
                    "<IiiHH4sIiiII", 40, par.width, par.height, 1, bits,
                    vtag, par.width * par.height * bits // 8, 0, 0, 0, 0)
            else:
                tag_bits = _CODEC_TO_TAG.get(par.codec_id, (1, 16))
                wtag, bits = tag_bits
                balign = par.block_align or par.nb_channels * bits // 8
                strh = (b"auds" + b"\x00" * 4
                        + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0,
                                      1, par.sample_rate, 0, 0, 0,
                                      0xFFFFFFFF, balign)
                        + struct.pack("<hhhh", 0, 0, 0, 0))
                strf = struct.pack("<HHIIHH", wtag, par.nb_channels,
                                   par.sample_rate,
                                   par.sample_rate * balign, balign, bits)
            strl = (b"strh" + struct.pack("<I", len(strh)) + strh
                    + b"strf" + struct.pack("<I", len(strf)) + strf)
            hdrl += (b"LIST" + struct.pack("<I", 4 + len(strl)) + b"strl"
                     + strl)
        hdrl_full = (b"avih" + struct.pack("<I", len(avih)) + avih
                     + bytes(hdrl))
        io.write(b"LIST")
        io.wl32(4 + len(hdrl_full))
        io.write(b"hdrl")
        self._avih_frames_pos = self._riff_size_pos + 8 + 12 + 8 + 16
        io.write(hdrl_full)

        io.write(b"LIST")
        self._movi_size_pos = io.tell()
        io.wl32(0)
        io.write(b"movi")
        self._movi_start = io.tell()
        self._index: list[tuple[bytes, int, int]] = []
        self._video_frames = 0

    def write_packet(self, pkt: Packet):
        st = self.streams[pkt.stream_index]
        kind = b"dc" if st.codecpar.codec_type == "video" else b"wb"
        tag = b"%02d%s" % (pkt.stream_index, kind)
        offset = self.io.tell() - self._movi_start - 4
        self.io.write(tag)
        self.io.wl32(len(pkt.data))
        self.io.write(pkt.data)
        if len(pkt.data) & 1:
            self.io.write(b"\x00")
        self._index.append((tag, offset + 4, len(pkt.data)))
        if st.codecpar.codec_type == "video":
            self._video_frames += 1

    def write_trailer(self):
        io = self.io
        movi_end = io.tell()
        # idx1
        io.write(b"idx1")
        io.wl32(16 * len(self._index))
        for tag, off, size in self._index:
            io.write(tag)
            io.wl32(0x10)      # AVIIF_KEYFRAME
            io.wl32(off)
            io.wl32(size)
        end = io.tell()
        if io.seekable:
            io.seek(self._riff_size_pos)
            io.wl32(end - 8)
            io.seek(self._movi_size_pos)
            io.wl32(movi_end - self._movi_size_pos - 4)
            io.seek(self._avih_frames_pos)
            io.wl32(self._video_frames)
            io.seek(end)
