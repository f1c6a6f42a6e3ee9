"""FLAC container (native stream format).

Analog of libavformat/flacdec.c + flacenc.c: "fLaC"
magic, metadata blocks (STREAMINFO), then frames; the demuxer splits
frames by scanning for the next sync pattern with a validated CRC-8
header (the same resync strategy the reference's flac parser uses).

Two repairs of the JAX module: each packet's duration is its frame's
block size from the frame header (the JAX demuxer gives every packet
STREAMINFO's max block size, so a short last frame reads 4096), and the
muxer writes back the final STREAMINFO (total samples, MD5) at close
when the output is seekable, from the `new_extradata` side data of the
encoder's last packet (flacenc.c's trailer; the JAX module's
`update_streaminfo` has no caller, so its files declare 0 samples and
an all-zero MD5).

A copy of librempeg_tpu/formats/flac.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

import struct

from librempeg_tpu_torch.codecs.flac.bitio import crc8
from librempeg_tpu_torch.codecs.flac.codec import parse_streaminfo
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


def _plausible_frame_at(buf: bytes, i: int) -> bool:
    """Sync code + header CRC-8 check at offset i."""
    if i + 16 > len(buf):
        return i + 2 <= len(buf) and buf[i] == 0xFF and (buf[i + 1] >> 1) == 0x7C
    if buf[i] != 0xFF or (buf[i + 1] >> 1) != 0x7C:
        return False
    # variable-length header: walk it to find the crc position
    pos = 4
    b = buf[i + 4]
    # utf-8 number length
    if b < 0x80:
        nlen = 1
    else:
        nlen = 0
        m = 0x80
        while b & m:
            nlen += 1
            m >>= 1
    pos = 4 + nlen
    bs_code = buf[i + 2] >> 4
    rate_code = buf[i + 2] & 0xF
    if bs_code == 6:
        pos += 1
    elif bs_code == 7:
        pos += 2
    if rate_code == 12:
        pos += 1
    elif rate_code in (13, 14):
        pos += 2
    if i + pos + 1 > len(buf):
        return False
    return crc8(buf[i:i + pos]) == buf[i + pos]


_BLOCKSIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608, 8: 256, 9: 512,
               10: 1024, 11: 2048, 12: 4096, 13: 8192, 14: 16384,
               15: 32768}


def _frame_blocksize(buf: bytes, default: int) -> int:
    """The block size a frame header at buf[0] declares (`default` where
    the header is cut short or reserved)."""
    if len(buf) < 5:
        return default
    bs_code = buf[2] >> 4
    if bs_code in _BLOCKSIZES:
        return _BLOCKSIZES[bs_code]
    if bs_code not in (6, 7):
        return default
    b = buf[4]
    nlen = 1
    if b >= 0x80:
        nlen, m = 0, 0x80
        while b & m:
            nlen += 1
            m >>= 1
    pos = 4 + nlen
    if bs_code == 6:
        return buf[pos] + 1 if pos < len(buf) else default
    if pos + 2 > len(buf):
        return default
    return (buf[pos] << 8 | buf[pos + 1]) + 1


@register_demuxer
class FlacDemuxer(Demuxer):
    NAME = "flac"
    LONG_NAME = "raw FLAC"
    EXTENSIONS = ("flac",)

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        return PROBE_SCORE_MAX if buf.startswith(b"fLaC") else 0

    def read_header(self, io):
        if io.read_exact(4) != b"fLaC":
            raise InvalidData("not a FLAC stream")
        streaminfo = None
        while True:
            hdr = io.read_exact(4)
            last = hdr[0] >> 7
            btype = hdr[0] & 0x7F
            size = hdr[1] << 16 | hdr[2] << 8 | hdr[3]
            block = io.read_exact(size)
            if btype == 0:
                streaminfo = block
            if last:
                break
        if streaminfo is None:
            raise InvalidData("FLAC: missing STREAMINFO")
        si = parse_streaminfo(streaminfo)
        par = CodecParameters(
            codec_type="audio", codec_id="flac",
            sample_rate=si["sample_rate"], nb_channels=si["channels"],
            extradata=streaminfo)
        st = Stream(index=0, codecpar=par,
                    time_base=Rational(1, si["sample_rate"]))
        if si["total_samples"]:
            st.duration = si["total_samples"]
        self.streams = [st]
        self._si = si
        self._buf = b""
        self._pts = 0
        self._blocksize = si["max_blocksize"] or 4096

    def read_packet(self) -> Packet:
        # accumulate enough bytes to find the NEXT frame sync
        while True:
            chunk = self.io.read(65536)
            self._buf += chunk
            if not chunk and not self._buf:
                raise EndOfStream
            if not self._buf:
                raise EndOfStream
            if not _plausible_frame_at(self._buf, 0):
                # resync
                idx = self._buf.find(b"\xff", 1)
                if idx < 0:
                    self._buf = b""
                    continue
                self._buf = self._buf[idx:]
                continue
            # find next sync after byte 16
            end = None
            i = 2
            while True:
                i = self._buf.find(b"\xff", i)
                if i < 0 or i + 16 > len(self._buf):
                    break
                if _plausible_frame_at(self._buf, i):
                    end = i
                    break
                i += 1
            if end is None:
                if not chunk:          # EOF: last frame
                    end = len(self._buf)
                else:
                    continue
            data, self._buf = self._buf[:end], self._buf[end:]
            n = _frame_blocksize(data, self._blocksize)
            pkt = Packet(data=data, pts=self._pts,
                         dts=self._pts, duration=n,
                         flags=PktFlags.KEY,
                         time_base=self.streams[0].time_base)
            self._pts += n
            return pkt


@register_muxer
class FlacMuxer(Muxer):
    NAME = "flac"
    LONG_NAME = "raw FLAC"
    EXTENSIONS = ("flac",)
    INTERLEAVE = False

    def write_header(self):
        super().write_header()
        par = self.streams[0].codecpar
        self.io.write(b"fLaC")
        self.io.write(bytes([0x80, 0, 0, 34]))  # last block, STREAMINFO, 34
        self._si_pos = self.io.tell()
        self._final_si = None
        if len(par.extradata) >= 34:
            self.io.write(par.extradata[:34])
        else:
            from librempeg_tpu_torch.codecs.flac.codec import build_streaminfo

            self.io.write(build_streaminfo(par.sample_rate, par.nb_channels,
                                           16, 0, 4096))

    def write_packet(self, pkt: Packet):
        si = pkt.side_data.get("new_extradata")
        if si is not None and len(si) >= 34:
            self._final_si = bytes(si)
        self.io.write(pkt.data)

    def write_trailer(self):
        if self._final_si is not None:
            self.update_streaminfo(self._final_si)
        super().write_trailer()

    def update_streaminfo(self, streaminfo: bytes) -> None:
        """Patch final STREAMINFO (total samples, md5) at close."""
        if self.io.seekable:
            end = self.io.tell()
            self.io.seek(self._si_pos)
            self.io.write(streaminfo[:34])
            self.io.seek(end)
