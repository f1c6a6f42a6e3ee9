"""Test-oriented digest muxers: framecrc / framemd5 / md5 / crc.

Analog of libavformat/framehash.c, crcenc.c, hashenc.c —
the backbone of FATE (SURVEY.md §4): golden outputs are per-packet digest
text, so decoder tests are "demux+decode -> framecrc" diffs. The text
format matches the reference byte-for-byte so outputs can be compared
against reference-produced golden files directly.

A copy of librempeg_tpu/formats/framehash.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

import hashlib
import zlib

from librempeg_tpu_torch.core.packet import Packet
from librempeg_tpu_torch.core.rational import NOPTS
from librempeg_tpu_torch.formats.api import Muxer, register_muxer


def packet_hash(data: bytes) -> int:
    """Per-packet digest: Adler-32 with init 0 (framecrcenc.c:53
    av_adler32_update(0, ...)) — NOT standard Adler (init 1)."""
    return zlib.adler32(data, 0) & 0xFFFFFFFF


def stream_crc_update(crc: int, data: bytes) -> int:
    """Whole-stream digest: standard Adler-32, init 1 (crcenc.c:37,45)."""
    return zlib.adler32(data, crc) & 0xFFFFFFFF


def _ts(v: int) -> str:
    return "None" if v == NOPTS else str(v)


class _FrameHashBase(Muxer):
    INTERLEAVE = True
    HASH_NAME = ""

    def _digest(self, data: bytes) -> str:
        raise NotImplementedError

    def write_header(self):
        super().write_header()
        w = self.io.write
        w(b"#format: frame checksums\n")
        w(b"#version: 2\n")
        w(f"#hash: {self.HASH_NAME}\n".encode() if self.HASH_NAME else b"")
        for st in self.streams:
            par = st.codecpar
            w(f"#tb {st.index}: {st.time_base.num}/{st.time_base.den}\n"
              .encode())
            w(f"#media_type {st.index}: {par.codec_type}\n".encode())
            w(f"#codec_id {st.index}: {par.codec_id}\n".encode())
            if par.codec_type == "video":
                w(f"#dimensions {st.index}: {par.width}x{par.height}\n"
                  .encode())
                sar = par.sample_aspect_ratio
                w(f"#sar {st.index}: {sar.num}/{sar.den}\n".encode())
            elif par.codec_type == "audio":
                w(f"#sample_rate {st.index}: {par.sample_rate}\n".encode())
                # av_channel_layout_describe of the stream's layout (the
                # JAX package writes "stereo" for every layout)
                w(f"#channel_layout_name {st.index}: "
                  f"{par.layout.name}\n".encode())
        if self.HASH_NAME:
            # hashenc.c's last header line (the JAX package stops
            # before it)
            w(b"#stream#, dts,        pts, duration,     size, hash\n")

    def write_packet(self, pkt: Packet):
        from librempeg_tpu_torch.core.packet import PktFlags

        st = self.streams[pkt.stream_index]
        p = pkt if not (pkt.time_base.valid and pkt.time_base.num) else \
            pkt.rescale_ts(st.time_base)
        # field widths match framecrcenc.c:56 exactly so outputs diff
        # cleanly against reference-generated golden files
        line = (f"{pkt.stream_index}, {_ts(p.dts):>10}, {_ts(p.pts):>10}, "
                f"{p.duration:>8}, {len(pkt.data):>8}, "
                f"{self._digest(pkt.data)}")
        if pkt.flags != PktFlags.KEY:
            line += f", F=0x{pkt.flags:X}"
        self.io.write(line.encode() + b"\n")


@register_muxer
class FrameCrcMuxer(_FrameHashBase):
    NAME = "framecrc"
    LONG_NAME = "framecrc testing"
    HASH_NAME = ""

    def write_header(self):
        # framecrc has no "#hash:" line
        super().write_header()

    def _digest(self, data: bytes) -> str:
        return f"0x{packet_hash(data):08x}"


@register_muxer
class FrameMd5Muxer(_FrameHashBase):
    NAME = "framemd5"
    LONG_NAME = "Per-packet MD5 testing"
    HASH_NAME = "MD5"

    def _digest(self, data: bytes) -> str:
        return hashlib.md5(data).hexdigest()


@register_muxer
class Md5Muxer(Muxer):
    """Whole-stream MD5 (hashenc.c 'md5' muxer)."""

    NAME = "md5"
    LONG_NAME = "MD5 testing"
    INTERLEAVE = True

    def write_header(self):
        super().write_header()
        self._md5 = hashlib.md5()

    def write_packet(self, pkt: Packet):
        self._md5.update(pkt.data)

    def write_trailer(self):
        self.io.write(f"MD5={self._md5.hexdigest()}\n".encode())


@register_muxer
class CrcMuxer(Muxer):
    """Whole-stream CRC (crcenc.c)."""

    NAME = "crc"
    LONG_NAME = "CRC testing"
    INTERLEAVE = True

    def write_header(self):
        super().write_header()
        self._crc = 1

    def write_packet(self, pkt: Packet):
        self._crc = stream_crc_update(self._crc, pkt.data)

    def write_trailer(self):
        self.io.write(f"CRC=0x{self._crc:08x}\n".encode())


@register_muxer
class NullMuxer(Muxer):
    NAME = "null"
    LONG_NAME = "raw null"
    INTERLEAVE = False

    def write_packet(self, pkt: Packet):
        pass
