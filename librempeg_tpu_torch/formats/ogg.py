"""Ogg container (mux + demux) with the FLAC-in-Ogg mapping.

Analog of libavformat/oggenc.c + oggdec.c/oggparseflac.c:
pages with lacing-value packet segmentation, CRC-32 poly 0x04C11DB7
(non-reflected, init 0) over the whole page with a zeroed CRC field,
granule positions in samples. The FLAC mapping (RFC-style header
packet 0x7F "FLAC") carries the STREAMINFO block; audio packets are
raw FLAC frames, which our codec layer already parses/validates.

A copy of librempeg_tpu/formats/ogg.py (host code, no JAX), imports
rewritten; Vorbis packets are timed and the stream's end trimmed as
libavformat's oggparsevorbis.c does (`_vorbis_timing`).
"""
from __future__ import annotations

import struct

from librempeg_tpu_torch.core.errors import EndOfStream, InvalidData, Unsupported
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import Rational
from librempeg_tpu_torch.core.sidedata import SkipSamples, set_side_data
from librempeg_tpu_torch.formats.api import (
    PROBE_SCORE_MAX,
    CodecParameters,
    Demuxer,
    Muxer,
    Stream,
    register_demuxer,
    register_muxer,
)

_CRC_TABLE = []


def _crc_table():
    if not _CRC_TABLE:
        for i in range(256):
            c = i << 24
            for _ in range(8):
                c = ((c << 1) ^ 0x04C11DB7) if c & 0x80000000 else (c << 1)
            _CRC_TABLE.append(c & 0xFFFFFFFF)
    return _CRC_TABLE


def _ogg_crc(data: bytes) -> int:
    tab = _crc_table()
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ tab[((crc >> 24) & 0xFF) ^ b]
    return crc


def _page(serial: int, seq: int, granule: int, packets: list[bytes],
          header_type: int = 0) -> bytes:
    segs = bytearray()
    body = bytearray()
    for pkt in packets:
        n = len(pkt)
        while True:
            seg = min(n, 255)
            segs.append(seg)
            n -= seg
            if seg < 255:
                break
        body += pkt
    if not packets:
        segs.append(0)
    hdr = (b"OggS\x00" + bytes([header_type])
           + struct.pack("<q", granule)
           + struct.pack("<II", serial, seq)
           + b"\x00\x00\x00\x00"
           + bytes([len(segs)]) + bytes(segs))
    page = bytearray(hdr + body)
    crc = _ogg_crc(bytes(page))
    page[22:26] = struct.pack("<I", crc)
    return bytes(page)


@register_muxer
class OggMuxer(Muxer):
    NAME = "ogg"
    LONG_NAME = "Ogg"
    EXTENSIONS = ("ogg", "oga")
    INTERLEAVE = False

    def write_header(self):
        super().write_header()
        if len(self.streams) != 1 or \
                self.streams[0].codecpar.codec_id != "flac":
            raise Unsupported("ogg: round-1 maps a single FLAC stream")
        par = self.streams[0].codecpar
        streaminfo = bytes(par.extradata)
        if streaminfo[:4] == b"fLaC":       # strip container signature
            streaminfo = streaminfo[4:]
        if len(streaminfo) > 34 and streaminfo[0] & 0x7F == 0:
            streaminfo = streaminfo[4:]     # strip metadata block header
        self._serial = 0x4C464C43          # arbitrary fixed serial
        self._seq = 0
        self._granule = 0
        header = (b"\x7fFLAC\x01\x00" + struct.pack(">H", 0)
                  + b"fLaC"
                  + b"\x80" + len(streaminfo).to_bytes(3, "big")
                  + streaminfo)
        self.io.write(_page(self._serial, self._seq, 0, [header],
                            header_type=2))   # BOS
        self._seq += 1
        self._pending: list[bytes] = []

    def write_packet(self, pkt: Packet):
        self._granule += pkt.duration or 0
        self.io.write(_page(self._serial, self._seq, self._granule,
                            [bytes(pkt.data)]))
        self._seq += 1

    def write_trailer(self):
        self.io.write(_page(self._serial, self._seq, self._granule, [],
                            header_type=4))   # EOS


def _vorbis_timing(packets, last_on_page, head: bytes, setup: bytes):
    """Each Vorbis audio packet's (pts, duration, end trim), as
    libavformat's oggparsevorbis.c gives them: a packet lasts a quarter
    of its block and the block before it (av_vorbis_parse_frame; the
    first packet counts a short block before it), the first page's
    packets end at its granule, and the last packet of every page ends
    at the page's granule, the samples past it trimmed (the end of the
    stream). The JAX package gives each packet the granule of the page
    before it and trims nothing."""
    from librempeg_tpu_torch.codecs.vorbis.decoder import VorbisDecoder, ilog

    dec = VorbisDecoder()
    dec.header(head)
    dec.header(setup)
    size, modes = dec.blocksize, dec.modes
    bits = ilog(len(modes) - 1)
    durs, prev = [], size[0]
    for _, data in packets:
        if not data or data[0] & 1:
            durs.append(0)
            continue
        mode = (data[0] >> 1) & ((1 << bits) - 1)
        if mode >= len(modes):
            raise InvalidData("ogg: vorbis packet of an unknown mode")
        flag = modes[mode][0]
        if flag:
            prev = size[(data[0] >> (1 + bits)) & 1]
        durs.append((prev + size[flag]) >> 2)
        prev = size[flag]
    first = min(last_on_page, default=len(packets) - 1)
    pts = packets[first][0] - sum(durs[:first + 1]) if packets else 0
    out = []
    for i, (granule, _) in enumerate(packets):
        dur, end = durs[i], 0
        if i in last_on_page and granule >= 0:
            end = max(0, pts + dur - granule)
            dur = granule - pts
        out.append((pts, dur, end))
        pts += dur
    return out


@register_demuxer
class OggDemuxer(Demuxer):
    NAME = "ogg"
    LONG_NAME = "Ogg"
    EXTENSIONS = ("ogg", "oga")

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        return PROBE_SCORE_MAX if buf.startswith(b"OggS") else 0

    def read_header(self, io):
        data = io.read(1 << 30)
        packets = []                 # (granule, payload)
        last_on_page = set()         # index of each page's last packet
        pos = 0
        partial = b""
        while pos + 27 <= len(data):
            if data[pos:pos + 4] != b"OggS":
                raise InvalidData("ogg: lost page sync")
            granule = struct.unpack("<q", data[pos + 6:pos + 14])[0]
            nsegs = data[pos + 26]
            lacing = data[pos + 27:pos + 27 + nsegs]
            body = pos + 27 + nsegs
            # verify page CRC
            end = body + sum(lacing)
            page = bytearray(data[pos:end])
            got = struct.unpack("<I", page[22:26])[0]
            page[22:26] = b"\x00" * 4
            if _ogg_crc(bytes(page)) != got:
                raise InvalidData("ogg: page CRC mismatch")
            cur = body
            first = len(packets)
            for seg in lacing:
                partial += data[cur:cur + seg]
                cur += seg
                if seg < 255:
                    packets.append((granule, partial))
                    partial = b""
            if len(packets) > first:
                last_on_page.add(len(packets) - 1)
            pos = end
        if not packets:
            raise InvalidData("ogg: no packets")
        n_headers = 1
        g0, head = packets.pop(0)
        if head[:5] == b"\x7fFLAC":
            i = head.find(b"fLaC")
            if i < 0 or len(head) < i + 8 + 34:
                raise InvalidData("ogg: bad FLAC header packet")
            streaminfo = head[i + 8:i + 8 + 34]
            sr = (struct.unpack(">I", streaminfo[10:14])[0] >> 12) \
                & 0xFFFFF
            ch = ((streaminfo[12] >> 1) & 7) + 1
            par = CodecParameters(codec_type="audio", codec_id="flac",
                                  sample_rate=sr, nb_channels=ch,
                                  extradata=streaminfo)
        elif head[:7] == b"\x01vorbis":
            # vorbis mapping (oggparsevorbis.c analog): 3 header
            # packets become xiph-laced extradata
            ch = head[11]
            sr = struct.unpack("<I", head[12:16])[0]
            if len(packets) < 2:
                raise InvalidData("ogg: missing vorbis headers")
            h2 = packets.pop(0)[1]
            h3 = packets.pop(0)[1]
            n_headers = 3

            def lace(ln):
                return b"\xff" * (ln // 255) + bytes([ln % 255])

            extradata = (b"\x02" + lace(len(head)) + lace(len(h2))
                         + head + h2 + h3)
            par = CodecParameters(codec_type="audio", codec_id="vorbis",
                                  sample_rate=sr, nb_channels=ch,
                                  extradata=extradata)
        elif head[:8] == b"OpusHead":
            # Ogg Opus mapping (RFC 7845; oggparseopus.c analog): the
            # OpusHead packet is the extradata; OpusTags is dropped.
            # Granule positions count 48 kHz samples regardless of the
            # original rate.
            ch = head[9]
            sr = 48000
            if packets and packets[0][1][:8] == b"OpusTags":
                packets.pop(0)
            par = CodecParameters(codec_type="audio", codec_id="opus",
                                  sample_rate=sr, nb_channels=ch,
                                  extradata=head)
        else:
            raise Unsupported("ogg: unsupported codec mapping")
        self.streams = [Stream(index=0, codecpar=par,
                               time_base=Rational(1, sr))]
        last_on_page = {i - n_headers for i in last_on_page
                        if i >= n_headers}
        self._timing = None
        if par.codec_id == "vorbis":
            self._timing = _vorbis_timing(
                packets, last_on_page, head, h3)
        keep = [i for i, p in enumerate(packets) if p[1]]
        self._pkts = [packets[i] for i in keep]
        if self._timing is not None:
            self._timing = [self._timing[i] for i in keep]
        self._cursor = 0
        self._last_granule = 0

    def read_packet(self) -> Packet:
        if self._cursor >= len(self._pkts):
            raise EndOfStream
        granule, payload = self._pkts[self._cursor]
        if self._timing is not None:
            pts, dur, end = self._timing[self._cursor]
            self._cursor += 1
            pkt = Packet(data=payload, pts=pts, dts=pts, duration=dur,
                         flags=PktFlags.KEY,
                         time_base=self.streams[0].time_base)
            if end:
                set_side_data(pkt, SkipSamples(end=end))
            return pkt
        self._cursor += 1
        pts = self._last_granule
        dur = max(granule - self._last_granule, 0)
        self._last_granule = granule
        return Packet(data=payload, pts=pts, dts=pts, duration=dur,
                      flags=PktFlags.KEY,
                      time_base=self.streams[0].time_base)
