"""FLV container: demuxer + muxer.

Analog of libavformat/flvdec.c / flvenc.c for the codecs
this framework carries: H.264 (avcC/length-prefixed payloads converted
to/from annex-B like the mov path), AAC (AudioSpecificConfig + raw
frames), MP3, and basic AMF0 onMetaData parsing.

A copy of librempeg_tpu/formats/flv.py (host code) with its imports
rewritten to the port's modules, and one repair: AAC is written with
its AudioSpecificConfig and without ADTS headers (the JAX muxer writes
neither right for the AAC encoder's ADTS frames, and its demuxer then
finds no stream in the file).
"""
from __future__ import annotations

import struct

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

_AUDIO_FMT = {0: "pcm_s16le", 2: "mp3", 10: "aac", 14: "mp3"}
_VIDEO_FMT = {7: "h264"}
_RATES = (5512, 11025, 22050, 44100)
_TB = Rational(1, 1000)        # FLV timestamps are milliseconds


def _amf_read(data: bytes, pos: int):
    """One AMF0 value -> (value, new_pos)."""
    t = data[pos]
    pos += 1
    if t == 0:                                    # number
        return struct.unpack(">d", data[pos:pos + 8])[0], pos + 8
    if t == 1:                                    # bool
        return bool(data[pos]), pos + 1
    if t == 2:                                    # string
        ln = struct.unpack(">H", data[pos:pos + 2])[0]
        return data[pos + 2:pos + 2 + ln].decode("utf-8", "replace"), \
            pos + 2 + ln
    if t in (3, 8):                               # object / ECMA array
        if t == 8:
            pos += 4
        obj = {}
        while pos + 2 <= len(data):
            ln = struct.unpack(">H", data[pos:pos + 2])[0]
            key = data[pos + 2:pos + 2 + ln].decode("utf-8", "replace")
            pos += 2 + ln
            if not key and pos < len(data) and data[pos] == 9:
                return obj, pos + 1               # object end marker
            val, pos = _amf_read(data, pos)
            obj[key] = val
        return obj, pos
    if t == 10:                                   # strict array
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        pos += 4
        arr = []
        for _ in range(n):
            v, pos = _amf_read(data, pos)
            arr.append(v)
        return arr, pos
    if t == 11:                                   # date
        return struct.unpack(">d", data[pos:pos + 8])[0], pos + 10
    return None, len(data)                        # null/undefined/other


@register_demuxer
class FlvDemuxer(Demuxer):
    NAME = "flv"
    LONG_NAME = "FLV (Flash Video)"
    EXTENSIONS = ("flv",)

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        if buf[:3] == b"FLV" and len(buf) > 8 and buf[3] == 1:
            return 100
        return 0

    def read_header(self, io):
        self.io = io
        hdr = io.read_exact(9)
        if hdr[:3] != b"FLV":
            raise InvalidData("flv: bad signature")
        off = struct.unpack(">I", hdr[5:9])[0]
        io.skip(off - 9)
        io.skip(4)                                # prev tag size
        self._streams_by_type: dict[str, Stream] = {}
        self._pending: list[Packet] = []
        # read tags until both declared streams appear (or a few tags)
        flags = hdr[4]
        want_a = bool(flags & 4)
        want_v = bool(flags & 1)
        for _ in range(64):
            have_a = "audio" in self._streams_by_type
            have_v = "video" in self._streams_by_type
            if (not want_a or have_a) and (not want_v or have_v) \
                    and (have_a or have_v):
                break
            try:
                pkt = self._read_tag()
            except EndOfStream:
                break
            if pkt is not None:
                self._pending.append(pkt)
        if not self.streams:
            raise InvalidData("flv: no streams found")

    def _get_stream(self, kind: str, par: CodecParameters) -> Stream:
        st = self._streams_by_type.get(kind)
        if st is None:
            st = Stream(index=len(self.streams), codecpar=par, time_base=_TB)
            self.streams.append(st)
            self._streams_by_type[kind] = st
        return st

    def _read_tag(self):
        io = self.io
        head = io.read(11)
        if len(head) < 11:
            raise EndOfStream
        ttype = head[0] & 0x1F
        size = head[1] << 16 | head[2] << 8 | head[3]
        ts = (head[4] << 16 | head[5] << 8 | head[6]) | (head[7] << 24)
        body = io.read_exact(size)
        io.skip(4)                                # prev tag size
        if ttype == 18:                           # script data
            try:
                name, pos = _amf_read(body, 0)
                val, _ = _amf_read(body, pos)
                if name == "onMetaData" and isinstance(val, dict):
                    for k in ("duration", "width", "height", "framerate"):
                        if k in val:
                            self.metadata[k] = str(val[k])
            except Exception:
                pass
            return None
        if ttype == 8 and body:                   # audio
            info = body[0]
            fmt = info >> 4
            codec = _AUDIO_FMT.get(fmt)
            if codec is None:
                return None
            rate = _RATES[(info >> 2) & 3]
            channels = (info & 1) + 1
            if codec == "aac":
                rate = 44100  # real rate comes from AudioSpecificConfig
                if body[1] == 0:                  # sequence header
                    par = CodecParameters(codec_type="audio",
                                          codec_id="aac", sample_rate=rate,
                                          nb_channels=channels,
                                          extradata=body[2:])
                    self._parse_asc(par)
                    self._get_stream("audio", par)
                    return None
                payload = body[2:]
            else:
                payload = body[1:]
                par = CodecParameters(codec_type="audio", codec_id=codec,
                                      sample_rate=rate,
                                      nb_channels=channels)
                self._get_stream("audio", par)
            st = self._streams_by_type.get("audio")
            if st is None:
                return None
            return Packet(data=payload, pts=ts, dts=ts,
                          stream_index=st.index, flags=PktFlags.KEY,
                          time_base=_TB)
        if ttype == 9 and body:                   # video
            frame_type = body[0] >> 4
            codec_id = body[0] & 15
            codec = _VIDEO_FMT.get(codec_id)
            if codec is None:
                return None
            if codec == "h264":
                avc_type = body[1]
                cts = struct.unpack(">i", bytes([0]) + body[2:5])[0] >> 8
                if avc_type == 0:                 # avcC sequence header
                    from librempeg_tpu_torch.codecs.h264.avcc import (
                        avcc_to_annexb,
                    )

                    par = CodecParameters(codec_type="video",
                                          codec_id="h264",
                                          extradata=avcc_to_annexb(
                                              body[5:]))
                    self._parse_sps_dims(par)
                    self._get_stream("video", par)
                    return None
                if avc_type == 2:                 # end of sequence
                    return None
                from librempeg_tpu_torch.codecs.h264.avcc import lp_to_annexb

                payload = lp_to_annexb(body[5:], force=True)  # FLV: LP
                st = self._streams_by_type.get("video")
                if st is None:
                    return None
                return Packet(data=payload, pts=ts + cts, dts=ts,
                              stream_index=st.index,
                              flags=PktFlags.KEY if frame_type == 1 else 0,
                              time_base=_TB)
        return None

    @staticmethod
    def _parse_asc(par) -> None:
        """AudioSpecificConfig -> sample_rate/channels."""
        asc = bytes(par.extradata or b"")
        if len(asc) >= 2:
            rates = (96000, 88200, 64000, 48000, 44100, 32000, 24000,
                     22050, 16000, 12000, 11025, 8000, 7350)
            idx = ((asc[0] & 7) << 1) | (asc[1] >> 7)
            if idx < len(rates):
                par.sample_rate = rates[idx]
            par.nb_channels = (asc[1] >> 3) & 15 or par.nb_channels
            par.frame_size = 1024

    @staticmethod
    def _parse_sps_dims(par) -> None:
        from librempeg_tpu_torch.codecs.h264.parse import (
            NalUnit,
            parse_sps,
            split_annexb,
        )

        for nal in split_annexb(bytes(par.extradata)):
            n = NalUnit.parse(nal)
            if n.type == 7:
                sps = parse_sps(n.rbsp)
                par.width, par.height = sps.width, sps.height

    def read_packet(self) -> Packet:
        if self._pending:
            return self._pending.pop(0)
        while True:
            pkt = self._read_tag()
            if pkt is not None:
                return pkt


def _lc_config(par) -> bytes:
    """AudioSpecificConfig of AAC-LC at the stream's rate and channels."""
    from librempeg_tpu_torch.codecs.aac.codec import _rate_index

    ri = _rate_index(par.sample_rate)
    return bytes([(2 << 3) | (ri >> 1),
                  ((ri & 1) << 7) | (par.nb_channels << 3)])


def _strip_adts(data: bytes) -> bytes:
    """A raw AAC frame: an ADTS header (7 bytes, 9 with its CRC) taken
    off, as ffmpeg's aac_adtstoasc does for FLV (the JAX package writes
    the header into the tag)."""
    if len(data) >= 7 and data[0] == 0xFF and data[1] & 0xF6 == 0xF0:
        return data[7 if data[1] & 1 else 9:]
    return data


@register_muxer
class FlvMuxer(Muxer):
    NAME = "flv"
    LONG_NAME = "FLV (Flash Video)"
    EXTENSIONS = ("flv",)

    def write_header(self):
        super().write_header()
        has_a = any(s.codecpar.codec_type == "audio" for s in self.streams)
        has_v = any(s.codecpar.codec_type == "video" for s in self.streams)
        flags = (4 if has_a else 0) | (1 if has_v else 0)
        self.io.write(b"FLV\x01" + bytes([flags]) + struct.pack(">I", 9))
        self.io.write(struct.pack(">I", 0))
        for st in self.streams:
            par = st.codecpar
            if par.codec_id == "h264" and par.extradata:
                from librempeg_tpu_torch.codecs.h264.avcc import build_avcc

                self._write_tag(9, 0, bytes([0x17, 0, 0, 0, 0])
                                + build_avcc(bytes(par.extradata)))
            elif par.codec_id == "aac":
                # the AudioSpecificConfig the demuxer needs: the
                # stream's, else AAC-LC at its rate and channels, as the
                # MP4 muxer writes it (the JAX package writes none for
                # the AAC encoder's stream, whose FLV then has no stream)
                self._write_tag(8, 0, self._audio_info(par) + b"\x00"
                                + (bytes(par.extradata or b"")
                                   or _lc_config(par)))

    @staticmethod
    def _audio_info(par) -> bytes:
        if par.codec_id == "aac":
            fmt = 10
        elif par.codec_id == "mp3":
            fmt = 2
        else:
            raise InvalidData(f"flv: unsupported audio {par.codec_id}")
        rate_idx = min(range(4),
                       key=lambda i: abs(_RATES[i] - par.sample_rate))
        return bytes([(fmt << 4) | (rate_idx << 2) | 2
                      | (1 if par.nb_channels == 2 else 0)])

    def _write_tag(self, ttype: int, ts: int, body: bytes):
        hdr = bytes([ttype]) + len(body).to_bytes(3, "big") \
            + (ts & 0xFFFFFF).to_bytes(3, "big") \
            + bytes([(ts >> 24) & 0xFF]) + b"\x00\x00\x00"
        self.io.write(hdr + body)
        self.io.write(struct.pack(">I", 11 + len(body)))

    def write_packet(self, pkt: Packet):
        st = self.streams[pkt.stream_index]
        par = st.codecpar
        tb = pkt.time_base if pkt.time_base.valid and pkt.time_base.num \
            else st.time_base
        ts = int(pkt.dts * 1000 * tb.num / tb.den) if pkt.dts is not None \
            else 0
        if par.codec_type == "video" and par.codec_id == "h264":
            from librempeg_tpu_torch.codecs.h264.avcc import annexb_to_lp

            key = bool(pkt.flags & PktFlags.KEY)
            pts = int(pkt.pts * 1000 * tb.num / tb.den)
            cts = max(0, pts - ts)
            body = bytes([(0x10 if key else 0x20) | 7, 1]) \
                + cts.to_bytes(3, "big") + annexb_to_lp(bytes(pkt.data))
            self._write_tag(9, ts, body)
        elif par.codec_type == "audio":
            if par.codec_id == "aac":
                body = self._audio_info(par) + b"\x01" \
                    + _strip_adts(bytes(pkt.data))
            else:
                body = self._audio_info(par) + bytes(pkt.data)
            self._write_tag(8, ts, body)
