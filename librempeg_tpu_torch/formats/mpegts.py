"""MPEG transport stream: muxer + demuxer (broadcast container).

Analog of libavformat/mpegtsenc.c + mpegts.c: 188-byte
packets, PAT/PMT with CRC-32/MPEG-2, PES packetization with PTS/DTS.

A copy of librempeg_tpu/formats/mpegts.py (host code, no JAX), imports
rewritten.
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

TS_SIZE = 188
_PAT_PID = 0x0000
_PMT_PID = 0x1000
_FIRST_ES_PID = 0x0100

# stream_type (ISO 13818-1 Table 2-29) <-> codec
_STREAM_TYPES = {
    "mpeg4": 0x10,
    "h264": 0x1B,
    "hevc": 0x24,
    # the JAX package has no entry for these and writes them as 0x06,
    # which neither demuxer maps back to a video codec
    "mpeg1video": 0x01,
    "mpeg2video": 0x02,
    "aac": 0x0F,     # ADTS
    "mjpeg": 0x06,   # private PES
    "pcm_s16le": 0x06,
}
_TYPE_TO_CODEC = {0x10: "mpeg4", 0x1B: "h264", 0x24: "hevc",
                  0x0F: "aac",
                  0x01: "mpeg1video", 0x02: "mpeg2video", 0x03: "mp3",
                  0x04: "mp3"}


def _crc32_mpeg(data: bytes) -> int:
    """CRC-32/MPEG-2 (poly 0x04C11DB7, init 0xFFFFFFFF, no reflect)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7 if crc & 0x80000000
                   else crc << 1) & 0xFFFFFFFF
    return crc


@register_muxer
class MpegTsMuxer(Muxer):
    NAME = "mpegts"
    LONG_NAME = "MPEG-TS (MPEG-2 Transport Stream)"
    EXTENSIONS = ("ts", "m2ts", "mts")

    def write_header(self):
        super().write_header()
        self._cc = {}           # continuity counters per pid
        self._pids = {st.index: _FIRST_ES_PID + st.index
                      for st in self.streams}
        self._write_pat()
        self._write_pmt()

    def _ts_packet(self, pid: int, payload: bytes, pusi: bool,
                   pcr: int | None = None) -> bytes:
        cc = self._cc.get(pid, 0)
        self._cc[pid] = (cc + 1) & 0xF
        header = bytearray(4)
        header[0] = 0x47
        header[1] = (0x40 if pusi else 0) | (pid >> 8)
        header[2] = pid & 0xFF
        adaptation = b""
        if pcr is not None:
            base = pcr // 300
            ext = pcr % 300
            af = bytearray(8)
            af[0] = 7                      # adaptation length
            af[1] = 0x10                   # PCR flag
            af[2] = (base >> 25) & 0xFF
            af[3] = (base >> 17) & 0xFF
            af[4] = (base >> 9) & 0xFF
            af[5] = (base >> 1) & 0xFF
            af[6] = ((base & 1) << 7) | 0x7E | ((ext >> 8) & 1)
            af[7] = ext & 0xFF
            adaptation = bytes(af)
        room = TS_SIZE - 4 - len(adaptation)
        if len(payload) < room:
            # stuff via adaptation field padding
            pad = room - len(payload)
            if adaptation:
                adaptation = (bytes([adaptation[0] + pad])
                              + adaptation[1:] + b"\xff" * pad)
            else:
                if pad == 1:
                    adaptation = b"\x00"
                else:
                    adaptation = bytes([pad - 1, 0x00]) + b"\xff" * (pad - 2)
        header[3] = ((0x30 if adaptation else 0x10) | self._cc[pid]) & 0xFF
        pkt = bytes(header) + adaptation + payload[:room]
        assert len(pkt) == TS_SIZE, len(pkt)
        return pkt

    def _write_section(self, pid: int, table: bytes):
        # pointer_field + section
        payload = b"\x00" + table
        self.io.write(self._ts_packet(pid, payload, pusi=True))

    def _write_pat(self):
        body = struct.pack(">HBBB", 1, 0xC1, 0, 0)  # tsid, ver/cur, sec, last
        body += struct.pack(">HH", 1, 0xE000 | _PMT_PID)
        sec = bytes([0x00]) + struct.pack(">H", 0xB000 | (len(body) + 4)) \
            + body
        sec += struct.pack(">I", _crc32_mpeg(sec))
        self._write_section(_PAT_PID, sec)

    def _write_pmt(self):
        pcr_pid = _FIRST_ES_PID
        body = struct.pack(">HBBB", 1, 0xC1, 0, 0)
        body += struct.pack(">HH", 0xE000 | pcr_pid, 0xF000)
        for st in self.streams:
            stype = _STREAM_TYPES.get(st.codecpar.codec_id, 0x06)
            body += struct.pack(">BHH", stype,
                                0xE000 | self._pids[st.index], 0xF000)
        sec = bytes([0x02]) + struct.pack(">H", 0xB000 | (len(body) + 4)) \
            + body
        sec += struct.pack(">I", _crc32_mpeg(sec))
        self._write_section(_PMT_PID, sec)

    def _pes(self, pkt: Packet, st) -> bytes:
        sid = 0xE0 if st.codecpar.codec_type == "video" else 0xC0
        pts = pkt.pts
        if pts == NOPTS:
            pts = 0
        pts90 = pts * 90000 * st.time_base.num // st.time_base.den

        def ts5(v, marker):
            v &= (1 << 33) - 1
            return bytes([
                (marker << 4) | (((v >> 30) & 7) << 1) | 1,
                (v >> 22) & 0xFF,
                (((v >> 15) & 0x7F) << 1) | 1,
                (v >> 7) & 0xFF,
                ((v & 0x7F) << 1) | 1])

        header_ext = ts5(pts90, 2)
        flags = 0x80
        total = len(pkt.data) + 3 + len(header_ext)
        plen = total if total <= 0xFFFF else 0
        return (b"\x00\x00\x01" + bytes([sid])
                + struct.pack(">H", plen)
                + bytes([0x80, flags, len(header_ext)])
                + header_ext + bytes(pkt.data))

    def write_packet(self, pkt: Packet):
        st = self.streams[pkt.stream_index]
        pid = self._pids[pkt.stream_index]
        pes = self._pes(pkt, st)
        first = True
        pos = 0
        while pos < len(pes):
            chunk = pes[pos:pos + TS_SIZE - 4]
            pcr = None
            if first and st.codecpar.codec_type == "video":
                pts = pkt.pts if pkt.pts != NOPTS else 0
                pcr = (pts * 90000 * st.time_base.num
                       // st.time_base.den) * 300
            tsp = self._ts_packet(pid, chunk, pusi=first, pcr=pcr)
            self.io.write(tsp)
            # recompute how much actually fit (header+af may shrink room)
            used = TS_SIZE - 4
            if pcr is not None:
                used -= 8
            if len(chunk) < used:
                used = len(chunk)
            pos += used
            first = False


#: codec: (a NAL's type from its first byte, the slice types, the
#: parameter-set types, the SPS type)
_PARAM_NALS = {
    "h264": (lambda b: b & 0x1F, (1, 5), (7, 8), 7),
    "hevc": (lambda b: (b >> 1) & 0x3F, range(32), (32, 33, 34), 33),
}


def _sps_size(codec: str, nal: bytes) -> tuple[int, int]:
    """(width, height) of an H.264 or HEVC SPS NAL unit."""
    from librempeg_tpu_torch.codecs.h264.parse import (
        NalUnit,
        parse_sps,
        remove_emulation_prevention,
    )
    from librempeg_tpu_torch.codecs.hevc import ps as hevc_ps

    sps = parse_sps(NalUnit.parse(nal).rbsp) if codec == "h264" else \
        hevc_ps.parse_sps(remove_emulation_prevention(nal[2:]))
    return sps.width, sps.height


@register_demuxer
class MpegTsDemuxer(Demuxer):
    NAME = "mpegts"
    LONG_NAME = "MPEG-TS (MPEG-2 Transport Stream)"
    EXTENSIONS = ("ts", "m2ts", "mts")

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        if len(buf) >= TS_SIZE * 3 and all(
                buf[i * TS_SIZE] == 0x47 for i in range(3)):
            return PROBE_SCORE_MAX
        return 0

    def read_header(self, io):
        self._data = io.read(1 << 30)
        self._pid_codec = {}
        self._pid_stream = {}
        self._pes_buf: dict[int, bytearray] = {}
        self._packets: list[Packet] = []
        self._parse_all()
        self._cursor = 0
        if not self.streams:
            raise InvalidData("mpegts: no recognized streams")
        self._probe_audio_params()
        self._probe_video_params()

    def _probe_video_params(self):
        """Fill an H.264 or HEVC stream's extradata (the parameter sets
        that open its first packet) and size from its first packet (the
        extract_extradata and avformat_find_stream_info roles; the PMT
        carries neither). A decoder that starts at a later keyframe,
        after -ss or a restore, then has its parameter sets, and an
        encoder its size. The JAX package's demuxer leaves both empty:
        its decoder refuses every seek into a stream that sends the
        parameter sets once, and its encoders get a 0x0 frame."""
        from librempeg_tpu_torch.codecs.h264.parse import split_annexb

        for st in self.streams:
            par = st.codecpar
            if par.codec_id not in _PARAM_NALS or par.extradata:
                continue
            pkt = next((p for p in self._packets
                        if p.stream_index == st.index), None)
            if pkt is None:
                continue
            nal_type, slices, sets, sps_type = _PARAM_NALS[par.codec_id]
            extra = bytearray()
            for nal in split_annexb(bytes(pkt.data)):
                if nal_type(nal[0]) in slices:
                    break
                if nal_type(nal[0]) in sets:
                    extra += b"\x00\x00\x00\x01" + nal
                if nal_type(nal[0]) == sps_type and not par.width:
                    par.width, par.height = _sps_size(par.codec_id, nal)
            par.extradata = bytes(extra)

    def _probe_audio_params(self):
        """Fill sample_rate/channels from the first elementary frame
        (avformat_find_stream_info role — PMT carries no audio
        parameters, downstream muxers need them)."""
        from librempeg_tpu_torch.formats.adts import _RATES as _AAC_RATES
        from librempeg_tpu_torch.formats.mp3 import FrameHeader

        for st in self.streams:
            par = st.codecpar
            if par.codec_type != "audio" or par.sample_rate:
                continue
            pkt = next((p for p in self._packets
                        if p.stream_index == st.index), None)
            if pkt is None:
                continue
            data = bytes(pkt.data)
            if par.codec_id == "mp3":
                for i in range(len(data) - 4):
                    h = FrameHeader.parse(data[i:i + 4])
                    if h is not None:
                        par.sample_rate = h.sample_rate
                        par.nb_channels = h.channels
                        break
            elif par.codec_id == "aac":
                for i in range(len(data) - 7):
                    if data[i] == 0xFF and (data[i + 1] & 0xF6) == 0xF0:
                        sr = (data[i + 2] >> 2) & 0xF
                        ch = ((data[i + 2] & 1) << 2) | \
                            (data[i + 3] >> 6)
                        if sr < len(_AAC_RATES) and ch:
                            par.sample_rate = _AAC_RATES[sr]
                            par.nb_channels = ch
                            break

    def _parse_all(self):
        data = self._data
        pmt_pids = set()
        # pass 1: PSI
        for off in range(0, len(data) - TS_SIZE + 1, TS_SIZE):
            if data[off] != 0x47:
                continue
            pid = ((data[off + 1] & 0x1F) << 8) | data[off + 2]
            pusi = bool(data[off + 1] & 0x40)
            afc = (data[off + 3] >> 4) & 3
            p = off + 4
            if afc & 2:
                p += 1 + data[p]
            if not (afc & 1) or not pusi:
                continue
            if pid == _PAT_PID:
                q = p + 1 + data[p]
                # skip to program loop: table header 8 bytes
                slen = ((data[q + 1] & 0x0F) << 8) | data[q + 2]
                loop = data[q + 8:q + 3 + slen - 4]
                for i in range(0, len(loop) - 3, 4):
                    pmt = ((loop[i + 2] & 0x1F) << 8) | loop[i + 3]
                    pmt_pids.add(pmt)
            elif pid in pmt_pids and not self._pid_codec:
                q = p + 1 + data[p]
                slen = ((data[q + 1] & 0x0F) << 8) | data[q + 2]
                pinfo = ((data[q + 10] & 0x0F) << 8) | data[q + 11]
                r = q + 12 + pinfo
                end = q + 3 + slen - 4
                while r + 5 <= end:
                    stype = data[r]
                    epid = ((data[r + 1] & 0x1F) << 8) | data[r + 2]
                    esinfo = ((data[r + 3] & 0x0F) << 8) | data[r + 4]
                    codec = _TYPE_TO_CODEC.get(stype)
                    if codec:
                        self._register(epid, codec)
                    r += 5 + esinfo
        # pass 2: PES payloads
        for off in range(0, len(data) - TS_SIZE + 1, TS_SIZE):
            if data[off] != 0x47:
                continue
            pid = ((data[off + 1] & 0x1F) << 8) | data[off + 2]
            if pid not in self._pid_stream:
                continue
            pusi = bool(data[off + 1] & 0x40)
            afc = (data[off + 3] >> 4) & 3
            p = off + 4
            if afc & 2:
                p += 1 + data[p]
            if not (afc & 1):
                continue
            payload = data[p:off + TS_SIZE]
            if pusi:
                self._flush_pes(pid)
                self._pes_buf[pid] = bytearray(payload)
            elif pid in self._pes_buf:
                self._pes_buf[pid] += payload
        for pid in list(self._pes_buf):
            self._flush_pes(pid)
        self._packets.sort(key=lambda pk: (pk.dts if pk.dts != NOPTS else 0))

    def _register(self, pid, codec):
        if pid in self._pid_stream:      # PMT repeats periodically
            return
        self._pid_codec[pid] = codec
        ctype = "video" if codec in ("mpeg4", "h264", "hevc",
                                     "mpeg1video",
                                     "mpeg2video") else "audio"
        par = CodecParameters(codec_type=ctype, codec_id=codec,
                              pix_fmt="yuv420p" if ctype == "video" else "")
        st = Stream(index=len(self.streams), codecpar=par,
                    time_base=Rational(1, 90000))
        self.streams.append(st)
        self._pid_stream[pid] = st.index

    def _flush_pes(self, pid):
        buf = self._pes_buf.pop(pid, None)
        if not buf or len(buf) < 9 or buf[:3] != b"\x00\x00\x01":
            return
        hlen = buf[8]
        flags = buf[7]
        pts = NOPTS
        if flags & 0x80:
            b = buf[9:14]
            pts = (((b[0] >> 1) & 7) << 30) | (b[1] << 22) | \
                ((b[2] >> 1) << 15) | (b[3] << 7) | (b[4] >> 1)
        payload = bytes(buf[9 + hlen:])
        if not payload:
            return
        sti = self._pid_stream[pid]
        st = self.streams[sti]
        if st.start_time == NOPTS and pts != NOPTS:
            st.start_time = pts
        key = _payload_is_key(self._pid_codec[pid], payload)
        self._packets.append(Packet(
            data=payload, pts=pts, dts=pts, duration=0,
            stream_index=sti, flags=PktFlags.KEY if key else 0,
            time_base=Rational(1, 90000)))

    def read_packet(self) -> Packet:
        if self._cursor >= len(self._packets):
            raise EndOfStream
        p = self._packets[self._cursor]
        self._cursor += 1
        return p


def _payload_is_key(codec: str, payload: bytes) -> bool:
    """Random-access detection from the ES payload (the mpegts.c
    random-access-indicator role when the muxer didn't set one)."""
    if codec in ("mpeg1video", "mpeg2video"):
        if b"\x00\x00\x01\xb3" in payload[:256]:
            return True
        p = payload.find(b"\x00\x00\x01\x00")
        return p != -1 and p + 5 < len(payload) \
            and ((payload[p + 5] >> 3) & 7) == 1
    if codec == "h264":
        i = payload.find(b"\x00\x00\x01")
        while i != -1 and i + 3 < len(payload):
            t = payload[i + 3] & 0x1F
            if t == 5:
                return True
            if t == 1:
                return False
            i = payload.find(b"\x00\x00\x01", i + 3)
        return False
    if codec == "hevc":
        i = payload.find(b"\x00\x00\x01")
        while i != -1 and i + 3 < len(payload):
            t = (payload[i + 3] >> 1) & 0x3F
            if 16 <= t <= 23:               # IRAP (BLA/IDR/CRA)
                return True
            if t < 16:
                return False
            i = payload.find(b"\x00\x00\x01", i + 3)
        return False
    if codec == "mpeg4":
        p = payload.find(b"\x00\x00\x01\xb6")
        return p != -1 and p + 4 < len(payload) \
            and (payload[p + 4] >> 6) == 0
    return True
