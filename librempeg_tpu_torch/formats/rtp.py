"""RTP depacketization + SDP session demuxer.

RFC 3550 packet layer with per-payload depacketizers:
* H.264 (RFC 6184): single NAL / STAP-A / FU-A -> Annex-B access units
* MPEG-4 ES (RFC 6416): fragments joined on the marker bit
* AAC mpeg4-generic (RFC 3640): AU-header section (sizelength /
  indexlength from fmtp), config from fmtp -> raw AAC frames
* G.711 PCMU/PCMA (RFC 3551 static types 0/8)
* MP2T (static type 33): transport-stream passthrough

The "sdp" demuxer reads an SDP file (the reference's sdp.c role),
binds the UDP ports and streams depacketized packets with a small
sequence-reorder window; rtsp.py reuses the same machinery over
interleaved TCP.

Behavioral reference: libavformat/rtpdec.c, rtpdec_h264.c,
rtpdec_mpeg4.c, sdp.c (reimplemented).

A copy of librempeg_tpu/formats/rtp.py (host code) with its imports
rewritten to the port's modules.
"""
from __future__ import annotations

import struct

from librempeg_tpu_torch.core.errors import EndOfStream, InvalidData
from librempeg_tpu_torch.core.log import Logger
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import Rational
from librempeg_tpu_torch.formats.api import (
    CodecParameters,
    Demuxer,
    Stream,
    register_demuxer,
)

log = Logger("rtp")


class RtpPacket:
    __slots__ = ("pt", "seq", "ts", "ssrc", "marker", "payload")

    def __init__(self, data: bytes):
        if len(data) < 12:
            raise InvalidData("rtp: short packet")
        b0, b1, self.seq, self.ts, self.ssrc = struct.unpack(
            ">BBHII", data[:12])
        if b0 >> 6 != 2:
            raise InvalidData("rtp: bad version")
        cc = b0 & 0xF
        self.marker = (b1 >> 7) & 1
        self.pt = b1 & 0x7F
        off = 12 + 4 * cc
        if (b0 >> 4) & 1:                    # extension header
            if len(data) < off + 4:
                raise InvalidData("rtp: short extension")
            ext_len = struct.unpack(">H", data[off + 2:off + 4])[0]
            off += 4 + 4 * ext_len
        end = len(data)
        if (b0 >> 5) & 1:                    # padding
            end -= data[-1]
        self.payload = data[off:end]


# ---------------------------------------------------------------------------
# depacketizers: feed(pkt) -> list of (payload_bytes, ts, key)
# ---------------------------------------------------------------------------

class _H264Depay:
    """RFC 6184 -> Annex-B access units, one per timestamp."""

    def __init__(self, fmtp: dict):
        self._au: list[bytes] = []
        self._ts = None
        self._frag = b""
        self.extradata = b""
        spp = fmtp.get("sprop-parameter-sets")
        if spp:
            import base64

            for b64 in spp.split(","):
                try:
                    self.extradata += b"\x00\x00\x00\x01" \
                        + base64.b64decode(b64 + "===")
                except Exception:
                    pass

    def _flush(self):
        if not self._au:
            return []
        data = b"".join(b"\x00\x00\x00\x01" + n for n in self._au)
        key = any((n[0] & 0x1F) in (5, 7) for n in self._au if n)
        out = [(data, self._ts, key)]
        self._au = []
        return out

    def feed(self, p: RtpPacket):
        out = []
        if self._ts is not None and p.ts != self._ts:
            out += self._flush()
        self._ts = p.ts
        pl = p.payload
        if not pl:
            return out
        t = pl[0] & 0x1F
        if 1 <= t <= 23:                     # single NAL
            self._au.append(pl)
        elif t == 24:                        # STAP-A
            off = 1
            while off + 2 <= len(pl):
                sz = struct.unpack(">H", pl[off:off + 2])[0]
                off += 2
                self._au.append(pl[off:off + sz])
                off += sz
        elif t == 28:                        # FU-A
            if len(pl) < 2:
                return out
            s = (pl[1] >> 7) & 1
            e = (pl[1] >> 6) & 1
            if s:
                nal_hdr = (pl[0] & 0xE0) | (pl[1] & 0x1F)
                self._frag = bytes([nal_hdr]) + pl[2:]
            else:
                self._frag += pl[2:]
            if e and self._frag:
                self._au.append(self._frag)
                self._frag = b""
        else:
            log.warning("rtp/h264: NAL type %d unsupported", t)
        if p.marker:
            out += self._flush()
            self._ts = None
        return out

    def flush(self):
        return self._flush()


class _FragmentDepay:
    """Join fragments until the marker bit (MPEG-4 ES etc.)."""

    def __init__(self, fmtp: dict):
        self._buf = b""
        self._ts = None
        self.extradata = bytes.fromhex(fmtp.get("config", "") or "")

    def feed(self, p: RtpPacket):
        if self._ts is None:
            self._ts = p.ts
        self._buf += p.payload
        if p.marker:
            out = [(self._buf, self._ts, True)]
            self._buf = b""
            self._ts = None
            return out
        return []

    def flush(self):
        if self._buf:
            out = [(self._buf, self._ts, True)]
            self._buf = b""
            return out
        return []


class _AacDepay:
    """RFC 3640 mpeg4-generic (AAC-hbr): AU-header section."""

    def __init__(self, fmtp: dict):
        self.sizelength = int(fmtp.get("sizelength", 13) or 13)
        self.indexlength = int(fmtp.get("indexlength", 3) or 3)
        self.extradata = bytes.fromhex(fmtp.get("config", "") or "")

    def feed(self, p: RtpPacket):
        pl = p.payload
        if len(pl) < 2:
            return []
        au_bits = struct.unpack(">H", pl[:2])[0]
        off = 2
        hdr_bits = self.sizelength + self.indexlength
        # AU-headers-length is untrusted: bound it by the payload size
        # (rtpdec_mpeg4.c rfc 3640 parse checks) before indexing.
        if off + (au_bits + 7) // 8 > len(pl):
            raise InvalidData("rtp aac: AU-headers exceed payload")
        naus = max(au_bits // max(hdr_bits, 1), 1)
        sizes = []
        bitpos = 0
        for _ in range(naus):
            if off + ((bitpos + self.sizelength - 1) >> 3) >= len(pl):
                raise InvalidData("rtp aac: truncated AU-header")
            v = 0
            for _ in range(self.sizelength):
                byte = pl[off + (bitpos >> 3)]
                v = (v << 1) | ((byte >> (7 - (bitpos & 7))) & 1)
                bitpos += 1
            bitpos += self.indexlength
            sizes.append(v)
        off += (au_bits + 7) // 8
        if sum(sizes) > len(pl) - off:
            raise InvalidData("rtp aac: AU sizes exceed payload")
        out = []
        ts = p.ts
        for sz in sizes:
            out.append((pl[off:off + sz], ts, True))
            off += sz
            ts += 1024
        return out

    def flush(self):
        return []


class _RawDepay:
    def __init__(self, fmtp: dict):
        self.extradata = b""

    def feed(self, p: RtpPacket):
        return [(p.payload, p.ts, True)]

    def flush(self):
        return []


# payload name -> (codec_id, codec_type, clock default, depay class)
_PAYLOADS = {
    "h264": ("h264", "video", 90000, _H264Depay),
    "mp4v-es": ("mpeg4", "video", 90000, _FragmentDepay),
    "mpeg4-generic": ("aac", "audio", 48000, _AacDepay),
    "pcmu": ("pcm_mulaw", "audio", 8000, _RawDepay),
    "pcma": ("pcm_alaw", "audio", 8000, _RawDepay),
    "l16": ("pcm_s16be", "audio", 44100, _RawDepay),
}
# RFC 3551 static payload types
_STATIC_PT = {0: ("pcmu", 8000, 1), 8: ("pcma", 8000, 1),
              10: ("l16", 44100, 2), 11: ("l16", 44100, 1),
              33: ("mp2t", 90000, 0)}


def parse_sdp(text: str):
    """Minimal SDP parse: list of media dicts with type/port/pt/
    rtpmap/fmtp/connection."""
    medias = []
    cur = None
    conn = "127.0.0.1"
    for line in text.splitlines():
        line = line.strip()
        if not line or "=" not in line:
            continue
        k, v = line[0], line[2:]
        if k == "c":
            addr = v.split()[-1].split("/")[0]
            if cur is None:
                conn = addr
            else:
                cur["conn"] = addr
        elif k == "m":
            parts = v.split()
            cur = {"type": parts[0], "port": int(parts[1]),
                   "proto": parts[2], "pt": int(parts[3]),
                   "rtpmap": None, "fmtp": {}, "conn": conn,
                   "control": ""}
            medias.append(cur)
        elif k == "a" and cur is not None:
            if v.startswith("rtpmap:"):
                body = v[7:].split(None, 1)
                if int(body[0]) == cur["pt"]:
                    enc = body[1].split("/")
                    cur["rtpmap"] = (enc[0].lower(), int(enc[1]),
                                     int(enc[2]) if len(enc) > 2 else 1)
            elif v.startswith("fmtp:"):
                body = v[5:].split(None, 1)
                if int(body[0]) == cur["pt"] and len(body) > 1:
                    for kv in body[1].split(";"):
                        kv = kv.strip()
                        if "=" in kv:
                            fk, fv = kv.split("=", 1)
                            cur["fmtp"][fk.lower()] = fv
            elif v.startswith("control:"):
                cur["control"] = v[8:]
    return medias


class RtpStreamCtx:
    """One media stream's depacketization + reorder state."""

    def __init__(self, media: dict, index: int):
        self.media = media
        self.index = index
        rtpmap = media["rtpmap"]
        if rtpmap is None:
            st = _STATIC_PT.get(media["pt"])
            if st is None:
                raise InvalidData(f"rtp: unknown payload {media['pt']}")
            rtpmap = st
        name, clock, ch = rtpmap
        self.clock = clock
        self.channels = ch
        if name not in _PAYLOADS:
            raise InvalidData(f"rtp: unsupported encoding {name}")
        codec_id, ctype, _, depay_cls = _PAYLOADS[name]
        self.depay = depay_cls(media["fmtp"])
        self.codec_id = codec_id
        self.codec_type = ctype
        self.first_ts = None
        self._last_ts = 0      # last raw 32-bit RTP timestamp seen
        self._ts_base = 0      # accumulated unwrapped pts of _last_ts
        self._reorder: dict[int, RtpPacket] = {}
        self._next_seq = None

    def _unwrap_ts(self, ts: int) -> int:
        """32-bit RTP timestamp -> monotonic-ish 64-bit pts.

        Signed wrap handling (rtpdec.c timestamp unwrapping role): the
        delta from the previous timestamp is interpreted as int32, so a
        slightly-earlier reordered packet maps to a small negative pts
        step and a mid-session 2^32 wrap continues smoothly instead of
        jumping by ~2^32.
        """
        if self.first_ts is None:
            self.first_ts = ts
            self._last_ts = ts
            self._ts_base = 0
            return 0
        delta = (ts - self._last_ts) & 0xFFFFFFFF
        if delta >= 1 << 31:
            delta -= 1 << 32
        self._ts_base += delta
        self._last_ts = ts
        return max(self._ts_base, 0)

    def codecpar(self) -> CodecParameters:
        par = CodecParameters(codec_type=self.codec_type,
                              codec_id=self.codec_id,
                              extradata=self.depay.extradata)
        if self.codec_type == "audio":
            par.sample_rate = self.clock
            par.nb_channels = self.channels
        return par

    def push(self, raw: bytes):
        """Raw RTP datagram -> list of Packets (seq-reordered)."""
        p = RtpPacket(raw)
        if self._next_seq is None:
            self._next_seq = p.seq
        self._reorder[p.seq] = p
        out = []
        # emit in-order packets; skip gaps once the window grows
        while self._reorder:
            if self._next_seq in self._reorder:
                q = self._reorder.pop(self._next_seq)
                self._next_seq = (self._next_seq + 1) & 0xFFFF
                out += self._emit(q)
            elif len(self._reorder) > 16:
                self._next_seq = min(
                    self._reorder,
                    key=lambda s: (s - self._next_seq) & 0xFFFF)
            else:
                break
        return out

    def _emit(self, p: RtpPacket):
        pkts = []
        for payload, ts, key in self.depay.feed(p):
            if not payload:
                continue
            pts = self._unwrap_ts(ts)
            pkts.append(Packet(
                data=payload, pts=pts, dts=pts, duration=0,
                flags=PktFlags.KEY if key else 0,
                stream_index=self.index,
                time_base=Rational(1, self.clock)))
        return pkts

    def flush(self):
        pkts = []
        for payload, ts, key in self.depay.flush():
            pts = self._unwrap_ts(ts)
            pkts.append(Packet(
                data=payload, pts=pts, dts=pts, duration=0,
                flags=PktFlags.KEY if key else 0,
                stream_index=self.index,
                time_base=Rational(1, self.clock)))
        return pkts


@register_demuxer
class SdpDemuxer(Demuxer):
    """RTP session described by an SDP file (reference sdp.c role):
    binds each media's UDP port and demuxes the arriving RTP."""

    NAME = "sdp"
    LONG_NAME = "SDP (RTP session description)"
    EXTENSIONS = ("sdp",)

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        head = buf[:256]
        if head.startswith(b"v=0") and b"m=" in buf:
            return 60
        return 0

    def read_header(self, io):
        import socket

        text = io.read(1 << 20).decode("utf-8", "replace")
        medias = parse_sdp(text)
        if not medias:
            raise InvalidData("sdp: no media sections")
        self._ctx = []
        self._socks = []
        self.streams = []
        for i, m in enumerate(medias):
            ctx = RtpStreamCtx(m, i)
            self._ctx.append(ctx)
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind(("0.0.0.0", m["port"]))
            sock.settimeout(float(self.opts.get("timeout", 10))
                            if hasattr(self, "opts") else 10.0)
            self._socks.append(sock)
            self.streams.append(Stream(
                index=i, codecpar=ctx.codecpar(),
                time_base=Rational(1, ctx.clock)))
        self._queue = []
        self._idle = 0

    def read_packet(self) -> Packet:
        import select

        while not self._queue:
            r, _, _ = select.select(self._socks, [], [], 1.0)
            if not r:
                self._idle += 1
                if self._idle >= 5:
                    for c in self._ctx:
                        self._queue += c.flush()
                    if self._queue:
                        break
                    raise EndOfStream
                continue
            self._idle = 0
            for sock in r:
                try:
                    data, _ = sock.recvfrom(65536)
                except OSError:
                    continue
                idx = self._socks.index(sock)
                try:
                    self._queue += self._ctx[idx].push(data)
                except (InvalidData, IndexError, struct.error):
                    # one malformed datagram must not kill the session
                    continue
        return self._queue.pop(0)

    def close(self):
        for s in getattr(self, "_socks", []):
            try:
                s.close()
            except OSError:
                pass
