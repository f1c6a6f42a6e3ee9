"""RTSP demuxer (RFC 2326 subset) over interleaved TCP.

Two roles:
* client PLAY (rtsp://host:port/path): DESCRIBE -> SETUP (one
  TCP-interleaved transport per media) -> PLAY, then demux the
  interleaved $-framed RTP.
* server RECORD (rtsp://host:port/path?listen=1): accept one pushing
  peer (the reference's -f rtsp output / -rtsp_flags listen inverse):
  ANNOUNCE (SDP) -> SETUP -> RECORD, then demux the pushed RTP.

Depacketization is shared with formats/rtp.py. TCP-interleaved only:
on the benchmark host UDP loopback works too (the sdp demuxer), but
interleaving keeps the tests deterministic and matches the common
firewall-safe deployment.

Behavioral reference: libavformat/rtsp.c, rtspdec.c (reimplemented).

A copy of librempeg_tpu/formats/rtsp.py (host code) with its imports
rewritten to the port's modules.
"""
from __future__ import annotations

import struct

import socket
import urllib.parse as up

from librempeg_tpu_torch.core.errors import EndOfStream, InvalidData
from librempeg_tpu_torch.core.log import Logger
from librempeg_tpu_torch.core.packet import Packet
from librempeg_tpu_torch.core.rational import Rational
from librempeg_tpu_torch.formats.api import (
    Demuxer,
    Stream,
    register_demuxer,
)
from librempeg_tpu_torch.formats.io import MemoryIO, register_protocol
from librempeg_tpu_torch.formats.rtp import RtpStreamCtx, parse_sdp

log = Logger("rtsp")


def _open_rtsp(url: str, mode: str):
    # the demuxer drives the session itself; hand it the URL
    return MemoryIO(url.encode())


register_protocol("rtsp", _open_rtsp)


class _RtspConn:
    """Request/response + interleaved framing over one TCP socket."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.f = sock.makefile("rwb")
        self.cseq = 1

    # -- client side --------------------------------------------------
    def request(self, method: str, url: str, headers: dict,
                body: bytes = b"") -> tuple[int, dict, bytes]:
        lines = [f"{method} {url} RTSP/1.0", f"CSeq: {self.cseq}"]
        self.cseq += 1
        for k, v in headers.items():
            lines.append(f"{k}: {v}")
        if body:
            lines.append(f"Content-Length: {len(body)}")
        msg = ("\r\n".join(lines) + "\r\n\r\n").encode() + body
        self.f.write(msg)
        self.f.flush()
        return self.read_response()

    def read_response(self):
        status_line = self.f.readline().decode("latin-1").strip()
        parts = status_line.split(None, 2)
        if len(parts) < 2 or not parts[0].startswith("RTSP/"):
            raise InvalidData(f"rtsp: bad response {status_line!r}")
        code = int(parts[1])
        hdrs = self._read_headers()
        body = b""
        cl = int(hdrs.get("content-length", 0))
        if cl:
            body = self.f.read(cl)
        return code, hdrs, body

    def _read_headers(self) -> dict:
        hdrs = {}
        while True:
            line = self.f.readline().decode("latin-1")
            if line in ("\r\n", "\n", ""):
                break
            if ":" in line:
                k, v = line.split(":", 1)
                hdrs[k.strip().lower()] = v.strip()
        return hdrs

    # -- server side --------------------------------------------------
    def read_request(self):
        line = self.f.readline().decode("latin-1").strip()
        if not line:
            raise EndOfStream
        parts = line.split()
        if len(parts) < 3:
            raise InvalidData(f"rtsp: bad request {line!r}")
        method, url = parts[0], parts[1]
        hdrs = self._read_headers()
        body = b""
        cl = int(hdrs.get("content-length", 0))
        if cl:
            body = self.f.read(cl)
        return method, url, hdrs, body

    def respond(self, cseq: str, extra: dict | None = None,
                body: bytes = b"") -> None:
        lines = ["RTSP/1.0 200 OK", f"CSeq: {cseq}"]
        for k, v in (extra or {}).items():
            lines.append(f"{k}: {v}")
        if body:
            lines.append(f"Content-Length: {len(body)}")
        self.f.write(("\r\n".join(lines) + "\r\n\r\n").encode() + body)
        self.f.flush()

    def read_interleaved(self):
        """One $-framed interleaved packet: returns (channel, data) or
        None for an in-band RTSP request (handled by caller)."""
        b = self.f.read(1)
        if not b:
            raise EndOfStream
        if b == b"$":
            hdr = self.f.read(3)
            if len(hdr) < 3:
                raise EndOfStream
            chan = hdr[0]
            ln = (hdr[1] << 8) | hdr[2]
            data = self.f.read(ln)
            if len(data) < ln:
                raise EndOfStream
            return chan, data
        # in-band request (e.g. TEARDOWN / GET_PARAMETER keepalive)
        rest = self.f.readline().decode("latin-1")
        line = (b.decode("latin-1") + rest).strip()
        hdrs = self._read_headers()
        cl = int(hdrs.get("content-length", 0))
        if cl:
            self.f.read(cl)
        if line.split()[0:1] == ["TEARDOWN"]:
            self.respond(hdrs.get("cseq", "0"))
            raise EndOfStream
        self.respond(hdrs.get("cseq", "0"))
        return None


@register_demuxer
class RtspDemuxer(Demuxer):
    NAME = "rtsp"
    LONG_NAME = "RTSP (TCP-interleaved RTP)"

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        return 100 if buf.startswith(b"rtsp://") else 0

    def __init__(self, timeout: float = 30.0):
        super().__init__()
        self.timeout = float(timeout)       # CLI passes option strings

    def read_header(self, io):
        url = io.read(1 << 16).decode()
        u = up.urlparse(url)
        host = u.hostname or "127.0.0.1"
        port = u.port or 554
        q = dict(up.parse_qsl(u.query))
        self._listen = bool(q.get("listen"))
        base = f"rtsp://{host}:{port}{u.path}"
        if self._listen:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((host, port))
            srv.listen(1)
            srv.settimeout(self.timeout)
            sock, _ = srv.accept()
            srv.close()
            sock.settimeout(self.timeout)
            self._conn = _RtspConn(sock)
            self._serve_setup()
        else:
            sock = socket.create_connection((host, port),
                                            timeout=self.timeout)
            self._conn = _RtspConn(sock)
            self._client_setup(base)

    # ------------------------------------------------------------------
    def _build_streams(self, sdp_text: str):
        medias = parse_sdp(sdp_text)
        if not medias:
            raise InvalidData("rtsp: no media in SDP")
        self._ctx = []
        self.streams = []
        for i, m in enumerate(medias):
            ctx = RtpStreamCtx(m, i)
            self._ctx.append(ctx)
            self.streams.append(Stream(
                index=i, codecpar=ctx.codecpar(),
                time_base=Rational(1, ctx.clock)))
        return medias

    def _client_setup(self, base: str):
        c = self._conn
        code, hdrs, body = c.request(
            "DESCRIBE", base, {"Accept": "application/sdp"})
        if code != 200:
            raise InvalidData(f"rtsp: DESCRIBE failed ({code})")
        medias = self._build_streams(body.decode("utf-8", "replace"))
        session = None
        for i, m in enumerate(medias):
            ctrl = m.get("control", "")
            surl = ctrl if ctrl.startswith("rtsp://") else \
                base + "/" + (ctrl or f"streamid={i}")
            h = {"Transport":
                 f"RTP/AVP/TCP;unicast;interleaved={2*i}-{2*i+1}"}
            if session:
                h["Session"] = session
            code, hdrs, _ = c.request("SETUP", surl, h)
            if code != 200:
                raise InvalidData(f"rtsp: SETUP failed ({code})")
            session = hdrs.get("session", session)
            if session:
                session = session.split(";")[0]
        code, hdrs, _ = c.request(
            "PLAY", base, {"Session": session or "", "Range": "npt=0-"})
        if code != 200:
            raise InvalidData(f"rtsp: PLAY failed ({code})")
        self._chan_map = {2 * i: i for i in range(len(medias))}

    def _serve_setup(self):
        c = self._conn
        sdp = None
        chan_map = {}
        nset = 0
        while True:
            method, url, hdrs, body = c.read_request()
            cseq = hdrs.get("cseq", "0")
            if method == "OPTIONS":
                c.respond(cseq, {"Public":
                                 "ANNOUNCE, SETUP, RECORD, TEARDOWN"})
            elif method == "ANNOUNCE":
                sdp = body.decode("utf-8", "replace")
                medias = self._build_streams(sdp)
                c.respond(cseq)
            elif method == "SETUP":
                tr = hdrs.get("transport", "")
                chan = 2 * nset
                for part in tr.split(";"):
                    if part.startswith("interleaved="):
                        chan = int(part.split("=")[1].split("-")[0])
                chan_map[chan] = nset
                nset += 1
                c.respond(cseq, {"Transport": tr,
                                 "Session": "librempeg-tpu"})
            elif method == "RECORD":
                c.respond(cseq, {"Session": "librempeg-tpu"})
                break
            else:
                c.respond(cseq)
        if sdp is None:
            raise InvalidData("rtsp: no ANNOUNCE before RECORD")
        self._chan_map = chan_map

    # ------------------------------------------------------------------
    def read_packet(self) -> Packet:
        q = getattr(self, "_queue", None)
        if q is None:
            q = self._queue = []
        while not q:
            try:
                r = self._conn.read_interleaved()
            except (EndOfStream, socket.timeout, OSError):
                for ctx in self._ctx:
                    q += ctx.flush()
                if q:
                    break
                raise EndOfStream from None
            if r is None:
                continue
            chan, data = r
            if chan & 1:
                continue                    # RTCP
            idx = self._chan_map.get(chan)
            if idx is None:
                continue
            try:
                q += self._ctx[idx].push(data)
            except (InvalidData, IndexError, struct.error):
                continue
        return q.pop(0)

    def close(self):
        try:
            self._conn.sock.close()
        except Exception:
            pass
