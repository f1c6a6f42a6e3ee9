"""HTTP/HTTPS protocol (URLProtocol analog).

Mirrors the behavior of libavformat/http.c: GET with
range-based seeking (206 Partial Content), automatic reconnect with
exponential backoff on mid-stream errors (http.c:101-108 option set),
TLS via the standard ssl module (control-plane code — bulk data never
touches the device). Chunked transfer and keep-alive come from
http.client.

A copy of librempeg_tpu/formats/http.py (host code) with its imports
rewritten to the port's modules, and one repair: after a redirect the
request goes to the new location's path (the JAX package re-requests
the old one until its retries run out).
"""
from __future__ import annotations

import http.client
import ssl
import time
import urllib.parse

from librempeg_tpu_torch.core.errors import InvalidData
from librempeg_tpu_torch.core.log import Logger

log = Logger("http")


class HttpFile:
    """File-like object over an HTTP(S) resource with range seeking and
    reconnect/backoff (reference http.c `reconnect`/`reconnect_delay_max`
    semantics)."""

    def __init__(self, url: str, *, reconnect: bool = True,
                 reconnect_delay_max: float = 4.0, max_retries: int = 5,
                 timeout: float = 10.0, headers: dict | None = None):
        self.url = url
        self.reconnect = reconnect
        self.reconnect_delay_max = reconnect_delay_max
        self.max_retries = max_retries
        self.timeout = timeout
        self.headers = dict(headers or {})
        self._u = urllib.parse.urlsplit(url)
        if self._u.scheme not in ("http", "https"):
            raise InvalidData(f"http: unsupported scheme {self._u.scheme}")
        self._conn = None
        self._resp = None
        self._pos = 0
        self._length = None       # total resource length if known
        self._accept_ranges = False
        self._open_at(0, first=True)

    # -- connection management ----------------------------------------
    def _connect(self):
        host = self._u.hostname
        port = self._u.port
        if self._u.scheme == "https":
            ctx = ssl.create_default_context()
            return http.client.HTTPSConnection(host, port,
                                               timeout=self.timeout,
                                               context=ctx)
        return http.client.HTTPConnection(host, port, timeout=self.timeout)

    def _open_at(self, offset: int, first: bool = False):
        delay = 0.05
        last_err = None
        for attempt in range(self.max_retries if self.reconnect else 1):
            # the path of the current URL: a redirect replaces it (the
            # JAX package keeps requesting the first path)
            path = self._u.path or "/"
            if self._u.query:
                path += "?" + self._u.query
            try:
                if self._conn is None:
                    self._conn = self._connect()
                hdrs = {"User-Agent": "librempeg-tpu/0.2",
                        "Accept": "*/*", **self.headers}
                if offset:
                    hdrs["Range"] = f"bytes={offset}-"
                self._conn.request("GET", path, headers=hdrs)
                resp = self._conn.getresponse()
                if resp.status in (301, 302, 303, 307, 308):
                    loc = resp.getheader("Location")
                    resp.read()
                    if not loc:
                        raise InvalidData("http: redirect without Location")
                    self._u = urllib.parse.urlsplit(
                        urllib.parse.urljoin(self.url, loc))
                    self.url = urllib.parse.urlunsplit(self._u)
                    self._conn.close()
                    self._conn = None
                    continue
                if offset and resp.status == 200:
                    # server ignored the range: read-and-discard to offset
                    resp.read(offset)
                elif resp.status not in (200, 206):
                    raise InvalidData(f"http: status {resp.status}")
                self._resp = resp
                self._pos = offset
                if first:
                    self._accept_ranges = (
                        resp.getheader("Accept-Ranges", "") == "bytes")
                    cl = resp.getheader("Content-Length")
                    if cl is not None and resp.status == 200:
                        self._length = int(cl)
                    cr = resp.getheader("Content-Range")
                    if cr and "/" in cr and cr.split("/")[-1].isdigit():
                        self._length = int(cr.split("/")[-1])
                return
            except (OSError, http.client.HTTPException) as e:
                last_err = e
                self._conn = None
                self._resp = None
                if attempt + 1 >= self.max_retries or not self.reconnect:
                    break
                log.warning("http: reconnect after %s (attempt %d)",
                            e, attempt + 1)
                time.sleep(delay)
                delay = min(delay * 2, self.reconnect_delay_max)
        raise InvalidData(f"http: open failed for {self.url}: {last_err}")

    # -- file-like interface --------------------------------------------
    def read(self, n: int = -1) -> bytes:
        if n is not None and n < 0:
            chunks = []
            while True:
                c = self.read(1 << 16)
                if not c:
                    break
                chunks.append(c)
            return b"".join(chunks)
        out = b""
        retries = 0
        while len(out) < n:
            if self._resp is None:
                break
            try:
                chunk = self._resp.read(n - len(out))
            except (OSError, http.client.HTTPException) as e:
                if not self.reconnect or retries >= self.max_retries:
                    raise InvalidData(f"http: read failed: {e}") from e
                retries += 1
                log.warning("http: mid-stream error %s; reconnecting at "
                            "offset %d", e, self._pos + len(out))
                self._conn = None
                self._open_at(self._pos + len(out))
                continue
            if not chunk:
                if (self._length is not None
                        and self._pos + len(out) < self._length
                        and self.reconnect and retries < self.max_retries):
                    retries += 1
                    log.warning("http: premature EOF at %d/%d; reconnect",
                                self._pos + len(out), self._length)
                    self._conn = None
                    self._open_at(self._pos + len(out))
                    continue
                break
            out += chunk
        self._pos += len(out)
        return out

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == 1:
            pos += self._pos
        elif whence == 2:
            if self._length is None:
                raise OSError("http: size unknown, cannot seek from end")
            pos += self._length
        if pos == self._pos:
            return self._pos
        if not self._accept_ranges and pos != 0:
            raise OSError("http: server does not accept ranges")
        if self._resp is not None:
            self._resp.close()
            self._conn = None     # simplest correct: fresh request
        self._open_at(pos)
        return self._pos

    def tell(self) -> int:
        return self._pos

    def close(self):
        if self._resp is not None:
            self._resp.close()
        if self._conn is not None:
            self._conn.close()

    @property
    def length(self):
        return self._length


def _open_http(url: str, mode: str):
    from librempeg_tpu_torch.formats.io import IOContext

    if "w" in mode:
        raise InvalidData("http: writing not supported")
    f = HttpFile(url)
    return IOContext(f, seekable=f._accept_ranges and f.length is not None,
                     url=url)


def register():
    from librempeg_tpu_torch.formats.io import register_protocol

    register_protocol("http", _open_http)
    register_protocol("https", _open_http)


register()
