"""Byte I/O layer.

Analog of AVIOContext/URLProtocol (libavformat/avio.h:160,
aviobuf.c, url.h:52): a buffered, seekable byte stream abstraction that
demuxers/muxers use, with probe-friendly peeking. Protocol selection by
URL scheme mirrors the reference's protocol registry (protocols.c);
file/pipe/memory are built in, network protocols plug in via register().
"""
from __future__ import annotations

import io as _pyio
import os
import struct
import sys
from typing import BinaryIO, Callable


class IOContext:
    """Buffered byte reader/writer with peek support."""

    def __init__(self, fh: BinaryIO, *, seekable: bool | None = None,
                 url: str = ""):
        self._fh = fh
        self.url = url
        if seekable is None:
            try:
                fh.seek(fh.tell())
                seekable = True
            except (OSError, ValueError, _pyio.UnsupportedOperation):
                seekable = False
        self.seekable = seekable
        self._peek = b""
        self.eof = False

    # -- reading ------------------------------------------------------
    def read(self, n: int) -> bytes:
        if self._peek:
            out, self._peek = self._peek[:n], self._peek[n:]
            if len(out) == n:
                return out
            rest = self._fh.read(n - len(out))
            if not rest:
                self.eof = True
            return out + rest
        data = self._fh.read(n)
        if len(data) < n:
            self.eof = True
        return data

    def read_exact(self, n: int) -> bytes:
        data = self.read(n)
        if len(data) != n:
            from librempeg_tpu_torch.core.errors import EndOfStream

            raise EndOfStream(f"needed {n} bytes, got {len(data)}")
        return data

    def peek(self, n: int) -> bytes:
        """Return up to n bytes without consuming them."""
        if len(self._peek) < n:
            more = self._fh.read(n - len(self._peek))
            self._peek += more
        return self._peek[:n]

    def skip(self, n: int) -> None:
        if self._peek:
            k = min(len(self._peek), n)
            self._peek = self._peek[k:]
            n -= k
        if n:
            if self.seekable:
                self._fh.seek(n, os.SEEK_CUR)
            else:
                self._fh.read(n)

    # -- binary helpers (names follow avio.h rl/rb conventions) -------
    def rl16(self) -> int:
        return struct.unpack("<H", self.read_exact(2))[0]

    def rl24(self) -> int:
        b = self.read_exact(3)
        return b[0] | b[1] << 8 | b[2] << 16

    def rl32(self) -> int:
        return struct.unpack("<I", self.read_exact(4))[0]

    def rl64(self) -> int:
        return struct.unpack("<Q", self.read_exact(8))[0]

    def rb16(self) -> int:
        return struct.unpack(">H", self.read_exact(2))[0]

    def rb24(self) -> int:
        b = self.read_exact(3)
        return b[0] << 16 | b[1] << 8 | b[2]

    def rb32(self) -> int:
        return struct.unpack(">I", self.read_exact(4))[0]

    def rb64(self) -> int:
        return struct.unpack(">Q", self.read_exact(8))[0]

    def r8(self) -> int:
        return self.read_exact(1)[0]

    # -- writing ------------------------------------------------------
    def write(self, data: bytes) -> None:
        self._fh.write(data)

    def wl16(self, v: int) -> None:
        self._fh.write(struct.pack("<H", v & 0xFFFF))

    def wl32(self, v: int) -> None:
        self._fh.write(struct.pack("<I", v & 0xFFFFFFFF))

    def wl64(self, v: int) -> None:
        self._fh.write(struct.pack("<Q", v & (1 << 64) - 1))

    def wb16(self, v: int) -> None:
        self._fh.write(struct.pack(">H", v & 0xFFFF))

    def wb24(self, v: int) -> None:
        self._fh.write(bytes([(v >> 16) & 255, (v >> 8) & 255, v & 255]))

    def wb32(self, v: int) -> None:
        self._fh.write(struct.pack(">I", v & 0xFFFFFFFF))

    def w8(self, v: int) -> None:
        self._fh.write(bytes([v & 255]))

    # -- position -----------------------------------------------------
    def tell(self) -> int:
        return self._fh.tell() - len(self._peek)

    def seek(self, pos: int, whence: int = os.SEEK_SET) -> int:
        self._peek = b""
        self.eof = False
        return self._fh.seek(pos, whence)

    @property
    def size(self) -> int:
        """Stream size in bytes, or -1 if unknown (avio_size)."""
        if not self.seekable:
            return -1
        cur = self._fh.tell()
        end = self._fh.seek(0, os.SEEK_END)
        self._fh.seek(cur)
        return end

    def flush(self) -> None:
        if hasattr(self._fh, "flush"):
            self._fh.flush()

    def close(self) -> None:
        self.flush()
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- protocol registry ------------------------------------------------------

_PROTOCOLS: dict[str, Callable[[str, str], IOContext]] = {}


def register_protocol(scheme: str, opener: Callable[[str, str], IOContext]) -> None:
    _PROTOCOLS[scheme] = opener


def _open_file(url: str, mode: str) -> IOContext:
    path = url[len("file:"):] if url.startswith("file:") else url
    if path == "-":
        return _open_pipe(url, mode)
    fh = open(path, "rb" if mode == "r" else "wb")
    return IOContext(fh, url=url)


def _open_pipe(url: str, mode: str) -> IOContext:
    fd = url[len("pipe:"):] if url.startswith("pipe:") else ""
    if fd and fd not in ("0", "1", "2"):
        fh = os.fdopen(int(fd), "rb" if mode == "r" else "wb")
    else:
        fh = sys.stdin.buffer if mode == "r" else sys.stdout.buffer
    return IOContext(fh, seekable=False, url=url)


def _open_concat(url: str, mode: str) -> IOContext:
    """concat:file1|file2 — virtual concatenation (concat protocol
    analog, libavformat/concat.c)."""
    if mode != "r":
        raise ValueError("concat: read-only")
    paths = url[len("concat:"):].split("|")
    data = b"".join(open(p, "rb").read() for p in paths)
    io = IOContext(_pyio.BytesIO(data), seekable=True, url=url)
    return io


def _open_data(url: str, mode: str) -> IOContext:
    """data: URIs (data.c analog) — base64 or percent-encoded inline."""
    import base64
    import urllib.parse

    body = url[len("data:"):]
    if "," not in body:
        raise ValueError("bad data: URI")
    meta, payload = body.split(",", 1)
    if meta.endswith(";base64"):
        raw = base64.b64decode(payload)
    else:
        raw = urllib.parse.unquote_to_bytes(payload)
    return IOContext(_pyio.BytesIO(raw), seekable=True, url=url)


def _open_md5(url: str, mode: str) -> IOContext:
    """md5: write-side digest protocol (md5proto.c analog): on close,
    writes the hex digest to stdout or the given file."""
    import hashlib

    target = url[len("md5:"):]

    class _Md5IO(IOContext):
        def __init__(self):
            super().__init__(_pyio.BytesIO(), seekable=False, url=url)
            self._h = hashlib.md5()

        def write(self, data: bytes) -> None:
            self._h.update(data)

        def close(self):
            digest = self._h.hexdigest() + "\n"
            if target:
                with open(target, "w") as f:
                    f.write(digest)
            else:
                sys.stdout.write(digest)

    return _Md5IO()


def _open_tcp(url: str, mode: str) -> IOContext:
    """tcp://host:port[?listen=1] (tcp.c analog). With listen=1 the
    opener binds and accepts one peer; otherwise it connects. The
    socket is wrapped unbuffered and unseekable, like the reference's
    streamed-protocol contract."""
    import socket
    import urllib.parse as up

    u = up.urlparse(url)
    host, port = u.hostname or "127.0.0.1", u.port
    if port is None:
        raise ValueError("tcp: missing port")
    q = dict(up.parse_qsl(u.query))
    if q.get("listen"):
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(1)
        srv.settimeout(float(q.get("timeout", 30)))
        conn, _ = srv.accept()
        srv.close()
    else:
        conn = socket.create_connection(
            (host, port), timeout=float(q.get("timeout", 30)))
    if mode == "r":
        # buffered reader: loops short socket reads until n bytes or EOF
        fh = conn.makefile("rb")
    else:
        fh = conn.makefile("wb", buffering=0)
    io = IOContext(fh, seekable=False, url=url)
    io._sock = conn                         # keep a ref for close()
    return io


def _open_udp(url: str, mode: str) -> IOContext:
    """udp://host:port (udp.c analog, datagram-as-stream)."""
    import socket
    import urllib.parse as up

    u = up.urlparse(url)
    host, port = u.hostname or "127.0.0.1", u.port
    if port is None:
        raise ValueError("udp: missing port")
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    class _UdpIO(IOContext):
        def __init__(self):
            self.url = url
            self.seekable = False
            self._peek = b""
            self.eof = False
            if mode == "r":
                sock.bind((host, port))
                sock.settimeout(30)

        def read(self, n):
            if self._peek:
                out, self._peek = self._peek[:n], self._peek[n:]
                return out
            try:
                data, _ = sock.recvfrom(65536)
            except OSError:
                self.eof = True
                return b""
            if not data:
                self.eof = True
            return data[:n] if n < len(data) else data

        def write(self, data):
            mv = memoryview(bytes(data))
            for i in range(0, len(mv), 1316):   # TS-friendly datagrams
                sock.sendto(bytes(mv[i:i + 1316]), (host, port))

        def close(self):
            sock.close()

    return _UdpIO()


register_protocol("file", _open_file)
register_protocol("pipe", _open_pipe)
register_protocol("concat", _open_concat)
register_protocol("data", _open_data)
register_protocol("md5", _open_md5)
register_protocol("tcp", _open_tcp)
register_protocol("udp", _open_udp)


def open_io(url: str, mode: str = "r") -> IOContext:
    """Open a URL with the registered protocol (avio_open analog)."""
    scheme = url.split(":", 1)[0] if ":" in url and not os.path.exists(url) else "file"
    opener = _PROTOCOLS.get(scheme, _open_file)
    return opener(url, mode)


class MemoryIO(IOContext):
    """In-memory IOContext (the reference's dyn_buf / buffer-backed avio)."""

    def __init__(self, data: bytes = b""):
        super().__init__(_pyio.BytesIO(data), seekable=True, url="memory:")

    def getvalue(self) -> bytes:
        return self._fh.getvalue()
