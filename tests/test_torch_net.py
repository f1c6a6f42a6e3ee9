"""The port's HTTP protocol (librempeg_tpu_torch/formats/http.py:
HttpFile and the http:// opener of formats/io.py) against the JAX
package's, on loopback (127.0.0.1) only.

A ThreadingHTTPServer on port 0 in a thread serves a directory, with
byte ranges (206) and, on one path, a body cut short once. Both
packages read the same bytes: whole, in chunks, after seeks, through a
redirect, across the reconnect after the cut, and a whole demux of an
MP4 over http:// (ranges and seeks inside) equal to the file's. Every
socket wait and thread join has a timeout of at most 15 s.
"""
import contextlib
import functools
import http.server
import os
import threading

import pytest

from librempeg_tpu.formats import api as JA
from librempeg_tpu.formats import registry as _jreg  # noqa: F401
from librempeg_tpu.formats.http import HttpFile as JHttp
from librempeg_tpu.formats.io import open_io as jopen_io
from librempeg_tpu_torch.formats import api as TA
from librempeg_tpu_torch.formats import registry as _treg  # noqa: F401
from librempeg_tpu_torch.formats.http import HttpFile as THttp
from librempeg_tpu_torch.formats.io import open_io as topen_io

TIMEOUT = 15.0


class _Handler(http.server.SimpleHTTPRequestHandler):
    """Static files with Range support; /cut/NAME sends NAME's first
    half once, closing the connection early; /moved/NAME redirects."""

    cuts: set = set()

    def log_message(self, *a):
        pass

    def do_GET(self):
        path = self.path.split("?")[0]
        if path.startswith("/moved/"):
            self.send_response(302)
            self.send_header("Location", "/" + path[len("/moved/"):])
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        cut = path.startswith("/cut/")
        name = path[len("/cut/"):] if cut else path.lstrip("/")
        full = os.path.join(self.directory, name)
        if not os.path.isfile(full):
            self.send_error(404)
            return
        with open(full, "rb") as f:
            data = f.read()
        start = 0
        rng = self.headers.get("Range")
        if rng and rng.startswith("bytes="):
            start = int(rng[6:].split("-")[0])
            self.send_response(206)
            self.send_header("Content-Range",
                             f"bytes {start}-{len(data) - 1}/{len(data)}")
        else:
            self.send_response(200)
        self.send_header("Accept-Ranges", "bytes")
        self.send_header("Content-Length", str(len(data) - start))
        self.end_headers()
        body = data[start:]
        if cut and name not in self.cuts:
            self.cuts.add(name)
            self.wfile.write(body[:len(body) // 2])
            self.wfile.flush()
            self.close_connection = True
            return
        self.wfile.write(body)


@contextlib.contextmanager
def serve(directory):
    """An HTTP server on 127.0.0.1, port 0, serving `directory`; yields
    its base URL and stops it on exit."""
    handler = functools.partial(_Handler, directory=str(directory))
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    srv.timeout = TIMEOUT
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()


@pytest.fixture(scope="module")
def site(tmp_path_factory):
    from tests.test_torch_slice import make_clip

    td = tmp_path_factory.mktemp("www")
    (td / "blob.bin").write_bytes(bytes(range(256)) * 1000 + b"end")
    make_clip(str(td / "c.264"), w=64, h=48, n=8)
    from librempeg_tpu_torch.cli.ffmpeg import main as tmain

    assert tmain(["-i", str(td / "c.264"), "-c", "copy", "-device", "cpu",
                  "-y", str(td / "c.mp4")]) == 0
    _Handler.cuts = set()
    with serve(td) as base:
        yield td, base


def _reads(cls, url):
    f = cls(url, timeout=TIMEOUT)
    out = [f.length, f.read(1000), f.read(1)]
    f.seek(100_000)
    out += [f.tell(), f.read(50)]
    f.seek(-3, 2)
    out.append(f.read())
    f.seek(7)
    out.append(f.read(-1)[:20])
    f.close()
    return out


def test_http_file_matches_jax(site):
    td, base = site
    j, t = _reads(JHttp, f"{base}/blob.bin"), _reads(THttp, f"{base}/blob.bin")
    assert j == t
    data = (td / "blob.bin").read_bytes()
    assert t[0] == len(data) and t[1] == data[:1000] and t[5] == b"end"


def test_http_follows_a_redirect(site):
    """The port requests the redirect's location; the JAX package
    re-requests the first path until its retries run out (a fault of
    the reference)."""
    from librempeg_tpu.core.errors import InvalidData

    td, base = site
    assert _reads(THttp, f"{base}/moved/blob.bin") == \
        _reads(THttp, f"{base}/blob.bin")
    with pytest.raises(InvalidData, match="open failed"):
        JHttp(f"{base}/moved/blob.bin", timeout=TIMEOUT)


def test_http_reconnects_after_a_cut_body(site):
    td, base = site
    data = (td / "blob.bin").read_bytes()
    got = []
    for cls in (JHttp, THttp):
        f = cls(f"{base}/cut/blob.bin", timeout=TIMEOUT)
        got.append(f.read())
        f.close()
        _Handler.cuts.discard("blob.bin")
    assert got[0] == got[1] == data


def test_http_protocol_and_demux_match_jax(site):
    td, base = site
    url = f"{base}/c.mp4"
    j, t = jopen_io(url, "r"), topen_io(url, "r")
    assert j.read(64) == t.read(64) == (td / "c.mp4").read_bytes()[:64]
    j.close()
    t.close()
    out = []
    for api in (JA, TA, TA):
        d = api.open_input(url if len(out) < 2 else str(td / "c.mp4"))
        out.append([(p.pts, p.dts, int(p.flags), bytes(p.data))
                    for p in d.packets()])
        d.close()
    assert out[0] == out[1] == out[2] and len(out[2]) == 8
