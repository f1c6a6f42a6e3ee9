"""HLS and DASH demuxing (VOD).

Analog of libavformat/hls.c and dashdec.c reduced to
the on-demand profiles our muxers and common packagers emit: the
playlist/manifest is resolved, the MPEG-TS segments are opened in
order (file or http(s) through the protocol layer) and concatenated
into one logical transport stream, and demuxing is delegated to the TS
demuxer -- segment boundaries are keyframe-aligned with in-band config
repetition, so the concatenation is a valid stream.

A copy of librempeg_tpu/formats/hlsdemux.py (host code) with its imports
rewritten to the port's modules.
"""
from __future__ import annotations

import posixpath
import urllib.parse
import xml.etree.ElementTree as ET

from librempeg_tpu_torch.core.errors import InvalidData
from librempeg_tpu_torch.formats.api import Demuxer, register_demuxer
from librempeg_tpu_torch.formats.io import MemoryIO, open_io


def _resolve(base_url: str, ref: str) -> str:
    """Resolve a segment reference against the playlist URL.

    Security (CVE-2016-1897 class, hls.c open_url checks): when the
    playlist came from the network, every segment ref is resolved with
    urljoin and MUST stay on a network scheme compatible with the
    playlist's -- a remote m3u8/MPD must not be able to direct the
    demuxer at local files (file:// or bare paths).
    """
    if "://" in base_url:
        base_scheme = urllib.parse.urlsplit(base_url).scheme.lower()
        resolved = urllib.parse.urljoin(base_url, ref)
        scheme = urllib.parse.urlsplit(resolved).scheme.lower()
        allowed = {base_scheme}
        if base_scheme == "http":
            allowed.add("https")  # http playlist may upgrade to https
        if scheme not in allowed:
            raise InvalidData(
                f"hls/dash: segment scheme {scheme!r} not allowed from a "
                f"{base_scheme!r} playlist: {resolved!r}")
        return resolved
    if "://" in ref or ref.startswith("/"):
        return ref
    d = posixpath.dirname(base_url)
    return posixpath.join(d, ref) if d else ref


def _concat_segments(base_url: str, uris: list[str]) -> MemoryIO:
    parts = []
    for u in uris:
        io = open_io(_resolve(base_url, u), "r")
        parts.append(io.read(1 << 30))
        io.close()
    return MemoryIO(b"".join(parts))


class _DelegatingDemuxer(Demuxer):
    """Common shell: subclasses fill self._inner in read_header."""

    def _delegate(self, data_io) -> None:
        from librempeg_tpu_torch.formats.mpegts import MpegTsDemuxer

        inner = MpegTsDemuxer()
        inner.io = data_io
        inner.read_header(data_io)
        self._inner = inner
        self.streams = inner.streams
        self.metadata.update(inner.metadata)
        self.duration = inner.duration

    def read_packet(self):
        return self._inner.read_packet()


@register_demuxer
class HlsDemuxer(_DelegatingDemuxer):
    NAME = "hls"
    LONG_NAME = "Apple HTTP Live Streaming (demuxer)"
    EXTENSIONS = ("m3u8",)

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        if buf.startswith(b"#EXTM3U"):
            return 100
        return 0

    def read_header(self, io):
        text = io.read(1 << 24).decode("utf-8", "replace")
        if not text.startswith("#EXTM3U"):
            raise InvalidData("hls: not an m3u8 playlist")
        base = getattr(io, "url", "") or ""
        lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
        segs = [ln for ln in lines if not ln.startswith("#")]
        # master playlist: first variant wins
        if segs and segs[0].endswith(".m3u8"):
            sub = open_io(_resolve(base, segs[0]), "r")
            return self.read_header(sub)
        if not segs:
            raise InvalidData("hls: empty playlist")
        self._delegate(_concat_segments(base, segs))


@register_demuxer
class DashDemuxer(_DelegatingDemuxer):
    NAME = "dash"
    LONG_NAME = "DASH (demuxer, static MPD with SegmentList)"
    EXTENSIONS = ("mpd",)

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        head = buf[:256]
        if b"<MPD" in head:
            return 100
        return 0

    def read_header(self, io):
        base = getattr(io, "url", "") or ""
        xml = io.read(1 << 24).decode("utf-8", "replace")
        try:
            root = ET.fromstring(xml)
        except ET.ParseError as e:
            raise InvalidData(f"dash: bad MPD: {e}")
        ns = ""
        if root.tag.startswith("{"):
            ns = root.tag[:root.tag.index("}") + 1]
        uris = []
        for su in root.iter(ns + "SegmentURL"):
            u = su.get("media")
            if u:
                uris.append(u)
        if not uris:
            # SegmentTemplate with $Number$ (bounded by duration)
            for st in root.iter(ns + "SegmentTemplate"):
                media = st.get("media")
                start = int(st.get("startNumber", "1"))
                if media and "$Number$" in media:
                    n = start
                    while n < start + 10000:
                        url = _resolve(base,
                                       media.replace("$Number$", str(n)))
                        try:
                            probe_io = open_io(url, "r")
                            probe_io.close()
                        except Exception:
                            break
                        uris.append(media.replace("$Number$", str(n)))
                        n += 1
                    break
        if not uris:
            raise InvalidData("dash: no segments in MPD")
        self._delegate(_concat_segments(base, uris))
