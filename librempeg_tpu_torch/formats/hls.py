"""HLS segment muxer: MPEG-TS media segments + m3u8 playlist.

Analog of libavformat/hlsenc.c (the VOD subset):
segments cut at keyframes once `hls_time` is reached, `#EXTINF`
durations from actual packet timestamps, `#EXT-X-ENDLIST` on close.
Segment names derive from the playlist path (out.m3u8 -> out0.ts ...).

A copy of librempeg_tpu/formats/hls.py (host code) with its imports
rewritten to the port's modules.
"""
from __future__ import annotations

import os

from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import NOPTS
from librempeg_tpu_torch.formats.api import Muxer, register_muxer
from librempeg_tpu_torch.formats.io import open_io


@register_muxer
class HlsMuxer(Muxer):
    NAME = "hls"
    LONG_NAME = "Apple HTTP Live Streaming"
    EXTENSIONS = ("m3u8",)

    #: seconds per segment (hls_time)
    SEGMENT_SECONDS = 2.0

    def write_header(self):
        super().write_header()
        base = self.io.url or "out.m3u8"
        self._base = os.path.splitext(base)[0]
        self._seg_index = 0
        self._segments: list[tuple[str, float]] = []   # (name, duration)
        self._seg_mux = None
        self._seg_start = None       # first pts (seconds) in segment
        self._seg_last = 0.0
        self._target = float(self.metadata.pop("hls_time",
                                               self.SEGMENT_SECONDS))
        self._config = None          # harvested in-band codec config

    def _open_segment(self):
        from librempeg_tpu_torch.formats.mpegts import MpegTsMuxer

        name = f"{self._base}{self._seg_index}.ts"
        mux = MpegTsMuxer(open_io(name, "w"))
        for st in self.streams:
            mux.add_stream(st.codecpar, st.time_base)
        mux.write_header()
        self._seg_mux = mux
        self._seg_conf_done = False
        self._seg_name = name
        self._seg_start = None

    def _close_segment(self):
        if self._seg_mux is None:
            return
        self._seg_mux.write_trailer()
        self._seg_mux.io.close()
        dur = max(self._seg_last - (self._seg_start or 0.0), 0.0)
        self._segments.append((os.path.basename(self._seg_name), dur))
        self._seg_mux = None
        self._seg_index += 1

    def write_packet(self, pkt: Packet):
        t = 0.0
        if pkt.pts != NOPTS and pkt.time_base.valid and pkt.time_base.num:
            t = pkt.pts * pkt.time_base.num / pkt.time_base.den
        key = bool(pkt.flags & PktFlags.KEY)
        is_video = (self.streams[pkt.stream_index].codecpar.codec_type
                    == "video")
        if self._seg_mux is None:
            self._open_segment()
        elif key and is_video and self._seg_start is not None and \
                t - self._seg_start >= self._target:
            self._close_segment()
            self._open_segment()
        if self._seg_start is None:
            self._seg_start = t
        dur = pkt.duration if pkt.duration and pkt.duration != NOPTS else 0
        if pkt.time_base.valid and pkt.time_base.num:
            self._seg_last = max(
                self._seg_last,
                t + dur * pkt.time_base.num / pkt.time_base.den)
        # every segment must be independently decodable: repeat the
        # codec config in-band at each segment's first video keyframe
        # (hlsenc's implicit dump_extra behavior)
        if key and is_video and not self._seg_conf_done:
            data = bytes(pkt.data)
            extra = bytes(
                self.streams[pkt.stream_index].codecpar.extradata or b"")
            if not extra and self._config is None:
                # encoders that carry config in-band (mpeg4 VOS/VOL):
                # harvest everything before the first VOP startcode
                vop = data.find(b"\x00\x00\x01\xb6")
                self._config = data[:vop] if vop > 0 else b""
            conf = extra or self._config or b""
            if conf and not data.startswith(conf):
                pkt = pkt.replace(data=conf + data)
            self._seg_conf_done = True
        self._seg_mux.write(pkt)

    def write_trailer(self):
        self._drain(final=True)
        self._close_segment()
        target = max((d for _, d in self._segments), default=self._target)
        lines = ["#EXTM3U", "#EXT-X-VERSION:3",
                 f"#EXT-X-TARGETDURATION:{int(target + 0.999)}",
                 "#EXT-X-MEDIA-SEQUENCE:0", "#EXT-X-PLAYLIST-TYPE:VOD"]
        for name, dur in self._segments:
            lines.append(f"#EXTINF:{dur:.6f},")
            lines.append(name)
        lines.append("#EXT-X-ENDLIST")
        self.io.write(("\n".join(lines) + "\n").encode())


@register_muxer
class DashMuxer(HlsMuxer):
    """MPEG-DASH (static/VOD profile, MPEG-2 TS segments).

    Analog of libavformat/dashenc.c's on-demand mode:
    same keyframe-aligned segmenter as HLS, manifest is a static MPD
    with a SegmentList (ISO/IEC 23009-1; TS media per the
    urn:mpeg:dash:profile:mp2t-simple profile).
    """

    NAME = "dash"
    LONG_NAME = "DASH Muxer"
    EXTENSIONS = ("mpd",)

    def write_trailer(self):
        self._drain(final=True)
        self._close_segment()
        total = sum(d for _, d in self._segments)
        maxseg = max((d for _, d in self._segments), default=self._target)
        par = next((st.codecpar for st in self.streams
                    if st.codecpar.codec_type == "video"),
                   self.streams[0].codecpar)
        lines = [
            '<?xml version="1.0" encoding="utf-8"?>',
            '<MPD xmlns="urn:mpeg:dash:schema:mpd:2011" type="static"',
            f'     mediaPresentationDuration="PT{total:.3f}S"',
            '     profiles="urn:mpeg:dash:profile:mp2t-simple:2011">',
            f'  <Period duration="PT{total:.3f}S">',
            '    <AdaptationSet mimeType="video/mp2t">',
            f'      <Representation id="0" width="{par.width}"'
            f' height="{par.height}" bandwidth="0">',
            f'        <SegmentList duration="{int(maxseg * 1000)}"'
            ' timescale="1000">',
        ]
        for name, _dur in self._segments:
            lines.append(f'          <SegmentURL media="{name}"/>')
        lines += ['        </SegmentList>', '      </Representation>',
                  '    </AdaptationSet>', '  </Period>', '</MPD>']
        self.io.write(("\n".join(lines) + "\n").encode())
