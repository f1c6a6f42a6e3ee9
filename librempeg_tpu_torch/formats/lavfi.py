"""lavfi virtual input device: the "filename" is a source filter graph.

Port of librempeg_tpu/formats/lavfi.py (libavdevice/lavfi.c analog):
`-f lavfi -i "testsrc=size=1920x1088:duration=2"` turns a source-filter
graph into an input whose frames are delivered as rawvideo or pcm_f32le
packets, so the normal decode path (codecs/rawvideo.py, codecs/pcm.py)
applies unchanged. The graph runs through FilterGraph.pump_sources on
the host, as the JAX package's does.
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.core.errors import EndOfStream, InvalidData
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import NOPTS, Rational
from librempeg_tpu_torch.formats.api import (
    CodecParameters,
    Demuxer,
    Stream,
    register_demuxer,
)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@register_demuxer
class LavfiDemuxer(Demuxer):
    NAME = "lavfi"
    LONG_NAME = "Libavfilter virtual input device"
    EXTENSIONS = ()
    #: open_input hands us the URL text itself instead of opening a file
    URL_IS_GRAPH = True

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        return 0                       # explicit -f lavfi only

    def read_header(self, io):
        from librempeg_tpu_torch.filters.graph import BufferSink, FilterGraph
        from librempeg_tpu_torch.filters.parser import build_graph

        desc = io.read(1 << 20).decode()
        if not desc:
            raise InvalidData("lavfi: empty graph description")
        self.graph = FilterGraph()
        _, exit_node, exit_pad = build_graph(self.graph, desc, [])
        media = exit_node.filter.OUTPUTS[exit_pad].media
        self.sink = BufferSink(media)
        sink_node = self.graph.add_instance(self.sink, "out")
        self.graph.link(exit_node, exit_pad, sink_node, 0)
        self.graph.configure()
        p = self.sink.props
        if media == "video":
            par = CodecParameters(
                codec_type="video", codec_id="rawvideo",
                width=p.width, height=p.height,
                pix_fmt=p.pix_fmt or "yuv420p",
                framerate=p.frame_rate or Rational(25, 1))
            tb = p.time_base or Rational(p.frame_rate.den, p.frame_rate.num)
        else:
            par = CodecParameters(
                codec_type="audio", codec_id="pcm_f32le",
                sample_rate=p.sample_rate, sample_fmt="flt",
                nb_channels=p.layout.nb_channels if p.layout else 1)
            tb = Rational(1, p.sample_rate)
        self.streams = [Stream(index=0, codecpar=par, time_base=tb)]
        self._tb = tb
        self._media = media
        self._eof = False
        self._next_pts = 0

    def read_packet(self) -> Packet:
        while not self.sink.frames:
            if self._eof or not self.graph.pump_sources():
                self.graph.flush()
                self._eof = True
                if not self.sink.frames:
                    raise EndOfStream
                break
        frame = self.sink.frames.popleft()
        if self._media == "video":
            data = b"".join(np.ascontiguousarray(_host(p)).tobytes()
                            for p in frame.planes)
            dur = 1
        else:
            from librempeg_tpu_torch.codecs.pcm import to_float

            x = _host(to_float(torch.as_tensor(frame.data),
                               frame.sample_fmt))
            data = np.ascontiguousarray(x.T.astype("<f4")).tobytes()
            dur = x.shape[1]
        pts = frame.pts if frame.pts != NOPTS else self._next_pts
        self._next_pts = pts + dur
        return Packet(data=data, pts=pts, dts=pts, duration=dur,
                      flags=PktFlags.KEY, time_base=self._tb)
