"""Transcode pipeline for one video stream.

Port of librempeg_tpu/sched/pipeline.py, cut to the slice: one H.264
video stream is decoded, run through a null/scale filter chain and
encoded to MPEG-4 into an AVI. There is no codec registry: the chain
wires the decoder, graph, encoder and muxer directly. Every device stage
runs on `device` (default "cuda"; a missing card raises).

As in the JAX package, a worker thread overlaps the fetch of frame i's
compacted levels and its host VLC packing with the decode of frame
i + 1 (the role of the reference scheduler's per-node threads,
ffmpeg_sched.h:31-87).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Any

from librempeg_tpu_torch.codecs.h264.codec import H264Decoder
from librempeg_tpu_torch.codecs.mpeg4.encoder import Mpeg4Encoder
from librempeg_tpu_torch.core.errors import InvalidData, Unsupported
from librempeg_tpu_torch.core.rational import Rational
from librempeg_tpu_torch.device import resolve
from librempeg_tpu_torch.filters import GraphRunner, StreamProps
from librempeg_tpu_torch.formats.api import open_input, open_output
from librempeg_tpu_torch.utils.stagetimer import stage


@dataclass
class StreamMap:
    """One output stream's processing chain configuration."""

    codec: str = ""                  # output codec name
    filters: str = ""                # filter chain description
    codec_opts: dict = field(default_factory=dict)
    width: int = 0                   # output size overrides
    height: int = 0
    frames_limit: int = 0            # -frames:v analog; 0 = unlimited


@dataclass
class TranscodeSpec:
    input_url: str
    output_url: str
    input_format: str | None = None
    output_format: str | None = None
    video: StreamMap | None = None
    device: str = "cuda"


class _StreamChain:
    """decode -> filter -> encode for the video stream."""

    def __init__(self, in_stream, smap: StreamMap, out_mux, device):
        par = in_stream.codecpar
        if (par.codec_id, smap.codec) != ("h264", "mpeg4"):
            raise Unsupported(
                f"transcode: {par.codec_id} -> {smap.codec} is not ported "
                "(h264 -> mpeg4 only)")
        self.smap = smap
        self.frames_done = 0
        self.eof = False
        self.decoder = H264Decoder(par, device=device)
        props = StreamProps(
            media="video", width=par.width, height=par.height,
            pix_fmt=par.pix_fmt or "yuv420p",
            frame_rate=par.framerate if par.framerate.num else
            Rational(25, 1),
            time_base=in_stream.time_base)
        desc = smap.filters or "null"
        if smap.width or smap.height:
            desc += f",scale={smap.width or -1}:{smap.height or -1}"
        self.graph = GraphRunner(desc, props)
        out = self.graph.output_props
        unknown = sorted(k for k in smap.codec_opts
                         if not Mpeg4Encoder.OPTIONS.get(k))
        if unknown:
            raise Unsupported(f"encoder mpeg4: unknown options {unknown}")
        self.encoder = Mpeg4Encoder(width=out.width, height=out.height,
                                    pix_fmt=out.pix_fmt, device=device,
                                    **smap.codec_opts)
        self.out_stream = out_mux.add_stream(
            self.encoder.codec_parameters(), out.time_base or Rational(1, 25))
        # pipelined encode: the worker fetches and packs frame i while
        # the main thread decodes frame i + 1
        self._pq: Any = queue.Queue(maxsize=4)
        self._perr: Exception | None = None
        self._pworker = threading.Thread(target=self._drain_encodes,
                                         daemon=True)
        self._pworker.start()

    def _drain_encodes(self) -> None:
        while True:
            item = self._pq.get()
            if item is None:
                self._pq.task_done()
                return
            handle, mux = item
            try:
                with stage("enc_finish.fetch"):
                    handle["packed_np"] = handle["packed"].cpu().numpy()
                with stage("enc_finish.worker"):
                    for pkt in self.encoder.encode_finish(handle):
                        mux.write(pkt.replace(
                            stream_index=self.out_stream.index))
            except Exception as e:      # raised on the next call
                self._perr = e
            finally:
                self._pq.task_done()

    def sync(self) -> None:
        """Block until every dispatched frame is packed and muxed."""
        self._pq.join()
        self._perr_check()

    def _join_encodes(self) -> None:
        if self._pworker.is_alive():
            self._pq.put(None)
            self._pworker.join()
        self._perr_check()

    def _perr_check(self) -> None:
        if self._perr is not None:
            err, self._perr = self._perr, None
            raise err

    def send_packet(self, pkt, mux) -> None:
        if self.eof:
            return
        with stage("video.decode"):
            frames = self.decoder.decode(pkt)
        for frame in frames:
            self._through_graph(frame, mux)

    def _through_graph(self, frame, mux, flush=False) -> None:
        with stage("video.graph"):
            outs = self.graph.push(frame) if frame is not None else []
            if flush:
                outs += self.graph.finish()
        for f in outs:
            if self.smap.frames_limit and \
                    self.frames_done >= self.smap.frames_limit:
                self.eof = True
                return
            self.frames_done += 1
            self._perr_check()
            with stage("video.enc_dispatch"):
                h = self.encoder.encode_async(f)
            self._pq.put((h, mux))

    def finish(self, mux) -> None:
        if not self.eof:
            for frame in self.decoder.flush():
                self._through_graph(frame, mux)
            self._through_graph(None, mux, flush=True)
        self._join_encodes()
        self.decoder.close()
        for pkt in self.encoder.flush():
            mux.write(pkt.replace(stream_index=self.out_stream.index))


class Transcoder:
    """Single input -> single output transcoder of one video stream."""

    def __init__(self, spec: TranscodeSpec):
        self.spec = spec
        device = resolve(spec.device)
        self.demux = open_input(spec.input_url, spec.input_format)
        self.mux = open_output(spec.output_url, spec.output_format)
        self.chains: dict[int, _StreamChain] = {}
        for st in self.demux.streams:
            if st.codecpar.codec_type == "video" and not self.chains:
                smap = spec.video or StreamMap(codec="mpeg4")
                self.chains[st.index] = _StreamChain(st, smap, self.mux,
                                                     device)
        if not self.chains:
            raise InvalidData("no video stream to transcode")

    def run(self) -> dict:
        n_packets = 0
        for pkt in self.demux.packets():
            chain = self.chains.get(pkt.stream_index)
            if chain is None:
                continue
            chain.send_packet(pkt, self.mux)
            n_packets += 1
            if all(c.eof for c in self.chains.values()):
                break
        for chain in self.chains.values():
            chain.finish(self.mux)
        self.mux.close()
        self.demux.close()
        return {"packets": n_packets,
                "frames": {i: c.frames_done
                           for i, c in self.chains.items()}}
