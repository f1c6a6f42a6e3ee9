"""Transcode pipeline: one chain per selected video and audio stream.

Port of librempeg_tpu/sched/pipeline.py, cut to the slices. Both
chains take their decoder and encoder from the codec registry
(codecs/registry.py: h264, hevc (decode), mpeg4, mjpeg, png,
mpeg1video, mpeg2video, rawvideo; aac, pcm_*, flac, ac3, adpcm_*,
and mp2, mp3, opus, vorbis (decode)). The
video chain runs the filter graph between them (-s appends scale=,
-pix_fmt format=) and maps -q:v onto what the encoder declares (quality
for mjpeg, qscale for mpeg4); `-c:v copy` passes the demuxer's packets
to the muxer with no decode. Without -c:v the output format picks the
codec (for image2 the extension's: png for .png, mjpeg for .jpg; mjpeg
for raw MJPEG; rawvideo for the hash muxers,
yuv4mpegpipe and rawvideo; mpeg4 otherwise). An audio
stream is decoded, run through its filter graph (-ar appends
aresample=, -ac aformat=channel_layouts=) and encoded, or copied
(`-c:a copy`).
Every device stage runs on `device` (default "cuda"; a missing card
raises).

-ss seeks as the JAX package does: the container seeks on its first
seekable stream (video first) to the keyframe at or before the time,
measured from the input's earliest start time, and both chains decode
and drop what ends before it; -t stops at the first packet at or past
seek + duration (the CLI turns -to into this duration). A text
subtitle stream (subrip, ass) is decoded to cues and re-encoded as
SubRip on the host (_SubtitleChain). -map selectors (spec.maps) pick
the input streams; run(progress=...) feeds the -progress report.

Codec options: a StreamMap's codec_opts go to its encoder, and each
must be one the encoder declares (or -q:v, -g, -bf, which map onto
what it declares); the spec's codec_opts (the CLI's unscoped private
options, -qp 26) go to every encoder that declares them, and one that
no encoder of the run declares raises.

As in the JAX package, a worker thread overlaps the fetch of frame i's
compacted levels and its host VLC packing with the decode of frame
i + 1 (the role of the reference scheduler's per-node threads,
ffmpeg_sched.h:31-87), for an encoder with that dispatch/finish split
(MPEG-4). With B-frames (max_b_frames > 0), or an encoder without the
split (JPEG), the chain encodes synchronously through encoder.encode();
B-frame packets come in decode order with the encoder's dts.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any

from librempeg_tpu_torch.codecs.api import find_decoder, find_encoder
from librempeg_tpu_torch.core.errors import InvalidData, Unsupported
from librempeg_tpu_torch.core.log import Logger
from librempeg_tpu_torch.core.rational import NOPTS, Rational
from librempeg_tpu_torch.core.samplefmt import ChannelLayout
from librempeg_tpu_torch.device import resolve
from librempeg_tpu_torch.filters import GraphRunner, StreamProps
from librempeg_tpu_torch.formats.api import open_input, open_output
from librempeg_tpu_torch.formats.image2 import codec_for_path
from librempeg_tpu_torch.parallel import product_mesh as PM
from librempeg_tpu_torch.utils.stagetimer import stage

log = Logger("transcode")


@dataclass
class StreamMap:
    """One output stream's processing chain configuration."""

    codec: str = ""                  # output codec ("copy": stream copy)
    filters: str = ""                # filter chain description
    codec_opts: dict = field(default_factory=dict)
    width: int = 0                   # output size overrides
    height: int = 0
    pix_fmt: str = ""                # output pixel format override
    sample_rate: int = 0             # -ar: output sample rate
    channels: int = 0                # -ac: output channel count
    frames_limit: int = 0            # -frames:v/-frames:a; 0 = unlimited


@dataclass
class TranscodeSpec:
    input_url: str
    output_url: str
    input_format: str | None = None
    input_opts: dict = field(default_factory=dict)  # options before -i
    output_format: str | None = None
    video: StreamMap | None = None
    audio: StreamMap | None = None
    no_video: bool = False           # -vn
    no_audio: bool = False           # -an
    duration: float = 0.0            # -t, seconds
    seek: float = 0.0                # -ss, seconds
    metadata: dict = field(default_factory=dict)    # -metadata key=value
    codec_opts: dict = field(default_factory=dict)  # -name value, unscoped
    maps: list = field(default_factory=list)        # -map selectors
    device: str = "cuda"
    mesh: str = ""                   # -mesh data=2,spatial=3


#: the video codec an output format takes when no -c:v names one (image2:
#: the one its file name's extension names, else this)
_DEFAULT_VIDEO_CODEC = {
    "image2": "mjpeg", "mjpeg": "mjpeg",
    **dict.fromkeys(("framecrc", "framemd5", "md5", "crc", "null",
                     "yuv4mpegpipe", "rawvideo"), "rawvideo"),
}


def _default_video_codec(mux_name: str, url: str) -> str:
    """-c:v when none is given: the output format's codec; for image2
    the codec of the file's extension (png for .png, mjpeg for .jpg)."""
    if mux_name == "image2":
        return codec_for_path(url) or "mjpeg"
    return _DEFAULT_VIDEO_CODEC.get(mux_name, "mpeg4")


def _discard(frame, until: float, media: str) -> bool:
    """-ss's exact decode-and-drop: a video frame before `until` by its
    pts, an audio frame by its end."""
    if not until or frame.pts == NOPTS or not frame.time_base.valid \
            or not frame.time_base.num:
        return False
    t = frame.pts * frame.time_base.num / frame.time_base.den
    if media == "audio":
        t += frame.nb_samples / max(1, frame.sample_rate)
    return t < until - 1e-9


#: CLI-level names and the short names some encoders declare instead
#: (-g, -bf: H.264's g and bf, MPEG-1/2's g)
_SHORT_NAMES = {"gop_size": "g", "max_b_frames": "bf"}


def _declared(enc_cls, codec_opts: dict) -> dict:
    """The options of `codec_opts` that `enc_cls` declares."""
    return {k: v for k, v in codec_opts.items() if enc_cls.OPTIONS.get(k)}


def _translate_codec_opts(enc_cls, codec_opts: dict) -> dict:
    """Map CLI-level options onto what the encoder declares
    (ffmpeg_opt.c's per-codec AVDictionary filtering analog): -q:v's
    1..31 qscale (`quality_scale`) stays qscale where the encoder has
    one and becomes JPEG-style quality where it has that, by the JAX
    package's rule; gop_size and max_b_frames become g and bf for an
    encoder that declares only the short names (the JAX package drops
    them with a warning). Options the encoder does not declare raise,
    and so does a -q:v with a fraction for an encoder whose qscale is an
    integer."""
    out = {}
    for k, v in codec_opts.items():
        short = _SHORT_NAMES.get(k)
        if short and not enc_cls.OPTIONS.get(k) and \
                enc_cls.OPTIONS.get(short):
            k = short
        if k == "quality_scale":
            if enc_cls.OPTIONS.get("qscale"):
                if v != int(v):
                    raise Unsupported(f"encoder {enc_cls.INFO.name}: -q:v "
                                      f"{v} is not an integer qscale")
                out["qscale"] = int(v)
            elif enc_cls.OPTIONS.get("quality"):
                out["quality"] = int(max(2, min(100, round(100 - v * 3.1))))
        elif enc_cls.OPTIONS.get(k):
            out[k] = v
        else:
            raise Unsupported(f"encoder {enc_cls.INFO.name}: unknown "
                              f"option {k!r}")
    return out


class _StreamChain:
    """decode -> filter -> encode for the video stream, or a stream copy
    (packets straight from the demuxer to the muxer)."""

    media = "video"

    def __init__(self, in_stream, smap: StreamMap, out_mux, device,
                 shared_opts: dict):
        par = in_stream.codecpar
        self.smap = smap
        self.frames_done = 0
        self.discard_until = 0.0     # -ss: decode and drop before this
        self.eof = False
        self.copy = smap.codec == "copy"
        self._pipelined = False
        self._perr: Exception | None = None
        if self.copy:
            self.out_stream = out_mux.add_stream(par, in_stream.time_base)
            return
        self.decoder = find_decoder(par.codec_id)(par, device=device)
        props = StreamProps(
            media="video", width=par.width, height=par.height,
            pix_fmt=par.pix_fmt or "yuv420p",
            frame_rate=par.framerate if par.framerate.num else
            Rational(25, 1),
            time_base=in_stream.time_base)
        desc = smap.filters or "null"
        if smap.width or smap.height:
            desc += f",scale={smap.width or -1}:{smap.height or -1}"
        if smap.pix_fmt:
            desc += f",format={smap.pix_fmt}"
        self.graph = GraphRunner(desc, props)
        out = self.graph.output_props
        enc_cls = find_encoder(smap.codec)
        if enc_cls.INFO.codec_type != "video":
            raise Unsupported(f"-c:v {smap.codec} is not a video encoder")
        self.encoder = enc_cls(
            width=out.width, height=out.height, pix_fmt=out.pix_fmt,
            device=device, **{**_declared(enc_cls, shared_opts),
                              **_translate_codec_opts(enc_cls,
                                                      smap.codec_opts)})
        self.out_stream = out_mux.add_stream(
            self.encoder.codec_parameters(), out.time_base or Rational(1, 25))
        # pipelined encode: the worker fetches and packs frame i while
        # the main thread decodes frame i + 1; the B-frame scheduler and
        # an encoder without the dispatch/finish split encode
        # synchronously
        self._pipelined = hasattr(self.encoder, "encode_async") and \
            not self.encoder.opts.get("max_b_frames", 0)
        if self._pipelined:
            self._pq: Any = queue.Queue(maxsize=4)
            self._pworker = threading.Thread(target=self._drain_encodes,
                                             daemon=True)
            self._pworker.start()

    def drain(self, mux) -> None:
        """Push the frames the decoder holds for packets already sent
        (its decode-ahead queue) through the graph and the encoder,
        keeping the stream open."""
        if not self.copy and not self.eof and \
                hasattr(self.decoder, "drain"):
            for frame in self.decoder.drain():
                self._through_graph(frame, mux)

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
                    self._write(self.encoder.encode_finish(handle), mux)
            except Exception as e:      # raised on the next call
                self._perr = e
            finally:
                self._pq.task_done()

    def sync(self) -> None:
        """Block until every dispatched frame is packed and muxed."""
        if self._pipelined:
            self._pq.join()
        self._perr_check()

    def _join_encodes(self) -> None:
        if self._pipelined and self._pworker.is_alive():
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
        if self.copy:
            self._write([pkt], mux)
            return
        with stage("video.decode"):
            frames = self.decoder.decode(pkt)
        for frame in frames:
            self._through_graph(frame, mux)

    def _through_graph(self, frame, mux, flush=False) -> None:
        if frame is not None and _discard(frame, self.discard_until,
                                          "video"):
            return
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
            if self._pipelined:
                with stage("video.enc_dispatch"):
                    h = self.encoder.encode_async(f)
                self._pq.put((h, mux))
            else:
                with stage("video.enc"):
                    self._write(self.encoder.encode(f), mux)

    def _write(self, pkts, mux) -> None:
        for pkt in pkts:
            mux.write(pkt.replace(stream_index=self.out_stream.index))

    def finish(self, mux) -> None:
        if self.copy:
            return
        if not self.eof:
            for frame in self.decoder.flush():
                self._through_graph(frame, mux)
            self._through_graph(None, mux, flush=True)
        self._join_encodes()
        if hasattr(self.decoder, "close"):
            self.decoder.close()
        # the trailing anchor group of a B-frame stream
        with stage("video.enc"):
            self._write(self.encoder.flush(), mux)


def _integer_sample_fmt(codec: str) -> str | None:
    """The planar integer sample format the audio encoder `codec`
    quantises its input to, or None for an encoder that takes floats
    (pcm_s24le is refused: its samples would need s32 with 24 bits)."""
    from librempeg_tpu_torch.codecs.pcm import _SAMPLE_FMT

    fmt = _SAMPLE_FMT.get(codec) if codec != "pcm_s24le" else None
    if codec in ("flac", "adpcm_ima_wav", "adpcm_ms"):
        fmt = "s16"
    return fmt + "p" if fmt in ("u8", "s16", "s32") else None


class _AudioChain:
    """decode -> filter -> encode for one audio stream, synchronous, or
    a stream copy (-c:a copy: the demuxer's packets to the muxer)."""

    media = "audio"

    def __init__(self, in_stream, smap: StreamMap, out_mux, device,
                 shared_opts: dict):
        par = in_stream.codecpar
        self.smap = smap
        self.frames_done = 0
        self.discard_until = 0.0     # -ss: decode and drop before this
        self.eof = False
        self.copy = smap.codec == "copy"
        nch = par.nb_channels or 2
        if par.nb_channels and not (par.ch_layout and par.ch_layout.mask):
            # a count in no known order takes the default layout of the
            # count (ffmpeg_opt.c guess_input_channel_layout), also for
            # a stream copy
            par.ch_layout = ChannelLayout.default(nch)
        if self.copy:
            self.out_stream = out_mux.add_stream(par, in_stream.time_base)
            return
        dec_cls = find_decoder(par.codec_id)
        if dec_cls.INFO.codec_type != "audio":
            raise Unsupported(f"{par.codec_id} is not an audio decoder")
        self.decoder = dec_cls(par, device=device)
        # the decoder's own sample format (the JAX package says s16p for
        # every codec, which scales an AAC decoder's floats by 2^-15)
        self._props = StreamProps(
            media="audio", sample_rate=par.sample_rate,
            sample_fmt=self.decoder.sample_fmt,
            layout=par.ch_layout or ChannelLayout.default(nch),
            time_base=in_stream.time_base)
        desc = smap.filters or "anull"
        if smap.channels and smap.channels != nch:
            # -ac: the JAX package parses it and never applies it
            desc += (",aformat=channel_layouts="
                     f"{ChannelLayout.default(smap.channels).name}")
        if smap.sample_rate:
            desc += f",aresample={smap.sample_rate}"
        self._make_graph = lambda props: GraphRunner(
            desc, props, sample_fmt=_integer_sample_fmt(smap.codec))
        self.graph = self._make_graph(self._props)
        enc_cls = find_encoder(smap.codec)
        if enc_cls.INFO.codec_type != "audio":
            raise Unsupported(f"-c:a {smap.codec} is not an audio encoder")
        self._make_encoder = lambda rate, ch: enc_cls(
            sample_rate=rate, channels=ch, device=device,
            **{**_declared(enc_cls, shared_opts), **smap.codec_opts})
        out = self.graph.output_props
        self.encoder = self._make_encoder(
            out.sample_rate, out.layout.nb_channels if out.layout else 2)
        self.out_stream = out_mux.add_stream(
            self._codec_parameters(), Rational(1, out.sample_rate))
        self._in_rate = par.sample_rate
        self._format_locked = False

    def _codec_parameters(self):
        """The encoder's parameters with the graph's output layout (the
        encoder's ch_layout, as ffmpeg sets it from the buffersink)."""
        par = self.encoder.codec_parameters()
        par.ch_layout = self.graph.output_props.layout
        return par

    def send_packet(self, pkt, mux) -> None:
        if self.eof:
            return
        if self.copy:
            self._write([pkt], mux)
            return
        with stage("audio.decode"):
            frames = self.decoder.decode(pkt)
        for frame in frames:
            self._through_graph(frame, mux)

    def _lock_format(self, frame, mux) -> None:
        """Late format discovery (the ffmpeg.c decoder-reconfig path),
        while nothing is written. ffmpeg configures its filter graph
        from the first decoded frame, so a decoder that reports a layout
        other than the stream's, of the same channel count (an AC-3
        track of a Matroska file, whose container gives only the count),
        retunes the graph. HE-AAC doubles the rate only once SBR is seen
        in-band, so the first decoded frame's rate retunes the chain
        where no -ar is set and the graph passes the rate through. (The
        JAX package compares the frame's rate with the graph's output,
        so -af aresample=R without -ar writes R-rate samples under the
        input's rate.)"""
        self._format_locked = True
        if mux.header_written:
            return
        lay = frame.layout
        if lay and lay.mask and lay != self._props.layout \
                and lay.nb_channels == self._props.layout.nb_channels:
            self._props = self._props.copy()
            self._props.layout = lay
            self.graph = self._make_graph(self._props)
            self.out_stream.codecpar = self._codec_parameters()
        out = self.graph.output_props
        rate = frame.sample_rate
        if (rate and rate != self._in_rate and out.sample_rate == self._in_rate
                and not self.smap.sample_rate):
            out.sample_rate = rate
            self.encoder = self._make_encoder(rate, self.encoder.channels)
            self.out_stream.codecpar = self._codec_parameters()
            self.out_stream.time_base = Rational(1, rate)

    def _through_graph(self, frame, mux, flush=False) -> None:
        if frame is not None and not self._format_locked:
            self._lock_format(frame, mux)
        if frame is not None and _discard(frame, self.discard_until,
                                          "audio"):
            return
        with stage("audio.graph"):
            outs = self.graph.push(frame) if frame is not None else []
            if flush:
                outs += self.graph.finish()
        for f in outs:
            if self.smap.frames_limit and \
                    self.frames_done >= self.smap.frames_limit:
                self.eof = True
                return
            self.frames_done += 1
            with stage("audio.enc"):
                self._write(self.encoder.encode(f), mux)

    def _write(self, pkts, mux) -> None:
        for pkt in pkts:
            mux.write(pkt.replace(stream_index=self.out_stream.index))

    def drain(self, mux) -> None:
        """Write the packets the encoder holds back (FLAC's newest,
        kept for the final STREAMINFO), keeping the stream open."""
        if not self.copy and hasattr(self.encoder, "release"):
            self._write(self.encoder.release(), mux)

    def finish(self, mux) -> None:
        if self.copy:
            return
        if not self.eof:
            for frame in self.decoder.flush():
                self._through_graph(frame, mux)
            self._through_graph(None, mux, flush=True)
        # flushed after -frames:a too (the JAX package drops the tail)
        self._write(self.encoder.flush(), mux)


def _map_matches(maps, st, media_index: int) -> bool:
    """-map selector subset: '0', '0:v', '0:a', '0:s', '0:N', '0:v:N'
    (one input; the leading file index must be 0)."""
    media_char = {"video": "v", "audio": "a", "subtitle": "s"}.get(
        st.codecpar.codec_type, "d")
    for m in maps:
        parts = str(m).split(":")
        if parts[0] != "0":
            continue
        if len(parts) == 1:
            return True
        if parts[1].isdigit():
            if int(parts[1]) == st.index:
                return True
        elif parts[1] == media_char:
            if len(parts) == 2 or (parts[2].isdigit()
                                   and int(parts[2]) == media_index):
                return True
    return False


class _SubtitleChain:
    """Text subtitle recode: decode cues (subrip/ass) and re-encode them
    as SubRip payloads for the output muxer (the srt extraction path),
    on the host, as the JAX package's _SubtitleChain does."""

    media = "subtitle"
    copy = False

    def __init__(self, in_stream, out_mux, device):
        self.in_stream = in_stream
        self.discard_until = 0.0
        self.frames_done = 0
        self.eof = False
        self.decoder = find_decoder(in_stream.codecpar.codec_id)(
            in_stream.codecpar, device=device)
        self.encoder = find_encoder("subrip")()
        self.out_stream = out_mux.add_stream(
            self.encoder.codec_parameters(), Rational(1, 1000))

    def send_packet(self, pkt, mux) -> None:
        for cue in self.decoder.decode(pkt):
            if not cue.text:
                continue
            t = cue.pts * cue.time_base.num / cue.time_base.den \
                if cue.pts != NOPTS and cue.time_base.valid else 0.0
            if t < self.discard_until:
                continue
            for out in self.encoder.encode(cue):
                mux.write(out.replace(stream_index=self.out_stream.index))
            self.frames_done += 1

    def finish(self, mux) -> None:
        pass


class Transcoder:
    """Single input -> single output transcoder: one chain per video
    and audio stream the output format takes (-vn, -an drop them)."""

    def __init__(self, spec: TranscodeSpec):
        self.spec = spec
        device = resolve(spec.device)
        # -mesh: distinct devices of the run's type (raises when the
        # machine has fewer); active for this run only (run())
        self.mesh = PM.make_mesh(spec.mesh, device=device) \
            if spec.mesh else None
        self.demux = open_input(spec.input_url, spec.input_format,
                                **spec.input_opts)
        self.mux = open_output(spec.output_url, spec.output_format)
        self.mux.metadata.update(spec.metadata)
        self.chains: dict[int, Any] = {}
        media_counts: dict = {}
        for st in self.demux.streams:
            media = st.codecpar.codec_type
            midx = media_counts.get(media, 0)
            media_counts[media] = midx + 1
            if spec.maps and not _map_matches(spec.maps, st, midx):
                continue
            if media not in type(self.mux).SUPPORTED_TYPES:
                continue
            if media == "video" and not spec.no_video:
                smap = spec.video or StreamMap()
                if not smap.codec:
                    smap.codec = _default_video_codec(
                        type(self.mux).NAME, spec.output_url)
                self.chains[st.index] = _StreamChain(
                    st, smap, self.mux, device, spec.codec_opts)
            elif media == "audio" and not spec.no_audio:
                smap = spec.audio or StreamMap(codec="pcm_s16le")
                self.chains[st.index] = _AudioChain(
                    st, smap, self.mux, device, spec.codec_opts)
            elif media == "subtitle":
                self.chains[st.index] = _SubtitleChain(st, self.mux, device)
        if not self.chains:
            raise InvalidData("no streams selected for transcoding")
        unused = sorted(k for k in spec.codec_opts if not any(
            c.encoder.OPTIONS.get(k) for c in self.chains.values()
            if hasattr(c, "encoder")))
        if unused:
            raise Unsupported(f"codec option(s) {', '.join(unused)} not "
                              "declared by any encoder of this run")

    def _start(self) -> float:
        """The input's earliest start time in seconds (an MPEG-TS from
        elsewhere may start at a nonzero pts; ffmpeg_opts.c seek math)."""
        start = 0.0
        for st in self.demux.streams:
            if st.start_time != NOPTS and st.time_base.valid \
                    and st.time_base.num:
                t0 = st.start_time * st.time_base.num / st.time_base.den
                start = t0 if start == 0.0 else min(start, t0)
        return start

    def _seek(self, start: float) -> None:
        """-ss: the container seek on the first seekable stream (video
        first, for keyframe snapping), relative to the input's start;
        the chains then decode and drop up to the exact time (the JAX
        package's Transcoder.run, fftools/ffmpeg_demux.c + ffmpeg_dec.c
        roles)."""
        for st in sorted(self.demux.streams,
                         key=lambda s: s.codecpar.codec_type != "video"):
            try:
                self.demux.read_seek(st.index, int(
                    (start + self.spec.seek) * st.time_base.den
                    / st.time_base.num))
                break
            except NotImplementedError:
                continue          # without a seek, read from the start
        for chain in self.chains.values():
            chain.discard_until = start + self.spec.seek

    def _past_end(self, pkt, end: float) -> bool:
        """-t: a packet at or past `end` seconds on its own clock (end
        counts from the input's start; the JAX package counts from 0)."""
        return pkt.pts != NOPTS and pkt.time_base.valid and \
            bool(pkt.time_base.num) and \
            pkt.pts * pkt.time_base.num / pkt.time_base.den >= end

    def run(self, progress=None, progress_interval: float = 0.5) -> dict:
        """progress: an optional callback(stats dict) fired at most every
        progress_interval seconds from the packet loop and once at the
        end (the -progress feed's source, ffmpeg.c:344).

        A mesh from spec.mesh is the active mesh for this run only: the
        one active before is restored when the run ends or raises (the
        JAX package's Transcoder sets it and never resets it)."""
        if self.mesh is None:
            return self._run(progress, progress_interval)
        before = PM.active_mesh()
        PM.set_active_mesh(self.mesh)
        try:
            return self._run(progress, progress_interval)
        finally:
            PM.set_active_mesh(before)

    def _run(self, progress, progress_interval: float) -> dict:
        spec = self.spec
        start = self._start() if spec.seek or spec.duration else 0.0
        if spec.seek:
            self._seek(start)
        end = start + spec.seek + spec.duration if spec.duration else 0.0
        n_packets = 0
        cut = set()                   # chains stopped by -t, flushed below
        t0 = time.perf_counter()
        next_prog = t0 + progress_interval
        for pkt in self.demux.packets():
            if progress is not None and time.perf_counter() >= next_prog:
                next_prog = time.perf_counter() + progress_interval
                progress(self._progress_stats(n_packets, t0, False))
            chain = self.chains.get(pkt.stream_index)
            if chain is None:
                continue
            if end and self._past_end(pkt, end):
                chain.eof = True
                cut.add(pkt.stream_index)
                if all(c.eof for c in self.chains.values()):
                    break
                continue
            chain.send_packet(pkt, self.mux)
            n_packets += 1
            if all(c.eof for c in self.chains.values()):
                break
        for i, chain in self.chains.items():
            if i in cut:
                chain.eof = False
            chain.finish(self.mux)
        self.mux.close()
        self.demux.close()
        if progress is not None:
            progress(self._progress_stats(n_packets, t0, True))
        return {"packets": n_packets,
                "frames": {i: c.frames_done
                           for i, c in self.chains.items()}}

    def _progress_stats(self, n_packets: int, t0: float,
                        done: bool) -> dict:
        """Snapshot for the -progress feed (print_report's fields), as
        the JAX package computes it: the first encoded video stream's
        frames at its graph's rate, else the first encoded audio
        stream's frames of frame_size samples."""
        dt = max(time.perf_counter() - t0, 1e-6)
        vframes = 0
        out_time = 0.0
        for c in self.chains.values():
            if c.media == "video" and not c.copy:
                vframes = c.frames_done
                fr = c.graph.output_props.frame_rate
                fps = (fr.num / fr.den) if fr and fr.num else 25.0
                out_time = c.frames_done / fps
                break
        else:
            for c in self.chains.values():
                if c.media == "audio" and not c.copy:
                    enc = c.encoder
                    rate = getattr(enc, "sample_rate", 0) or 48000
                    fsz = getattr(enc, "frame_size", 0) or 1024
                    out_time = c.frames_done * fsz / rate
                    break
        return {"frame": vframes, "fps": vframes / dt,
                "packets": n_packets, "out_time_s": out_time,
                "speed": out_time / dt, "done": done}
