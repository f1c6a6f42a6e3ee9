"""Matroska/WebM demuxer.

Analog of libavformat/matroskadec.c (EBML parse, Tracks,
Clusters with SimpleBlock/BlockGroup, all three lacing modes) and
matroskaenc.c; an audio packet's end trim travels as the block's
DiscardPadding both ways (the JAX package drops it).

A copy of librempeg_tpu/formats/matroska.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

import struct

from librempeg_tpu_torch.core.errors import (
    EndOfStream,
    InvalidData,
    NotFound,
    Unsupported,
)
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import NOPTS, Rational, rescale_q
from librempeg_tpu_torch.core.sidedata import (
    SkipSamples,
    get_side_data,
    set_side_data,
)
from librempeg_tpu_torch.formats.api import (
    PROBE_SCORE_MAX,
    CodecParameters,
    Demuxer,
    Muxer,
    Stream,
    register_demuxer,
    register_muxer,
)

# EBML element IDs (core subset)
_EBML_HEADER = 0x1A45DFA3
_SEGMENT = 0x18538067
_INFO = 0x1549A966
_TIMESTAMP_SCALE = 0x2AD7B1
_TRACKS = 0x1654AE6B
_TRACK_ENTRY = 0xAE
_TRACK_NUMBER = 0xD7
_TRACK_TYPE = 0x83
_CODEC_ID = 0x86
_CODEC_PRIVATE = 0x63A2
_DEFAULT_DURATION = 0x23E383
_VIDEO = 0xE0
_PIXEL_WIDTH = 0xB0
_PIXEL_HEIGHT = 0xBA
_AUDIO = 0xE1
_SAMPLING_FREQ = 0xB5
_CHANNELS = 0x9F
_BIT_DEPTH = 0x6264
_CLUSTER = 0x1F43B675
_CLUSTER_TS = 0xE7
_SIMPLE_BLOCK = 0xA3
_BLOCK_GROUP = 0xA0
_BLOCK = 0xA1
_BLOCK_DURATION = 0x9B
_DISCARD_PADDING = 0x75A2        # signed, ns (the end trim of a block)

_CODEC_IDS = {
    "V_MPEG4/ISO/ASP": "mpeg4",
    "V_MPEG4/ISO/SP": "mpeg4",
    "V_MPEG4/ISO/AVC": "h264",
    "V_MPEGH/ISO/HEVC": "hevc",
    "V_MPEG1": "mpeg1video",
    "V_MPEG2": "mpeg2video",
    "V_MJPEG": "mjpeg",
    "V_UNCOMPRESSED": "rawvideo",
    "A_AAC": "aac",
    "A_FLAC": "flac",
    "A_PCM/INT/LIT": "pcm_s16le",
    "A_PCM/FLOAT/IEEE": "pcm_f32le",
    "A_MPEG/L3": "mp3",
    "A_MPEG/L2": "mp2",
    "A_MPEG/L1": "mp1",
    "A_AC3": "ac3",
    "A_EAC3": "eac3",
    "A_VORBIS": "vorbis",
    "A_OPUS": "opus",
    "S_TEXT/UTF8": "subrip",
    "S_TEXT/ASS": "ass",
    "S_TEXT/SSA": "ass",
}


def _read_vint(data: bytes, pos: int, keep_marker: bool) -> tuple[int, int]:
    """EBML variable-length integer at pos -> (value, new_pos)."""
    if pos >= len(data):
        raise EndOfStream
    b0 = data[pos]
    if b0 == 0:
        raise InvalidData("mkv: invalid vint")
    length = 1
    mask = 0x80
    while not (b0 & mask):
        length += 1
        mask >>= 1
    v = b0 if keep_marker else (b0 & (mask - 1))
    for i in range(1, length):
        v = (v << 8) | data[pos + i]
    return v, pos + length


class _Element:
    __slots__ = ("eid", "start", "end")


def _iter_elements(data: bytes, pos: int, end: int):
    while pos < end:
        eid, pos = _read_vint(data, pos, keep_marker=True)
        size, pos = _read_vint(data, pos, keep_marker=False)
        yield eid, pos, min(pos + size, end)
        pos += size


def _uint(data: bytes) -> int:
    v = 0
    for b in data:
        v = (v << 8) | b
    return v


def _float(data: bytes) -> float:
    if len(data) == 4:
        return struct.unpack(">f", data)[0]
    if len(data) == 8:
        return struct.unpack(">d", data)[0]
    return 0.0


@register_demuxer
class MatroskaDemuxer(Demuxer):
    NAME = "matroska"
    LONG_NAME = "Matroska / WebM"
    EXTENSIONS = ("mkv", "webm", "mka")

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        return PROBE_SCORE_MAX if buf.startswith(b"\x1aE\xdf\xa3") else 0

    def read_header(self, io):
        data = io.read(1 << 30)  # whole file (seekable stream model)
        self._data = data
        self.timescale = 1_000_000  # ns per tick
        self._track_map: dict[int, int] = {}
        pos = 0
        segment_range = None
        for eid, s, e in _iter_elements(data, 0, len(data)):
            if eid == _SEGMENT:
                segment_range = (s, e)
                break
        if segment_range is None:
            raise InvalidData("mkv: no Segment")
        self._blocks: list[tuple[int, int, int, bytes]] = []
        for eid, s, e in _iter_elements(data, *segment_range):
            if eid == _INFO:
                for eid2, s2, e2 in _iter_elements(data, s, e):
                    if eid2 == _TIMESTAMP_SCALE:
                        self.timescale = _uint(data[s2:e2])
                    elif eid2 == _TITLE:
                        self.metadata["title"] = data[s2:e2].decode(
                            "utf-8", "replace")
            elif eid == _TRACKS:
                self._parse_tracks(data, s, e)
            elif eid == _CLUSTER:
                self._parse_cluster(data, s, e)
        self._cursor = 0

    def _parse_tracks(self, data, s, e):
        for eid, ts, te in _iter_elements(data, s, e):
            if eid != _TRACK_ENTRY:
                continue
            num = 0
            ttype = 0
            codec = ""
            private = b""
            w = h = 0
            rate = 0
            channels = 0
            codec_delay_ns = 0
            for eid2, s2, e2 in _iter_elements(data, ts, te):
                if eid2 == _TRACK_NUMBER:
                    num = _uint(data[s2:e2])
                elif eid2 == 0x56AA:            # CodecDelay (ns)
                    codec_delay_ns = _uint(data[s2:e2])
                elif eid2 == _TRACK_TYPE:
                    ttype = _uint(data[s2:e2])
                elif eid2 == _CODEC_ID:
                    codec = data[s2:e2].decode("ascii", "replace")
                elif eid2 == _CODEC_PRIVATE:
                    private = data[s2:e2]
                elif eid2 == _VIDEO:
                    for eid3, s3, e3 in _iter_elements(data, s2, e2):
                        if eid3 == _PIXEL_WIDTH:
                            w = _uint(data[s3:e3])
                        elif eid3 == _PIXEL_HEIGHT:
                            h = _uint(data[s3:e3])
                elif eid2 == _AUDIO:
                    for eid3, s3, e3 in _iter_elements(data, s2, e2):
                        if eid3 == _SAMPLING_FREQ:
                            rate = int(_float(data[s3:e3]))
                        elif eid3 == _CHANNELS:
                            channels = _uint(data[s3:e3])
            cid = _CODEC_IDS.get(codec)
            if cid is None:
                continue
            if ttype == 1:
                extradata = bytes(private)
                nal_size = 4
                is_avcc = cid in ("h264", "hevc") \
                    and extradata[:1] == b"\x01"
                if is_avcc:
                    if cid == "h264":
                        from librempeg_tpu_torch.codecs.h264.avcc import (
                            avcc_to_annexb as cfg_to_annexb,
                            nal_length_size,
                        )
                    else:
                        from librempeg_tpu_torch.codecs.hevc.hvcc import (
                            hvcc_to_annexb as cfg_to_annexb,
                            nal_length_size,
                        )

                    nal_size = nal_length_size(extradata)
                    extradata = cfg_to_annexb(extradata)
                par = CodecParameters(codec_type="video", codec_id=cid,
                                      width=w, height=h,
                                      pix_fmt="yuv420p",
                                      extradata=extradata)
                par.extra["nal_length_size"] = nal_size
                par.extra["h264_lp"] = is_avcc   # avcC => blocks are LP
            elif ttype == 2:
                par = CodecParameters(codec_type="audio", codec_id=cid,
                                      sample_rate=rate or 48000,
                                      nb_channels=channels or 2,
                                      extradata=bytes(private))
                if codec_delay_ns:
                    # encoder priming samples to drop at decode start
                    # (mkv CodecDelay; skip_samples side-data role)
                    par.extra["skip_samples"] = round(
                        codec_delay_ns * (rate or 48000) / 1_000_000_000)
                    # block timestamps include the delay: shift them
                    # back like the reference (matroskadec.c subtracts
                    # codec_delay_in_track_tb from block timecodes)
                    par.extra["codec_delay_ticks"] = round(
                        codec_delay_ns / self.timescale)
            elif ttype == 0x11:
                par = CodecParameters(codec_type="subtitle",
                                      codec_id=cid,
                                      extradata=bytes(private))
            else:
                continue
            st = Stream(index=len(self.streams), codecpar=par,
                        time_base=Rational(self.timescale, 1_000_000_000))
            self._track_map[num] = st.index
            self.streams.append(st)

    def _parse_cluster(self, data, s, e):
        cluster_ts = 0
        for eid, s2, e2 in _iter_elements(data, s, e):
            if eid == _CLUSTER_TS:
                cluster_ts = _uint(data[s2:e2])
            elif eid == _SIMPLE_BLOCK:
                self._parse_block(data, s2, e2, cluster_ts, key_known=True)
            elif eid == _BLOCK_GROUP:
                # BlockDuration (subtitle cue length) may follow the
                # Block: collect it first, then parse
                dur = discard = 0
                spans = []
                for eid3, s3, e3 in _iter_elements(data, s2, e2):
                    if eid3 == _BLOCK:
                        spans.append((s3, e3))
                    elif eid3 == _BLOCK_DURATION:
                        dur = _uint(data[s3:e3])
                    elif eid3 == _DISCARD_PADDING:
                        discard = int.from_bytes(data[s3:e3], "big",
                                                 signed=True)
                for s3, e3 in spans:
                    self._parse_block(data, s3, e3, cluster_ts,
                                      key_known=False, duration=dur,
                                      discard=discard)

    def _parse_block(self, data, s, e, cluster_ts, key_known,
                     duration=0, discard=0):
        track, pos = _read_vint(data, s, keep_marker=False)
        rel_ts = struct.unpack(">h", data[pos:pos + 2])[0]
        flags = data[pos + 2]
        pos += 3
        lacing = (flags >> 1) & 3
        key = bool(flags & 0x80) if key_known else True
        frames: list[bytes] = []
        if lacing == 0:
            frames = [data[pos:e]]
        else:
            nframes = data[pos] + 1
            pos += 1
            sizes = []
            if lacing == 2:      # fixed
                total = e - pos
                sizes = [total // nframes] * nframes
            elif lacing == 1:    # Xiph
                for _ in range(nframes - 1):
                    sz = 0
                    while True:
                        b = data[pos]
                        pos += 1
                        sz += b
                        if b != 255:
                            break
                    sizes.append(sz)
                sizes.append(e - pos - sum(sizes))
            else:                # EBML lacing
                first, pos = _read_vint(data, pos, keep_marker=False)
                sizes = [first]
                for _ in range(nframes - 2):
                    dv, pos = _read_vint(data, pos, keep_marker=False)
                    nbits = dv.bit_length()
                    # signed delta: subtract range midpoint
                    length = (nbits + 6) // 7
                    dv -= (1 << (7 * length - 1)) - 1
                    sizes.append(sizes[-1] + dv)
                sizes.append(e - pos - sum(sizes))
            for sz in sizes:
                frames.append(data[pos:pos + sz])
                pos += sz
        ts = cluster_ts + rel_ts
        for i, f in enumerate(frames):
            self._blocks.append((ts + i, track, 1 if key else 0, f,
                                 duration, discard))

    def read_seek(self, stream_index: int, ts: int) -> None:
        """Seek to the latest keyframe of `stream_index` at or before
        `ts` (ticks); binary search over the block index, then walk
        back to a keyframe (avformat_seek_file backward semantics)."""
        import bisect

        track = None
        for tnum, sidx in self._track_map.items():
            if sidx == stream_index:
                track = tnum
        if track is None:
            raise NotFound("mkv: no such stream")
        times = [b[0] for b in self._blocks]
        i = bisect.bisect_right(times, ts) - 1
        while i > 0 and not (self._blocks[i][1] == track
                             and self._blocks[i][2]):
            i -= 1
        self._cursor = max(i, 0)

    def read_packet(self) -> Packet:
        if self._cursor >= len(self._blocks):
            raise EndOfStream
        ts, track, key, payload, dur, discard = self._blocks[self._cursor]
        self._cursor += 1
        sidx = self._track_map.get(track)
        if sidx is None:
            return self.read_packet()
        st = self.streams[sidx]
        if st.codecpar.codec_id in ("h264", "hevc") \
                and st.codecpar.extra.get("h264_lp", False):
            if st.codecpar.codec_id == "h264":
                from librempeg_tpu_torch.codecs.h264.avcc import lp_to_annexb
            else:
                from librempeg_tpu_torch.codecs.hevc.hvcc import lp_to_annexb

            payload = lp_to_annexb(
                payload, st.codecpar.extra.get("nal_length_size", 4),
                force=True)
        delay = st.codecpar.extra.get("codec_delay_ticks", 0)
        if delay:
            ts -= delay
        pkt = Packet(data=payload, pts=ts, dts=ts, duration=dur,
                     stream_index=sidx, flags=PktFlags.KEY if key else 0,
                     time_base=st.time_base)
        if discard > 0 and st.codecpar.sample_rate:
            # matroskadec.c: DiscardPadding becomes the packet's end trim
            set_side_data(pkt, SkipSamples(end=rescale_q(
                discard, Rational(1, 1_000_000_000),
                Rational(1, st.codecpar.sample_rate))))
        return pkt


# ---------------------------------------------------------------------------
# Muxer
# ---------------------------------------------------------------------------

def _enc_id(eid: int) -> bytes:
    """EBML IDs are stored verbatim (marker included)."""
    return eid.to_bytes((eid.bit_length() + 7) // 8, "big")


def _enc_size(n: int) -> bytes:
    """EBML size vint: shortest length whose all-ones value isn't n."""
    for length in range(1, 9):
        if n < (1 << (7 * length)) - 1:
            return ((1 << (7 * length)) | n).to_bytes(length, "big")
    raise InvalidData("mkv: size too large")


def _enc_uint(v: int) -> bytes:
    return v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big")


def _el(eid: int, payload: bytes) -> bytes:
    return _enc_id(eid) + _enc_size(len(payload)) + payload


def _el_uint(eid: int, v: int) -> bytes:
    return _el(eid, _enc_uint(v))


def _el_float(eid: int, v: float) -> bytes:
    return _el(eid, struct.pack(">d", v))


_DOCTYPE = 0x4282
_DOCTYPE_VERSION = 0x4287
_DOCTYPE_READ_VERSION = 0x4285
_EBML_VERSION = 0x4286
_EBML_READ_VERSION = 0x42F7
_EBML_MAX_ID_LENGTH = 0x42F2
_EBML_MAX_SIZE_LENGTH = 0x42F3
_TITLE = 0x7BA9
_MUXING_APP = 0x4D80
_WRITING_APP = 0x5741
_DURATION = 0x4489
_TRACK_UID = 0x73C5
_FLAG_LACING = 0x9C

_CODEC_IDS_MUX = {v: k for k, v in _CODEC_IDS.items()}
_CODEC_IDS_MUX["mpeg4"] = "V_MPEG4/ISO/SP"


@register_muxer
class MatroskaMuxer(Muxer):
    """Matroska muxer (libavformat/matroskaenc.c analog).

    EBML header is written eagerly; Segment children (Info, Tracks,
    Clusters of SimpleBlocks) are buffered so the Segment and total
    Duration can be emitted with exact sizes in the trailer."""

    NAME = "matroska"
    LONG_NAME = "Matroska / WebM"
    EXTENSIONS = ("mkv", "mka", "webm")

    def write_header(self):
        super().write_header()
        self.io.write(_el(_EBML_HEADER, b"".join([
            _el_uint(_EBML_VERSION, 1),
            _el_uint(_EBML_READ_VERSION, 1),
            _el_uint(_EBML_MAX_ID_LENGTH, 4),
            _el_uint(_EBML_MAX_SIZE_LENGTH, 8),
            _el(_DOCTYPE, b"matroska"),
            _el_uint(_DOCTYPE_VERSION, 2),
            _el_uint(_DOCTYPE_READ_VERSION, 2),
        ])))
        self._timescale = 1_000_000          # 1 ms ticks
        self._clusters: list[bytes] = []
        self._cluster = bytearray()
        self._cluster_ts = 0
        self._max_ts = 0

    def _track_entry(self, st) -> bytes:
        par = st.codecpar
        mkv_id = _CODEC_IDS_MUX.get(par.codec_id)
        if mkv_id is None:
            raise Unsupported(f"mkv: codec {par.codec_id}")
        out = [
            _el_uint(_TRACK_NUMBER, st.index + 1),
            _el_uint(_TRACK_UID, st.index + 1),
            _el_uint(_TRACK_TYPE, 1 if par.codec_type == "video" else 2),
            _el_uint(_FLAG_LACING, 0),
            _el(_CODEC_ID, mkv_id.encode("ascii")),
        ]
        if par.extradata:
            private = bytes(par.extradata)
            if par.codec_id == "h264":      # mkv carries avcC, not annex-B
                from librempeg_tpu_torch.codecs.h264.avcc import build_avcc

                private = build_avcc(private)
            elif par.codec_id == "hevc":    # likewise hvcC
                from librempeg_tpu_torch.codecs.hevc.hvcc import build_hvcc

                private = build_hvcc(private)
            out.append(_el(_CODEC_PRIVATE, private))
        if par.codec_type == "video":
            if par.framerate.num > 0:
                out.append(_el_uint(
                    _DEFAULT_DURATION,
                    (1_000_000_000 * par.framerate.den)
                    // par.framerate.num))
            out.append(_el(_VIDEO,
                           _el_uint(_PIXEL_WIDTH, par.width)
                           + _el_uint(_PIXEL_HEIGHT, par.height)))
        else:
            audio = (_el_float(_SAMPLING_FREQ, float(par.sample_rate))
                     + _el_uint(_CHANNELS, par.nb_channels))
            if par.codec_id.startswith("pcm_s16"):
                audio += _el_uint(_BIT_DEPTH, 16)
            elif par.codec_id.startswith("pcm_f32"):
                audio += _el_uint(_BIT_DEPTH, 32)
            out.append(_el(_AUDIO, audio))
        return _el(_TRACK_ENTRY, b"".join(out))

    def _flush_cluster(self):
        if self._cluster:
            self._clusters.append(_el(
                _CLUSTER,
                _el_uint(_CLUSTER_TS, self._cluster_ts)
                + bytes(self._cluster)))
            self._cluster = bytearray()

    def write_packet(self, pkt: Packet):
        st = self.streams[pkt.stream_index]
        tb = pkt.time_base if pkt.time_base.valid and pkt.time_base.num \
            else st.time_base
        pts = pkt.pts if pkt.pts != NOPTS else (pkt.dts or 0)
        ts = (pts * tb.num * 1000) // tb.den        # ms ticks
        key = bool(pkt.flags & PktFlags.KEY)
        rel = ts - self._cluster_ts
        new_cluster = (
            not self._cluster
            or rel > 32000 or rel < -32768
            or (key and st.codecpar.codec_type == "video"))
        if new_cluster:
            self._flush_cluster()
            self._cluster_ts = max(ts, 0)
            rel = ts - self._cluster_ts
        data = bytes(pkt.data)
        if st.codecpar.codec_id == "h264":
            from librempeg_tpu_torch.codecs.h264.avcc import annexb_to_lp

            data = annexb_to_lp(data)
        elif st.codecpar.codec_id == "hevc":
            from librempeg_tpu_torch.codecs.hevc.hvcc import annexb_to_lp

            data = annexb_to_lp(data)
        sd = get_side_data(pkt, SkipSamples)
        if sd is not None and sd.end > 0 and \
                st.codecpar.codec_type == "audio":
            # matroskaenc.c: an end trim makes the block a BlockGroup
            # with its DiscardPadding in ns (a start trim is not kept)
            block = (_enc_size(st.index + 1) + struct.pack(">h", rel)
                     + b"\x00" + data)
            ns = rescale_q(sd.end, Rational(1, st.codecpar.sample_rate),
                           Rational(1, 1_000_000_000))
            self._cluster += _el(_BLOCK_GROUP, _el(_BLOCK, block) + _el(
                _DISCARD_PADDING, ns.to_bytes((ns.bit_length() + 8) // 8,
                                              "big", signed=True)))
        else:
            block = (_enc_size(st.index + 1) + struct.pack(">h", rel)
                     + bytes([0x80 if key else 0]) + data)
            self._cluster += _el(_SIMPLE_BLOCK, block)
        dur = pkt.duration if pkt.duration and pkt.duration != NOPTS else 0
        self._max_ts = max(self._max_ts,
                           ts + (dur * tb.num * 1000) // tb.den)

    def write_trailer(self):
        self._drain(final=True)
        self._flush_cluster()
        title = [_el(_TITLE, self.metadata["title"].encode())] \
            if self.metadata.get("title") else []
        info = _el(_INFO, b"".join([
            _el_uint(_TIMESTAMP_SCALE, self._timescale),
            *title,
            _el(_MUXING_APP, b"librempeg_tpu"),
            _el(_WRITING_APP, b"librempeg_tpu"),
            _el_float(_DURATION, float(self._max_ts)),
        ]))
        tracks = _el(_TRACKS,
                     b"".join(self._track_entry(st) for st in self.streams))
        self.io.write(_el(_SEGMENT,
                          info + tracks + b"".join(self._clusters)))
