"""MP4/MOV container: muxer (+ demuxer for the common ISO-BMFF subset).

Analog of libavformat/movenc.c and mov.c (the ~12k-LoC
demuxer; here the ISO 14496-12 common subset: ftyp/mdat/moov with
stts/stsc/stsz/stco sample tables, esds for MPEG-4/AAC, avcC for H.264).

A copy of librempeg_tpu/formats/mov.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

import struct

from librempeg_tpu_torch.core.errors import EndOfStream, InvalidData, Unsupported
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import NOPTS, Rational
from librempeg_tpu_torch.formats.api import (
    PROBE_SCORE_MAX,
    CodecParameters,
    Demuxer,
    Muxer,
    Stream,
    register_demuxer,
    register_muxer,
)


def _box(tag: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + tag + payload


def _full(tag: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(tag, struct.pack(">B", version)
                + flags.to_bytes(3, "big") + payload)


# -- esds (MPEG-4 elementary stream descriptor) -----------------------------

def _desc(tag: int, payload: bytes) -> bytes:
    # expandable size, single byte is enough for our sizes
    assert len(payload) < 128
    return bytes([tag, len(payload)]) + payload


def _esds(object_type: int, dsi: bytes, is_audio: bool) -> bytes:
    dec_specific = _desc(0x05, dsi) if dsi else b""
    dec_config = _desc(
        0x04,
        bytes([object_type, (0x05 if is_audio else 0x04) << 2 | 1])
        + (0).to_bytes(3, "big")          # buffer size
        + struct.pack(">II", 0, 0)         # max/avg bitrate
        + dec_specific)
    es = _desc(0x03, struct.pack(">HB", 1, 0) + dec_config
               + _desc(0x06, b"\x02"))
    return _full(b"esds", 0, 0, es)


_VIDEO_SAMPLE_ENTRY = {"mpeg4": b"mp4v", "h264": b"avc1",
                       "hevc": b"hvc1", "mjpeg": b"jpeg"}
_OBJECT_TYPE = {"mpeg4": 0x20, "aac": 0x40, "mjpeg": 0x6C}


@register_muxer
class MovMuxer(Muxer):
    NAME = "mp4"
    LONG_NAME = "MP4 (MPEG-4 Part 14)"
    EXTENSIONS = ("mp4", "m4v", "m4a", "mov")

    def write_header(self):
        super().write_header()
        io = self.io
        io.write(_box(b"ftyp", b"isom" + struct.pack(">I", 512)
                      + b"isomiso2mp41"))
        self._mdat_pos = io.tell()
        io.write(struct.pack(">I", 8) + b"mdat")
        self._samples: list[list[tuple[int, int, int, bool, int]]] = [
            [] for _ in self.streams]  # (offset, size, duration, key, pts)

    def write_packet(self, pkt: Packet):
        data = pkt.data
        cid = self.streams[pkt.stream_index].codecpar.codec_id
        if cid == "h264":
            from librempeg_tpu_torch.codecs.h264.avcc import annexb_to_lp

            data = annexb_to_lp(bytes(data))    # ISO samples: 4B lengths
        elif cid == "hevc":
            from librempeg_tpu_torch.codecs.hevc.hvcc import annexb_to_lp

            data = annexb_to_lp(bytes(data))
        off = self.io.tell()
        self.io.write(data)
        dur = pkt.duration or 1
        pts = pkt.pts if pkt.pts != NOPTS else \
            (pkt.dts if pkt.dts != NOPTS else 0)
        self._samples[pkt.stream_index].append(
            (off, len(data), dur, bool(pkt.flags & PktFlags.KEY), pts))

    def write_trailer(self):
        io = self.io
        mdat_end = io.tell()
        traks = b""
        for st in self.streams:
            if self._samples[st.index]:
                traks += self._trak(st, self._samples[st.index])
        total_dur = 0
        for st in self.streams:
            samples = self._samples[st.index]
            if samples:
                d = sum(s[2] for s in samples)
                # convert into movie timescale 1000
                d = d * 1000 * st.time_base.num // st.time_base.den
                total_dur = max(total_dur, d)
        mvhd = _full(b"mvhd", 0, 0, struct.pack(
            ">IIIIII", 0, 0, 1000, total_dur, 0x00010000, 0x01000000 >> 8)
            + b"\x00" * 10
            + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                          0x40000000)
            + struct.pack(">6I", 0, 0, 0, 0, 0, 0)
            + struct.pack(">I", len(self.streams) + 1))
        udta = self._udta()
        moov = _box(b"moov", mvhd + traks + udta)
        io.write(moov)
        if io.seekable:
            end = io.tell()
            io.seek(self._mdat_pos)
            io.wl32(0)  # placeholder; rewrite big-endian below
            io.seek(self._mdat_pos)
            io.write(struct.pack(">I", mdat_end - self._mdat_pos))
            io.seek(end)

    def _trak(self, st: Stream, samples) -> bytes:
        par = st.codecpar
        is_video = par.codec_type == "video"
        timescale = st.time_base.den if st.time_base.num == 1 else 90000
        if st.time_base.num != 1:
            # rescale durations into the chosen timescale
            scale = lambda d: d * timescale * st.time_base.num // st.time_base.den  # noqa: E731
        else:
            scale = lambda d: d  # noqa: E731

        duration = sum(scale(s[2]) for s in samples)

        # stts: run-length (count, duration)
        stts_entries = []
        for _, _, dur, _, _ in samples:
            d = scale(dur)
            if stts_entries and stts_entries[-1][1] == d:
                stts_entries[-1][0] += 1
            else:
                stts_entries.append([1, d])
        stts = _full(b"stts", 0, 0, struct.pack(">I", len(stts_entries))
                     + b"".join(struct.pack(">II", c, d)
                                for c, d in stts_entries))
        # one chunk per sample (simple + valid)
        stsc = _full(b"stsc", 0, 0, struct.pack(">I", 1)
                     + struct.pack(">III", 1, 1, 1))
        stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, len(samples))
                     + b"".join(struct.pack(">I", s[1]) for s in samples))
        stco = _full(b"stco", 0, 0, struct.pack(">I", len(samples))
                     + b"".join(struct.pack(">I", s[0]) for s in samples))
        keys = [i + 1 for i, s in enumerate(samples) if s[3]]
        stss = b""
        if is_video and len(keys) != len(samples):
            stss = _full(b"stss", 0, 0, struct.pack(">I", len(keys))
                         + b"".join(struct.pack(">I", k) for k in keys))

        # ctts: composition offsets (pts - dts) for reordered streams
        # (B frames). The stts timeline starts at 0, so offsets get a
        # uniform reorder delay added to stay non-negative (version 0);
        # an elst entry shifts presentation back by that delay
        # (movenc.c mov_write_edts_tag role).
        ctts = b""
        elst_delay = 0
        cum = 0
        offsets = []
        for _, _, dur, _, pts in samples:
            offsets.append(scale(pts) - cum)
            cum += scale(dur)
        if any(offsets):
            elst_delay = max(0, -min(offsets))
            offsets = [o + elst_delay for o in offsets]
            runs = []
            for o in offsets:
                if runs and runs[-1][1] == o:
                    runs[-1][0] += 1
                else:
                    runs.append([1, o])
            ctts = _full(b"ctts", 0, 0, struct.pack(">I", len(runs))
                         + b"".join(struct.pack(">II", c, o)
                                    for c, o in runs))

        stsd = self._stsd(par)
        stbl = _box(b"stbl",
                    stsd + stts + ctts + stsc + stsz + stco + stss)

        if is_video:
            hdlr_type, hdlr_name = b"vide", b"VideoHandler\x00"
            mhd = _full(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
        else:
            hdlr_type, hdlr_name = b"soun", b"SoundHandler\x00"
            mhd = _full(b"smhd", 0, 0, struct.pack(">HH", 0, 0))
        hdlr = _full(b"hdlr", 0, 0, b"\x00" * 4 + hdlr_type
                     + b"\x00" * 12 + hdlr_name)
        url = _full(b"url ", 0, 1, b"")
        dinf = _box(b"dinf", _full(b"dref", 0, 0,
                                   struct.pack(">I", 1) + url))
        mdhd = _full(b"mdhd", 0, 0, struct.pack(
            ">IIIIHH", 0, 0, timescale, duration, 0x55C4, 0))
        mdia = _box(b"mdia", mdhd + hdlr + _box(b"minf", mhd + dinf + stbl))
        w = par.width << 16 if is_video else 0
        h = par.height << 16 if is_video else 0
        tkhd = _full(b"tkhd", 0, 3, struct.pack(
            ">IIII", 0, 0, st.index + 1, 0)
            + struct.pack(">I", duration * 1000 // timescale)
            + b"\x00" * 8
            + struct.pack(">hhhh", 0, 0, 0 if is_video else 0x100, 0)
            + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                          0x40000000)
            + struct.pack(">II", w, h))
        edts = b""
        if elst_delay:
            elst = _full(b"elst", 0, 0, struct.pack(
                ">I", 1) + struct.pack(
                ">IIhh", duration * 1000 // timescale, elst_delay, 1, 0))
            edts = _box(b"edts", elst)
        return _box(b"trak", tkhd + edts + mdia)

    _ILST_TAGS = {"title": b"\xa9nam", "artist": b"\xa9ART",
                  "album": b"\xa9alb", "comment": b"\xa9cmt",
                  "date": b"\xa9day", "genre": b"\xa9gen",
                  "encoder": b"\xa9too"}

    def _udta(self) -> bytes:
        """iTunes-style metadata: udta/meta/(hdlr mdir)/ilst
        (libavformat/movenc.c mov_write_ilst_tag analog)."""
        items = b""
        for key, val in self.metadata.items():
            tag = self._ILST_TAGS.get(key.lower())
            if tag is None:
                continue
            data = _full(b"data", 0, 1, b"\x00" * 4 + val.encode())
            items += _box(tag, data)
        if not items:
            return b""
        hdlr = _full(b"hdlr", 0, 0,
                     b"\x00" * 4 + b"mdir" + b"appl" + b"\x00" * 9)
        meta = _full(b"meta", 0, 0, hdlr + _box(b"ilst", items))
        return _box(b"udta", meta)

    def _stsd(self, par: CodecParameters) -> bytes:
        if par.codec_type == "video":
            fourcc = _VIDEO_SAMPLE_ENTRY.get(par.codec_id)
            if fourcc is None:
                raise Unsupported(f"mp4: video codec {par.codec_id}")
            extra = b""
            if par.codec_id == "mpeg4":
                extra = _esds(_OBJECT_TYPE["mpeg4"], par.extradata, False)
            elif par.codec_id == "h264" and par.extradata:
                from librempeg_tpu_torch.codecs.h264.avcc import build_avcc

                extra = _box(b"avcC", build_avcc(bytes(par.extradata)))
            elif par.codec_id == "hevc" and par.extradata:
                from librempeg_tpu_torch.codecs.hevc.hvcc import build_hvcc

                extra = _box(b"hvcC", build_hvcc(bytes(par.extradata)))
            entry = _box(fourcc, struct.pack(">IHH", 0, 0, 1)
                         + b"\x00" * 16
                         + struct.pack(">HH", par.width, par.height)
                         + struct.pack(">IIIH", 0x00480000, 0x00480000, 0, 1)
                         + b"\x00" * 32
                         + struct.pack(">HH", 0x18, 0xFFFF)
                         + extra)
        else:
            if par.codec_id == "aac":
                fourcc = b"mp4a"
                # AudioSpecificConfig: AAC-LC(2), rate idx, channels
                from librempeg_tpu_torch.codecs.aac.codec import _rate_index

                ri = _rate_index(par.sample_rate)
                asc = bytes([(2 << 3) | (ri >> 1),
                             ((ri & 1) << 7) | (par.nb_channels << 3)])
                extra = _esds(0x40, asc, True)
            elif par.codec_id in ("pcm_s16le", "pcm_s16be"):
                fourcc = b"sowt" if par.codec_id.endswith("le") else b"twos"
                extra = b""
            else:
                raise Unsupported(f"mp4: audio codec {par.codec_id}")
            entry = _box(fourcc, struct.pack(">IHH", 0, 0, 1)
                         + struct.pack(">HHHHI", 0, 0, par.nb_channels, 16,
                                       0)
                         + struct.pack(">I", par.sample_rate << 16)
                         + extra)
        return _full(b"stsd", 0, 0, struct.pack(">I", 1) + entry)


@register_demuxer
class MovDemuxer(Demuxer):
    NAME = "mov"
    LONG_NAME = "QuickTime / MP4"
    EXTENSIONS = ("mp4", "mov", "m4a", "m4v", "3gp")

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        if len(buf) >= 12 and buf[4:8] in (b"ftyp", b"moov", b"mdat",
                                           b"wide", b"free"):
            return PROBE_SCORE_MAX
        return 0

    def read_header(self, io):
        if not io.seekable:
            raise Unsupported("mov: need seekable input")
        size = io.size
        moov = None
        pos = 0
        while pos + 8 <= size:
            io.seek(pos)
            hdr = io.read_exact(8)
            bsize = struct.unpack(">I", hdr[:4])[0]
            tag = hdr[4:8]
            if bsize == 1:
                bsize = struct.unpack(">Q", io.read_exact(8))[0]
            if bsize == 0:
                bsize = size - pos
            if tag == b"moov":
                moov = io.read_exact(bsize - 8)
                break
            pos += bsize
        if moov is None:
            raise InvalidData("mov: no moov box")
        self._parse_moov(moov)
        self._cursor = [0] * len(self.streams)

    def _boxes(self, data: bytes):
        pos = 0
        while pos + 8 <= len(data):
            bsize = struct.unpack(">I", data[pos:pos + 4])[0]
            tag = data[pos + 4:pos + 8]
            if bsize < 8:
                return
            yield tag, data[pos + 8:pos + bsize]
            pos += bsize

    def _find(self, data: bytes, *path):
        cur = data
        for want in path:
            found = None
            for tag, body in self._boxes(cur):
                if tag == want:
                    found = body
                    break
            if found is None:
                return None
            cur = found
        return cur

    _ILST_KEYS = {b"\xa9nam": "title", b"\xa9ART": "artist",
                  b"\xa9alb": "album", b"\xa9cmt": "comment",
                  b"\xa9day": "date", b"\xa9gen": "genre",
                  b"\xa9too": "encoder"}

    def _parse_moov(self, moov: bytes):
        idx = 0
        for tag, body in self._boxes(moov):
            if tag == b"udta":
                meta = self._find(body, b"meta")
                if meta is not None:
                    ilst = self._find(meta[4:], b"ilst")  # skip fullbox hdr
                    if ilst is not None:
                        for itag, item in self._boxes(ilst):
                            key = self._ILST_KEYS.get(itag)
                            dat = self._find(item, b"data")
                            if key and dat is not None and len(dat) > 8:
                                self.metadata[key] = dat[8:].decode(
                                    "utf-8", "replace")
            if tag != b"trak":
                continue
            mdia = self._find(body, b"mdia")
            if mdia is None:
                continue
            mdhd = self._find(mdia, b"mdhd")
            timescale = struct.unpack(">I", mdhd[12:16])[0]
            hdlr = self._find(mdia, b"hdlr")
            htype = hdlr[8:12]
            stbl = self._find(mdia, b"minf", b"stbl")
            if stbl is None:
                continue
            stsd = self._find(stbl, b"stsd")
            # body: version/flags(4) + entry_count(4) + first entry
            entry = stsd[8:]
            fourcc = entry[4:8]
            par = self._codec_from_entry(htype, fourcc, entry)
            if par is None:
                continue
            st = Stream(index=idx, codecpar=par,
                        time_base=Rational(1, timescale))
            st.extra_samples = self._sample_table(stbl)
            st.duration = sum(d for _, _, d in st.extra_samples)
            # ctts composition offsets (B-frame reorder) + elst shift
            ctts = self._find(stbl, b"ctts")
            st.extra_ctts = None
            if ctts is not None:
                n = struct.unpack(">I", ctts[4:8])[0]
                offs = []
                for i in range(n):
                    c, o = struct.unpack(">Ii", ctts[8 + 8 * i:16 + 8 * i])
                    offs.extend([o] * c)
                st.extra_ctts = offs
            st.extra_elst_delay = 0
            edts = self._find(body, b"edts", b"elst")
            if edts is not None and struct.unpack(">I", edts[4:8])[0] >= 1:
                mtime = struct.unpack(">i", edts[12:16])[0]
                if mtime > 0:
                    st.extra_elst_delay = mtime
            stss = self._find(stbl, b"stss")
            if stss is not None:
                n = struct.unpack(">I", stss[4:8])[0]
                st.extra_sync = set(
                    struct.unpack(f">{n}I", stss[8:8 + 4 * n]))
            else:
                st.extra_sync = None        # absent stss = all sync
            self.streams.append(st)
            idx += 1

    def _codec_from_entry(self, htype, fourcc, entry):
        f2c = {b"mp4v": "mpeg4", b"avc1": "h264", b"hvc1": "hevc",
               b"hev1": "hevc", b"jpeg": "mjpeg", b"MJPG": "mjpeg"}
        if htype == b"vide":
            codec = f2c.get(fourcc)
            if codec is None:
                return None
            w, h = struct.unpack(">HH", entry[8 + 24:8 + 28])
            extra = b""
            nal_size = 4
            pos = 86                  # 8B box header + 78B fixed entry
            while pos + 8 <= len(entry):
                sz = struct.unpack(">I", entry[pos:pos + 4])[0]
                if sz < 8 or pos + sz > len(entry):
                    break
                if entry[pos + 4:pos + 8] == b"avcC":
                    from librempeg_tpu_torch.codecs.h264.avcc import (
                        avcc_to_annexb,
                        nal_length_size,
                    )

                    avcc = entry[pos + 8:pos + sz]
                    extra = avcc_to_annexb(avcc)
                    nal_size = nal_length_size(avcc)
                elif entry[pos + 4:pos + 8] == b"hvcC":
                    from librempeg_tpu_torch.codecs.hevc.hvcc import (
                        hvcc_to_annexb,
                        nal_length_size,
                    )

                    hvcc = entry[pos + 8:pos + sz]
                    extra = hvcc_to_annexb(hvcc)
                    nal_size = nal_length_size(hvcc)
                pos += sz
            par = CodecParameters(codec_type="video", codec_id=codec,
                                  width=w, height=h, pix_fmt="yuv420p",
                                  extradata=extra)
            par.extra["nal_length_size"] = nal_size
            return par
        if htype == b"soun":
            if fourcc == b"mp4a":
                channels, bits = struct.unpack(">HH", entry[8 + 8:8 + 12])
                rate = struct.unpack(">I", entry[8 + 16:8 + 20])[0] >> 16
                return CodecParameters(codec_type="audio", codec_id="aac",
                                       sample_rate=rate,
                                       nb_channels=channels)
            if fourcc in (b"sowt", b"twos", b"lpcm"):
                channels, bits = struct.unpack(">HH", entry[8 + 8:8 + 12])
                rate = struct.unpack(">I", entry[8 + 16:8 + 20])[0] >> 16
                return CodecParameters(
                    codec_type="audio",
                    codec_id="pcm_s16le" if fourcc == b"sowt" else "pcm_s16be",
                    sample_rate=rate, nb_channels=channels,
                    block_align=channels * 2)
        return None

    def _sample_table(self, stbl: bytes):
        """[(offset, size, duration)] flattened from stts/stsz/stco/stsc."""
        stsz = self._find(stbl, b"stsz")
        fixed_size = struct.unpack(">I", stsz[4:8])[0]
        count = struct.unpack(">I", stsz[8:12])[0]
        sizes = ([fixed_size] * count if fixed_size else
                 list(struct.unpack(f">{count}I", stsz[12:12 + 4 * count])))
        stco = self._find(stbl, b"stco")
        nchunks = struct.unpack(">I", stco[4:8])[0]
        chunk_offsets = list(struct.unpack(f">{nchunks}I",
                                           stco[8:8 + 4 * nchunks]))
        stsc = self._find(stbl, b"stsc")
        nstsc = struct.unpack(">I", stsc[4:8])[0]
        stsc_entries = [struct.unpack(">III", stsc[8 + 12 * i:20 + 12 * i])
                        for i in range(nstsc)]
        stts = self._find(stbl, b"stts")
        nstts = struct.unpack(">I", stts[4:8])[0]
        durs = []
        for i in range(nstts):
            c, d = struct.unpack(">II", stts[8 + 8 * i:16 + 8 * i])
            durs.extend([d] * c)
        # expand chunks
        out = []
        si = 0
        for ci in range(nchunks):
            spc = 1
            for first, per, _desc in stsc_entries:
                if ci + 1 >= first:
                    spc = per
            off = chunk_offsets[ci]
            for _ in range(spc):
                if si >= len(sizes):
                    break
                out.append((off, sizes[si],
                            durs[si] if si < len(durs) else 1))
                off += sizes[si]
                si += 1
        return out

    def read_seek(self, stream_index: int, ts: int) -> None:
        """Position `stream_index` at the latest sync sample with
        pts <= ts; other streams snap near the same time."""
        st = self.streams[stream_index]

        def seek_one(stream, target):
            acc = 0
            idx = 0
            sync = getattr(stream, "extra_sync", None)
            for i, (_, _, dur) in enumerate(stream.extra_samples):
                if acc > target:
                    break
                if sync is None or (i + 1) in sync:
                    idx = i
                acc += dur
            self._cursor[stream.index] = idx

        seek_one(st, ts)
        t_sec = ts * st.time_base.num / st.time_base.den
        for other in self.streams:
            if other.index != stream_index:
                seek_one(other, int(t_sec * other.time_base.den
                                    / other.time_base.num))

    def read_packet(self) -> Packet:
        # pick stream with smallest next dts
        best = None
        for st in self.streams:
            cur = self._cursor[st.index]
            samples = st.extra_samples
            if cur >= len(samples):
                continue
            t = sum(d for _, _, d in samples[:cur])  # small files only
            key = t * (1.0 / st.time_base.den)
            if best is None or key < best[0]:
                best = (key, st, cur)
        if best is None:
            raise EndOfStream
        _, st, cur = best
        off, size, dur = st.extra_samples[cur]
        self.io.seek(off)
        data = self.io.read_exact(size)
        if st.codecpar.codec_id in ("h264", "hevc"):
            if st.codecpar.codec_id == "h264":
                from librempeg_tpu_torch.codecs.h264.avcc import lp_to_annexb
            else:
                from librempeg_tpu_torch.codecs.hevc.hvcc import lp_to_annexb

            data = lp_to_annexb(                 # ISO samples: always LP
                data, st.codecpar.extra.get("nal_length_size", 4),
                force=True)
        dts = sum(d for _, _, d in st.extra_samples[:cur])
        pts = dts
        if getattr(st, "extra_ctts", None) and cur < len(st.extra_ctts):
            pts = dts + st.extra_ctts[cur] \
                - getattr(st, "extra_elst_delay", 0)
        sync = st.extra_sync is None or (cur + 1) in st.extra_sync
        self._cursor[st.index] += 1
        return Packet(data=data, pts=pts, dts=dts, duration=dur,
                      stream_index=st.index,
                      flags=PktFlags.KEY if sync else 0,
                      time_base=st.time_base)
