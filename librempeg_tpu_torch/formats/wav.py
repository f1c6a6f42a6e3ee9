"""RIFF/WAVE container: format tags, demuxer and muxer.

Port of librempeg_tpu/formats/wav.py (libavformat/wavdec.c + wavenc.c
analog: fmt/data chunk parsing, WAVE_FORMAT_PCM/IEEE_FLOAT/EXTENSIBLE,
packets of about 4096 bytes, LIST/INFO metadata, the ADPCM codecs'
blocks and fmt extension), a host copy. The tag tables also serve the
AVI muxer.

Unlike the JAX package, the PCM fmt chunk follows libavformat 59's
ff_put_wav_header: WAVE_FORMAT_EXTENSIBLE (a 40-byte chunk with the
channel mask and the subformat GUID) for a layout in native order that
is neither mono nor stereo, a rate above 48 kHz, or samples wider than
16 bits, and a `fact` chunk with the sample count after it for float
samples; the demuxer reads the channel mask back into `ch_layout`
(tests/test_torch_channel_layouts.py holds both to libavformat's
files). For the other tags (A-law, mu-law, IMA and MS ADPCM) it
writes WAVEFORMATEX's cbSize, ADPCM's byte rate as the codec's bit rate
over 8, and a `fact` chunk with the packets' sample span, as wavenc.c
does (tests/test_torch_wav_tags.py).
"""
from __future__ import annotations

import struct

from librempeg_tpu_torch.core.errors import EndOfStream, InvalidData
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import NOPTS, Rational, rescale_q
from librempeg_tpu_torch.core.samplefmt import MONO, STEREO, ChannelLayout
from librempeg_tpu_torch.formats.api import (
    PROBE_SCORE_MAX,
    CodecParameters,
    Demuxer,
    Muxer,
    Stream,
    register_demuxer,
    register_muxer,
)
from librempeg_tpu_torch.formats.io import IOContext

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_ALAW = 0x0006
WAVE_FORMAT_MULAW = 0x0007
WAVE_FORMAT_EXTENSIBLE = 0xFFFE
WAVE_FORMAT_ADPCM_MS = 0x0002
WAVE_FORMAT_ADPCM_IMA = 0x0011
WAVE_FORMAT_ADPCM_YAMAHA = 0x0020

_TAG_TO_CODEC = {
    (WAVE_FORMAT_PCM, 8): "pcm_u8",
    (WAVE_FORMAT_PCM, 16): "pcm_s16le",
    (WAVE_FORMAT_PCM, 24): "pcm_s24le",
    (WAVE_FORMAT_PCM, 32): "pcm_s32le",
    (WAVE_FORMAT_IEEE_FLOAT, 32): "pcm_f32le",
    (WAVE_FORMAT_IEEE_FLOAT, 64): "pcm_f64le",
    (WAVE_FORMAT_ALAW, 8): "pcm_alaw",
    (WAVE_FORMAT_MULAW, 8): "pcm_mulaw",
    (WAVE_FORMAT_ADPCM_MS, 4): "adpcm_ms",
    (WAVE_FORMAT_ADPCM_IMA, 4): "adpcm_ima_wav",
    (WAVE_FORMAT_ADPCM_YAMAHA, 4): "adpcm_yamaha",
}

_ADPCM_CODECS = ("adpcm_ms", "adpcm_ima_wav", "adpcm_yamaha")

_CODEC_TO_TAG = {
    "pcm_u8": (WAVE_FORMAT_PCM, 8),
    "pcm_s16le": (WAVE_FORMAT_PCM, 16),
    "pcm_s24le": (WAVE_FORMAT_PCM, 24),
    "pcm_s32le": (WAVE_FORMAT_PCM, 32),
    "pcm_f32le": (WAVE_FORMAT_IEEE_FLOAT, 32),
    "pcm_f64le": (WAVE_FORMAT_IEEE_FLOAT, 64),
    "pcm_alaw": (WAVE_FORMAT_ALAW, 8),
    "pcm_mulaw": (WAVE_FORMAT_MULAW, 8),
    "adpcm_ms": (WAVE_FORMAT_ADPCM_MS, 4),
    "adpcm_ima_wav": (WAVE_FORMAT_ADPCM_IMA, 4),
    "adpcm_yamaha": (WAVE_FORMAT_ADPCM_YAMAHA, 4),
}

#: the subformat GUID's tail after its first 4 bytes (the format tag):
#: KSDATAFORMAT_SUBTYPE_* = tag-0000-0010-8000-00AA00389B71
_SUBFORMAT_TAIL = bytes.fromhex("00001000800000aa00389b71")

# packet size target (bytes); like the reference, demuxed PCM is chunked
# into modest packets so downstream batching controls granularity
_MAX_PKT = 4096


@register_demuxer
class WavDemuxer(Demuxer):
    NAME = "wav"
    LONG_NAME = "WAV / WAVE (Waveform Audio)"
    EXTENSIONS = ("wav", "wave")

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        if len(buf) >= 12 and buf[:4] == b"RIFF" and buf[8:12] == b"WAVE":
            return PROBE_SCORE_MAX
        return 0

    def read_header(self, io: IOContext) -> None:
        if io.read_exact(4) != b"RIFF":
            raise InvalidData("not a RIFF file")
        io.rl32()  # riff size (unreliable; ignored)
        if io.read_exact(4) != b"WAVE":
            raise InvalidData("not a WAVE file")

        fmt_seen = False
        self._data_size = -1
        self._data_start = -1
        par = CodecParameters(codec_type="audio")
        while True:
            hdr = io.read(8)
            if len(hdr) < 8:
                break
            tag, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if tag == b"fmt ":
                fmt = io.read_exact(size if size % 2 == 0 else size + 1)
                (wtag, channels, rate, brate, balign, bits) = struct.unpack(
                    "<HHIIHH", fmt[:16])
                par.bit_rate = brate * 8        # as ff_get_wav_header
                if wtag == WAVE_FORMAT_EXTENSIBLE and size >= 40:
                    mask, wtag = struct.unpack("<IH", fmt[20:26])
                    if mask and bin(mask).count("1") == channels:
                        par.ch_layout = ChannelLayout.from_mask(mask)
                codec = _TAG_TO_CODEC.get((wtag, bits))
                if codec is None:
                    raise InvalidData(f"unsupported WAV format tag={wtag} bits={bits}")
                par.codec_id = codec
                par.sample_rate = rate
                par.nb_channels = channels
                par.block_align = balign or channels * (bits // 8)
                par.extra["bits_per_sample"] = bits
                if codec in _ADPCM_CODECS:
                    from librempeg_tpu_torch.codecs import adpcm as _adpcm

                    if codec == "adpcm_ima_wav":
                        spb = _adpcm.ima_samples_per_block(balign, channels)
                    elif codec == "adpcm_ms":
                        spb = _adpcm.ms_samples_per_block(balign, channels)
                    else:
                        spb = balign * 2 // channels
                    par.frame_size = spb
                    par.extra["samples_per_block"] = spb
                fmt_seen = True
            elif tag == b"LIST" and size >= 4:
                body = io.read_exact(size + (size & 1))[:size]
                if body[:4] == b"INFO":
                    pos = 4
                    while pos + 8 <= len(body):
                        k = body[pos:pos + 4]
                        ln = struct.unpack("<I", body[pos + 4:pos + 8])[0]
                        v = body[pos + 8:pos + 8 + ln].split(b"\x00")[0]
                        key = _INFO_TO_KEY.get(k)
                        if key:
                            self.metadata[key] = v.decode("utf-8",
                                                          "replace")
                        pos += 8 + ln + (ln & 1)
            elif tag == b"data":
                self._data_start = io.tell()
                self._data_size = size if size != 0xFFFFFFFF else -1
                if not io.seekable or self._data_size < 0:
                    break
                io.skip(size + (size & 1))
            else:
                io.skip(size + (size & 1))
        if not fmt_seen or self._data_start < 0:
            raise InvalidData("WAV: missing fmt or data chunk")

        st = Stream(index=0, codecpar=par,
                    time_base=Rational(1, par.sample_rate))
        if self._data_size > 0 and par.block_align:
            st.duration = (self._data_size // par.block_align
                           * par.extra.get("samples_per_block", 1))
        self.streams = [st]
        if io.seekable:
            io.seek(self._data_start)
        self._pos = 0  # bytes consumed within data chunk
        # packet size: whole blocks, close to _MAX_PKT
        ba = par.block_align
        self._pkt_bytes = max(ba, (_MAX_PKT // ba) * ba)

    def read_packet(self) -> Packet:
        par = self.streams[0].codecpar
        remaining = (self._data_size - self._pos
                     if self._data_size >= 0 else self._pkt_bytes)
        n = min(self._pkt_bytes, remaining)
        if n <= 0:
            raise EndOfStream
        data = self.io.read(n)
        if not data:
            raise EndOfStream
        spb = par.extra.get("samples_per_block", 1)
        pts = self._pos // par.block_align * spb
        self._pos += len(data)
        return Packet(
            data=data,
            pts=pts,
            dts=pts,
            duration=len(data) // par.block_align * spb,
            stream_index=0,
            flags=PktFlags.KEY,
            time_base=self.streams[0].time_base,
        )

    def read_seek(self, stream_index: int, ts: int) -> None:
        par = self.streams[0].codecpar
        byte = ts * par.block_align
        if self._data_size >= 0:
            byte = min(byte, self._data_size)
        self.io.seek(self._data_start + byte)
        self._pos = byte


#: RIFF LIST/INFO tag <-> metadata key (libavformat/riff.c ff_riff_info_conv)
_INFO_TO_KEY = {b"INAM": "title", b"IART": "artist", b"ICMT": "comment",
                b"ICRD": "date", b"IGNR": "genre", b"ISFT": "encoder",
                b"IPRD": "album", b"ITRK": "track"}
_KEY_TO_INFO = {v: k for k, v in _INFO_TO_KEY.items()}


@register_muxer
class WavMuxer(Muxer):
    NAME = "wav"
    LONG_NAME = "WAV / WAVE (Waveform Audio)"
    EXTENSIONS = ("wav", "wave")
    INTERLEAVE = False

    def write_header(self) -> None:
        super().write_header()
        if len(self.streams) != 1 or self.streams[0].codecpar.codec_type != "audio":
            raise InvalidData("wav muxer needs exactly one audio stream")
        par = self.streams[0].codecpar
        # wavenc.c counts in samples: the stream's time base is 1/rate
        self.streams[0].time_base = Rational(1, par.sample_rate)
        tag_bits = _CODEC_TO_TAG.get(par.codec_id)
        if tag_bits is None:
            raise InvalidData(f"wav: unsupported codec {par.codec_id}")
        wtag, bits = tag_bits
        io = self.io
        io.write(b"RIFF")
        self._riff_size_pos = io.tell()
        io.wl32(0)  # patched in trailer
        io.write(b"WAVE")
        io.write(b"fmt ")
        if par.codec_id in _ADPCM_CODECS:
            balign = par.block_align
            spb = par.frame_size or par.extra.get("samples_per_block", 0)
            extra = struct.pack("<H", spb)
            if par.codec_id == "adpcm_ms":
                from librempeg_tpu_torch.codecs.adpcm import MS_C1, MS_C2

                extra += struct.pack("<H", 7)
                for c1, c2 in zip(MS_C1, MS_C2):
                    extra += struct.pack("<hh", int(c1), int(c2))
            io.wl32(18 + len(extra))
            io.wl16(wtag)
            io.wl16(par.nb_channels)
            io.wl32(par.sample_rate)
            # ff_put_wav_header: the codec's bit rate over 8 (the JAX
            # package writes rate x block / samples per block)
            io.wl32(par.bit_rate // 8)
            io.wl16(balign)
            io.wl16(bits)
            io.wl16(len(extra))
            io.write(extra)
        else:
            layout = par.layout
            extensible = (layout.mask and layout not in (MONO, STEREO)) \
                or par.sample_rate > 48000 or bits > 16
            # WAVEFORMATEX (18 bytes, a zero cbSize) for a tag but PCM
            io.wl32(40 if extensible else 16 if wtag == WAVE_FORMAT_PCM
                    else 18)
            balign = par.nb_channels * (bits // 8)
            io.wl16(WAVE_FORMAT_EXTENSIBLE if extensible else wtag)
            io.wl16(par.nb_channels)
            io.wl32(par.sample_rate)
            io.wl32(par.sample_rate * balign)  # byte rate
            io.wl16(balign)
            io.wl16(bits)
            if extensible:
                # cbSize, valid bits, the channel mask (none past the
                # 18 channels WAVE defines), the subformat GUID
                io.wl16(22)
                io.wl16(bits)
                io.wl32(layout.mask if layout.mask < 0x40000 else 0)
                io.wl32(wtag)
                io.write(_SUBFORMAT_TAIL)
            elif wtag != WAVE_FORMAT_PCM:
                io.wl16(0)                      # cbSize
        self._fact_pos, self._block_align = -1, balign
        self._pts_span = None                   # (min pts, max pts, dur)
        if wtag != WAVE_FORMAT_PCM and io.seekable:
            # wavenc.c: a fact chunk for every tag but PCM (the JAX
            # package writes one for none), its sample count written at
            # the trailer
            io.write(b"fact")
            io.wl32(4)
            self._fact_pos = io.tell()
            io.wl32(0)
        io.write(b"data")
        self._data_size_pos = io.tell()
        io.wl32(0)  # patched in trailer
        self._data_bytes = 0

    def write_packet(self, pkt: Packet) -> None:
        self.io.write(pkt.data)
        self._data_bytes += len(pkt.data)
        if pkt.pts != NOPTS:
            st = self.streams[0]
            p = pkt if not (pkt.time_base.valid and pkt.time_base.num) \
                else pkt.rescale_ts(st.time_base)
            lo, hi, _ = self._pts_span or (p.pts, p.pts, 0)
            self._pts_span = (min(lo, p.pts), max(hi, p.pts), p.duration)

    def _fact_samples(self) -> int:
        """wavenc.c's sample count: the packets' pts span and the last
        duration, in samples; without pts, the data's blocks."""
        par, st = self.streams[0].codecpar, self.streams[0]
        if self._pts_span is None:
            spb = par.frame_size or par.extra.get("samples_per_block", 1)
            return self._data_bytes // self._block_align * spb
        lo, hi, dur = self._pts_span
        return rescale_q(hi - lo + dur, st.time_base,
                         Rational(1, par.sample_rate))

    def write_trailer(self) -> None:
        io = self.io
        if self.metadata:
            body = b"INFO"
            for key, val in self.metadata.items():
                tag = _KEY_TO_INFO.get(key.lower())
                if tag is None:
                    continue
                v = val.encode() + b"\x00"
                if len(v) & 1:
                    v += b"\x00"
                body += tag + struct.pack("<I", len(v)) + v
            if body != b"INFO":
                io.write(b"LIST" + struct.pack("<I", len(body)) + body)
        if io.seekable:
            end = io.tell()
            io.seek(self._riff_size_pos)
            io.wl32(end - 8)
            io.seek(self._data_size_pos)
            io.wl32(self._data_bytes)
            if self._fact_pos >= 0:
                io.seek(self._fact_pos)
                io.wl32(self._fact_samples())
            io.seek(end)
