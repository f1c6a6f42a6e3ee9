"""MP3/MP2 (MPEG audio) demuxer + muxer with ID3v2 tags.

Analog of libavformat/mp3dec.c (frame framing, Xing/Info
VBR header, the LAME tag's gapless trim, id3 skip) and mp3enc.c (id3v2
write + passthrough). Framing is incremental (rolling buffer,
tell_resume checkpoint protocol).

A copy of librempeg_tpu/formats/mp3.py (host code, no JAX), imports
rewritten; the LAME tag's trim is the port's (the JAX demuxer reads the
Info frame for the duration only).
"""
from __future__ import annotations

from librempeg_tpu_torch.core.errors import EndOfStream, InvalidData
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import Rational
from librempeg_tpu_torch.core.sidedata import SkipSamples, set_side_data
from librempeg_tpu_torch.formats import id3v2
from librempeg_tpu_torch.formats.api import (
    CodecParameters,
    Demuxer,
    Muxer,
    Stream,
    register_demuxer,
    register_muxer,
)

# bitrate kbps tables [version(0=v1,1=v2/2.5)][layer(1..3)][idx]
_BITRATES = {
    (0, 1): (0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352,
             384, 416, 448),
    (0, 2): (0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
             320, 384),
    (0, 3): (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224,
             256, 320),
    (1, 1): (0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192,
             224, 256),
    (1, 2): (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144,
             160),
    (1, 3): (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144,
             160),
}
#: the MPEG audio decoder's delay in samples (libavformat's 528 + 1)
_DECODER_DELAY = 529
_RATES = {3: (44100, 48000, 32000),      # MPEG-1
          2: (22050, 24000, 16000),      # MPEG-2
          0: (11025, 12000, 8000)}       # MPEG-2.5


class FrameHeader:
    __slots__ = ("version_bits", "layer", "bitrate", "sample_rate",
                 "padding", "channels", "frame_size", "samples")

    @staticmethod
    def parse(b: bytes):
        if len(b) < 4 or b[0] != 0xFF or (b[1] & 0xE0) != 0xE0:
            return None
        h = FrameHeader()
        h.version_bits = (b[1] >> 3) & 3          # 0=2.5, 2=2, 3=1
        if h.version_bits == 1:
            return None
        h.layer = 4 - ((b[1] >> 1) & 3)           # 1..3
        if h.layer == 4:
            return None
        br_idx = (b[2] >> 4) & 0xF
        sr_idx = (b[2] >> 2) & 3
        if br_idx in (0, 15) or sr_idx == 3:
            return None
        v2 = 0 if h.version_bits == 3 else 1
        h.bitrate = _BITRATES[(v2, h.layer)][br_idx] * 1000
        h.sample_rate = _RATES[h.version_bits][sr_idx]
        h.padding = (b[2] >> 1) & 1
        h.channels = 1 if ((b[3] >> 6) & 3) == 3 else 2
        if h.layer == 1:
            h.samples = 384
            h.frame_size = (12 * h.bitrate // h.sample_rate
                            + h.padding) * 4
        elif h.layer == 2:
            h.samples = 1152
            h.frame_size = 144 * h.bitrate // h.sample_rate + h.padding
        else:
            h.samples = 1152 if v2 == 0 else 576
            coef = 144 if v2 == 0 else 72
            h.frame_size = coef * h.bitrate // h.sample_rate + h.padding
        if h.frame_size < 4:
            return None
        return h


@register_demuxer
class Mp3Demuxer(Demuxer):
    NAME = "mp3"
    LONG_NAME = "MP2/3 (MPEG audio layer 2/3)"
    EXTENSIONS = ("mp3", "mp2", "mpa", "m2a")
    _CHUNK = 1 << 16

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        if buf[:3] == b"ID3":
            return 63
        # require a few consecutive consistent frames
        pos = 0
        while pos < min(len(buf), 2048):
            h = FrameHeader.parse(buf[pos:pos + 4])
            if h is None:
                pos += 1
                continue
            n, p, sr = 0, pos, h.sample_rate
            while n < 3:
                h2 = FrameHeader.parse(buf[p:p + 4])
                if h2 is None or h2.sample_rate != sr:
                    break
                p += h2.frame_size
                n += 1
                if p >= len(buf):
                    break
            if n >= 3 or (n >= 1 and p >= len(buf)):
                return 51 if n >= 3 else 25
            pos += 1
        return 0

    def read_header(self, io):
        self.io = io
        self.metadata.update(id3v2.parse(io))
        self._buf = b""
        self._eof = False
        self._consumed = io.tell()
        self._idx = 0
        self._sample_off = 0
        if not self._sync(4):
            raise InvalidData("mp3: no frame sync")
        h = FrameHeader.parse(self._buf)
        self._hdr = h
        codec = {1: "mp1", 2: "mp2", 3: "mp3"}[h.layer]
        par = CodecParameters(codec_type="audio", codec_id=codec,
                              sample_rate=h.sample_rate,
                              nb_channels=h.channels,
                              bit_rate=h.bitrate, frame_size=h.samples)
        self.streams = [Stream(index=0, codecpar=par,
                               time_base=Rational(1, h.sample_rate))]
        # gapless trim from the LAME tag (libavformat's start_skip_samples,
        # first/last_discard_sample): 0 where the file has none
        self._start_skip = self._first_discard = self._last_discard = 0
        # Xing/Info/VBRI header in the first frame -> duration
        if self._fill(h.frame_size):
            frame = self._buf[:h.frame_size]
            for tag in (b"Xing", b"Info", b"VBRI"):
                k = frame.find(tag)
                if 0 < k < h.frame_size - 12:
                    if tag in (b"Xing", b"Info"):
                        flags = int.from_bytes(frame[k + 4:k + 8], "big")
                        nfr = 0
                        if flags & 1:
                            nfr = int.from_bytes(frame[k + 8:k + 12], "big")
                            self.duration = (nfr * h.samples * 1_000_000
                                             // h.sample_rate)
                        self._lame_tag(frame, k, flags, nfr, h.samples)
                    else:
                        nfr = int.from_bytes(frame[k + 14:k + 18], "big")
                        self.duration = (nfr * h.samples * 1_000_000
                                         // h.sample_rate)
                    # drop the metadata frame from the packet stream
                    self._buf = self._buf[h.frame_size:]
                    self._consumed += h.frame_size
                    break

    def _lame_tag(self, frame: bytes, k: int, flags: int, nfr: int,
                  spf: int) -> None:
        """The LAME tag after the Xing/Info fields at `k` (libavformat's
        mp3_parse_info_tag): a 9-byte encoder version, then 12 bits of
        encoder delay and 12 of padding 21 bytes on. Only a LAME, Lavf
        or Lavc tag is read; the decoder's own 529-sample delay is
        trimmed with the encoder's."""
        p = k + 8 + 4 * bool(flags & 1) + 4 * bool(flags & 2) \
            + 100 * bool(flags & 4) + 4 * bool(flags & 8)
        if p + 24 > len(frame) or frame[p:p + 4] not in (b"LAME", b"Lavf",
                                                         b"Lavc"):
            return
        v = int.from_bytes(frame[p + 21:p + 24], "big")
        self._start_skip = (v >> 12) + _DECODER_DELAY
        if nfr:
            self._first_discard = nfr * spf + _DECODER_DELAY - (v & 4095)
            self._last_discard = nfr * spf
        self.streams[0].start_time = self._start_skip

    def _fill(self, need: int) -> bool:
        while len(self._buf) < need and not self._eof:
            chunk = self.io.read(self._CHUNK)
            if not chunk:
                self._eof = True
                break
            self._buf += chunk
        return len(self._buf) >= need

    def _sync(self, need: int) -> bool:
        while True:
            if not self._fill(max(need, 4)):
                return False
            if FrameHeader.parse(self._buf) is not None:
                return self._fill(need)
            nxt = self._buf.find(b"\xff", 1)
            drop = nxt if nxt > 0 else len(self._buf)
            self._consumed += drop
            self._buf = self._buf[drop:]

    def read_packet(self) -> Packet:
        if not self._sync(4):
            raise EndOfStream
        h = FrameHeader.parse(self._buf)
        if not self._fill(h.frame_size):
            raise EndOfStream                      # truncated final frame
        data, self._buf = (self._buf[:h.frame_size],
                           self._buf[h.frame_size:])
        self._consumed += h.frame_size
        pts = self._sample_off
        self._sample_off += h.samples
        self._idx += 1
        pkt = Packet(data=data, pts=pts, dts=pts, duration=h.samples,
                     flags=PktFlags.KEY, time_base=self.streams[0].time_base)
        # the trim goes to the decoder as side data, as libavformat's
        # demux.c attaches it: the start skip on the packet at pts 0, so
        # a resumed read or a seek past it skips nothing again, and the
        # padding on each packet that reaches past the first discarded
        # sample
        start = self._start_skip if pts == 0 else 0
        end = 0
        if self._first_discard and pts + h.samples >= self._first_discard \
                and pts < self._last_discard:
            end = min(pts + h.samples - self._first_discard, h.samples)
        if start or end:
            set_side_data(pkt, SkipSamples(start=start, end=end))
        return pkt

    def tell_resume(self) -> int:
        return self._consumed

    def on_restore(self) -> None:
        self._buf = b""
        self._eof = False


@register_muxer
class Mp3Muxer(Muxer):
    NAME = "mp3"
    LONG_NAME = "MP3 (MPEG audio layer 3)"
    EXTENSIONS = ("mp3", "mp2")
    INTERLEAVE = False

    def write_header(self):
        super().write_header()
        tag = id3v2.write(self.metadata)
        if tag:
            self.io.write(tag)

    def write_packet(self, pkt: Packet):
        self.io.write(bytes(pkt.data))
