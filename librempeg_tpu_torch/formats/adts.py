"""ADTS (AAC transport) demuxer + muxer.

Port of librempeg_tpu/formats/adts.py, a host copy. Analog of libavformat/aacdec.c (probe: consecutive
0xFFF-sync frames with sane lengths) and adtsenc.c (the encoder already
emits ADTS headers, so muxing is passthrough; raw AAC packets get a
header built from codec parameters).
"""
from __future__ import annotations

from librempeg_tpu_torch.core.errors import EndOfStream, InvalidData
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import Rational
from librempeg_tpu_torch.formats.api import (
    CodecParameters,
    Demuxer,
    Muxer,
    Stream,
    register_demuxer,
    register_muxer,
)

_RATES = (96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
          16000, 12000, 11025, 8000, 7350)


def _frame_len(data: bytes, pos: int) -> int:
    return ((data[pos + 3] & 3) << 11) | (data[pos + 4] << 3) \
        | (data[pos + 5] >> 5)


def _is_sync(data: bytes, pos: int) -> bool:
    return (pos + 7 <= len(data) and data[pos] == 0xFF
            and (data[pos + 1] & 0xF6) == 0xF0)


@register_demuxer
class AdtsDemuxer(Demuxer):
    NAME = "aac"
    LONG_NAME = "raw ADTS AAC"
    EXTENSIONS = ("aac", "adts")

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        pos = 0
        frames = 0
        while _is_sync(buf, pos) and frames < 3:
            ln = _frame_len(buf, pos)
            if ln < 7:
                return 0
            frames += 1
            pos += ln
        if frames >= 2 or (frames == 1 and pos >= len(buf)):
            return 51
        return 0

    _CHUNK = 1 << 16

    def read_header(self, io):
        # Incremental framing (reference aacdec.c reads per-packet): keep a
        # rolling buffer; never slurp the whole stream into memory.
        self.io = io
        self._buf = b""
        self._eof = False
        self._consumed = io.tell()  # stream offset of the start of _buf
        if not self._refill_to(7):
            raise InvalidData("adts: no sync")
        hdr = self._buf
        rate_idx = (hdr[2] >> 2) & 0xF
        channels = ((hdr[2] & 1) << 2) | (hdr[3] >> 6)
        rate = _RATES[rate_idx] if rate_idx < len(_RATES) else 44100
        par = CodecParameters(codec_type="audio", codec_id="aac",
                              sample_rate=rate, nb_channels=channels or 2,
                              frame_size=1024)
        self.streams = [Stream(index=0, codecpar=par,
                               time_base=Rational(1, rate))]
        self._idx = 0

    def _refill_to(self, need: int) -> bool:
        """Grow the rolling buffer until it starts at a sync word and holds
        at least `need` bytes; returns False at clean EOF."""
        while True:
            while len(self._buf) < max(need, 7) and not self._eof:
                chunk = self.io.read(self._CHUNK)
                if not chunk:
                    self._eof = True
                    break
                self._buf += chunk
            if len(self._buf) < 7:
                return False
            if _is_sync(self._buf, 0):
                return len(self._buf) >= need  # filled or truncated at EOF
            # resync: drop bytes up to the next candidate sync
            nxt = self._buf.find(b"\xff", 1)
            dropped = nxt if nxt > 0 else len(self._buf)
            self._consumed += dropped
            self._buf = self._buf[dropped:]
            if not self._buf and self._eof:
                return False

    def read_packet(self) -> Packet:
        if not self._refill_to(7):
            raise EndOfStream
        ln = _frame_len(self._buf, 0)
        if ln < 7:
            raise InvalidData("adts: bad frame length")
        if not self._refill_to(ln):
            raise EndOfStream  # truncated final frame
        data, self._buf = self._buf[:ln], self._buf[ln:]
        self._consumed += ln
        i = self._idx
        self._idx += 1
        return Packet(data=data, pts=i * 1024, dts=i * 1024,
                      duration=1024, flags=PktFlags.KEY,
                      time_base=self.streams[0].time_base)

    def tell_resume(self) -> int:
        return self._consumed

    def on_restore(self) -> None:
        self._buf = b""
        self._eof = False


@register_muxer
class AdtsMuxer(Muxer):
    NAME = "adts"
    LONG_NAME = "ADTS AAC"
    EXTENSIONS = ("aac", "adts")
    INTERLEAVE = False

    def write_packet(self, pkt: Packet):
        data = bytes(pkt.data)
        if not _is_sync(data, 0):    # raw AAC: synthesize the header
            par = self.streams[pkt.stream_index].codecpar
            ln = len(data) + 7
            ri = _RATES.index(par.sample_rate) \
                if par.sample_rate in _RATES else 4
            ch = par.nb_channels
            hdr = bytes([
                0xFF, 0xF1, (1 << 6) | (ri << 2) | (ch >> 2),
                ((ch & 3) << 6) | ((ln >> 11) & 3),
                (ln >> 3) & 0xFF, ((ln & 7) << 5) | 0x1F, 0xFC])
            data = hdr + data
        self.io.write(data)
