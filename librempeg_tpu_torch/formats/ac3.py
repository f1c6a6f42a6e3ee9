"""Raw AC-3 (.ac3) demuxer + muxer (libavformat/ac3dec.c raw analog):
0x0B77-sync framing with frame sizes from the A/52 table.

A copy of librempeg_tpu/formats/ac3.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

from librempeg_tpu_torch.codecs.ac3 import tables_data as T
from librempeg_tpu_torch.core.errors import EndOfStream, InvalidData
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import Rational
from librempeg_tpu_torch.core.samplefmt import CH_LOW_FREQUENCY, ChannelLayout
from librempeg_tpu_torch.formats.api import (
    CodecParameters,
    Demuxer,
    Muxer,
    Stream,
    register_demuxer,
    register_muxer,
)

_RATES = (48000, 44100, 32000)
#: acmod -> the channel mask libavcodec gives its full-bandwidth
#: channels (ac3tab.c avpriv_ac3_channel_layout_tab: dual mono is
#: stereo, 2/1 and 2/2 put the surrounds at the back centre and the
#: sides); the LFE channel adds CH_LOW_FREQUENCY
ACMOD_MASKS = (0x3, 0x4, 0x3, 0x7, 0x103, 0x107, 0x603, 0x607)


def _layout(acmod: int, lfeon: int) -> ChannelLayout:
    return ChannelLayout.from_mask(ACMOD_MASKS[acmod]
                                   | (CH_LOW_FREQUENCY if lfeon else 0))


def _frame_info(buf: bytes, pos: int):
    """(size_bytes, sample_rate, layout, codec_id, samples) or None.
    Handles AC-3 (bsid <= 8) and E-AC-3 (11..16); bsid sits at bit 40
    in both syntaxes (libavformat/ac3dec.c probe role)."""
    if pos + 7 > len(buf) or buf[pos] != 0x0B or buf[pos + 1] != 0x77:
        return None
    bsid = buf[pos + 5] >> 3
    if bsid <= 8:
        fscod = buf[pos + 4] >> 6
        frmsizecod = buf[pos + 4] & 0x3F
        if fscod == 3 or frmsizecod > 37:
            return None
        acmod = buf[pos + 6] >> 5
        # lfeon follows acmod after cmixlev, surmixlev and dsurmod, each
        # present only for some acmods (A/52 5.3.2); the JAX package
        # counts no LFE channel here
        skip = 2 * ((acmod & 1 and acmod != 1) + (acmod >> 2)
                    + (acmod == 2))
        lfeon = (buf[pos + 6] >> (4 - skip)) & 1
        return (T.FRAME_SIZE_TAB[frmsizecod][fscod] * 2, _RATES[fscod],
                _layout(acmod, lfeon), "ac3", 1536)
    if 11 <= bsid <= 16:
        strmtyp = buf[pos + 2] >> 6
        if strmtyp == 3:
            return None
        frmsiz = ((buf[pos + 2] & 0x07) << 8) | buf[pos + 3]
        fscod = buf[pos + 4] >> 6
        if fscod == 3:
            return None
        nblocks = (1, 2, 3, 6)[(buf[pos + 4] >> 4) & 3]
        acmod = (buf[pos + 4] >> 1) & 7
        lfeon = buf[pos + 4] & 1
        return ((frmsiz + 1) * 2, _RATES[fscod], _layout(acmod, lfeon),
                "eac3", 256 * nblocks)
    return None


@register_demuxer
class Ac3Demuxer(Demuxer):
    NAME = "ac3"
    LONG_NAME = "raw AC-3 / E-AC-3"
    EXTENSIONS = ("ac3", "eac3", "ec3")
    _CHUNK = 1 << 16

    @classmethod
    def probe(cls, buf: bytes, filename: str = "") -> int:
        pos = frames = 0
        while frames < 3:
            info = _frame_info(buf, pos)
            if info is None:
                break
            pos += info[0]
            frames += 1
            if pos >= len(buf):
                break
        if frames >= 2 or (frames == 1 and pos >= len(buf)):
            return 51
        return 0

    def read_header(self, io):
        self.io = io
        self._buf = b""
        self._eof = False
        self._consumed = self._start = io.tell()
        self._idx = 0
        if not self._sync(7):
            raise InvalidData("ac3: no sync")
        _, rate, layout, codec_id, samples = _frame_info(self._buf, 0)
        self._samples = samples
        par = CodecParameters(codec_type="audio", codec_id=codec_id,
                              sample_rate=rate,
                              nb_channels=layout.nb_channels,
                              ch_layout=layout, frame_size=samples)
        self.streams = [Stream(index=0, codecpar=par,
                               time_base=Rational(1, rate))]

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
            if not self._fill(max(need, 7)):
                return False
            if _frame_info(self._buf, 0) is not None:
                return self._fill(need)
            nxt = self._buf.find(b"\x0b", 1)
            drop = nxt if nxt > 0 else len(self._buf)
            self._consumed += drop
            self._buf = self._buf[drop:]

    def read_packet(self) -> Packet:
        if not self._sync(7):
            raise EndOfStream
        size = _frame_info(self._buf, 0)[0]
        if not self._fill(size):
            raise EndOfStream
        data, self._buf = self._buf[:size], self._buf[size:]
        self._consumed += size
        samples = self._samples
        pts = self._idx * samples
        self._idx += 1
        return Packet(data=data, pts=pts, dts=pts, duration=samples,
                      flags=PktFlags.KEY,
                      time_base=self.streams[0].time_base)

    def read_seek(self, stream_index: int, ts: int) -> None:
        """To the frame that holds sample `ts` (every frame is a key
        frame), counted from the first frame, as libavformat's generic
        index finds it in a raw stream. The JAX package cannot seek
        here and decodes from the start. After this seek the decoder
        starts at the frame with no overlap and its dither generator at
        its seed, as the decoder that ffmpeg's -ss opens after its seek
        does."""
        if not self.io.seekable:
            raise NotImplementedError("ac3: seek on an unseekable input")
        self.io.seek(self._start)
        self._buf, self._eof = b"", False
        self._consumed, self._idx = self._start, 0
        while self._idx < max(0, ts) // self._samples and self._sync(7):
            size = _frame_info(self._buf, 0)[0]
            if not self._fill(size):
                break
            self._buf = self._buf[size:]
            self._consumed += size
            self._idx += 1

    def tell_resume(self) -> int:
        return self._consumed

    def on_restore(self) -> None:
        self._buf = b""
        self._eof = False


@register_muxer
class Ac3Muxer(Muxer):
    NAME = "ac3"
    LONG_NAME = "raw AC-3"
    EXTENSIONS = ("ac3",)
    INTERLEAVE = False

    def write_packet(self, pkt: Packet):
        self.io.write(bytes(pkt.data))
