"""Raw PCM audio containers (s16le, f32le, ...).

Analog of libavformat/pcmdec.c / pcmenc.c.

A copy of librempeg_tpu/formats/rawaudio.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

from librempeg_tpu_torch.core.errors import EndOfStream
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

_RAW_FORMATS = {
    "s16le": ("pcm_s16le", 2),
    "s24le": ("pcm_s24le", 3),
    "s32le": ("pcm_s32le", 4),
    "f32le": ("pcm_f32le", 4),
    "f64le": ("pcm_f64le", 8),
    "u8": ("pcm_u8", 1),
    "alaw": ("pcm_alaw", 1),
    "mulaw": ("pcm_mulaw", 1),
}


def _make_demuxer(name: str, codec: str, bps: int):
    @register_demuxer
    class RawPcmDemuxer(Demuxer):
        NAME = name
        LONG_NAME = f"raw PCM {name}"
        EXTENSIONS = (name,) if name != "s16le" else ("sw", "s16le")

        def __init__(self, sample_rate: int = 44100, channels: int = 2):
            super().__init__()
            self._rate = sample_rate
            self._ch = channels

        def read_header(self, io):
            ba = bps * self._ch
            par = CodecParameters(
                codec_type="audio", codec_id=codec,
                sample_rate=self._rate, nb_channels=self._ch,
                block_align=ba)
            self.streams = [Stream(index=0, codecpar=par,
                                   time_base=Rational(1, self._rate))]
            self._pos = 0
            self._pkt_bytes = max(ba, 4096 // ba * ba)

        def read_packet(self) -> Packet:
            data = self.io.read(self._pkt_bytes)
            if not data:
                raise EndOfStream
            ba = self.streams[0].codecpar.block_align
            pts = self._pos // ba
            self._pos += len(data)
            return Packet(data=data, pts=pts, dts=pts,
                          duration=len(data) // ba, flags=PktFlags.KEY,
                          time_base=self.streams[0].time_base)

    RawPcmDemuxer.__name__ = f"RawPcmDemuxer_{name}"
    return RawPcmDemuxer


def _make_muxer(name: str):
    @register_muxer
    class RawPcmMuxer(Muxer):
        NAME = name
        LONG_NAME = f"raw PCM {name}"
        EXTENSIONS = (name,) if name != "s16le" else ("sw", "s16le")
        INTERLEAVE = False

        def write_packet(self, pkt: Packet):
            self.io.write(pkt.data)

    RawPcmMuxer.__name__ = f"RawPcmMuxer_{name}"
    return RawPcmMuxer


for _name, (_codec, _bps) in _RAW_FORMATS.items():
    _make_demuxer(_name, _codec, _bps)
    _make_muxer(_name)
