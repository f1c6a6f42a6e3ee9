"""Compressed packets.

Analog of AVPacket (libavcodec/packet.h). Packets are
host-side objects: compressed bitstreams stay on the CPU (entropy coding
is serial); only decoded samples/pixels cross to the device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from librempeg_tpu_torch.core.rational import NOPTS, Rational


class PktFlags:
    KEY = 1 << 0
    CORRUPT = 1 << 1
    DISCARD = 1 << 2


@dataclass
class Packet:
    data: bytes = b""
    pts: int = NOPTS
    dts: int = NOPTS
    duration: int = 0
    stream_index: int = 0
    flags: int = 0
    time_base: Rational = Rational(0, 1)
    pos: int = -1              # byte offset in the source, -1 unknown
    side_data: dict = field(default_factory=dict)

    @property
    def size(self) -> int:
        return len(self.data)

    @property
    def is_key(self) -> bool:
        return bool(self.flags & PktFlags.KEY)

    def replace(self, **kw) -> "Packet":
        return dataclasses.replace(self, **kw)

    def rescale_ts(self, dst_tb: Rational) -> "Packet":
        """Rescale pts/dts/duration into dst_tb (av_packet_rescale_ts)."""
        from librempeg_tpu_torch.core.rational import rescale_q

        src = self.time_base
        if not src.valid or src.num == 0:
            return self.replace(time_base=dst_tb)
        return self.replace(
            pts=NOPTS if self.pts == NOPTS else rescale_q(self.pts, src, dst_tb),
            dts=NOPTS if self.dts == NOPTS else rescale_q(self.dts, src, dst_tb),
            duration=rescale_q(self.duration, src, dst_tb),
            time_base=dst_tb,
        )
