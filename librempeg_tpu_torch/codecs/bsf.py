"""Bitstream filters: packet-level transforms.

Analog of the reference's bsf layer (libavcodec/bsf.c,
bitstream_filters.c — 53 filters). Round-1 set:

* null            passthrough (ff_null_bsf)
* chomp           strip trailing zero bytes (bsf/chomp.c)
* noise           deterministic packet corruption for robustness tests
                  (bsf/noise.c — SURVEY.md §5 fault injection)
* setts           rescale/offset packet timestamps (bsf/setts.c class)
* dump_extradata  prepend stream extradata to keyframes

A copy of librempeg_tpu/codecs/bsf.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

import hashlib

import numpy as np

from librempeg_tpu_torch.core.errors import NotFound
from librempeg_tpu_torch.core.options import Option, OptionTable, OptionedObject
from librempeg_tpu_torch.core.packet import Packet, PktFlags


class BitstreamFilter(OptionedObject):
    NAME = ""

    def __init__(self, params=None, **opts):
        super().__init__(**opts)
        self.params = params

    def filter(self, pkt: Packet) -> list[Packet]:
        return [pkt]

    def flush(self) -> list[Packet]:
        return []


_BSFS: dict[str, type[BitstreamFilter]] = {}


def register_bsf(cls):
    _BSFS[cls.NAME] = cls
    return cls


def find_bsf(name: str) -> type[BitstreamFilter]:
    try:
        return _BSFS[name]
    except KeyError:
        raise NotFound(f"bitstream filter {name!r} not found") from None


def bsfs() -> dict[str, type[BitstreamFilter]]:
    return dict(_BSFS)


@register_bsf
class NullBsf(BitstreamFilter):
    NAME = "null"


@register_bsf
class ChompBsf(BitstreamFilter):
    NAME = "chomp"

    def filter(self, pkt: Packet) -> list[Packet]:
        data = bytes(pkt.data).rstrip(b"\x00")
        return [pkt.replace(data=data)]


@register_bsf
class NoiseBsf(BitstreamFilter):
    """Deterministic fault injection: flips bytes with given frequency.

    `amount` = corrupt 1 byte every `amount` bytes (like the reference's
    noise bsf); seeded per-packet from the payload so runs reproduce.
    """

    NAME = "noise"
    OPTIONS = OptionTable(
        Option("amount", int, 1024, min=1, max=1 << 30),
        Option("drop", int, 0, min=0, max=100,
               help="percent of packets to drop entirely"),
        Option("seed", int, 0),
    )

    def __init__(self, params=None, **opts):
        super().__init__(params, **opts)
        self._count = 0

    def filter(self, pkt: Packet) -> list[Packet]:
        self._count += 1
        h = hashlib.sha256(
            bytes(pkt.data[:64]) + self._count.to_bytes(4, "little")
            + self.opts["seed"].to_bytes(8, "little", signed=True)).digest()
        rng = np.random.default_rng(int.from_bytes(h[:8], "little"))
        if self.opts["drop"] and rng.integers(0, 100) < self.opts["drop"]:
            return []
        data = bytearray(pkt.data)
        n = max(1, len(data) // self.opts["amount"])
        idx = rng.integers(0, len(data), n)
        for i in idx:
            data[i] ^= int(rng.integers(1, 256))
        return [pkt.replace(data=bytes(data), flags=pkt.flags
                            | PktFlags.CORRUPT)]


@register_bsf
class SetTsBsf(BitstreamFilter):
    """Timestamp arithmetic on packets (setts class)."""

    NAME = "setts"
    OPTIONS = OptionTable(
        Option("offset", int, 0),
        Option("scale_num", int, 1, min=1),
        Option("scale_den", int, 1, min=1),
    )

    def filter(self, pkt: Packet) -> list[Packet]:
        from librempeg_tpu_torch.core.rational import NOPTS

        def fix(v):
            if v == NOPTS:
                return v
            return (v * self.opts["scale_num"] // self.opts["scale_den"]
                    + self.opts["offset"])

        return [pkt.replace(pts=fix(pkt.pts), dts=fix(pkt.dts))]


@register_bsf
class DumpExtradataBsf(BitstreamFilter):
    NAME = "dump_extra"

    def filter(self, pkt: Packet) -> list[Packet]:
        extra = self.params.extradata if self.params is not None else b""
        if extra and pkt.is_key and not bytes(pkt.data).startswith(extra):
            return [pkt.replace(data=extra + bytes(pkt.data))]
        return [pkt]


@register_bsf
class H264Mp4ToAnnexbBsf(BitstreamFilter):
    """Convert length-prefixed H.264 (ISO-BMFF) packets to annex-B and
    prepend SPS/PPS from avcC extradata before keyframes.

    Analog of libavcodec/bsf/h264_mp4toannexb.c."""

    NAME = "h264_mp4toannexb"

    def __init__(self, params=None, **opts):
        super().__init__(params, **opts)
        from librempeg_tpu_torch.codecs.h264.avcc import (
            avcc_to_annexb,
            nal_length_size,
        )

        self._ps = b""
        self._nal_size = 4
        extra = bytes(getattr(params, "extradata", b"") or b"")
        if extra[:1] == b"\x01":
            self._ps = avcc_to_annexb(extra)
            self._nal_size = nal_length_size(extra)
        elif extra:
            self._ps = extra
        self._sent_ps = False

    def filter(self, pkt: Packet) -> list[Packet]:
        from librempeg_tpu_torch.codecs.h264.avcc import lp_to_annexb
        from librempeg_tpu_torch.codecs.h264.parse import split_annexb

        data = lp_to_annexb(bytes(pkt.data), self._nal_size)
        if self._ps and not self._sent_ps and (pkt.flags & PktFlags.KEY):
            has_sps = any((nal[0] & 0x1F) == 7 for nal in split_annexb(data))
            if not has_sps:
                data = self._ps + data
            self._sent_ps = True
        return [pkt.replace(data=data)]


@register_bsf
class ExtractExtradataBsf(BitstreamFilter):
    """Extract SPS/PPS from in-band H.264 annex-B packets into packet
    side data / filter-level extradata (bsf/extract_extradata.c analog);
    with remove=1 the parameter sets are stripped from the packet."""

    NAME = "extract_extradata"
    OPTIONS = OptionTable(
        Option("remove", int, 0, min=0, max=1,
               help="strip parameter sets from the packets"),
    )

    def __init__(self, args: str = "", **kw):
        super().__init__(args, **kw)
        self.extradata = b""

    def filter(self, pkt: Packet) -> list[Packet]:
        from librempeg_tpu_torch.codecs.h264.parse import split_annexb

        data = bytes(pkt.data)
        ps, rest = [], []
        for nal in split_annexb(data):
            if nal and (nal[0] & 0x1F) in (7, 8):
                ps.append(nal)
            else:
                rest.append(nal)
        if ps:
            extra = b"".join(b"\x00\x00\x00\x01" + n for n in ps)
            self.extradata = extra
            pkt.side_data["new_extradata"] = extra
            if self.opts["remove"]:
                pkt = pkt.replace(data=b"".join(
                    b"\x00\x00\x00\x01" + n for n in rest))
        return [pkt]


@register_bsf
class H264Cavlc2CabacBsf(BitstreamFilter):
    """Entropy-recode annex-B H.264 CAVLC packets to CABAC (pixel-exact;
    see codecs/h264/entropy_transcode.py)."""

    NAME = "h264_cavlc2cabac"

    def __init__(self, params=None, **opts):
        super().__init__(params, **opts)
        from librempeg_tpu_torch.codecs.h264.entropy_transcode import (
            EntropyTranscoder,
        )

        self._etc = EntropyTranscoder()
        if params is not None and params.extradata \
                and bytes(params.extradata[:1]) == b"\x00":
            params.extradata = self._etc.feed(bytes(params.extradata))

    def filter(self, pkt):
        return [pkt.replace(data=self._etc.feed(bytes(pkt.data)))]
