"""Annex-B <-> AVCDecoderConfigurationRecord/length-prefixed conversion.

Analog of libavcodec/bsf/h264_mp4toannexb.c and the
avcC writer in libavformat/avc.c: ISO/IEC 14496-15 §5.2.4.1 record
layout, 4-byte NAL length prefixes in samples.

A copy of librempeg_tpu/codecs/h264/avcc.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

import struct

from librempeg_tpu_torch.core.errors import InvalidData

_SC = b"\x00\x00\x00\x01"


def build_avcc(annexb_extradata: bytes) -> bytes:
    """Annex-B SPS/PPS blob -> AVCDecoderConfigurationRecord."""
    from librempeg_tpu_torch.codecs.h264.parse import split_annexb

    if annexb_extradata[:1] == b"\x01":
        return bytes(annexb_extradata)          # already avcC
    sps_list, pps_list = [], []
    for nal in split_annexb(bytes(annexb_extradata)):
        t = nal[0] & 0x1F
        if t == 7:
            sps_list.append(nal)
        elif t == 8:
            pps_list.append(nal)
    if not sps_list or not pps_list:
        raise InvalidData("avcC: extradata lacks SPS/PPS")
    sps = sps_list[0]
    out = bytearray()
    out += bytes([1, sps[1], sps[2], sps[3], 0xFC | 3])  # 4-byte lengths
    out += bytes([0xE0 | len(sps_list)])
    for s in sps_list:
        out += struct.pack(">H", len(s)) + s
    out += bytes([len(pps_list)])
    for p in pps_list:
        out += struct.pack(">H", len(p)) + p
    return bytes(out)


def avcc_to_annexb(avcc: bytes) -> bytes:
    """AVCDecoderConfigurationRecord -> annex-B SPS/PPS blob."""
    if avcc[:1] != b"\x01":
        return bytes(avcc)                      # already annex-B
    pos = 5
    n_sps = avcc[pos] & 0x1F
    pos += 1
    out = bytearray()
    for _ in range(n_sps):
        ln = struct.unpack(">H", avcc[pos:pos + 2])[0]
        pos += 2
        out += _SC + avcc[pos:pos + ln]
        pos += ln
    n_pps = avcc[pos]
    pos += 1
    for _ in range(n_pps):
        ln = struct.unpack(">H", avcc[pos:pos + 2])[0]
        pos += 2
        out += _SC + avcc[pos:pos + ln]
        pos += ln
    return bytes(out)


def nal_length_size(avcc: bytes) -> int:
    if avcc[:1] != b"\x01" or len(avcc) < 5:
        return 4
    return (avcc[4] & 3) + 1


def annexb_to_lp(data: bytes, strip_ps: bool = True) -> bytes:
    """Annex-B access unit -> 4-byte length-prefixed NALs (drops SPS/PPS
    when strip_ps — they live in avcC)."""
    from librempeg_tpu_torch.codecs.h264.parse import split_annexb

    out = bytearray()
    for nal in split_annexb(bytes(data)):
        if strip_ps and (nal[0] & 0x1F) in (7, 8):
            continue
        out += struct.pack(">I", len(nal)) + nal
    return bytes(out)


def lp_to_annexb(data: bytes, nal_size: int = 4,
                 force: bool = False) -> bytes:
    """Length-prefixed NALs -> annex-B.

    force=True skips the "already annex-B" sniff — callers that KNOW
    the payload is length-prefixed (ISO samples, avcC-mkv blocks) must
    set it: a 4-byte length prefix of a 256..511-byte NAL is
    00 00 01 XX, genuinely ambiguous with a 3-byte start code."""
    data = bytes(data)
    if not force:
        # sniff with NAL-header validation (forbidden_zero_bit clear,
        # nal_type != 0) — heuristic, for context-free callers only
        for sc in (3, 4):
            if data[:sc] == _SC[4 - sc:] and len(data) > sc \
                    and not (data[sc] & 0x80) and (data[sc] & 0x1F):
                return data                     # already annex-B
    out = bytearray()
    pos = 0
    while pos + nal_size <= len(data):
        ln = int.from_bytes(data[pos:pos + nal_size], "big")
        pos += nal_size
        if ln <= 0 or pos + ln > len(data):
            raise InvalidData("h264: bad NAL length prefix")
        out += _SC + data[pos:pos + ln]
        pos += ln
    return bytes(out)
