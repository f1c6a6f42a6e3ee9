"""Annex-B <-> HEVCDecoderConfigurationRecord/length-prefixed NALs.

Analog of libavcodec/bsf/hevc_mp4toannexb.c and the
hvcC writer in libavformat/hevc.c: ISO/IEC 14496-15 §8.3.3.1 record
layout, 4-byte NAL length prefixes in samples.

A copy of librempeg_tpu/codecs/hevc/hvcc.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

import struct

from librempeg_tpu_torch.core.errors import InvalidData

_SC = b"\x00\x00\x00\x01"
_CFG_NALS = (32, 33, 34)                # VPS, SPS, PPS


def _split(data: bytes):
    from librempeg_tpu_torch.codecs.h264.parse import split_annexb

    return split_annexb(bytes(data))


def build_hvcc(annexb_extradata: bytes) -> bytes:
    """Annex-B VPS/SPS/PPS blob -> HEVCDecoderConfigurationRecord."""
    if annexb_extradata[:1] == b"\x01":
        return bytes(annexb_extradata)          # already hvcC
    arrays: dict[int, list[bytes]] = {t: [] for t in _CFG_NALS}
    for nal in _split(annexb_extradata):
        t = (nal[0] >> 1) & 0x3F
        if t in arrays:
            arrays[t].append(nal)
    if not arrays[33]:
        raise InvalidData("hvcC: extradata lacks SPS")
    sps = arrays[33][0]
    # profile_tier_level: 12 bytes at SPS RBSP offset 1 (after the
    # 2-byte NAL header and the vps_id/max_sub_layers/nesting byte);
    # valid while max_sub_layers == 1 (all our streams)
    ptl = sps[3:15]
    out = bytearray()
    out.append(1)                               # configurationVersion
    out += ptl[0:1]                             # space/tier/profile_idc
    out += ptl[1:5]                             # compatibility flags
    out += ptl[5:11]                            # constraint flags
    out += ptl[11:12]                           # level_idc
    out += struct.pack(">H", 0xF000)            # min_spatial_seg
    out.append(0xFC)                            # parallelismType 0
    out.append(0xFC | 1)                        # chromaFormat 4:2:0
    out.append(0xF8)                            # bitDepthLuma 8
    out.append(0xF8)                            # bitDepthChroma 8
    out += b"\x00\x00"                          # avgFrameRate
    out.append((1 << 3) | (1 << 2) | 3)         # 1 layer, nested, len 4
    out.append(sum(1 for t in _CFG_NALS if arrays[t]))
    for t in _CFG_NALS:
        if not arrays[t]:
            continue
        out.append(0x80 | t)                    # array_completeness=1
        out += struct.pack(">H", len(arrays[t]))
        for nal in arrays[t]:
            out += struct.pack(">H", len(nal)) + nal
    return bytes(out)


def hvcc_to_annexb(hvcc: bytes) -> bytes:
    """HEVCDecoderConfigurationRecord -> annex-B VPS/SPS/PPS blob."""
    if hvcc[:1] != b"\x01":
        return bytes(hvcc)                      # already annex-B
    if len(hvcc) < 23:
        raise InvalidData("hvcC: record too short")
    out = bytearray()
    pos = 23
    n_arrays = hvcc[22]
    for _ in range(n_arrays):
        pos += 1                                # completeness + type
        n = struct.unpack(">H", hvcc[pos:pos + 2])[0]
        pos += 2
        for _ in range(n):
            ln = struct.unpack(">H", hvcc[pos:pos + 2])[0]
            pos += 2
            out += _SC + hvcc[pos:pos + ln]
            pos += ln
    return bytes(out)


def nal_length_size(hvcc: bytes) -> int:
    if hvcc[:1] != b"\x01" or len(hvcc) < 22:
        return 4
    return (hvcc[21] & 3) + 1


def annexb_to_lp(data: bytes, strip_ps: bool = True) -> bytes:
    """Annex-B access unit -> 4-byte length-prefixed NALs (drops
    VPS/SPS/PPS when strip_ps — they live in hvcC)."""
    out = bytearray()
    for nal in _split(data):
        if strip_ps and ((nal[0] >> 1) & 0x3F) in _CFG_NALS:
            continue
        out += struct.pack(">I", len(nal)) + nal
    return bytes(out)


def lp_to_annexb(data: bytes, nal_size: int = 4,
                 force: bool = False) -> bytes:
    """Length-prefixed NALs -> annex-B (see h264/avcc.py lp_to_annexb
    for the force semantics — the sniff is ambiguous by construction)."""
    data = bytes(data)
    if not force:
        for sc in (3, 4):
            if data[:sc] == _SC[4 - sc:] and len(data) > sc \
                    and not (data[sc] & 0x80):
                return data
    out = bytearray()
    pos = 0
    while pos + nal_size <= len(data):
        ln = int.from_bytes(data[pos:pos + nal_size], "big")
        pos += nal_size
        if ln <= 0 or pos + ln > len(data):
            raise InvalidData("hevc: bad NAL length prefix")
        out += _SC + data[pos:pos + ln]
        pos += ln
    return bytes(out)
