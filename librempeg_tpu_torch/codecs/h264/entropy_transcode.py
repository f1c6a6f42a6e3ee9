"""H.264 entropy transcoding: CAVLC -> CABAC without touching pixels.

Each slice's entropy layer is decoded to per-MB tensors (the native
CAVLC walk) and re-encoded with the CABAC engine (native/h264.cpp
h264_cabac_slice mode 1); the PPS gains entropy_coding_mode_flag=1 and
P slice headers gain cabac_init_idc. Reconstruction is untouched, so a
conformant decoder produces bit-identical frames from both streams --
which is exactly how the CABAC engine is validated against the
reference decoder in tests/test_h264_cabac.py.

Role analog: the reference's cbs-based bitstream rewriting
(libavcodec/cbs.c) -- here at the entropy-recode level the reference
does not offer.

Limitations match the CAVLC layer: frame MBs, 4:2:0, I/P slices.

A copy of librempeg_tpu/codecs/h264/entropy_transcode.py (host code, no
JAX), imports rewritten.
"""
from __future__ import annotations

import numpy as np

from librempeg_tpu_torch.codecs.h264.intra import _rbsp_to_nal
from librempeg_tpu_torch.codecs.h264.parse import (
    NalUnit,
    parse_pps,
    parse_slice_header,
    parse_sps,
    split_annexb,
)
from librempeg_tpu_torch.core.errors import InvalidData


class _BitCursor:
    """Bit-exact copy/patch over an rbsp."""

    def __init__(self):
        self.bits: list[int] = []

    def copy(self, data: bytes, start: int, end: int) -> None:
        for p in range(start, end):
            self.bits.append((data[p >> 3] >> (7 - (p & 7))) & 1)

    def put(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def put_ue(self, v: int) -> None:
        code = v + 1
        n = code.bit_length()
        self.put(0, n - 1)
        self.put(code, n)

    def align_ones(self) -> None:
        while len(self.bits) % 8:
            self.bits.append(1)

    def bytes(self) -> bytes:
        assert len(self.bits) % 8 == 0
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for j in range(8):
                b = (b << 1) | self.bits[i + j]
            out.append(b)
        return bytes(out)


def _pps_set_cabac(rbsp: bytes) -> bytes:
    """Flip entropy_coding_mode_flag (bit after two leading ue(v))."""
    bits = _BitCursor()
    bits.copy(rbsp, 0, len(rbsp) * 8)
    pos = 0

    def skip_ue():
        nonlocal pos
        zeros = 0
        while bits.bits[pos] == 0:
            zeros += 1
            pos += 1
        pos += 1 + zeros

    skip_ue()          # pic_parameter_set_id
    skip_ue()          # seq_parameter_set_id
    if bits.bits[pos] != 0:
        raise InvalidData("PPS already CABAC")
    bits.bits[pos] = 1
    return bits.bytes()


class EntropyTranscoder:
    """Stateful CAVLC -> CABAC recoder over annex-B chunks (tracks
    SPS/PPS across packets so it plugs in as a bitstream filter or an
    encoder back-end)."""

    def __init__(self):
        self.sps = None
        self.pps = None

    def feed(self, annexb: bytes) -> bytes:
        from librempeg_tpu_torch.native import build as native

        out = bytearray()
        for raw in split_annexb(annexb):
            nal = NalUnit.parse(raw)
            if nal.type == 7:
                self.sps = parse_sps(nal.rbsp)
                out += b"\x00\x00\x00\x01" + raw
            elif nal.type == 8:
                self.pps = parse_pps(nal.rbsp, self.sps)
                if self.pps.entropy_coding_mode:
                    raise InvalidData("input is already CABAC")
                out += _rbsp_to_nal(_pps_set_cabac(nal.rbsp), 8,
                                    nal.ref_idc)
            elif nal.type in (1, 5):
                if self.sps is None or self.pps is None:
                    raise InvalidData("slice before SPS/PPS")
                sh = parse_slice_header(nal.rbsp, self.sps, self.pps,
                                        nal.type, nal.ref_idc)
                mb_w = self.sps.pic_width_in_mbs
                mb_h = self.sps.pic_height_in_map_units
                st = {"P": 0, "B": 1}.get(sh.slice_type, 2)
                res = native.h264_decode_slice_cavlc(
                    nal.rbsp, sh.data_bit_pos, mb_w, mb_h, sh.first_mb,
                    st, sh.qp, sh.num_ref_idx_l0, sh.num_ref_idx_l1,
                    transform_8x8_mode=self.pps.transform_8x8_mode)
                if res["last_mb"] != mb_w * mb_h or sh.first_mb != 0:
                    raise InvalidData(
                        "entropy transcode: multi-slice frame")
                if np.any(res["kind"] == 4):
                    # CABAC I_PCM needs an engine re-init mid-slice
                    # (§9.3.1.2), which the recode path does not carry
                    raise InvalidData(
                        "entropy transcode: I_PCM macroblocks")
                payload = native.h264_encode_slice_cabac(
                    res, mb_w, mb_h, st, sh.qp, sh.num_ref_idx_l0, 0,
                    sh.num_ref_idx_l1,
                    transform_8x8_mode=self.pps.transform_8x8_mode)
                bc = _BitCursor()
                bc.copy(nal.rbsp, 0, sh.bitpos_cabac_idc)
                if sh.slice_type in ("P", "B"):
                    bc.put_ue(0)           # cabac_init_idc
                bc.copy(nal.rbsp, sh.bitpos_cabac_idc, sh.data_bit_pos)
                bc.align_ones()            # cabac_alignment_one_bit
                rbsp = bc.bytes() + payload
                out += _rbsp_to_nal(rbsp, nal.type, nal.ref_idc)
            else:
                out += b"\x00\x00\x00\x01" + raw
        return bytes(out)


def cavlc_to_cabac(annexb: bytes) -> bytes:
    """Transcode one annex-B access unit sequence CAVLC -> CABAC."""
    return EntropyTranscoder().feed(annexb)
