"""HEVC parameter sets + slice headers: parse AND write.

Minimal Main-profile intra feature point (the generator writes exactly
what the decoder consumes; both are validated against the reference
decoder): 8-bit 4:2:0, one slice per picture, SAO/PCM/AMP/scaling
lists/tiles/WPP off, deblocking controllable.

Syntax reference: ITU-T H.265 §7.3 (behavioral reference
libavcodec/hevc/ps.c).

A copy of librempeg_tpu/codecs/hevc/ps.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

from dataclasses import dataclass

from librempeg_tpu_torch.codecs.flac.bitio import BitWriterMSB
from librempeg_tpu_torch.codecs.h264.intra import _write_se, _write_ue
from librempeg_tpu_torch.codecs.h264.parse import ExpGolombReader
from librempeg_tpu_torch.core.errors import InvalidData, Unsupported

NAL_TRAIL_R = 1
NAL_IDR_W_RADL = 19
NAL_VPS, NAL_SPS, NAL_PPS = 32, 33, 34


def nal_header(nal_type: int) -> bytes:
    return bytes([(nal_type << 1), 1])     # layer 0, tid+1 = 1


def rbsp_to_nal(rbsp: bytes, nal_type: int) -> bytes:
    out = bytearray(b"\x00\x00\x00\x01" + nal_header(nal_type))
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def split_nals(data: bytes, raw: bool = False):
    """[(nal_type, rbsp bytes)] from an annex-B HEVC stream.
    With raw=True the escaped NAL bytes (incl. 2-byte header) are
    returned instead of the unescaped RBSP."""
    from librempeg_tpu_torch.codecs.h264.parse import (
        remove_emulation_prevention, split_annexb)

    out = []
    for nal in split_annexb(data):
        if len(nal) < 3:
            continue
        ntype = (nal[0] >> 1) & 0x3F
        out.append((ntype, nal if raw
                    else remove_emulation_prevention(nal[2:])))
    return out


@dataclass
class HevcSPS:
    width: int = 0                  # coded size (multiple of min CB)
    height: int = 0
    # conformance window (§7.4.3.2.1), in LUMA samples; output size is
    # width - crop_l - crop_r x height - crop_t - crop_b
    crop_l: int = 0
    crop_r: int = 0
    crop_t: int = 0
    crop_b: int = 0
    chroma_format_idc: int = 1
    log2_min_cb: int = 3
    log2_ctb: int = 5
    log2_min_tb: int = 2
    log2_max_tb: int = 5
    max_transform_hierarchy_depth_intra: int = 1
    max_transform_hierarchy_depth_inter: int = 0
    log2_max_poc_lsb: int = 8
    fps_num: int = 25
    fps_den: int = 1
    sao_enabled: bool = False
    amp_enabled: bool = False
    strong_intra_smoothing: bool = False
    max_dec_pic_buffering: int = 1
    num_reorder: int = 0            # sps_max_num_reorder_pics

    @property
    def ctb_size(self) -> int:
        return 1 << self.log2_ctb

    @property
    def out_width(self) -> int:
        return self.width - self.crop_l - self.crop_r

    @property
    def out_height(self) -> int:
        return self.height - self.crop_t - self.crop_b

    @property
    def pic_w_ctb(self) -> int:
        return -(-self.width // self.ctb_size)

    @property
    def pic_h_ctb(self) -> int:
        return -(-self.height // self.ctb_size)


@dataclass
class HevcPPS:
    init_qp: int = 26
    sign_data_hiding: bool = False
    cabac_init_present: bool = False
    cu_qp_delta_enabled: bool = False
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    transform_skip_enabled: bool = False
    deblocking_disabled: bool = True
    beta_offset: int = 0            # beta_offset_div2 * 2
    tc_offset: int = 0              # tc_offset_div2 * 2
    loop_filter_across_slices: bool = True


def _write_ptl(bw: BitWriterMSB) -> None:
    """profile_tier_level for Main, level 4.0 (§7.3.3)."""
    bw.write(0, 2)                  # profile_space
    bw.write(0, 1)                  # tier
    bw.write(1, 5)                  # profile_idc: Main
    bw.write(1 << 30, 32)           # compat flags: bit for Main
    bw.write(1, 1)                  # progressive_source
    bw.write(0, 1)                  # interlaced_source
    bw.write(1, 1)                  # non_packed_constraint
    bw.write(1, 1)                  # frame_only_constraint
    bw.write(0, 32)                 # reserved 44 bits
    bw.write(0, 12)
    bw.write(120, 8)                # level_idc 4.0


def _parse_ptl(g: ExpGolombReader) -> None:
    g.u(2 + 1 + 5)
    g.u(32)
    g.u(4)
    g.u(32)
    g.u(12)
    g.u(8)


def write_vps() -> bytes:
    bw = BitWriterMSB()
    bw.write(0, 4)                  # vps id
    bw.write(3, 2)                  # base_layer_internal/available (re-
    bw.write(0, 6)                  # served '11' + max_layers_minus1
    bw.write(0, 3)                  # max_sub_layers_minus1
    bw.write(1, 1)                  # temporal_id_nesting
    bw.write(0xFFFF, 16)            # reserved
    _write_ptl(bw)
    bw.write(0, 1)                  # sub_layer_ordering_info_present
    _write_ue(bw, 1)                # max_dec_pic_buffering_minus1
    _write_ue(bw, 0)                # num_reorder_pics
    _write_ue(bw, 0)                # max_latency_increase
    bw.write(0, 6)                  # max_layer_id
    _write_ue(bw, 0)                # num_layer_sets_minus1
    bw.write(0, 1)                  # timing_info_present
    bw.write(0, 1)                  # extension
    bw.write(1, 1)
    bw.align()
    return rbsp_to_nal(bw.bytes(), NAL_VPS)


def write_sps(sps: HevcSPS) -> bytes:
    bw = BitWriterMSB()
    bw.write(0, 4)                  # sps_video_parameter_set_id
    bw.write(0, 3)                  # max_sub_layers_minus1
    bw.write(1, 1)                  # temporal_id_nesting
    _write_ptl(bw)
    _write_ue(bw, 0)                # sps id
    _write_ue(bw, sps.chroma_format_idc)
    _write_ue(bw, sps.width)
    _write_ue(bw, sps.height)
    crop = sps.crop_l or sps.crop_r or sps.crop_t or sps.crop_b
    bw.write(1 if crop else 0, 1)   # conformance_window_flag
    if crop:
        # offsets in units of SubWidthC/SubHeightC (2 for 4:2:0)
        _write_ue(bw, sps.crop_l // 2)
        _write_ue(bw, sps.crop_r // 2)
        _write_ue(bw, sps.crop_t // 2)
        _write_ue(bw, sps.crop_b // 2)
    _write_ue(bw, 0)                # bit_depth_luma - 8
    _write_ue(bw, 0)                # bit_depth_chroma - 8
    _write_ue(bw, sps.log2_max_poc_lsb - 4)
    bw.write(0, 1)                  # sub_layer_ordering_info_present
    _write_ue(bw, sps.max_dec_pic_buffering)   # minus1
    _write_ue(bw, sps.num_reorder)
    _write_ue(bw, 0)                # max_latency
    _write_ue(bw, sps.log2_min_cb - 3)
    _write_ue(bw, sps.log2_ctb - sps.log2_min_cb)
    _write_ue(bw, sps.log2_min_tb - 2)
    _write_ue(bw, sps.log2_max_tb - sps.log2_min_tb)
    _write_ue(bw, sps.max_transform_hierarchy_depth_inter)
    _write_ue(bw, sps.max_transform_hierarchy_depth_intra)
    bw.write(0, 1)                  # scaling_list_enabled
    bw.write(1 if sps.amp_enabled else 0, 1)
    bw.write(1 if sps.sao_enabled else 0, 1)
    bw.write(0, 1)                  # pcm_enabled
    _write_ue(bw, 0)                # num_short_term_ref_pic_sets
    bw.write(0, 1)                  # long_term_ref_pics_present
    bw.write(0, 1)                  # temporal_mvp_enabled
    bw.write(1 if sps.strong_intra_smoothing else 0, 1)
    bw.write(1, 1)                  # vui_present
    # VUI (§E.2.1): only timing_info, so container-less streams carry
    # a frame rate (the reference CFR-fills rawvideo output otherwise)
    bw.write(0, 1)                  # aspect_ratio_info_present
    bw.write(0, 1)                  # overscan_info_present
    bw.write(0, 1)                  # video_signal_type_present
    bw.write(0, 1)                  # chroma_loc_info_present
    bw.write(0, 1)                  # neutral_chroma_indication
    bw.write(0, 1)                  # field_seq
    bw.write(0, 1)                  # frame_field_info_present
    bw.write(0, 1)                  # default_display_window
    bw.write(1, 1)                  # timing_info_present
    bw.write(sps.fps_den, 32)       # num_units_in_tick
    bw.write(sps.fps_num, 32)       # time_scale
    bw.write(0, 1)                  # poc_proportional_to_timing
    bw.write(0, 1)                  # hrd_parameters_present
    bw.write(0, 1)                  # bitstream_restriction
    bw.write(0, 1)                  # sps_extension
    bw.write(1, 1)
    bw.align()
    return rbsp_to_nal(bw.bytes(), NAL_SPS)


def parse_sps(rbsp: bytes) -> HevcSPS:
    g = ExpGolombReader(rbsp)
    s = HevcSPS()
    g.u(4)
    max_sub = g.u(3)
    g.u(1)
    _parse_ptl(g)
    if g.ue() != 0:
        raise Unsupported("hevc: multiple SPS ids")
    s.chroma_format_idc = g.ue()
    if s.chroma_format_idc != 1:
        raise Unsupported("hevc: chroma format != 4:2:0")
    s.width = g.ue()
    s.height = g.ue()
    if g.u(1):                      # conformance window
        s.crop_l = g.ue() * 2       # 4:2:0: SubWidthC = SubHeightC = 2
        s.crop_r = g.ue() * 2
        s.crop_t = g.ue() * 2
        s.crop_b = g.ue() * 2
    if g.ue() or g.ue():
        raise Unsupported("hevc: bit depth > 8")
    s.log2_max_poc_lsb = g.ue() + 4
    sub_info = g.u(1)
    for _ in range((max_sub + 1) if sub_info else 1):
        s.max_dec_pic_buffering = g.ue()
        s.num_reorder = g.ue()
        g.ue()
    s.log2_min_cb = g.ue() + 3
    s.log2_ctb = s.log2_min_cb + g.ue()
    s.log2_min_tb = g.ue() + 2
    s.log2_max_tb = s.log2_min_tb + g.ue()
    s.max_transform_hierarchy_depth_inter = g.ue()
    s.max_transform_hierarchy_depth_intra = g.ue()
    if g.u(1):
        raise Unsupported("hevc: scaling lists")
    s.amp_enabled = bool(g.u(1))
    s.sao_enabled = bool(g.u(1))
    if g.u(1):
        raise Unsupported("hevc: PCM")
    if g.ue():
        raise Unsupported("hevc: short-term RPS sets")
    if g.u(1):
        raise Unsupported("hevc: long-term ref pics")
    g.u(1)                          # temporal_mvp
    s.strong_intra_smoothing = bool(g.u(1))
    if g.u(1):                      # vui_present (timing only)
        if g.u(1):                  # aspect_ratio_info
            idc = g.u(8)
            if idc == 255:
                g.u(16), g.u(16)
        if g.u(1):                  # overscan
            g.u(1)
        if g.u(1):                  # video_signal_type
            g.u(3), g.u(1)
            if g.u(1):
                g.u(8), g.u(8), g.u(8)
        if g.u(1):                  # chroma_loc
            g.ue(), g.ue()
        g.u(3)                      # neutral/field_seq/frame_field
        if g.u(1):                  # default display window
            g.ue(), g.ue(), g.ue(), g.ue()
        if g.u(1):                  # timing_info
            s.fps_den = g.u(32)
            s.fps_num = g.u(32)
            if g.u(1):              # poc_proportional
                g.ue()
            if g.u(1):
                raise Unsupported("hevc: HRD parameters")
    return s


def write_pps(pps: HevcPPS) -> bytes:
    bw = BitWriterMSB()
    _write_ue(bw, 0)
    _write_ue(bw, 0)
    bw.write(0, 1)                  # dependent_slice_segments
    bw.write(0, 1)                  # output_flag_present
    bw.write(0, 3)                  # num_extra_slice_header_bits
    bw.write(1 if pps.sign_data_hiding else 0, 1)
    bw.write(1 if pps.cabac_init_present else 0, 1)
    _write_ue(bw, 0)                # num_ref_idx_l0_default - 1
    _write_ue(bw, 0)
    _write_se(bw, pps.init_qp - 26)
    bw.write(0, 1)                  # constrained_intra_pred
    bw.write(1 if pps.transform_skip_enabled else 0, 1)
    bw.write(1 if pps.cu_qp_delta_enabled else 0, 1)
    if pps.cu_qp_delta_enabled:
        _write_ue(bw, 0)
    _write_se(bw, pps.cb_qp_offset)
    _write_se(bw, pps.cr_qp_offset)
    bw.write(0, 1)                  # slice_chroma_qp_offsets_present
    bw.write(0, 1)                  # weighted_pred
    bw.write(0, 1)                  # weighted_bipred
    bw.write(0, 1)                  # transquant_bypass
    bw.write(0, 1)                  # tiles
    bw.write(0, 1)                  # entropy_coding_sync
    bw.write(1, 1)                  # loop_filter_across_slices
    bw.write(1, 1)                  # deblocking_filter_control_present
    bw.write(0, 1)                  # deblocking_filter_override_enabled
    bw.write(1 if pps.deblocking_disabled else 0, 1)
    if not pps.deblocking_disabled:
        _write_se(bw, pps.beta_offset // 2)
        _write_se(bw, pps.tc_offset // 2)
    bw.write(0, 1)                  # pps_scaling_list_data_present
    bw.write(0, 1)                  # lists_modification_present
    _write_ue(bw, 0)                # log2_parallel_merge_level - 2
    bw.write(0, 1)                  # slice_header_extension
    bw.write(0, 1)                  # pps_extension
    bw.write(1, 1)
    bw.align()
    return rbsp_to_nal(bw.bytes(), NAL_PPS)


def parse_pps(rbsp: bytes) -> HevcPPS:
    g = ExpGolombReader(rbsp)
    p = HevcPPS()
    if g.ue() or g.ue():
        raise Unsupported("hevc: multiple PPS/SPS ids")
    if g.u(1):
        raise Unsupported("hevc: dependent slice segments")
    g.u(1)
    if g.u(3):
        raise Unsupported("hevc: extra slice header bits")
    p.sign_data_hiding = bool(g.u(1))
    p.cabac_init_present = bool(g.u(1))
    g.ue(), g.ue()
    p.init_qp = 26 + g.se()
    if g.u(1):
        raise Unsupported("hevc: constrained intra pred")
    p.transform_skip_enabled = bool(g.u(1))
    if p.transform_skip_enabled:
        raise Unsupported("hevc: transform skip")
    p.cu_qp_delta_enabled = bool(g.u(1))
    if p.cu_qp_delta_enabled:
        raise Unsupported("hevc: cu qp delta")
    p.cb_qp_offset = g.se()
    p.cr_qp_offset = g.se()
    if g.u(1):
        raise Unsupported("hevc: slice chroma qp offsets")
    if g.u(1) or g.u(1):
        raise Unsupported("hevc: weighted prediction")
    if g.u(1):
        raise Unsupported("hevc: transquant bypass")
    if g.u(1) or g.u(1):
        raise Unsupported("hevc: tiles / WPP")
    p.loop_filter_across_slices = bool(g.u(1))
    if g.u(1):                      # deblocking control present
        if g.u(1):
            raise Unsupported("hevc: deblocking override")
        p.deblocking_disabled = bool(g.u(1))
        if not p.deblocking_disabled:
            p.beta_offset = g.se() * 2
            p.tc_offset = g.se() * 2
    else:
        p.deblocking_disabled = False
    if g.u(1):
        raise Unsupported("hevc: PPS scaling lists")
    if g.u(1):
        raise Unsupported("hevc: ref list modification")
    g.ue()
    return p


@dataclass
class HevcSliceHeader:
    slice_type: int = 2             # 2 = I, 1 = P, 0 = B
    qp: int = 26
    data_bit_pos: int = 0
    first_slice: bool = True
    segment_address: int = 0        # CTB raster address of this slice
    poc_lsb: int = 0
    poc_delta: int = 1              # st RPS: negative (past) ref delta
    poc_delta_pos: int = 0          # st RPS: positive (future) delta
    max_merge: int = 5
    mvd_l1_zero: bool = False
    sao_luma: bool = False
    sao_chroma: bool = False

    @property
    def init_type(self) -> int:
        """CABAC initType (§9.3.2.2): I -> 0, P -> 1, B -> 2
        (cabac_init_flag 0)."""
        return {2: 0, 1: 1, 0: 2}[self.slice_type]


def write_slice_header(sps: HevcSPS, pps: HevcPPS, qp: int, *,
                       slice_type: int = 2, poc_lsb: int = 0,
                       poc_delta: int = 1, poc_delta_pos: int = 0,
                       max_merge: int = 5, mvd_l1_zero: bool = False,
                       sao_luma: bool = False,
                       sao_chroma: bool = False, first_slice: bool = True,
                       segment_address: int = 0) -> BitWriterMSB:
    """Slice segment header bits (IDR I, or a TRAIL_R P/B slice with a
    one-past(+one-future for B) short-term RPS); CABAC data is appended
    byte-aligned after these bits."""
    bw = BitWriterMSB()
    bw.write(1 if first_slice else 0, 1)   # first_slice_segment_in_pic
    if slice_type == 2:
        bw.write(0, 1)              # no_output_of_prior_pics (IRAP)
    _write_ue(bw, 0)                # pps id
    if not first_slice:
        n_ctb = sps.pic_w_ctb * sps.pic_h_ctb
        bits = max(1, (n_ctb - 1).bit_length())
        bw.write(segment_address, bits)
    _write_ue(bw, slice_type)
    if slice_type != 2:
        bw.write(poc_lsb, sps.log2_max_poc_lsb)
        bw.write(0, 1)              # short_term_ref_pic_set_sps_flag
        # st_ref_pic_set(0): one negative (past) reference, plus one
        # positive (future) reference for B slices
        _write_ue(bw, 1)            # num_negative_pics
        _write_ue(bw, 1 if slice_type == 0 else 0)  # num_positive_pics
        _write_ue(bw, poc_delta - 1)
        bw.write(1, 1)              # used_by_curr_pic_s0
        if slice_type == 0:
            _write_ue(bw, poc_delta_pos - 1)
            bw.write(1, 1)          # used_by_curr_pic_s1
    if sps.sao_enabled:
        bw.write(1 if sao_luma else 0, 1)
        bw.write(1 if sao_chroma else 0, 1)
    if slice_type != 2:
        bw.write(0, 1)              # num_ref_idx_active_override
        if slice_type == 0:
            bw.write(1 if mvd_l1_zero else 0, 1)
        _write_ue(bw, 5 - max_merge)
    _write_se(bw, qp - pps.init_qp)
    # deblocking control present + override disabled: no override flag.
    # §7.3.6.1: slice_loop_filter_across_slices_enabled_flag is present
    # when the PPS across-slices flag is set AND any in-loop filter is
    # active for the slice (deblocking or SAO)
    if pps.loop_filter_across_slices and (
            sao_luma or sao_chroma or not pps.deblocking_disabled):
        bw.write(1, 1)              # slice_loop_filter_across_slices
    bw.write(1, 1)                  # alignment bit (byte_alignment())
    bw.align()
    return bw


def parse_slice_header(rbsp: bytes, sps: HevcSPS, pps: HevcPPS,
                       nal_type: int) -> HevcSliceHeader:
    g = ExpGolombReader(rbsp)
    sh = HevcSliceHeader()
    sh.first_slice = bool(g.u(1))
    if 16 <= nal_type <= 23:        # IRAP
        g.u(1)                      # no_output_of_prior_pics
    if g.ue() != 0:
        raise InvalidData("hevc: bad pps id")
    if not sh.first_slice:
        n_ctb = sps.pic_w_ctb * sps.pic_h_ctb
        bits = max(1, (n_ctb - 1).bit_length())
        sh.segment_address = g.u(bits)
        if not 0 < sh.segment_address < n_ctb:
            raise InvalidData("hevc: bad slice segment address")
    sh.slice_type = g.ue()
    if sh.slice_type not in (0, 1, 2):
        raise InvalidData("hevc: bad slice type")
    if nal_type not in (19, 20):
        sh.poc_lsb = g.u(sps.log2_max_poc_lsb)
        if g.u(1):                  # short_term_ref_pic_set_sps_flag
            raise Unsupported("hevc: SPS short-term RPS")
        n_neg = g.ue()
        n_pos = g.ue()
        if n_neg != 1 or n_pos > 1:
            raise Unsupported("hevc: multi-picture RPS")
        sh.poc_delta = g.ue() + 1
        if not g.u(1):
            raise Unsupported("hevc: unused RPS pictures")
        if n_pos:
            sh.poc_delta_pos = g.ue() + 1
            if not g.u(1):
                raise Unsupported("hevc: unused RPS pictures")
        if sh.slice_type == 0 and n_pos != 1:
            raise InvalidData("hevc: B slice without future ref")
    if sps.sao_enabled:
        sh.sao_luma = bool(g.u(1))
        sh.sao_chroma = bool(g.u(1))
    if sh.slice_type != 2:
        if g.u(1):                  # num_ref_idx_active_override
            raise Unsupported("hevc: ref idx override")
        if sh.slice_type == 0:
            sh.mvd_l1_zero = bool(g.u(1))
        sh.max_merge = 5 - g.ue()
        if not 1 <= sh.max_merge <= 5:
            raise InvalidData("hevc: bad merge cand count")
    sh.qp = pps.init_qp + g.se()
    if pps.loop_filter_across_slices and (
            sh.sao_luma or sh.sao_chroma
            or not pps.deblocking_disabled):
        g.u(1)                      # slice_loop_filter_across_slices
    # byte alignment: one 1-bit + zeros
    if g.u(1) != 1:
        raise InvalidData("hevc: slice header alignment")
    pos = g.pos
    sh.data_bit_pos = (pos + 7) & ~7
    return sh
