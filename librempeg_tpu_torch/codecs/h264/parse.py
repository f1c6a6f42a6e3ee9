"""H.264/AVC bitstream foundation: NAL units, exp-Golomb, SPS/PPS,
slice headers, annex-B framing.

Analog of the parsing layers of libavcodec/h264dec.c /
h2645_parse.c / h264_ps.c (and the cbs_h2645 syntax reader). This is
the round-1 foundation for the H.264 decoder: the macroblock layer
(CAVLC/CABAC entropy + prediction/IDCT on device) builds on it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from librempeg_tpu_torch.core.errors import InvalidData, Unsupported


class ExpGolombReader:
    """MSB-first bit reader with ue(v)/se(v) (ITU-T H.264 §9.1)."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 31:
                raise InvalidData("exp-golomb overflow")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) >> 1 if k & 1 else -(k >> 1)

    def more_rbsp(self) -> bool:
        return self.pos < len(self.data) * 8 - 8

    def more_rbsp_data(self) -> bool:
        """Precise more_rbsp_data() (§7.2): data remains iff any bit is
        set strictly after pos (the rbsp_stop_one_bit is the last)."""
        for i in range(len(self.data) - 1, -1, -1):
            b = self.data[i]
            if b:
                last = i * 8 + (7 - (b & -b).bit_length() + 1)
                return self.pos < last
        return False


def remove_emulation_prevention(data: bytes) -> bytes:
    """00 00 03 -> 00 00 (rbsp extraction). bytes.replace scans
    left-to-right non-overlapping, exactly the escape-removal order."""
    return data.replace(b"\x00\x00\x03", b"\x00\x00")


def split_annexb(data: bytes) -> list[bytes]:
    """Split an annex-B stream into NAL units (without start codes).

    Start-code positions found vectorized (the 3-byte pattern cannot
    self-overlap, so every candidate is a real boundary)."""
    import numpy as np

    n = len(data)
    if n < 4:
        return []
    a = np.frombuffer(data, np.uint8)
    sc = np.flatnonzero((a[:-2] == 0) & (a[1:-1] == 0) & (a[2:] == 1))
    if sc.size == 0:
        return []
    nals = []
    for k in range(sc.size):
        start = int(sc[k]) + 3
        end = int(sc[k + 1]) if k + 1 < sc.size else n
        while end > start and data[end - 1] == 0:
            end -= 1
        if end > start:
            nals.append(data[start:end])
    return nals


@dataclass
class NalUnit:
    type: int
    ref_idc: int
    rbsp: bytes

    TYPE_NAMES = {1: "slice", 5: "idr_slice", 6: "sei", 7: "sps", 8: "pps",
                  9: "aud", 10: "end_seq", 11: "end_stream"}

    @staticmethod
    def parse(nal: bytes) -> "NalUnit":
        if not nal:
            raise InvalidData("empty NAL")
        hdr = nal[0]
        if hdr & 0x80:
            raise InvalidData("NAL forbidden_zero_bit set")
        return NalUnit(type=hdr & 0x1F, ref_idc=(hdr >> 5) & 3,
                       rbsp=remove_emulation_prevention(nal[1:]))


def _parse_scaling_list(g: "ExpGolombReader", size: int,
                        default: tuple, fallback: tuple) -> tuple:
    """scaling_list() (§7.3.2.1.1): returns `size` weights in RASTER
    order. Absent list -> fallback; first delta driving nextScale to 0
    -> the default list (Table 7-2 'use default' escape)."""
    from librempeg_tpu_torch.codecs.h264 import high_tables as HT

    scan = HT.ZZ4 if size == 16 else HT.ZZ8
    if not g.u(1):                       # scaling_list_present_flag
        return tuple(fallback)
    out = [0] * size
    last, nxt = 8, 8
    for j in range(size):
        if nxt:
            delta = g.se()
            if delta < -128 or delta > 127:
                raise InvalidData("h264: scaling list delta out of range")
            nxt = (last + delta) & 0xFF
            if j == 0 and nxt == 0:
                return tuple(default)
        out[scan[j]] = last = (nxt if nxt else last)
    return tuple(out)


def parse_scaling_matrices(g: "ExpGolombReader", sps: "SPS | None",
                           parse_8x8: bool):
    """All scaling lists at an SPS or PPS site (§7.3.2.1/7.3.2.2).

    Fallback rule (Table 7-2): at a PPS whose SPS carried matrices,
    absent lists 0/3/6/7 fall back to the SPS lists; otherwise to the
    defaults. Intermediate absent lists fall back to the previous one.
    Returns (mat4 [6][16], mat8 [2][64]) raster-order tuples
    (8x8: [intra Y, inter Y]; 4:2:0 only).
    """
    from librempeg_tpu_torch.codecs.h264 import high_tables as HT

    d4i, d4p = HT.DEFAULT_SCALING4
    d8i, d8p = HT.DEFAULT_SCALING8
    from_sps = sps is not None and sps.scaling_matrix4 is not None
    fb = [sps.scaling_matrix4[0] if from_sps else d4i,
          sps.scaling_matrix4[3] if from_sps else d4p,
          sps.scaling_matrix8[0] if from_sps else d8i,
          sps.scaling_matrix8[1] if from_sps else d8p]
    m4 = []
    m4.append(_parse_scaling_list(g, 16, d4i, fb[0]))         # intra Y
    m4.append(_parse_scaling_list(g, 16, d4i, m4[0]))         # intra Cb
    m4.append(_parse_scaling_list(g, 16, d4i, m4[1]))         # intra Cr
    m4.append(_parse_scaling_list(g, 16, d4p, fb[1]))         # inter Y
    m4.append(_parse_scaling_list(g, 16, d4p, m4[3]))         # inter Cb
    m4.append(_parse_scaling_list(g, 16, d4p, m4[4]))         # inter Cr
    m8 = []
    if parse_8x8:
        m8.append(_parse_scaling_list(g, 64, d8i, fb[2]))     # intra Y
        m8.append(_parse_scaling_list(g, 64, d8p, fb[3]))     # inter Y
    else:
        m8 = [fb[2], fb[3]]      # not coded here: inherit (ff memcpy)
    return tuple(m4), tuple(m8)


@dataclass
class SPS:
    profile_idc: int = 66
    level_idc: int = 30
    seq_parameter_set_id: int = 0
    log2_max_frame_num: int = 4
    pic_order_cnt_type: int = 0
    log2_max_poc_lsb: int = 4
    max_num_ref_frames: int = 1
    pic_width_in_mbs: int = 0
    pic_height_in_map_units: int = 0
    frame_mbs_only: bool = True
    mb_adaptive_frame_field: bool = False
    direct_8x8_inference: bool = True
    crop: tuple[int, int, int, int] = (0, 0, 0, 0)
    chroma_format_idc: int = 1
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    delta_pic_order_always_zero: bool = False
    num_reorder_frames: int = 0
    bitstream_restriction: bool = False  # VUI carried an explicit depth
    # High profile: raster-order scaling lists, or None when the SPS
    # carries none (flat-16 dequant)
    scaling_matrix4: tuple | None = None   # [6][16]
    scaling_matrix8: tuple | None = None   # [intraY, interY][64]

    @property
    def width(self) -> int:
        w = self.pic_width_in_mbs * 16
        return w - 2 * (self.crop[0] + self.crop[1])

    @property
    def height(self) -> int:
        h = self.pic_height_in_map_units * 16 * (1 if self.frame_mbs_only
                                                 else 2)
        return h - 2 * (self.crop[2] + self.crop[3]) * \
            (1 if self.frame_mbs_only else 2)


def parse_sps(rbsp: bytes) -> SPS:
    g = ExpGolombReader(rbsp)
    s = SPS()
    s.profile_idc = g.u(8)
    g.u(8)  # constraint flags + reserved
    s.level_idc = g.u(8)
    s.seq_parameter_set_id = g.ue()
    if s.profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128):
        s.chroma_format_idc = g.ue()
        if s.chroma_format_idc == 3:
            g.u(1)  # separate_colour_plane
        s.bit_depth_luma = g.ue() + 8
        s.bit_depth_chroma = g.ue() + 8
        if g.u(1):  # qpprime_y_zero_transform_bypass
            raise Unsupported("h264: transform bypass (lossless)")
        if g.u(1):  # seq_scaling_matrix_present
            s.scaling_matrix4, s.scaling_matrix8 = \
                parse_scaling_matrices(g, None, parse_8x8=True)
    s.log2_max_frame_num = g.ue() + 4
    s.pic_order_cnt_type = g.ue()
    if s.pic_order_cnt_type == 0:
        s.log2_max_poc_lsb = g.ue() + 4
    elif s.pic_order_cnt_type == 1:
        s.delta_pic_order_always_zero = bool(g.u(1))
        g.se()
        g.se()
        for _ in range(g.ue()):
            g.se()
    s.max_num_ref_frames = g.ue()
    g.u(1)  # gaps_in_frame_num_value_allowed
    s.pic_width_in_mbs = g.ue() + 1
    s.pic_height_in_map_units = g.ue() + 1
    s.frame_mbs_only = bool(g.u(1))
    if not s.frame_mbs_only:
        s.mb_adaptive_frame_field = bool(g.u(1))
    s.direct_8x8_inference = bool(g.u(1))
    if g.u(1):  # frame_cropping
        s.crop = (g.ue(), g.ue(), g.ue(), g.ue())
    # vui: only the subset our encoder writes is parsed (flags-off
    # everywhere except bitstream_restriction -> num_reorder_frames);
    # anything fancier keeps the conservative default
    try:
        if g.u(1):                       # vui present
            if g.u(1):                   # aspect ratio
                ar = g.u(8)
                if ar == 255:
                    g.u(32)
            if g.u(1):                   # overscan
                g.u(1)
            if g.u(1):                   # video signal type
                g.u(4)
                if g.u(1):
                    g.u(24)
            if g.u(1):                   # chroma loc
                g.ue()
                g.ue()
            if g.u(1):                   # timing
                g.u(65)
            h0 = g.u(1)                  # nal hrd
            if h0:
                raise ValueError
            h1 = g.u(1)                  # vcl hrd
            if h1:
                raise ValueError
            g.u(1)                       # pic_struct
            if g.u(1):                   # bitstream restriction
                g.u(1)
                g.ue()
                g.ue()
                g.ue()
                g.ue()
                s.num_reorder_frames = g.ue()
                s.bitstream_restriction = True
                g.ue()
    except Exception:
        pass
    return s


@dataclass
class PPS:
    pic_parameter_set_id: int = 0
    seq_parameter_set_id: int = 0
    entropy_coding_mode: int = 0       # 0=CAVLC 1=CABAC
    pic_order_present: bool = False
    num_ref_idx_l0: int = 1
    num_ref_idx_l1: int = 1
    weighted_pred: bool = False
    weighted_bipred_idc: int = 0
    pic_init_qp: int = 26
    chroma_qp_index_offset: int = 0
    deblocking_filter_control_present: bool = False
    constrained_intra_pred: bool = False
    redundant_pic_cnt_present: bool = False
    transform_8x8_mode: bool = False
    second_chroma_qp_index_offset: int | None = None
    # active scaling lists (PPS-level view after SPS inheritance), or
    # None for flat-16 dequant
    scaling_matrix4: tuple | None = None
    scaling_matrix8: tuple | None = None


def parse_pps(rbsp: bytes, sps: "SPS | None" = None) -> PPS:
    g = ExpGolombReader(rbsp)
    p = PPS()
    p.pic_parameter_set_id = g.ue()
    p.seq_parameter_set_id = g.ue()
    p.entropy_coding_mode = g.u(1)
    p.pic_order_present = bool(g.u(1))
    num_slice_groups = g.ue() + 1
    if num_slice_groups > 1:
        raise Unsupported("FMO slice groups")
    p.num_ref_idx_l0 = g.ue() + 1
    p.num_ref_idx_l1 = g.ue() + 1
    p.weighted_pred = bool(g.u(1))
    p.weighted_bipred_idc = g.u(2)
    p.pic_init_qp = g.se() + 26
    g.se()  # pic_init_qs
    p.chroma_qp_index_offset = g.se()
    p.deblocking_filter_control_present = bool(g.u(1))
    p.constrained_intra_pred = bool(g.u(1))
    p.redundant_pic_cnt_present = bool(g.u(1))
    # High-profile PPS tail (§7.3.2.2)
    if sps is not None and sps.scaling_matrix4 is not None:
        p.scaling_matrix4 = sps.scaling_matrix4
        p.scaling_matrix8 = sps.scaling_matrix8
    if g.more_rbsp_data():
        p.transform_8x8_mode = bool(g.u(1))
        if g.u(1):                       # pic_scaling_matrix_present
            p.scaling_matrix4, p.scaling_matrix8 = \
                parse_scaling_matrices(g, sps, p.transform_8x8_mode)
        p.second_chroma_qp_index_offset = g.se()
    return p


SLICE_TYPES = {0: "P", 1: "B", 2: "I", 3: "SP", 4: "SI",
               5: "P", 6: "B", 7: "I", 8: "SP", 9: "SI"}


@dataclass
class SliceHeader:
    first_mb: int = 0
    slice_type: str = "I"
    pps_id: int = 0
    frame_num: int = 0
    idr: bool = False
    qp: int = 26
    num_ref_idx_l0: int = 1
    cabac_init_idc: int = 0
    bitpos_cabac_idc: int = 0          # bit pos where cabac_init_idc sits
    poc_lsb: int = 0
    num_ref_idx_l1: int = 1
    direct_spatial: int = 1
    disable_deblock: int = 0       # disable_deblocking_filter_idc
    alpha_off: int = 0             # slice_alpha_c0_offset_div2 * 2
    beta_off: int = 0
    data_bit_pos: int = 0          # first bit of slice_data()
    # ref_pic_list_modification (§7.3.3.1): per list, a sequence of
    # (modification_idc, value) ops; idc 0/1 carry abs_diff_pic_num-1,
    # idc 2 carries long_term_pic_num
    ref_list_mods: tuple = ((), ())
    # pred_weight_table (§7.3.3.2): None = unweighted, else
    # (luma_log2_denom, chroma_log2_denom,
    #  [per list][per ref](wy, oy, wcb, ocb, wcr, ocr))
    pred_weights: tuple | None = None
    # dec_ref_pic_marking (§7.3.3.3): list of (mmco, v1, v2) ops
    mmco: tuple = ()


def parse_slice_header(rbsp: bytes, sps: SPS, pps: PPS,
                       nal_type: int, nal_ref_idc: int = 1) -> SliceHeader:
    """Full slice_header() for I/P CAVLC+CABAC slices (§7.3.3)."""
    g = ExpGolombReader(rbsp)
    sh = SliceHeader()
    sh.first_mb = g.ue()
    sh.slice_type = SLICE_TYPES.get(g.ue(), "?")
    sh.pps_id = g.ue()
    sh.frame_num = g.u(sps.log2_max_frame_num)
    sh.idr = nal_type == 5
    if sh.idr:
        g.ue()  # idr_pic_id
    if sps.pic_order_cnt_type == 0:
        sh.poc_lsb = g.u(sps.log2_max_poc_lsb)
        if pps.pic_order_present:
            g.se()
    elif sps.pic_order_cnt_type == 1 and not sps.delta_pic_order_always_zero:
        g.se()
        if pps.pic_order_present:
            g.se()
    if pps.redundant_pic_cnt_present:
        g.ue()
    sh.num_ref_idx_l0 = pps.num_ref_idx_l0
    sh.num_ref_idx_l1 = getattr(pps, "num_ref_idx_l1", 1)

    def _list_mods():
        ops = []
        if g.u(1):                  # ref_pic_list_modification_flag
            while True:
                idc = g.ue()
                if idc == 3:
                    break
                if idc > 3 or len(ops) > 64:
                    raise InvalidData("h264: bad ref list modification")
                ops.append((idc, g.ue()))
        return tuple(ops)

    if sh.slice_type == "B":
        sh.direct_spatial = g.u(1)
        if g.u(1):  # num_ref_idx_active_override
            sh.num_ref_idx_l0 = g.ue() + 1
            sh.num_ref_idx_l1 = g.ue() + 1
        sh.ref_list_mods = (_list_mods(), _list_mods())
    elif sh.slice_type in ("P", "SP"):
        if g.u(1):  # num_ref_idx_active_override
            sh.num_ref_idx_l0 = g.ue() + 1
        sh.ref_list_mods = (_list_mods(), ())
    if (pps.weighted_pred and sh.slice_type in ("P", "SP")) or \
            (getattr(pps, "weighted_bipred_idc", 0) == 1
             and sh.slice_type == "B"):
        # pred_weight_table (§7.3.3.2), 4:2:0 (chroma always coded)
        luma_denom = g.ue()
        chroma_denom = g.ue()
        if luma_denom > 7 or chroma_denom > 7:
            raise InvalidData("h264: weight denom out of range")
        lists = []
        nrefs = (sh.num_ref_idx_l0,) if sh.slice_type != "B" else \
            (sh.num_ref_idx_l0, sh.num_ref_idx_l1)
        for n in nrefs:
            ws = []
            for _ in range(n):
                wy, oy = 1 << luma_denom, 0
                wcb = wcr = 1 << chroma_denom
                ocb = ocr = 0
                if g.u(1):           # luma_weight_flag
                    wy, oy = g.se(), g.se()
                if g.u(1):           # chroma_weight_flag
                    wcb, ocb = g.se(), g.se()
                    wcr, ocr = g.se(), g.se()
                ws.append((wy, oy, wcb, ocb, wcr, ocr))
            lists.append(tuple(ws))
        sh.pred_weights = (luma_denom, chroma_denom, tuple(lists))
    if nal_ref_idc != 0:
        if sh.idr:
            g.u(1)  # no_output_of_prior_pics
            if g.u(1):  # long_term_reference_flag
                sh.mmco = ((6, 0, 0),)   # current becomes long-term 0
        else:
            if g.u(1):  # adaptive_ref_pic_marking_mode_flag
                ops = []
                while True:
                    op = g.ue()
                    if op == 0:
                        break
                    if op > 6 or len(ops) > 64:
                        raise InvalidData("h264: bad MMCO op")
                    v1 = v2 = 0
                    if op in (1, 3):
                        v1 = g.ue()       # difference_of_pic_nums - 1
                    if op == 2:
                        v1 = g.ue()       # long_term_pic_num
                    if op in (3, 6):
                        v2 = g.ue()       # long_term_frame_idx
                    if op == 4:
                        v1 = g.ue()       # max_long_term_frame_idx + 1
                    ops.append((op, v1, v2))
                sh.mmco = tuple(ops)
    sh.bitpos_cabac_idc = g.pos       # insertion point for CAVLC->CABAC
    if pps.entropy_coding_mode and sh.slice_type not in ("I", "SI"):
        sh.cabac_init_idc = g.ue()
    sh.qp = pps.pic_init_qp + g.se()
    if sh.slice_type == "SP":
        raise Unsupported("h264: SP slices")
    if pps.deblocking_filter_control_present:
        sh.disable_deblock = g.ue()
        if sh.disable_deblock != 1:
            sh.alpha_off = g.se() * 2
            sh.beta_off = g.se() * 2
    sh.data_bit_pos = g.pos
    return sh


class H264StreamParser:
    """Stateful annex-B stream parser: tracks SPS/PPS, reports stream
    properties (the AVCodecParser analog for h264)."""

    def __init__(self):
        self.sps: dict[int, SPS] = {}
        self.pps: dict[int, PPS] = {}
        self.width = 0
        self.height = 0

    def feed(self, data: bytes) -> list[NalUnit]:
        nals = [NalUnit.parse(n) for n in split_annexb(data)]
        for nal in nals:
            if nal.type == 7:
                s = parse_sps(nal.rbsp)
                self.sps[s.seq_parameter_set_id] = s
                self.width, self.height = s.width, s.height
            elif nal.type == 8:
                p = parse_pps(nal.rbsp,
                              next(iter(self.sps.values()), None))
                self.pps[p.pic_parameter_set_id] = p
        return nals
