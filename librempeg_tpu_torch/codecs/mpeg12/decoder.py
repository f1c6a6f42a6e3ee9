"""MPEG-1/2 video decoder (ISO/IEC 11172-2 / 13818-2).

Progressive frame pictures, 4:2:0, I/P/B, MP@ML feature set: the
profile point the reference's own encoder emits and the common payload
of MPEG-PS/TS files. Entropy decode walks the Annex-B VLCs
(codecs/mpeg12/tables.py, extracted normative data); dequantization
mirrors the reference decoder's inline forms (mpeg12dec.c
mpeg1/2_decode_block_* -- including the §7.4.4 mismatch control and
the historical no-mismatch mpeg1 path) and the IDCT is a numpy port of
the reference's simple_idct 8-bit numeric contract (row-pass DC
shortcut and int16 row storage included), so decoded frames are
bit-exact against the reference decoder (asserted in
tests/test_mpeg12.py).

Behavioral reference: libavcodec/mpeg12dec.c:2927
(decode loop), simple_idct_template.c (IDCT), mpegvideo motion comp.

A copy of librempeg_tpu/codecs/mpeg12/decoder.py (host code, no JAX),
imports rewritten; its frames carry tensors on `device` (default
"cuda"; numpy planes with device=None).
"""
from __future__ import annotations

import numpy as np

from librempeg_tpu_torch.codecs.api import CodecInfo, Decoder, register_decoder
from librempeg_tpu_torch.codecs.mpeg12 import tables as T
from librempeg_tpu_torch.core.errors import InvalidData, Unsupported
from librempeg_tpu_torch.core.frame import VideoFrame
from librempeg_tpu_torch.core.rational import Rational
from librempeg_tpu_torch.device import resolve

# picture_coding_type
PIC_I, PIC_P, PIC_B = 1, 2, 3


class Bits:
    """MSB-first bit reader over bytes."""

    __slots__ = ("d", "pos", "n")

    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0
        self.n = len(data) * 8

    def u(self, k: int) -> int:
        v = 0
        p = self.pos
        d = self.d
        for _ in range(k):
            v = (v << 1) | ((d[p >> 3] >> (7 - (p & 7))) & 1)
            p += 1
        self.pos = p
        return v

    def u1(self) -> int:
        p = self.pos
        self.pos = p + 1
        return (self.d[p >> 3] >> (7 - (p & 7))) & 1

    def peek(self, k: int) -> int:
        p = self.pos
        v = 0
        for _ in range(k):
            if p >= self.n:
                v <<= 1
            else:
                v = (v << 1) | ((self.d[p >> 3] >> (7 - (p & 7))) & 1)
            p += 1
        return v

    def more(self) -> bool:
        return self.pos < self.n


def _vlc_dict(pairs, symbols=None):
    """{(nbits, code): symbol} from a flat (code, bits) pair list."""
    out = {}
    for i in range(len(pairs) // 2):
        code, bits = pairs[2 * i], pairs[2 * i + 1]
        if bits == 0:
            continue
        out[(bits, code)] = symbols[i] if symbols is not None else i
    return out


def _read_vlc(br: Bits, table: dict, max_bits: int = 17):
    code = 0
    for n in range(1, max_bits + 1):
        code = (code << 1) | br.u1()
        sym = table.get((n, code))
        if sym is not None:
            return sym
    raise InvalidData("mpeg12: bad VLC code")


_MB_INC = _vlc_dict(T.MB_ADDR_INC)        # 0..32 = inc-1, 33 esc, 34 stuff
_MB_PAT = _vlc_dict(T.MB_PAT)
_MB_MV = _vlc_dict(T.MB_MV)               # motion_code magnitude 0..16
_MB_PTYPE = _vlc_dict(T.MB_PTYPE, T.PTYPE_FLAGS)
_MB_BTYPE = _vlc_dict(T.MB_BTYPE, T.BTYPE_FLAGS)
_DC_LUM = _vlc_dict(T.DC_LUM)
_DC_CHR = _vlc_dict(T.DC_CHROMA)

F_INTRA, F_FWD, F_BWD, F_CBP, F_QUANT = 1, 2, 4, 8, 16


def _rl_dict(vlc_pairs):
    """DCT coefficient table: {(nbits, code): (run, level) | 'eob' |
    'esc'} -- the sign bit is read separately by the caller."""
    out = {}
    n = T.RL_N
    for i in range(n):
        code, bits = vlc_pairs[2 * i], vlc_pairs[2 * i + 1]
        out[(bits, code)] = (T.RL_RUN[i], T.RL_LEVEL[i])
    # entries n, n+1: escape ('000001') then EOB ('10')
    out[(vlc_pairs[2 * n + 1], vlc_pairs[2 * n])] = "esc"
    out[(vlc_pairs[2 * n + 3], vlc_pairs[2 * n + 2])] = "eob"
    return out


_RL_B14 = _rl_dict(T.VLC_MPEG1)
_RL_B15 = _rl_dict(T.VLC_MPEG2)

_ZZ = np.array(T.ZZ_SCAN, np.int32)
_ALT = np.array(T.ALT_SCAN, np.int32)
_NLQ = np.array(T.NONLINEAR_QSCALE, np.int32)


# ---------------------------------------------------------------------------
# simple_idct numeric contract (numpy port of simple_idct_template.c,
# 8-bit: ROW_SHIFT 11, COL_SHIFT 20, DC_SHIFT 3, int16 row storage,
# row-pass DC shortcut)
# ---------------------------------------------------------------------------

def _idct_matrix() -> np.ndarray:
    from librempeg_tpu_torch.ops.dct8x8 import _int_idct_matrix

    return _int_idct_matrix().astype(np.int64)


_M = None


def idct_simple(blocks: np.ndarray) -> np.ndarray:
    """[..., 8, 8] int -> int32 spatial (un-clamped residual)."""
    global _M
    if _M is None:
        _M = _idct_matrix()
    x = blocks.astype(np.int64)
    rows = (x @ _M.T + (1 << 10)) >> 11
    # DC-only rows: the reference shortcuts to dc << 3
    dconly = (np.abs(x[..., 1:]).sum(axis=-1)) == 0
    dc8 = (x[..., 0:1] * 8)
    rows = np.where(dconly[..., None], dc8, rows)
    # row storage is int16 in the reference: wrap
    rows = ((rows + 0x8000) & 0xFFFF) - 0x8000
    cols = rows.copy()
    cols[..., 0, :] += (1 << 19) // 16383
    out = (np.swapaxes(_M @ np.swapaxes(cols, -1, -2), -1, -2))
    # M is applied along columns: out[., i, j] = sum_k M[i,k]*cols[k,j]
    out = np.einsum("ik,...kj->...ij", _M, cols) >> 20
    return out.astype(np.int32)


class _SeqCtx:
    def __init__(self):
        self.width = self.height = 0
        self.mpeg2 = False
        self.intra_matrix = np.array(T.DEFAULT_INTRA_MATRIX, np.int64)
        self.inter_matrix = np.full(64, 16, np.int64)
        self.frame_rate = Rational(25, 1)
        self.progressive = True


class _PicCtx:
    def __init__(self):
        self.type = PIC_I
        self.full_pel = [0, 0]
        self.f_code = [[15, 15], [15, 15]]   # [list][h/v]
        self.intra_dc_precision = 0
        self.picture_structure = 3           # frame
        self.frame_pred_frame_dct = 1
        self.concealment_mv = 0
        self.q_scale_type = 0
        self.intra_vlc_format = 0
        self.alternate_scan = 0
        self.temporal_reference = 0


@register_decoder
class Mpeg12Decoder(Decoder):
    """MPEG-1/2 video (progressive frame pictures, 4:2:0)."""

    INFO = CodecInfo(name="mpeg2video", long_name="MPEG-1/2 video",
                     codec_type="video")
    ALIASES = ("mpeg1video",)

    def __init__(self, params=None, device="cuda", **opts):
        # host decoder: the planes are uploaded to `device`, or stay
        # numpy arrays where the caller passes device=None
        self.device = None if device is None else resolve(device)
        self.seq = _SeqCtx()
        self._refs = []        # [older, newer] ref frames (y, u, v)
        self._pending = None   # decoded B-frames output ordering
        self._last_p = None    # held-back ref frame (output delayed)
        super().__init__(params, **opts)

    def configure(self, params):
        if params.extradata:
            try:
                self._decode_headers(bytes(params.extradata))
            except (InvalidData, IndexError):
                pass

    # ------------------------------------------------------------- parsing
    def _decode_headers(self, data: bytes):
        for code, payload in _start_codes(data):
            if code == 0xB3:
                self._seq_header(Bits(payload))
            elif code == 0xB5:
                self._extension(Bits(payload))

    def _seq_header(self, br: Bits):
        s = self.seq
        s.width = br.u(12)
        s.height = br.u(12)
        br.u(4)                      # aspect
        fr = br.u(4)
        FR = {1: (24000, 1001), 2: (24, 1), 3: (25, 1), 4: (30000, 1001),
              5: (30, 1), 6: (50, 1), 7: (60000, 1001), 8: (60, 1)}
        if fr in FR:
            s.frame_rate = Rational(*FR[fr])
        br.u(18)                     # bit_rate
        br.u1()                      # marker
        br.u(10)                     # vbv
        br.u1()                      # constrained
        if br.u1():                  # load intra matrix (zigzag order)
            m = np.array([br.u(8) for _ in range(64)], np.int64)
            s.intra_matrix = np.zeros(64, np.int64)
            s.intra_matrix[_ZZ] = m
        if br.u1():
            m = np.array([br.u(8) for _ in range(64)], np.int64)
            s.inter_matrix = np.zeros(64, np.int64)
            s.inter_matrix[_ZZ] = m

    def _extension(self, br: Bits):
        ext = br.u(4)
        s = self.seq
        if ext == 1:                 # sequence extension -> MPEG-2
            s.mpeg2 = True
            br.u(8)                  # profile/level
            s.progressive = bool(br.u1())
            cf = br.u(2)
            if cf != 1:
                raise Unsupported("mpeg2: chroma format != 4:2:0")
            s.width |= br.u(2) << 12
            s.height |= br.u(2) << 12
        elif ext == 8:               # picture coding extension
            p = getattr(self, "_pic", None)
            if p is None:
                return
            p.f_code = [[br.u(4), br.u(4)], [br.u(4), br.u(4)]]
            p.intra_dc_precision = br.u(2)
            p.picture_structure = br.u(2)
            br.u1()                  # top_field_first
            p.frame_pred_frame_dct = br.u1()
            p.concealment_mv = br.u1()
            p.q_scale_type = br.u1()
            p.intra_vlc_format = br.u1()
            p.alternate_scan = br.u1()
            if p.picture_structure != 3:
                raise Unsupported("mpeg2: field pictures")
        elif ext == 3:               # quant matrix extension
            if br.u1():
                m = np.array([br.u(8) for _ in range(64)], np.int64)
                s.intra_matrix = np.zeros(64, np.int64)
                s.intra_matrix[_ZZ] = m
            if br.u1():
                m = np.array([br.u(8) for _ in range(64)], np.int64)
                s.inter_matrix = np.zeros(64, np.int64)
                s.inter_matrix[_ZZ] = m

    # -------------------------------------------------------------- decode
    def decode(self, pkt):
        data = bytes(pkt.data)
        frames = []
        pic = None
        slices = []
        for code, payload in _start_codes(data):
            if code == 0xB3:
                self._seq_header(Bits(payload))
            elif code == 0xB5:
                self._extension(Bits(payload))
            elif code == 0xB8:
                pass                               # GOP header
            elif code == 0x00:                     # picture header
                if pic is not None and slices:
                    frames.extend(self._finish_picture(pic, slices, pkt))
                    slices = []
                pic = self._pic = _PicCtx()
                br = Bits(payload)
                pic.temporal_reference = br.u(10)
                pic.type = br.u(3)
                br.u(16)                           # vbv_delay
                if not self.seq.mpeg2:
                    if pic.type in (PIC_P, PIC_B):
                        pic.full_pel[0] = br.u1()
                        pic.f_code[0] = [br.u(3)] * 2
                    if pic.type == PIC_B:
                        pic.full_pel[1] = br.u1()
                        pic.f_code[1] = [br.u(3)] * 2
            elif 0x01 <= code <= 0xAF:
                slices.append((code, payload))
        if pic is not None and slices:
            frames.extend(self._finish_picture(pic, slices, pkt))
        return frames

    def flush(self):
        out = []
        if self._last_p is not None:
            f, pkt = self._last_p
            out.append(self._mk_frame(f, pkt))
            self._last_p = None
        return out

    def _mk_frame(self, planes, pkt):
        s = self.seq
        y, u, v = planes
        tb = pkt.time_base if pkt.time_base.valid and pkt.time_base.num \
            else Rational(s.frame_rate.den, s.frame_rate.num)
        f = VideoFrame(
            planes=(y[:s.height, :s.width],
                    u[:(s.height + 1) // 2, :(s.width + 1) // 2],
                    v[:(s.height + 1) // 2, :(s.width + 1) // 2]),
            format="yuv420p", width=s.width, height=s.height,
            pts=pkt.pts, time_base=tb)
        return f if self.device is None else f.to_device(self.device)

    def _finish_picture(self, pic, slices, pkt):
        s = self.seq
        if not s.width or not s.height:
            raise InvalidData("mpeg12: slice before sequence header")
        if pic.type not in (PIC_I, PIC_P, PIC_B):
            raise Unsupported("mpeg12: D pictures")
        mb_w = (s.width + 15) // 16
        mb_h = (s.height + 15) // 16
        planes = self._decode_picture(pic, slices, mb_w, mb_h)
        out = []
        if pic.type in (PIC_I, PIC_P):
            # reorder: refs are emitted when the NEXT ref arrives
            if self._last_p is not None:
                out.append(self._mk_frame(*self._last_p))
            self._last_p = (planes, pkt)
            self._refs.append(planes)
            del self._refs[:-2]
        else:
            out.append(self._mk_frame(planes, pkt))
        return out

    def _decode_picture(self, pic, slices, mb_w, mb_h):
        s = self.seq
        W, H = mb_w * 16, mb_h * 16
        y = np.zeros((H, W), np.uint8)
        u = np.zeros((H // 2, W // 2), np.uint8)
        v = np.zeros((H // 2, W // 2), np.uint8)
        if pic.type == PIC_B:
            if len(self._refs) < 2:
                raise InvalidData("mpeg12: B picture without two refs")
            fwd, bwd = self._refs[-2], self._refs[-1]
        elif pic.type == PIC_P:
            if not self._refs:
                raise InvalidData("mpeg12: P picture without reference")
            fwd, bwd = self._refs[-1], None
        else:
            fwd = bwd = None
        # pad refs for MC overreach
        pads = None
        if fwd is not None:
            pads = [_pad_ref(fwd), _pad_ref(bwd) if bwd else None]
        scan = _ALT if pic.alternate_scan else _ZZ
        for code, payload in slices:
            self._decode_slice(pic, code, payload, mb_w, mb_h,
                               (y, u, v), pads, scan)
        return y, u, v

    def _qscale(self, pic, code):
        if self.seq.mpeg2 and pic.q_scale_type:
            return int(_NLQ[code])
        return code << 1

    def _decode_slice(self, pic, scode, payload, mb_w, mb_h, planes,
                      pads, scan):
        s = self.seq
        br = Bits(payload)
        mb_row = scode - 1
        if s.height > 2800:
            raise Unsupported("mpeg12: large pictures")
        qscale = self._qscale(pic, br.u(5))
        while br.u1():               # extra_bit_slice + extra info
            br.u(8)
        # slice state
        last_dc = [128 << pic.intra_dc_precision
                   if s.mpeg2 else 128] * 3
        if not s.mpeg2:
            last_dc = [128, 128, 128]
        pmv = np.zeros((2, 2), np.int32)      # [list][h/v] predictors
        # MPEG-1 slices may span rows: track a global MB address
        addr = mb_row * mb_w - 1
        first = True
        mvdir_prev = (False, False)           # B skipped-MB inheritance
        mv_prev = np.zeros((2, 2), np.int32)
        y, u, v = planes
        while True:
            # macroblock_address_increment
            inc = 0
            while True:
                sym = _read_vlc(br, _MB_INC, 11)
                if sym == 34:                 # stuffing
                    continue
                if sym == 33:                 # escape: +33, keep reading
                    inc += 33
                    continue
                inc += sym + 1
                break
            skipped = () if first else range(addr + 1, addr + inc)
            addr += inc
            first = False
            if addr >= mb_w * mb_h:
                raise InvalidData("mpeg12: mb address beyond picture")
            mb_row, mb_x = divmod(addr, mb_w)
            # handle skipped MBs
            for sa in skipped:
                sy, sx = divmod(sa, mb_w)
                if pic.type == PIC_P:
                    pmv[:] = 0
                    _copy_mb(planes, pads[0], sy, sx)
                elif pic.type == PIC_B:
                    self._inter_mb(planes, pads, sy, sx,
                                   mvdir_prev, mv_prev, pic)
                last_dc = [128 << pic.intra_dc_precision
                           if s.mpeg2 else 128] * 3
            # macroblock_type (I: "1" intra, "01" intra+quant)
            if pic.type == PIC_I:
                if br.u1():
                    flags = F_INTRA
                elif br.u1():
                    flags = F_INTRA | F_QUANT
                else:
                    raise InvalidData("mpeg12: bad I mb type")
            elif pic.type == PIC_P:
                flags = _read_vlc(br, _MB_PTYPE, 6)
            else:
                flags = _read_vlc(br, _MB_BTYPE, 6)
            if self.seq.mpeg2 and pic.frame_pred_frame_dct == 0 \
                    and (flags & (F_FWD | F_BWD)):
                fms = br.u(2)                 # frame_motion_type
                if fms != 2:
                    raise Unsupported("mpeg12: field motion")
            dct_type = 0
            if self.seq.mpeg2 and pic.frame_pred_frame_dct == 0 \
                    and (flags & (F_INTRA | F_CBP)):
                dct_type = br.u1()
            if flags & F_QUANT:
                qscale = self._qscale(pic, br.u(5))
            # motion vectors
            mvs = np.zeros((2, 2), np.int32)
            used = [bool(flags & F_FWD), bool(flags & F_BWD)]
            if flags & F_INTRA:
                if pic.concealment_mv:
                    raise Unsupported("mpeg12: concealment MVs")
                pmv[:] = 0
            for lst in range(2):
                if not used[lst]:
                    continue
                for comp in range(2):         # h then v
                    fc = pic.f_code[lst][comp]
                    val = self._motion(br, fc, int(pmv[lst][comp]))
                    if pic.full_pel[lst]:
                        pmv[lst][comp] = val
                        mvs[lst][comp] = val << 1
                    else:
                        pmv[lst][comp] = val
                        mvs[lst][comp] = val
            if pic.type == PIC_P and not (flags & (F_FWD | F_INTRA)):
                # no-MC coded MB: zero MV, predictors reset
                pmv[:] = 0
                used[0] = True
                mvs[0] = 0
            if pic.type == PIC_B and (flags & F_INTRA):
                pmv[:] = 0
            # coded block pattern
            cbp = 0
            if flags & F_INTRA:
                cbp = 0x3F
            elif flags & F_CBP:
                cbp = _read_vlc(br, _MB_PAT, 9)
                cbp = _CBP_SYM[cbp]
            # prediction
            if flags & F_INTRA:
                pass
            elif pic.type == PIC_P:
                self._inter_mb(planes, pads, mb_row, mb_x,
                               (used[0], False), mvs, pic)
            else:
                self._inter_mb(planes, pads, mb_row, mb_x,
                               (used[0], used[1]), mvs, pic)
                mvdir_prev = (used[0], used[1])
                mv_prev = mvs.copy()
            if not (flags & F_INTRA):
                last_dc = [128 << pic.intra_dc_precision
                           if s.mpeg2 else 128] * 3
            # blocks
            for blk in range(6):
                coded = (cbp >> (5 - blk)) & 1
                if not coded:
                    continue
                if flags & F_INTRA:
                    block = self._intra_block(br, pic, blk, last_dc,
                                              qscale, scan)
                    self._put_block(planes, mb_row, mb_x, blk, block,
                                    dct_type, intra=True)
                else:
                    block = self._inter_block(br, pic, blk, qscale,
                                              scan)
                    self._put_block(planes, mb_row, mb_x, blk, block,
                                    dct_type, intra=False)
            if not br.more() or br.peek(23) == 0:
                break

    def _motion(self, br, fcode, pred):
        code = _read_vlc(br, _MB_MV, 11)
        if code == 0:
            return pred
        sign = br.u1()
        shift = fcode - 1
        val = code
        if shift:
            val = ((val - 1) << shift) | br.u(shift)
            val += 1
        if sign:
            val = -val
        val += pred
        # modulo decoding (mpeg12dec.c mpeg_decode_motion)
        bits = 5 + shift
        mask = 1 << (bits - 1)
        return (val & (mask - 1)) - (val & mask)

    # --------------------------------------------------------- block layer
    def _intra_block(self, br, pic, blk, last_dc, qscale, scan):
        s = self.seq
        comp = 0 if blk < 4 else (blk & 1) + 1
        tab = _DC_LUM if blk < 4 else _DC_CHR
        size = _read_vlc(br, tab, 12)
        diff = 0
        if size:
            diff = br.u(size)
            if diff < (1 << (size - 1)):
                diff -= (1 << size) - 1
        dc = last_dc[comp] + diff
        last_dc[comp] = dc
        block = np.zeros(64, np.int64)
        if s.mpeg2:
            block[0] = dc << (3 - pic.intra_dc_precision)
            mism = int(block[0]) ^ 1
            rl = _RL_B15 if pic.intra_vlc_format else _RL_B14
            m = s.intra_matrix
            i = 0
            while True:
                sym = _read_vlc(br, rl)
                if sym == "eob":
                    break
                if sym == "esc":
                    run = br.u(6)
                    lv = br.u(12)
                    if lv >= 2048:
                        lv -= 4096
                    i += run + 1
                    if i > 63:
                        raise InvalidData("mpeg12: run overflow")
                    j = int(scan[i])
                    a = abs(lv)
                    d = (a * qscale * int(m[j])) >> 4
                    d = -d if lv < 0 else d
                else:
                    run, lv = sym
                    i += run + 1
                    if i > 63:
                        raise InvalidData("mpeg12: run overflow")
                    j = int(scan[i])
                    d = (lv * qscale * int(m[j])) >> 4
                    if br.u1():
                        d = -d
                block[j] = _w16(d)
                mism ^= int(block[j])
            block[63] ^= mism & 1
        else:
            block[0] = dc * 8
            m = s.intra_matrix
            i = 0
            while True:
                sym = _read_vlc(br, _RL_B14)
                if sym == "eob":
                    break
                if sym == "esc":
                    run = br.u(6)
                    lv = br.u(8)
                    if lv == 128:
                        lv = br.u(8) - 256
                    elif lv == 0:
                        lv = br.u(8)
                    elif lv > 128:
                        lv -= 256
                    i += run + 1
                    if i > 63:
                        raise InvalidData("mpeg12: run overflow")
                    j = int(scan[i])
                    a = abs(lv)
                    d = (a * qscale * int(m[j])) >> 4
                    d = (d - 1) | 1
                    d = -d if lv < 0 else d
                else:
                    run, lv = sym
                    i += run + 1
                    if i > 63:
                        raise InvalidData("mpeg12: run overflow")
                    j = int(scan[i])
                    d = (lv * qscale * int(m[j])) >> 4
                    d = (d - 1) | 1
                    if br.u1():
                        d = -d
                block[j] = _w16(d)
        return block

    def _inter_block(self, br, pic, blk, qscale, scan):
        s = self.seq
        m = s.inter_matrix
        block = np.zeros(64, np.int64)
        i = -1
        mism = 1
        # first-coefficient special case: bit pattern 1x
        if br.peek(1) == 1:
            br.u1()
            sgn = br.u1()
            d = (3 * qscale * int(m[0])) >> 5
            if not s.mpeg2:
                d = (d - 1) | 1
            if sgn:
                d = -d
            block[int(scan[0])] = _w16(d)
            mism ^= int(block[int(scan[0])])
            i = 0
            # EOB check: next code 10 (B.14 EOB)
            if br.peek(2) == 0b10:
                br.u(2)
                if s.mpeg2:
                    block[63] ^= mism & 1
                return block
        while True:
            sym = _read_vlc(br, _RL_B14)
            if sym == "eob":
                break
            if sym == "esc":
                run = br.u(6)
                if s.mpeg2:
                    lv = br.u(12)
                    if lv >= 2048:
                        lv -= 4096
                else:
                    lv = br.u(8)
                    if lv == 128:
                        lv = br.u(8) - 256
                    elif lv == 0:
                        lv = br.u(8)
                    elif lv > 128:
                        lv -= 256
                i += run + 1
                if i > 63:
                    raise InvalidData("mpeg12: run overflow")
                j = int(scan[i])
                a = abs(lv)
                d = ((a * 2 + 1) * qscale * int(m[j])) >> 5
                if not s.mpeg2:
                    d = (d - 1) | 1
                d = -d if lv < 0 else d
            else:
                run, lv = sym
                i += run + 1
                if i > 63:
                    raise InvalidData("mpeg12: run overflow")
                j = int(scan[i])
                d = ((lv * 2 + 1) * qscale * int(m[j])) >> 5
                if not s.mpeg2:
                    d = (d - 1) | 1
                if br.u1():
                    d = -d
            block[j] = _w16(d)
            mism ^= int(block[j])
        if s.mpeg2:
            block[63] ^= mism & 1
        return block

    # -------------------------------------------------------------- recon
    def _put_block(self, planes, mb_row, mb_x, blk, block64, dct_type,
                   intra):
        res = idct_simple(block64.reshape(8, 8))
        y, u, v = planes
        if blk < 4:
            y0 = mb_row * 16 + (blk >> 1) * 8
            x0 = mb_x * 16 + (blk & 1) * 8
            if dct_type:          # field DCT: interleaved rows
                ys = y0 - (blk >> 1) * 8 + (blk >> 1)
                dst = y[ys:ys + 16:2, x0:x0 + 8]
            else:
                dst = y[y0:y0 + 8, x0:x0 + 8]
        else:
            pl = u if blk == 4 else v
            y0, x0 = mb_row * 8, mb_x * 8
            dst = pl[y0:y0 + 8, x0:x0 + 8]
        if intra:
            dst[:] = np.clip(res, 0, 255).astype(np.uint8)
        else:
            dst[:] = np.clip(dst.astype(np.int32) + res, 0,
                             255).astype(np.uint8)

    def _inter_mb(self, planes, pads, mb_row, mb_x, used, mvs, pic):
        """Forward/backward/bi 16x16 half-pel MC into the planes."""
        y, u, v = planes
        acc_y = None
        acc_u = None
        acc_v = None
        n = 0
        for lst in range(2):
            if not used[lst]:
                continue
            py, pu, pv = _mc_fetch(pads[lst], mb_row, mb_x,
                                   int(mvs[lst][0]), int(mvs[lst][1]))
            if acc_y is None:
                acc_y, acc_u, acc_v = py, pu, pv
            else:
                acc_y = (acc_y + py + 1) >> 1
                acc_u = (acc_u + pu + 1) >> 1
                acc_v = (acc_v + pv + 1) >> 1
            n += 1
        if n == 0:                    # B skipped without direction: bug
            raise InvalidData("mpeg12: MC without direction")
        y0, x0 = mb_row * 16, mb_x * 16
        y[y0:y0 + 16, x0:x0 + 16] = acc_y.astype(np.uint8)
        u[y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8] = \
            acc_u.astype(np.uint8)
        v[y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8] = \
            acc_v.astype(np.uint8)


def _w16(v: int) -> int:
    """int16 wrap (reference block storage is int16_t)."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _pad_ref(planes, pad=32):
    y, u, v = planes
    return (np.pad(y, pad, mode="edge").astype(np.int32),
            np.pad(u, pad // 2, mode="edge").astype(np.int32),
            np.pad(v, pad // 2, mode="edge").astype(np.int32), pad)


def _hpel(a, oy, ox, h, w):
    iy, fy = oy >> 1, oy & 1
    ix, fx = ox >> 1, ox & 1
    if not fy and not fx:
        return a[iy:iy + h, ix:ix + w]
    if not fy:
        return (a[iy:iy + h, ix:ix + w]
                + a[iy:iy + h, ix + 1:ix + w + 1] + 1) >> 1
    if not fx:
        return (a[iy:iy + h, ix:ix + w]
                + a[iy + 1:iy + h + 1, ix:ix + w] + 1) >> 1
    return (a[iy:iy + h, ix:ix + w] + a[iy:iy + h, ix + 1:ix + w + 1]
            + a[iy + 1:iy + h + 1, ix:ix + w]
            + a[iy + 1:iy + h + 1, ix + 1:ix + w + 1] + 2) >> 2


def _mc_fetch(pad, mb_row, mb_x, mvx, mvy):
    yp, up, vp, pad_n = pad
    ly = mb_row * 16 * 2 + mvy + pad_n * 2
    lx = mb_x * 16 * 2 + mvx + pad_n * 2
    py = _hpel(yp, ly, lx, 16, 16)
    # chroma vector = luma/2 with C truncation toward zero
    # (mpegvideo_motion.c mpeg_motion: mx = motion_x / 2)
    cmvx = -(-mvx // 2) if mvx < 0 else mvx // 2
    cmvy = -(-mvy // 2) if mvy < 0 else mvy // 2
    cy = mb_row * 8 * 2 + cmvy + pad_n
    cx = mb_x * 8 * 2 + cmvx + pad_n
    pu = _hpel(up, cy, cx, 8, 8)
    pv = _hpel(vp, cy, cx, 8, 8)
    return py, pu, pv


def _copy_mb(planes, pad, mb_row, mb_x):
    y, u, v = planes
    py, pu, pv = _mc_fetch(pad, mb_row, mb_x, 0, 0)
    y0, x0 = mb_row * 16, mb_x * 16
    y[y0:y0 + 16, x0:x0 + 16] = py.astype(np.uint8)
    u[y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8] = pu.astype(np.uint8)
    v[y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8] = pv.astype(np.uint8)


# coded_block_pattern: the VLC symbol IS the cbp value index; B.9 maps
# vlc index -> cbp via the table order (ff mbPatTable is indexed BY cbp)
_CBP_SYM = list(range(64))


def _start_codes(data: bytes):
    """Yield (code, payload) for each 00 00 01 xx unit."""
    n = len(data)
    out = []
    idx = []
    i = data.find(b"\x00\x00\x01")
    while i != -1 and i + 3 < n:
        idx.append(i)
        i = data.find(b"\x00\x00\x01", i + 3)
    for k, start in enumerate(idx):
        code = data[start + 3]
        end = idx[k + 1] if k + 1 < len(idx) else n
        out.append((code, data[start + 4:end]))
    return out
