"""MPEG-1/2 video encoders (ISO/IEC 11172-2 / 13818-2).

Progressive frame pictures, 4:2:0, I/P GOPs: the encode-side
counterpart of codecs/mpeg12/decoder.py, sharing its normative tables
and reconstructing references through the decoder's exact dequant +
simple-IDCT contract, so our own decode of the emitted stream is
bit-exact with the encoder's reference frames.  Full-search half-pel
motion estimation, per-row slices, skip/no-MC macroblock decisions.

Behavioral references: libavcodec/mpeg12enc.c:1342
(header/bitstream layer), mpegvideo_enc.c (MB decisions; redesigned —
this encoder is vectorized numpy per picture, not a per-MB C loop).

A copy of librempeg_tpu/codecs/mpeg12/encoder.py (host code, no JAX),
imports rewritten; its frames may come from any device (one fetch a
plane).
"""
from __future__ import annotations

import numpy as np

from librempeg_tpu_torch.codecs.api import CodecInfo, Encoder, register_encoder
from librempeg_tpu_torch.codecs.mpeg12 import tables as T
from librempeg_tpu_torch.codecs.mpeg12.decoder import (
    _hpel,
    _pad_ref,
    _w16,
    idct_simple,
)
from librempeg_tpu_torch.core.errors import Unsupported
from librempeg_tpu_torch.core.frame import VideoFrame
from librempeg_tpu_torch.core.options import Option, OptionTable
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import NOPTS, Rational

_ZZ = np.array(T.ZZ_SCAN, np.int64)

F_INTRA, F_FWD, F_BWD, F_CBP, F_QUANT = 1, 2, 4, 8, 16


class BitW:
    """MSB-first bit writer."""

    def __init__(self):
        self.bits = 0
        self.n = 0
        self.out = bytearray()

    def w(self, val: int, nbits: int):
        self.bits = (self.bits << nbits) | (val & ((1 << nbits) - 1))
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            self.out.append((self.bits >> self.n) & 0xFF)
        self.bits &= (1 << self.n) - 1

    def align(self):
        if self.n:
            self.w(0, 8 - self.n)

    def bytes(self) -> bytes:
        self.align()
        return bytes(self.out)


def _enc_tables():
    """Inverse VLC maps built from the decoder's normative tables."""
    rl = {}
    for i in range(T.RL_N):
        rl[(T.RL_RUN[i], T.RL_LEVEL[i])] = (T.VLC_MPEG1[2 * i],
                                            T.VLC_MPEG1[2 * i + 1])
    dc_l = [(T.DC_LUM[2 * i], T.DC_LUM[2 * i + 1]) for i in range(12)]
    dc_c = [(T.DC_CHROMA[2 * i], T.DC_CHROMA[2 * i + 1])
            for i in range(12)]
    inc = [(T.MB_ADDR_INC[2 * i], T.MB_ADDR_INC[2 * i + 1])
           for i in range(35)]
    pat = [(T.MB_PAT[2 * i], T.MB_PAT[2 * i + 1])
           for i in range(len(T.MB_PAT) // 2)]
    mv = [(T.MB_MV[2 * i], T.MB_MV[2 * i + 1]) for i in range(17)]
    ptype = {T.PTYPE_FLAGS[i]: (T.MB_PTYPE[2 * i], T.MB_PTYPE[2 * i + 1])
             for i in range(len(T.PTYPE_FLAGS))}
    return rl, dc_l, dc_c, inc, pat, mv, ptype


_RL, _DC_L, _DC_C, _INC, _PAT, _MV, _PTYPE = _enc_tables()

_FRC = {(24000, 1001): 1, (24, 1): 2, (25, 1): 3, (30000, 1001): 4,
        (30, 1): 5, (50, 1): 6, (60000, 1001): 7, (60, 1): 8}


@register_encoder
class Mpeg1Encoder(Encoder):
    """MPEG-1 video encoder (I/P GOPs, half-pel full-search ME)."""

    INFO = CodecInfo(name="mpeg1video", long_name="MPEG-1 video",
                     codec_type="video")
    OPTIONS = OptionTable(
        Option("qscale", int, 6, min=1, max=31),
        Option("g", int, 12, min=1, max=600, help="GOP size"),
        Option("sr", int, 7, min=1, max=15,
               help="ME search range (full pels)"),
    )
    MPEG2 = False

    def __init__(self, width=0, height=0, pix_fmt="yuv420p",
                 framerate: Rational = Rational(25, 1), device=None,
                 **opts):
        # a host encoder: `device` is where the frames come from, and
        # each plane is fetched once per frame (encode)
        super().__init__(**opts)
        if width % 2 or height % 2:
            raise Unsupported("mpeg12: dimensions must be even")
        self.width, self.height = width, height
        self.cw = (width + 15) // 16 * 16
        self.ch = (height + 15) // 16 * 16
        self.framerate = framerate if framerate.num else Rational(25, 1)
        self.time_base = Rational(self.framerate.den, self.framerate.num)
        self._idx = 0
        self._next_pts = 0
        self._ref = None            # (y, u, v) recon of last ref
        self._im = np.array(T.DEFAULT_INTRA_MATRIX, np.int64)
        self._nm = np.full(64, 16, np.int64)
        # f_code from the half-pel search range
        fc = 1
        while (8 << fc) < self.opts["sr"] * 2 + 1:
            fc += 1
        self._fc = min(fc, 7)

    def codec_parameters(self):
        from librempeg_tpu_torch.formats.api import CodecParameters

        return CodecParameters(
            codec_type="video",
            codec_id="mpeg2video" if self.MPEG2 else "mpeg1video",
            width=self.width, height=self.height, pix_fmt="yuv420p",
            framerate=self.framerate, extradata=self._headers())

    # ------------------------------------------------------------ headers
    def _headers(self) -> bytes:
        bw = BitW()
        bw.w(0x000001B3, 32)
        bw.w(self.width & 0xFFF, 12)
        bw.w(self.height & 0xFFF, 12)
        bw.w(1, 4)                       # aspect: square pixels
        fr = _FRC.get((self.framerate.num, self.framerate.den), 3)
        bw.w(fr, 4)
        bw.w(0x3FFFF, 18)                # bit_rate: variable
        bw.w(1, 1)                       # marker
        bw.w(112, 10)                    # vbv_buffer_size
        bw.w(0, 1)                       # constrained_parameters
        bw.w(0, 1)                       # load_intra_quantiser_matrix
        bw.w(0, 1)                       # load_non_intra_matrix
        data = bw.bytes()
        if self.MPEG2:
            bw = BitW()
            bw.w(0x000001B5, 32)
            bw.w(1, 4)                   # sequence_extension
            bw.w(0x48, 8)                # Main@Main
            bw.w(1, 1)                   # progressive_sequence
            bw.w(1, 2)                   # chroma 4:2:0
            bw.w(0, 2)                   # horizontal_size_extension
            bw.w(0, 2)                   # vertical_size_extension
            bw.w(0, 12)                  # bit_rate_extension
            bw.w(1, 1)                   # marker
            bw.w(0, 8)                   # vbv_buffer_size_extension
            bw.w(0, 1)                   # low_delay
            bw.w(0, 2)                   # frame_rate_ext_n
            bw.w(0, 5)                   # frame_rate_ext_d
            data += bw.bytes()
        return data

    def _gop_header(self) -> bytes:
        bw = BitW()
        bw.w(0x000001B8, 32)
        bw.w(0, 1)                       # drop frame
        secs = self._idx * self.framerate.den // self.framerate.num
        bw.w(secs // 3600 % 24, 5)
        bw.w(secs // 60 % 60, 6)
        bw.w(1, 1)                       # marker
        bw.w(secs % 60, 6)
        bw.w(0, 6)                       # pictures
        bw.w(1, 1)                       # closed_gop
        bw.w(0, 1)                       # broken_link
        return bw.bytes()

    def _pic_header(self, ptype: int, temporal_ref: int) -> bytes:
        bw = BitW()
        bw.w(0x00000100, 32)
        bw.w(temporal_ref & 0x3FF, 10)
        bw.w(ptype, 3)                   # 1 = I, 2 = P
        bw.w(0xFFFF, 16)                 # vbv_delay
        if ptype == 2:
            # H.262 §6.3.9 keeps full_pel_forward_vector + forward_f_code
            # in the picture header even for MPEG-2 (where they must be
            # 0 / '111'; the real codes live in the coding extension).
            # The reference encoder writes them too (mpeg12enc.c).
            bw.w(0, 1)                   # full_pel_forward
            bw.w(7 if self.MPEG2 else self._fc, 3)
        data = bw.bytes()
        if self.MPEG2:
            bw = BitW()
            bw.w(0x000001B5, 32)
            bw.w(8, 4)                   # picture_coding_extension
            if ptype == 2:
                bw.w(self._fc, 4)
                bw.w(self._fc, 4)
            else:
                bw.w(15, 4)
                bw.w(15, 4)
            bw.w(15, 4)                  # backward f_codes unused
            bw.w(15, 4)
            bw.w(0, 2)                   # intra_dc_precision (8-bit)
            bw.w(3, 2)                   # picture_structure: frame
            bw.w(0, 1)                   # top_field_first
            bw.w(1, 1)                   # frame_pred_frame_dct
            bw.w(0, 1)                   # concealment_motion_vectors
            bw.w(0, 1)                   # q_scale_type (linear)
            bw.w(0, 1)                   # intra_vlc_format (B.14)
            bw.w(0, 1)                   # alternate_scan
            bw.w(0, 1)                   # repeat_first_field
            bw.w(1, 1)                   # chroma_420_type
            bw.w(1, 1)                   # progressive_frame
            bw.w(0, 1)                   # composite_display_flag
            data += bw.bytes()
        return data

    # ---------------------------------------------------------- bit pieces
    def _put_inc(self, bw, inc: int):
        while inc > 33:
            bw.w(*_INC[33])              # escape (+33)
            inc -= 33
        bw.w(*_INC[inc - 1])

    def _put_mv(self, bw, val: int, pred: int) -> int:
        """Code one MV component (half-pel units); returns new pred."""
        shift = self._fc - 1
        rng = 16 << shift
        d = val - pred
        if d < -rng:
            d += rng * 2
        elif d >= rng:
            d -= rng * 2
        a = abs(d)
        if a == 0:
            bw.w(*_MV[0])
        else:
            code = ((a - 1) >> shift) + 1
            bw.w(*_MV[code])
            bw.w(0 if d > 0 else 1, 1)
            if shift:
                bw.w((a - 1) & ((1 << shift) - 1), shift)
        return val

    def _put_coeffs(self, bw, idx, lv, first_inter: bool,
                    intra: bool = False):
        """Run/level pairs in scan order (idx ascending, levels != 0),
        then EOB. first_inter: B.14 first-coefficient '1s' form.
        intra: scan slot 0 is the separately-coded DC, so the first
        AC run counts from position 1."""
        prev = 0 if intra else -1
        for j, l in zip(idx, lv):
            run = j - prev - 1
            prev = j
            a = abs(int(l))
            sgn = 1 if l < 0 else 0
            if first_inter and run == 0 and a == 1:
                bw.w(2 | sgn, 2)         # '1' + sign
            else:
                cb = _RL.get((run, a))
                if cb is not None:
                    bw.w(cb[0], cb[1])
                    bw.w(sgn, 1)
                else:
                    bw.w(1, 6)           # escape '000001'
                    bw.w(run, 6)
                    if self.MPEG2:
                        bw.w(int(l) & 0xFFF, 12)
                    else:
                        v = int(l)
                        if -127 <= v <= 127 and v != 0:
                            bw.w(v & 0xFF, 8)
                        elif v > 0:
                            bw.w(0, 8)
                            bw.w(v, 8)
                        else:
                            bw.w(128, 8)
                            bw.w(v + 256, 8)
            first_inter = False
        bw.w(2, 2)                       # EOB '10'

    # ------------------------------------------------------------ encoding
    def _dct_blocks(self, y, u, v):
        """All 6 per-MB 8x8 blocks -> float DCT coefficients
        [mb_h, mb_w, 6, 64] (block order Y00 Y01 Y10 Y11 Cb Cr)."""
        D = _dct_mat()
        mbh, mbw = self.ch // 16, self.cw // 16

        def plane_blocks(p, n):
            h, w = p.shape
            b = p.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
            return D @ b.astype(np.float64) @ D.T

        yb = plane_blocks(y, 16)          # [H/8, W/8, 8, 8]
        ub = plane_blocks(u, 8)
        vb = plane_blocks(v, 8)
        out = np.zeros((mbh, mbw, 6, 64), np.float64)
        out[:, :, 0] = yb[0::2, 0::2].reshape(mbh, mbw, 64)
        out[:, :, 1] = yb[0::2, 1::2].reshape(mbh, mbw, 64)
        out[:, :, 2] = yb[1::2, 0::2].reshape(mbh, mbw, 64)
        out[:, :, 3] = yb[1::2, 1::2].reshape(mbh, mbw, 64)
        out[:, :, 4] = ub.reshape(mbh, mbw, 64)
        out[:, :, 5] = vb.reshape(mbh, mbw, 64)
        return out

    def _quant_intra(self, coef):
        """[..., 64] float DCT -> (levels int, dequant int) per the
        decoder's exact reconstruction contract."""
        q = 2 * self.opts["qscale"]
        m = self._im
        dc = np.clip(np.round(coef[..., 0] / 8.0), 0, 255).astype(
            np.int64)
        # quantize in natural order (the matrix is natural-order too)
        lv = np.round(coef * 16.0 / (q * m)).astype(np.int64)
        lim = 2047 if self.MPEG2 else 255
        lv = np.clip(lv, -lim, lim)
        lv[..., 0] = 0                    # DC handled separately
        deq = (np.abs(lv) * q * m) >> 4
        if not self.MPEG2:
            deq = np.where(lv != 0, (deq - 1) | 1, 0)
        deq = np.where(lv < 0, -deq, deq)
        deq[..., 0] = dc * 8
        return dc, lv, deq

    def _quant_inter(self, coef):
        q = 2 * self.opts["qscale"]
        m = self._nm
        lv = np.trunc(coef * 16.0 / (q * m)).astype(np.int64)
        lim = 2047 if self.MPEG2 else 255
        lv = np.clip(lv, -lim, lim)
        deq = ((2 * np.abs(lv) + 1) * q * m) >> 5
        if not self.MPEG2:
            deq = np.where(lv != 0, (deq - 1) | 1, 0)
        deq = np.where(lv < 0, -deq, np.where(lv > 0, deq, 0))
        return lv, deq

    def _mismatch(self, deq):
        """MPEG-2 §7.4.4 mismatch control on the dequantized block
        [..., 64] (the decoder XORs parity into coefficient 63)."""
        if not self.MPEG2:
            return deq
        deq = deq.copy()
        parity = (np.bitwise_xor.reduce(deq.astype(np.int64), axis=-1)
                  ^ 1) & 1
        deq[..., 63] ^= parity
        return deq

    def _recon_blocks(self, deq):
        """Dequantized [..., 64] -> spatial int32 via the decoder IDCT."""
        return idct_simple(_w16_arr(deq).reshape(*deq.shape[:-1], 8, 8))

    def encode(self, frame: VideoFrame):
        if frame.format not in ("yuv420p", "yuvj420p"):
            raise Unsupported("mpeg12: input must be yuv420p")
        y, u, v = frame.to_host().planes
        if self.cw != self.width or self.ch != self.height:
            py, px = self.ch - self.height, self.cw - self.width
            y = np.pad(y, ((0, py), (0, px)), mode="edge")
            u = np.pad(u, ((0, py // 2), (0, px // 2)), mode="edge")
            v = np.pad(v, ((0, py // 2), (0, px // 2)), mode="edge")
        idx = self._idx
        self._idx += 1
        pts = frame.pts if frame.pts != NOPTS else self._next_pts
        self._next_pts = pts + 1
        is_i = idx % self.opts["g"] == 0 or self._ref is None
        data = b""
        if is_i:
            if idx == 0:
                data += self._headers()
            data += self._gop_header()
            body = self._encode_i(y, u, v)
            tr = 0
        else:
            body = self._encode_p(y, u, v)
            tr = idx % self.opts["g"]
        data += self._pic_header(1 if is_i else 2, tr) + body
        return [Packet(data=data, pts=pts, dts=pts, duration=1,
                       flags=PktFlags.KEY if is_i else 0,
                       time_base=self.time_base)]

    def flush(self):
        return []

    # ----------------------------------------------------------- I picture
    def _encode_i(self, y, u, v) -> bytes:
        mbh, mbw = self.ch // 16, self.cw // 16
        coef = self._dct_blocks(y, u, v)
        dc, lv, deq = self._quant_intra(coef)
        deq = self._mismatch(deq)
        res = self._recon_blocks(deq)
        self._store_recon(res, None, np.ones((mbh, mbw), bool),
                          None, None)
        out = bytearray()
        qcode = self.opts["qscale"]
        for row in range(mbh):
            bw = BitW()
            bw.w(1, 24)                  # start code prefix
            bw.w(row + 1, 8)
            bw.w(qcode, 5)
            bw.w(0, 1)                   # extra_bit_slice
            last = [128, 128, 128]
            for x in range(mbw):
                self._put_inc(bw, 1)
                bw.w(1, 1)               # mb_type: intra
                for blk in range(6):
                    comp = 0 if blk < 4 else (blk & 1) + 1
                    self._put_dc(bw, int(dc[row, x, blk]), last, comp)
                    nz = np.nonzero(lv[row, x, blk][_ZZ])[0]
                    self._put_coeffs(bw, nz,
                                     lv[row, x, blk][_ZZ][nz], False,
                                     intra=True)
            out += bw.bytes()
        return bytes(out)

    def _put_dc(self, bw, dc, last, comp):
        diff = dc - last[comp]
        last[comp] = dc
        size = abs(diff).bit_length()
        tab = _DC_L if comp == 0 else _DC_C
        bw.w(*tab[size])
        if size:
            bw.w(diff if diff > 0 else diff + (1 << size) - 1, size)

    # ----------------------------------------------------------- P picture
    def _motion_search(self, y, ref_pack):
        """Half-pel full search per MB: returns mv [mbh, mbw, 2]
        (half-pel units) + SAD fields for mode decisions."""
        mbh, mbw = self.ch // 16, self.cw // 16
        yp = ref_pack[0]
        pad = ref_pack[3]
        sr = self.opts["sr"]
        cur = y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3) \
            .astype(np.int32)
        best = np.full((mbh, mbw), 1 << 30, np.int64)
        bmv = np.zeros((mbh, mbw, 2), np.int32)
        ry = yp[pad:pad + self.ch, pad:pad + self.cw]
        refp = np.pad(ry, sr, mode="edge")
        # MPEG-1/2 forbids motion vectors referencing samples outside
        # the picture (ISO 11172-2 §2.4.4.2): candidates whose 16x16
        # fetch would cross the edge are masked out per MB
        rows16 = np.arange(mbh)[:, None] * 16
        cols16 = np.arange(mbw)[None, :] * 16
        # integer full search, vectorized over the MB grid per offset
        for dy in range(-sr, sr + 1):
            for dx in range(-sr, sr + 1):
                sh = refp[sr + dy:sr + dy + self.ch,
                          sr + dx:sr + dx + self.cw]
                sad = np.abs(cur - sh.reshape(mbh, 16, mbw, 16)
                             .transpose(0, 2, 1, 3)).sum((2, 3)) \
                    .astype(np.int64)
                sad += (abs(dx) + abs(dy))   # slight zero bias
                ok = ((rows16 + dy >= 0)
                      & (rows16 + 16 + dy <= self.ch)
                      & (cols16 + dx >= 0)
                      & (cols16 + 16 + dx <= self.cw))
                sad = np.where(ok, sad, 1 << 30)
                better = sad < best
                best = np.where(better, sad, best)
                bmv[better] = (dx, dy)
        # half-pel refinement around the integer winner
        mv = bmv * 2
        hbest = np.full((mbh, mbw), 1 << 30, np.int64)
        hmv = mv.copy()
        lim = sr * 2
        for hy in (-1, 0, 1):
            for hx in (-1, 0, 1):
                cand = mv + (hx, hy)
                cand[..., 0] = np.clip(cand[..., 0], -lim, lim)
                cand[..., 1] = np.clip(cand[..., 1], -lim, lim)
                y0f = rows16 + (cand[..., 1] >> 1)
                x0f = cols16 + (cand[..., 0] >> 1)
                ok = ((y0f >= 0)
                      & (y0f + 16 + (cand[..., 1] & 1) <= self.ch)
                      & (x0f >= 0)
                      & (x0f + 16 + (cand[..., 0] & 1) <= self.cw))
                sad = np.zeros((mbh, mbw), np.int64)
                for row in range(mbh):
                    for x in range(mbw):
                        p = _hpel(yp, row * 32 + int(cand[row, x, 1])
                                  + 2 * pad,
                                  x * 32 + int(cand[row, x, 0])
                                  + 2 * pad, 16, 16)
                        sad[row, x] = np.abs(
                            cur[row, x] - p).sum()
                sad = np.where(ok, sad, 1 << 30)
                better = sad < hbest
                hbest = np.where(better, sad, hbest)
                hmv = np.where(better[..., None], cand, hmv)
        return hmv, hbest

    def _encode_p(self, y, u, v) -> bytes:
        mbh, mbw = self.ch // 16, self.cw // 16
        pack = _pad_ref(self._ref)
        mv, sad_inter = self._motion_search(y, pack)
        # build the MC prediction for every MB
        pred_y = np.zeros((self.ch, self.cw), np.int32)
        pred_u = np.zeros((self.ch // 2, self.cw // 2), np.int32)
        pred_v = np.zeros_like(pred_u)
        yp, up, vp, pad = pack
        for row in range(mbh):
            for x in range(mbw):
                mvx, mvy = int(mv[row, x, 0]), int(mv[row, x, 1])
                pred_y[row * 16:row * 16 + 16, x * 16:x * 16 + 16] = \
                    _hpel(yp, row * 32 + mvy + 2 * pad,
                          x * 32 + mvx + 2 * pad, 16, 16)
                cmx = -(-mvx // 2) if mvx < 0 else mvx // 2
                cmy = -(-mvy // 2) if mvy < 0 else mvy // 2
                pred_u[row * 8:row * 8 + 8, x * 8:x * 8 + 8] = \
                    _hpel(up, row * 16 + cmy + pad,
                          x * 16 + cmx + pad, 8, 8)
                pred_v[row * 8:row * 8 + 8, x * 8:x * 8 + 8] = \
                    _hpel(vp, row * 16 + cmy + pad,
                          x * 16 + cmx + pad, 8, 8)
        # residual transform of the difference
        dif_y = y.astype(np.float64) - pred_y
        dif_u = u.astype(np.float64) - pred_u
        dif_v = v.astype(np.float64) - pred_v
        coef = self._dct_blocks(dif_y, dif_u, dif_v)
        lv, deq = self._quant_inter(coef)
        deq = self._mismatch(deq)
        # intra decision: compare inter SAD with intra deviation
        cur = y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3) \
            .astype(np.int64)
        mean = cur.mean((2, 3), keepdims=True)
        sad_intra = np.abs(cur - mean).sum((2, 3)).astype(np.int64)
        use_intra = sad_intra + 256 < sad_inter
        # intra data for the chosen MBs
        icoef = self._dct_blocks(y, u, v)
        idc, ilv, ideq = self._quant_intra(icoef)
        ideq = self._mismatch(ideq)
        # reconstruction
        res = self._recon_blocks(deq)
        ires = self._recon_blocks(ideq)
        self._store_recon(ires, res, use_intra, pred_y,
                          (pred_u, pred_v))
        # bitstream
        out = bytearray()
        qcode = self.opts["qscale"]
        nz_any = (lv != 0).any(-1)            # [mbh, mbw, 6]
        for row in range(mbh):
            bw = BitW()
            bw.w(1, 24)
            bw.w(row + 1, 8)
            bw.w(qcode, 5)
            bw.w(0, 1)
            last = [128, 128, 128]
            pmv = [0, 0]
            pending = 0
            for x in range(mbw):
                zero_mv = mv[row, x, 0] == 0 and mv[row, x, 1] == 0
                cbp = 0
                for blk in range(6):
                    if nz_any[row, x, blk]:
                        cbp |= 1 << (5 - blk)
                intra = bool(use_intra[row, x])
                can_skip = (not intra and zero_mv and cbp == 0
                            and 0 < x < mbw - 1 and pmv == [0, 0])
                if can_skip:
                    pending += 1
                    last = [128, 128, 128]
                    continue
                self._put_inc(bw, pending + 1)
                pending = 0
                if intra:
                    bw.w(*_PTYPE[F_INTRA])
                    pmv = [0, 0]
                    for blk in range(6):
                        comp = 0 if blk < 4 else (blk & 1) + 1
                        self._put_dc(bw, int(idc[row, x, blk]), last,
                                     comp)
                        zl = ilv[row, x, blk][_ZZ]
                        nz = np.nonzero(zl)[0]
                        self._put_coeffs(bw, nz, zl[nz], False,
                                         intra=True)
                    continue
                last = [128, 128, 128]
                if zero_mv and pmv == [0, 0]:
                    # no-MC coded MB (cbp only); cbp == 0 can't happen
                    # here except at row edges -> code 0-MV explicitly
                    if cbp:
                        bw.w(*_PTYPE[F_CBP])
                    else:
                        bw.w(*_PTYPE[F_FWD])
                        pmv[0] = self._put_mv(bw, 0, pmv[0])
                        pmv[1] = self._put_mv(bw, 0, pmv[1])
                else:
                    flags = F_FWD | (F_CBP if cbp else 0)
                    bw.w(*_PTYPE[flags])
                    pmv[0] = self._put_mv(bw, int(mv[row, x, 0]),
                                          pmv[0])
                    pmv[1] = self._put_mv(bw, int(mv[row, x, 1]),
                                          pmv[1])
                if cbp:
                    bw.w(*_PAT[cbp])
                    for blk in range(6):
                        if not (cbp >> (5 - blk)) & 1:
                            continue
                        zl = lv[row, x, blk][_ZZ]
                        nz = np.nonzero(zl)[0]
                        self._put_coeffs(bw, nz, zl[nz], True)
            out += bw.bytes()
        return bytes(out)

    def _store_recon(self, ires, res, use_intra, pred_y, pred_uv):
        """Assemble the reference frame from per-MB recon blocks."""
        mbh, mbw = self.ch // 16, self.cw // 16
        y = np.zeros((self.ch, self.cw), np.int32)
        u = np.zeros((self.ch // 2, self.cw // 2), np.int32)
        v = np.zeros_like(u)
        bi = ires.reshape(mbh, mbw, 6, 8, 8)
        bp = None if res is None else res.reshape(mbh, mbw, 6, 8, 8)
        for row in range(mbh):
            for x in range(mbw):
                if use_intra[row, x]:
                    blocks = bi[row, x]
                    py = pu = pv = 0
                else:
                    blocks = bp[row, x]
                    py = pred_y[row * 16:row * 16 + 16,
                                x * 16:x * 16 + 16]
                    pu = pred_uv[0][row * 8:row * 8 + 8,
                                    x * 8:x * 8 + 8]
                    pv = pred_uv[1][row * 8:row * 8 + 8,
                                    x * 8:x * 8 + 8]
                mb = np.zeros((16, 16), np.int32)
                mb[0:8, 0:8] = blocks[0]
                mb[0:8, 8:16] = blocks[1]
                mb[8:16, 0:8] = blocks[2]
                mb[8:16, 8:16] = blocks[3]
                y[row * 16:row * 16 + 16, x * 16:x * 16 + 16] = \
                    np.clip(py + mb, 0, 255)
                u[row * 8:row * 8 + 8, x * 8:x * 8 + 8] = \
                    np.clip(pu + blocks[4], 0, 255)
                v[row * 8:row * 8 + 8, x * 8:x * 8 + 8] = \
                    np.clip(pv + blocks[5], 0, 255)
        self._ref = (y.astype(np.uint8), u.astype(np.uint8),
                     v.astype(np.uint8))


def _w16_arr(a):
    return ((a + 0x8000) & 0xFFFF) - 0x8000


_DCT_M = None


def _dct_mat() -> np.ndarray:
    """Orthonormal 8x8 DCT-II matrix (float64): X = D @ x @ D.T."""
    global _DCT_M
    if _DCT_M is None:
        k = np.arange(8)
        D = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
        D[0] *= 1 / np.sqrt(2)
        _DCT_M = D
    return _DCT_M


@register_encoder
class Mpeg2Encoder(Mpeg1Encoder):
    """MPEG-2 video encoder (MP@ML progressive frame pictures)."""

    INFO = CodecInfo(name="mpeg2video", long_name="MPEG-2 video",
                     codec_type="video")
    OPTIONS = Mpeg1Encoder.OPTIONS
    MPEG2 = True
