"""HEVC decoder (Main profile intra feature point) + conformance
stream generator.

Decode path: parameter sets (ps.py) -> slice header -> CABAC CTU walk
(ctu.py, shared with the generator) -> per-TU dequant + inverse
transform + intra prediction (recon.py) in z-order. The generator
drives the same walker in encode mode with randomized legal choices —
both are validated bit-exactly against the reference decoder.

Behavioral reference: libavcodec/hevc/hevcdec.c:4310.

A copy of librempeg_tpu/codecs/hevc/decoder.py (host code, no JAX),
imports rewritten; its frames carry tensors on `device` (default
"cuda"; numpy planes with device=None), and they leave in display order with the packets' timestamps
sorted: a picture is stamped when it is output, with the least pts of
the pictures decoded and not yet output. A raw stream's packets carry
decode-order pts (0, 1, 2, ...), which become 0, 1, 2, ... in display
order; packets that carry display times already (MP4 ctts, MPEG-TS PES
pts) keep them.
"""
from __future__ import annotations

import heapq

import numpy as np

from librempeg_tpu_torch.codecs.api import CodecInfo, Decoder, register_decoder
from librempeg_tpu_torch.codecs.hevc import ps as PS
from librempeg_tpu_torch.codecs.hevc import recon as R
from librempeg_tpu_torch.codecs.hevc.cabac import CabacDecoder, CabacEncoder
from librempeg_tpu_torch.codecs.hevc.ctu import Chooser, CtuCoder
from librempeg_tpu_torch.core.errors import InvalidData, Unsupported
from librempeg_tpu_torch.core.frame import VideoFrame
from librempeg_tpu_torch.core.rational import NOPTS, Rational
from librempeg_tpu_torch.device import resolve


class _PicRecon:
    """Per-picture reconstruction driven by CtuCoder callbacks."""

    def __init__(self, sps, qp, pps, refs=None, cur_poc=0, max_merge=5,
                 slice_type=2):
        w, h = sps.width, sps.height
        self.y = np.zeros((h, w), np.uint8)
        self.u = np.full((h // 2, w // 2), 0, np.uint8)
        self.v = np.full((h // 2, w // 2), 0, np.uint8)
        self.done = [np.zeros((h // 4, w // 4), bool),
                     np.zeros((h // 4, w // 4), bool),
                     np.zeros((h // 4, w // 4), bool)]
        self.qp = qp
        self.qp_cb = R.chroma_qp(qp, pps.cb_qp_offset)
        self.qp_cr = R.chroma_qp(qp, pps.cr_qp_offset)
        self.sps = sps
        self.pred = [R.IntraPred(self.y, sps.strong_intra_smoothing),
                     R.IntraPred(self.u, False),
                     R.IntraPred(self.v, False)]
        # inter state: per-list ref planes+POC, per-4x4 prediction info
        # (the tab_mvf analog, hevcdec.c:2152)
        self.refs = refs or [None, None]   # [( (y,u,v), poc ) or None]*2
        self.refpoc = [r[1] if r else None for r in self.refs]
        self.cur_poc = cur_poc
        self.max_merge = max_merge
        self.slice_type = slice_type
        self.pred4 = np.full((h // 4, w // 4), -1, np.int8)
        self.mv4 = np.zeros((h // 4, w // 4, 2, 2), np.int32)
        self.pflag4 = np.zeros((h // 4, w // 4, 2), bool)
        self.part_mode = 0              # current CU's part (for merge)
        # deblock maps (4x4 luma cells): luma cbf, TB/PB edge flags
        h4, w4 = h // 4, w // 4
        self.cbf4 = np.zeros((h4, w4), bool)
        self.tuedge_v = np.zeros((h4, w4), bool)
        self.tuedge_h = np.zeros((h4, w4), bool)
        self.pbedge_v = np.zeros((h4, w4), bool)
        self.pbedge_h = np.zeros((h4, w4), bool)
        # per-4x4 slice-id grid (the walker's; None = single slice):
        # prediction never crosses slice segments (§6.4.1)
        self.slice4 = None

    def _sl_ok(self, cy, cx, cur_sl) -> bool:
        return self.slice4 is None or self.slice4[cy, cx] == cur_sl

    def _cur_sl(self, gx, gy):
        return 0 if self.slice4 is None else int(self.slice4[gy, gx])

    def deblock_maps(self):
        return {"intra": self.pred4 == 0, "inter": self.pred4 == 1,
                "cbf": self.cbf4, "mv": self.mv4, "pflag": self.pflag4,
                "refpoc": self.refpoc,
                "tuedge_v": self.tuedge_v, "tuedge_h": self.tuedge_h,
                "pbedge_v": self.pbedge_v, "pbedge_h": self.pbedge_h}

    def on_cu(self, x0, y0, log2, part_nxn, modes, chroma_mode):
        n4 = (1 << log2) // 4
        self.pred4[y0 // 4:y0 // 4 + n4, x0 // 4:x0 // 4 + n4] = 0

    def on_tu(self, x0, y0, log2, cidx, coeffs, mode):
        n = 1 << log2
        if cidx == 0:                   # deblock maps (luma TBs only)
            g0x, g0y, gn = x0 // 4, y0 // 4, n // 4
            self.tuedge_v[g0y:g0y + gn, g0x] = True
            self.tuedge_h[g0y, g0x:g0x + gn] = True
            if coeffs is not None:
                self.cbf4[g0y:g0y + gn, g0x:g0x + gn] = True
        if cidx == 0:
            plane, qp = self.y, self.qp
            px, py = x0, y0
        else:
            plane = self.u if cidx == 1 else self.v
            qp = self.qp_cb if cidx == 1 else self.qp_cr
            px, py = x0 // 2, y0 // 2
        done = self.done[cidx]
        # the done grid is 4x4 in LUMA coords; chroma planes index it
        # at half resolution (2 chroma samples per cell)
        shift = 2 if cidx == 0 else 1
        cur_sl = self._cur_sl(px >> shift, py >> shift)

        def avail(sx, sy):
            cy, cx = sy >> shift, sx >> shift
            return bool(done[cy, cx]) and self._sl_ok(cy, cx, cur_sl)

        if mode >= 0:                   # intra TU
            pred = self.pred[cidx].predict(px, py, n, mode, cidx,
                                           avail)
        else:                           # inter: MC already in plane
            pred = plane[py:py + n, px:px + n].astype(np.int32)
        if coeffs is not None:
            d = R.dequant(coeffs, qp, log2)
            res = R.inverse_transform(
                d, use_dst=(cidx == 0 and log2 == 2 and mode >= 0))
            out = np.clip(pred + res, 0, 255)
        else:
            out = pred
        plane[py:py + n, px:px + n] = out.astype(np.uint8)
        # mark done at 4x4 luma-equivalent granularity
        if cidx == 0:
            done[py // 4:(py + n) // 4, px // 4:(px + n) // 4] = True
        else:
            done[py * 2 // 4:(py + n) * 2 // 4,
                 px * 2 // 4:(px + n) * 2 // 4] = True

    # ---------------------------------------------------------- inter
    # motion tuple: (pf0, pf1, (mv0x, mv0y), (mv1x, mv1y)); unused-list
    # MVs are (0, 0), so tuple equality == compare_mv_ref_idx
    # (mvs.c:100 — refIdx is 0 everywhere with one ref per list)

    def _nb(self, x, y, cur_sl=0):
        """Neighbor motion at luma (x, y), or None when outside the
        picture, not yet decoded (z-scan order), in another slice,
        or intra."""
        h4, w4 = self.pred4.shape
        gx, gy = x >> 2, y >> 2
        if x < 0 or y < 0 or gx >= w4 or gy >= h4:
            return None
        if not self._sl_ok(gy, gx, cur_sl):
            return None
        if self.pred4[gy, gx] != 1:
            return None
        return (int(self.pflag4[gy, gx, 0]), int(self.pflag4[gy, gx, 1]),
                (int(self.mv4[gy, gx, 0, 0]), int(self.mv4[gy, gx, 0, 1])),
                (int(self.mv4[gy, gx, 1, 0]), int(self.mv4[gy, gx, 1, 1])))

    # spec Table 8-8 combined-candidate index pairs (l0CandIdx, l1CandIdx)
    _COMB = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1),
             (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2))

    def _merge_list(self, x0, y0, w, h, part, idx):
        """Merge candidates (§8.5.3.2.2-4 / mvs.c:287): spatial, then
        combined bi-predictive (B), then zero fill. Temporal MVP is
        disabled in the SPS."""
        sl = self._cur_sl(x0 >> 2, y0 >> 2)
        is_b = self.slice_type == 0
        cands = []
        a1 = b1 = None
        if not (idx == 1 and part == 2):        # Nx2N PU1: A1 excluded
            a1 = self._nb(x0 - 1, y0 + h - 1, sl)
            if a1 is not None:
                cands.append(a1)
        if not (idx == 1 and part == 1):        # 2NxN PU1: B1 excluded
            b1 = self._nb(x0 + w - 1, y0 - 1, sl)
            if b1 is not None and b1 != a1:
                cands.append(b1)
        b0 = self._nb(x0 + w, y0 - 1, sl)
        if b0 is not None and b0 != b1:
            cands.append(b0)
        a0 = self._nb(x0 - 1, y0 + h, sl)
        if a0 is not None and a0 != a1:
            cands.append(a0)
        if len(cands) != 4:
            b2 = self._nb(x0 - 1, y0 - 1, sl)
            if b2 is not None and b2 != a1 and b2 != b1:
                cands.append(b2)
        norig = len(cands)
        if is_b and norig > 1:
            for ci in range(min(norig * (norig - 1), 12)):
                if len(cands) >= self.max_merge:
                    break
                c0 = cands[self._COMB[ci][0]]
                c1 = cands[self._COMB[ci][1]]
                if c0[0] and c1[1] and (
                        self.refpoc[0] != self.refpoc[1]
                        or c0[2] != c1[3]):
                    cands.append((1, 1, c0[2], c1[3]))
        while len(cands) < self.max_merge:
            cands.append((1, 1 if is_b else 0, (0, 0), (0, 0)))
        return cands

    @staticmethod
    def _scale(mv, td, tb):
        """§8.5.3.2.8 MV scaling (mvs.c:116 mv_scale, C semantics:
        truncating division, arithmetic shifts)."""
        td = max(-128, min(127, td))
        tb = max(-128, min(127, tb))
        q = (0x4000 + (abs(td) >> 1)) // abs(td)
        tx = q if td > 0 else -q
        sf = max(-4096, min(4095, (tb * tx + 32) >> 6))

        def comp(v):
            p = sf * v
            return max(-32768, min(32767, (p + 127 + (p < 0)) >> 8))

        return (comp(mv[0]), comp(mv[1]))

    def _scaled_mv(self, mv, cand_ref_poc, target_poc):
        """dist_scale (mvs.c:517): identity when the candidate already
        references the target picture."""
        if cand_ref_poc == target_poc:
            return mv
        td = self.cur_poc - cand_ref_poc
        if td == 0:
            td = 1
        return self._scale(mv, td, self.cur_poc - target_poc)

    def _amvp(self, x0, y0, w, h, X):
        """AMVP candidate pair for list X (§8.5.3.2.6-7, mirrors
        mvs.c:589 ff_hevc_luma_mv_mvp_mode): A then B positions, each
        checking list X then the other list; same-picture matches
        first, then POC-scaled (A always; B only when neither A
        position exists)."""
        sl = self._cur_sl(x0 >> 2, y0 >> 2)
        target = self.refpoc[X]
        A = (self._nb(x0 - 1, y0 + h, sl),
             self._nb(x0 - 1, y0 + h - 1, sl))
        is_scaled = any(c is not None for c in A)
        mxA = None
        for c in A:
            if c is None:
                continue
            for L in (X, 1 - X):
                if c[L] and self.refpoc[L] == target:
                    mxA = c[2 + L]
                    break
            if mxA is not None:
                break
        if mxA is None:
            for c in A:
                if c is None:
                    continue
                for L in (X, 1 - X):
                    if c[L]:
                        mxA = self._scaled_mv(c[2 + L], self.refpoc[L],
                                              target)
                        break
                if mxA is not None:
                    break
        B = (self._nb(x0 + w, y0 - 1, sl),
             self._nb(x0 + w - 1, y0 - 1, sl),
             self._nb(x0 - 1, y0 - 1, sl))
        mxB = None
        for c in B:
            if c is None:
                continue
            for L in (X, 1 - X):
                if c[L] and self.refpoc[L] == target:
                    mxB = c[2 + L]
                    break
            if mxB is not None:
                break
        if not is_scaled:
            if mxB is not None:
                mxA = mxB
            mxB = None
            for c in B:
                if c is None:
                    continue
                for L in (X, 1 - X):
                    if c[L]:
                        mxB = self._scaled_mv(c[2 + L], self.refpoc[L],
                                              target)
                        break
                if mxB is not None:
                    break
        out = []
        if mxA is not None:
            out.append(mxA)
        if mxB is not None and (mxA is None or mxB != mxA):
            out.append(mxB)
        while len(out) < 2:
            out.append((0, 0))
        return out

    @staticmethod
    def _wrap16(mv):
        """MVs live in int16 in the reference (Mv in hevcdec.h); the
        predictor+mvd sum wraps accordingly."""
        return (((mv[0] + 0x8000) & 0xFFFF) - 0x8000,
                ((mv[1] + 0x8000) & 0xFFFF) - 0x8000)

    def on_pu(self, x0, y0, w, h, part, idx, pu):
        if pu["merge"]:
            pf0, pf1, mv0, mv1 = self._merge_list(
                x0, y0, w, h, part, idx)[pu["merge_idx"]]
            if pf0 and pf1 and w + h == 12:
                pf1 = 0                 # 8x4/4x8: no bi (mvs.c:509)
                mv1 = (0, 0)
        else:
            idc = pu["idc"]
            pf0, pf1 = int(idc != 1), int(idc != 0)
            mv0 = mv1 = (0, 0)
            if pf0:
                p = self._amvp(x0, y0, w, h, 0)[pu["mvp"]]
                mv0 = self._wrap16((p[0] + pu["mvd"][0],
                                    p[1] + pu["mvd"][1]))
            if pf1:
                p = self._amvp(x0, y0, w, h, 1)[pu["mvp1"]]
                mv1 = self._wrap16((p[0] + pu["mvd1"][0],
                                    p[1] + pu["mvd1"][1]))
        gx, gy = x0 // 4, y0 // 4
        self.pred4[gy:gy + h // 4, gx:gx + w // 4] = 1
        self.pflag4[gy:gy + h // 4, gx:gx + w // 4] = (bool(pf0),
                                                       bool(pf1))
        self.mv4[gy:gy + h // 4, gx:gx + w // 4, 0] = mv0
        self.mv4[gy:gy + h // 4, gx:gx + w // 4, 1] = mv1
        self.pbedge_v[gy:gy + h // 4, gx] = True
        self.pbedge_h[gy, gx:gx + w // 4] = True
        cw, chh = w // 2, h // 2
        cx, cy = x0 // 2, y0 // 2
        if pf0 and pf1:                 # bi: average 14-bit intermediates
            r0, r1 = self.refs[0][0], self.refs[1][0]
            self.y[y0:y0 + h, x0:x0 + w] = R.bi_avg(
                R.mc_luma_int(r0[0], x0, y0, w, h, *mv0),
                R.mc_luma_int(r1[0], x0, y0, w, h, *mv1))
            for ci in (1, 2):
                self._cplane(ci)[cy:cy + chh, cx:cx + cw] = R.bi_avg(
                    R.mc_chroma_int(r0[ci], cx, cy, cw, chh, *mv0),
                    R.mc_chroma_int(r1[ci], cx, cy, cw, chh, *mv1))
        else:
            L = 0 if pf0 else 1
            mv = mv0 if pf0 else mv1
            ry, ru, rv = self.refs[L][0]
            self.y[y0:y0 + h, x0:x0 + w] = R.mc_luma(
                ry, x0, y0, w, h, mv[0], mv[1])
            self.u[cy:cy + chh, cx:cx + cw] = R.mc_chroma(
                ru, cx, cy, cw, chh, mv[0], mv[1])
            self.v[cy:cy + chh, cx:cx + cw] = R.mc_chroma(
                rv, cx, cy, cw, chh, mv[0], mv[1])
        for d in self.done:
            d[y0 // 4:(y0 + h) // 4, x0 // 4:(x0 + w) // 4] = True

    def _cplane(self, cidx):
        return self.u if cidx == 1 else self.v


@register_decoder
class HevcDecoder(Decoder):
    """HEVC Main profile: I (IDR) / P / B pictures, 4:2:0 8-bit, with
    deblocking + SAO, multi-slice pictures, POC-ordered output."""

    INFO = CodecInfo(name="hevc", long_name="HEVC / H.265",
                     codec_type="video")
    ALIASES = ("h265",)

    def __init__(self, params=None, device="cuda", **opts):
        # host decoder: the planes are uploaded to `device`, or stay
        # numpy arrays where the caller passes device=None
        self.device = None if device is None else resolve(device)
        self.sps = None
        self.pps = None
        self._dpb = {}                  # poc -> (y, u, v) of ref pics
        self._prev_poc = 0              # prevTid0Pic POC (§8.3.1)
        self._reorder = []              # [(poc, VideoFrame)] pending out
        self._pts = []                  # heap: pts of the pending pictures
        super().__init__(params, **opts)

    def configure(self, params):
        if params.extradata and bytes(params.extradata[:1]) == b"\x00":
            self._headers(bytes(params.extradata))

    def _headers(self, data: bytes):
        for ntype, rbsp in PS.split_nals(data):
            if ntype == PS.NAL_SPS:
                self.sps = PS.parse_sps(rbsp)
            elif ntype == PS.NAL_PPS:
                self.pps = PS.parse_pps(rbsp)

    def decode(self, pkt):
        frames = []
        pending = []                    # slice NALs of one picture
        for ntype, rbsp in PS.split_nals(bytes(pkt.data)):
            if ntype == PS.NAL_SPS:
                self.sps = PS.parse_sps(rbsp)
            elif ntype == PS.NAL_PPS:
                self.pps = PS.parse_pps(rbsp)
            elif ntype in (PS.NAL_IDR_W_RADL, 20, 0, 1):
                if self.sps is None or self.pps is None:
                    raise InvalidData("hevc: slice before SPS/PPS")
                sh = PS.parse_slice_header(rbsp, self.sps, self.pps,
                                           ntype)
                if sh.first_slice and pending:
                    frames.extend(self._decode_picture(pending, pkt))
                    pending = []
                pending.append((ntype, rbsp, sh))
            elif ntype < 32:
                raise Unsupported(f"hevc: nal type {ntype}")
        if pending:
            frames.extend(self._decode_picture(pending, pkt))
        return frames

    def flush(self):
        out = [self._output(f)
               for _, f in sorted(self._reorder, key=lambda t: t[0])]
        self._reorder = []
        return out

    def _output(self, frame):
        """`frame` as it leaves the decoder: stamped with the least
        pending pts and moved to the decoder's device."""
        if frame.pts != NOPTS:
            frame = frame.replace(pts=heapq.heappop(self._pts))
        return frame if self.device is None else frame.to_device(self.device)

    def _poc_of(self, ntype, sh):
        """PicOrderCntVal (§8.3.1) with MSB wraparound against the
        previous TemporalId-0 reference picture."""
        if ntype in (19, 20):
            return 0
        max_lsb = 1 << self.sps.log2_max_poc_lsb
        prev_lsb = self._prev_poc & (max_lsb - 1)
        prev_msb = self._prev_poc - prev_lsb
        lsb = sh.poc_lsb
        if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
            msb = prev_msb + max_lsb
        elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
            msb = prev_msb - max_lsb
        else:
            msb = prev_msb
        return msb + lsb

    def _bump(self, force=False):
        """Emit pending pictures in POC order (§C.5.2.2 bumping with
        sps_max_num_reorder_pics)."""
        out = []
        depth = 0 if force else self.sps.num_reorder
        while len(self._reorder) > depth:
            i = min(range(len(self._reorder)),
                    key=lambda k: self._reorder[k][0])
            out.append(self._output(self._reorder.pop(i)[1]))
        return out

    def _decode_picture(self, slices, pkt):
        """Decode one picture's slice segments (all NALs of one AU);
        returns the POC-ordered frames ready for output."""
        ntype, _, sh0 = slices[0]
        if not sh0.first_slice:
            raise InvalidData("hevc: picture lacks its first slice")
        out = []
        if ntype in (19, 20):           # IDR: drain output, reset DPB
            out = self._bump(force=True)
            self._dpb.clear()
            self._prev_poc = 0
        poc = self._poc_of(ntype, sh0)
        refs = [None, None]
        if sh0.slice_type != 2:
            p0 = poc - sh0.poc_delta
            if p0 not in self._dpb:
                raise InvalidData("hevc: L0 reference not in DPB")
            refs[0] = (self._dpb[p0], p0)
            if sh0.slice_type == 0:
                p1 = poc + sh0.poc_delta_pos
                if p1 not in self._dpb:
                    raise InvalidData("hevc: L1 reference not in DPB")
                refs[1] = (self._dpb[p1], p1)
        pic = _PicRecon(self.sps, sh0.qp, self.pps, refs=refs,
                        cur_poc=poc, max_merge=sh0.max_merge,
                        slice_type=sh0.slice_type)
        coder = CtuCoder(self.sps, self.pps, sh0.qp,
                         dec=None,
                         on_tu=pic.on_tu, on_cu=pic.on_cu,
                         on_pu=pic.on_pu, slice_type=sh0.slice_type,
                         max_merge=sh0.max_merge, sao_luma=sh0.sao_luma,
                         sao_chroma=sh0.sao_chroma)
        if len(slices) > 1:
            pic.slice4 = coder.slice4
        n_ctb = self.sps.pic_w_ctb * self.sps.pic_h_ctb
        sh = sh0
        for k, (nt, rbsp, sh) in enumerate(slices):
            start = sh.segment_address
            end = slices[k + 1][2].segment_address \
                if k + 1 < len(slices) else n_ctb
            if (k == 0 and start != 0) or not start < end <= n_ctb:
                raise InvalidData("hevc: bad slice segment order")
            dec = CabacDecoder(rbsp, sh.data_bit_pos, sh.init_type,
                               sh.qp)
            coder.dec = dec
            coder.slice_type = sh.slice_type
            coder.max_merge = sh.max_merge
            coder.mvd_l1_zero = sh.mvd_l1_zero
            pic.max_merge = sh.max_merge
            pic.slice_type = sh.slice_type
            coder.code_slice(start, end, slice_id=k)
            if dec.error:
                raise InvalidData("hevc: slice overread")
        sh = sh0
        if not self.pps.deblocking_disabled:
            from librempeg_tpu_torch.codecs.hevc.deblock import deblock_picture

            deblock_picture(pic, self.sps, self.pps, sh)
        if sh.sao_luma or sh.sao_chroma:
            from librempeg_tpu_torch.codecs.hevc.sao import sao_filter_picture

            pic.sao = coder.saog
            sao_filter_picture(pic, self.sps, sh)
        is_ref = ntype in (19, 20) or (ntype < 16 and ntype & 1)
        if is_ref:
            self._dpb[poc] = (pic.y, pic.u, pic.v)
            while len(self._dpb) > 8:   # bound; lookups are POC-exact
                self._dpb.pop(next(iter(self._dpb)))
            self._prev_poc = poc        # TemporalId 0 everywhere here
        tb = pkt.time_base if pkt.time_base.valid and pkt.time_base.num \
            else Rational(1, 25)
        sps = self.sps
        ow, oh = sps.out_width, sps.out_height
        cl, ct = sps.crop_l, sps.crop_t
        planes = (pic.y[ct:ct + oh, cl:cl + ow],
                  pic.u[ct // 2:(ct + oh) // 2, cl // 2:(cl + ow) // 2],
                  pic.v[ct // 2:(ct + oh) // 2, cl // 2:(cl + ow) // 2])
        frame = VideoFrame(planes=planes,
                           format="yuv420p", width=ow,
                           height=oh, pts=pkt.pts,
                           time_base=tb)
        if pkt.pts != NOPTS:
            heapq.heappush(self._pts, pkt.pts)
        self._reorder.append((poc, frame))
        out.extend(self._bump())
        return out


# ---------------------------------------------------------------------------
# conformance stream generator
# ---------------------------------------------------------------------------

def generate_stream(width: int, height: int, n_frames: int = 1, *,
                    seed: int = 0, qp: int = 30, ctb_log2: int = 5,
                    density: float = 0.25, amp: int = 6,
                    split_prob: float = 0.35, nxn_prob: float = 0.3,
                    p_frames: bool = False, b_frames: bool = False,
                    mvd_l1_zero: bool = False, max_merge: int = 5,
                    deblock: bool = False, beta_offset: int = 0,
                    tc_offset: int = 0, sao: bool = False,
                    sao_chroma: bool | None = None,
                    slices: int = 1) -> bytes:
    """Randomized-but-valid HEVC stream (annex B): an IDR picture,
    followed by TRAIL_R P pictures when p_frames is set; with b_frames
    the GOP is I P B P B ... in decode order (each TRAIL_N B picture
    references its POC neighbors, display order I B P B P).

    width/height are the DISPLAY size; non-multiple-of-8 dimensions get
    a coded size rounded up to the min-CB grid plus a conformance
    window (§7.4.3.2.1) cropping back — the path every real-encoder
    stream with an odd display size exercises."""
    cw = (width + 7) & ~7
    ch = (height + 7) & ~7
    sps = PS.HevcSPS(width=cw, height=ch, crop_r=cw - width,
                     crop_b=ch - height, log2_ctb=ctb_log2,
                     log2_max_tb=min(5, ctb_log2), sao_enabled=sao,
                     max_dec_pic_buffering=3 if b_frames else 1,
                     num_reorder=1 if b_frames else 0)
    pps = PS.HevcPPS(init_qp=qp, deblocking_disabled=not deblock,
                     beta_offset=beta_offset, tc_offset=tc_offset)
    sao_c = sao if sao_chroma is None else sao_chroma
    out = bytearray()
    out += PS.write_vps()
    out += PS.write_sps(sps)
    out += PS.write_pps(pps)
    n_ctb = sps.pic_w_ctb * sps.pic_h_ctb
    nsl = max(1, min(slices, n_ctb))
    bounds = [round(k * n_ctb / nsl) for k in range(nsl + 1)]
    # picture plan in DECODE order: (poc, slice_type, nal, dneg, dpos)
    if b_frames:
        plan = [(0, 2, PS.NAL_IDR_W_RADL, 0, 0)]
        k = 0
        while k + 2 <= n_frames - 1:
            plan.append((k + 2, 1, PS.NAL_TRAIL_R, 2, 0))
            plan.append((k + 1, 0, 0, 1, 1))       # TRAIL_N B
            k += 2
        if k < n_frames - 1:
            plan.append((k + 1, 1, PS.NAL_TRAIL_R, 1, 0))
    else:
        plan = [(i, 1 if (p_frames and i) else 2,
                 PS.NAL_TRAIL_R if (p_frames and i)
                 else PS.NAL_IDR_W_RADL, 1, 0) for i in range(n_frames)]
    for poc, stype, ntype, dneg, dpos in plan:
        ch = Chooser(seed=seed + 1000 * poc, qp=qp, density=density,
                     amp=amp, split_prob=split_prob, nxn_prob=nxn_prob)
        coder = CtuCoder(sps, pps, qp, enc=None, chooser=ch,
                         slice_type=stype, max_merge=max_merge,
                         sao_luma=sao, sao_chroma=sao_c)
        coder.mvd_l1_zero = mvd_l1_zero and stype == 0
        for k in range(nsl):
            hdr = PS.write_slice_header(
                sps, pps, qp, slice_type=stype,
                poc_lsb=poc % (1 << sps.log2_max_poc_lsb),
                poc_delta=max(dneg, 1), poc_delta_pos=max(dpos, 1),
                max_merge=max_merge,
                mvd_l1_zero=mvd_l1_zero and stype == 0,
                sao_luma=sao, sao_chroma=sao_c,
                first_slice=(k == 0), segment_address=bounds[k])
            enc = CabacEncoder({2: 0, 1: 1, 0: 2}[stype], qp)
            coder.enc = enc
            coder.code_slice(bounds[k], bounds[k + 1], slice_id=k)
            rbsp = hdr.bytes() + enc.bytes()
            out += PS.rbsp_to_nal(rbsp, ntype)
    return bytes(out)
