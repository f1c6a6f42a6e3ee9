"""H.264 frame encoder (I + P slices): motion search over all partition
shapes (16x16/16x8/8x16/8x8 + sub-8x8), quarter-pel refinement, I_16x16
and I_4x4 intra, P_SKIP, CAVLC packing, spec-exact reconstruction.

The reconstruction path reuses the decoder's integer primitives
(codecs/h264/recon.py), so every stream this encoder emits doubles as a
decoder test vector: tests assert our decoder's output is bit-exact
with both this encoder's recon and the reference decoder's output.
A `variety` mode forces each partition shape / intra type cyclically so
conformance tests cover every decode path deterministically.

Behavioral reference (not a translation): mpegvideo_enc.c-style host
loop adapted to H.264 syntax (§7.3.5, §8.4.1 mv prediction, §9.2
CAVLC); interpolation matches the decode side exactly (§8.4.2.2).

A copy of librempeg_tpu/codecs/h264/inter_enc.py (host code, no JAX),
imports rewritten.
"""
from __future__ import annotations

import numpy as np

from librempeg_tpu_torch.codecs.flac.bitio import BitWriterMSB
from librempeg_tpu_torch.codecs.h264 import intra as I
from librempeg_tpu_torch.codecs.h264 import recon as R
from librempeg_tpu_torch.codecs.h264.cavlc import ZIGZAG4, write_residual
from librempeg_tpu_torch.codecs.h264.intra import (
    _BLK4,
    _NcCtx,
    _rbsp_to_nal,
    _write_se,
    _write_ue,
)

# CBP me(v) inverse mappings (Table 9-4)
_GOLOMB_TO_INTER_CBP = [
    0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13,
    14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
    17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41]
_GOLOMB_TO_INTRA4X4_CBP = [
    47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46,
    16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4,
    8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41]
_INTER_CBP_TO_GOLOMB = np.zeros(48, np.int32)
_INTRA_CBP_TO_GOLOMB = np.zeros(48, np.int32)
for _g, _c in enumerate(_GOLOMB_TO_INTER_CBP):
    _INTER_CBP_TO_GOLOMB[_c] = _g
for _g, _c in enumerate(_GOLOMB_TO_INTRA4X4_CBP):
    _INTRA_CBP_TO_GOLOMB[_c] = _g

# sub_mb_type geometry: (n_parts, part_w4, part_h4)
_SUB_GEOM = {0: (1, 2, 2), 1: (2, 2, 1), 2: (2, 1, 2), 3: (4, 1, 1)}


class MotionCtx:
    """Per-frame mv/ref grids mirroring the decoder's prediction state
    (native/h264.cpp SliceCtx): refg -2 undecoded, -1 intra, >=0 ref."""

    def __init__(self, mb_w: int, mb_h: int):
        self.w4, self.h4 = mb_w * 4, mb_h * 4
        self.mvg = np.zeros((self.h4, self.w4, 2), np.int32)
        self.refg = np.full((self.h4, self.w4), -2, np.int32)

    def fetch(self, x4: int, y4: int):
        if x4 < 0 or y4 < 0 or x4 >= self.w4 or y4 >= self.h4:
            return False, -1, 0, 0
        r = int(self.refg[y4, x4])
        if r == -2:
            return False, -1, 0, 0
        if r < 0:
            return True, -1, 0, 0
        return True, r, int(self.mvg[y4, x4, 0]), int(self.mvg[y4, x4, 1])

    def predict(self, x4, y4, w4p, h4p, ref, part_kind=0):
        aA, rA, xA, yA = self.fetch(x4 - 1, y4)
        aB, rB, xB, yB = self.fetch(x4, y4 - 1)
        aC, rC, xC, yC = self.fetch(x4 + w4p, y4 - 1)
        if not aC:
            aC, rC, xC, yC = self.fetch(x4 - 1, y4 - 1)
        if part_kind == 1 and aB and rB == ref:
            return xB, yB
        if part_kind in (2, 3) and aA and rA == ref:
            return xA, yA
        if part_kind == 4 and aC and rC == ref:
            return xC, yC
        if not aB and not aC and aA:
            return xA, yA
        eA = aA and rA == ref
        eB = aB and rB == ref
        eC = aC and rC == ref
        if eA and not eB and not eC:
            return xA, yA
        if eB and not eA and not eC:
            return xB, yB
        if eC and not eA and not eB:
            return xC, yC

        def med(a, b, c):
            return a + b + c - max(a, b, c) - min(a, b, c)

        return med(xA, xB, xC), med(yA, yB, yC)

    def skip_mv(self, mx: int, my: int):
        x4, y4 = mx * 4, my * 4
        aA, rA, xA, yA = self.fetch(x4 - 1, y4)
        aB, rB, xB, yB = self.fetch(x4, y4 - 1)
        if not aA or not aB or (rA == 0 and xA == 0 and yA == 0) \
                or (rB == 0 and xB == 0 and yB == 0):
            return 0, 0
        return self.predict(x4, y4, 4, 4, 0)

    def fill(self, x4, y4, w4p, h4p, ref, mvx, mvy):
        self.refg[y4:y4 + h4p, x4:x4 + w4p] = ref
        self.mvg[y4:y4 + h4p, x4:x4 + w4p, 0] = mvx
        self.mvg[y4:y4 + h4p, x4:x4 + w4p, 1] = mvy

    def fill_intra(self, mx, my):
        self.refg[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = -1
        self.mvg[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0


def _sad(a, b):
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).sum())


def _int_search(epad, src, y, x, pred_mv, sr, bh=16, bw=16):
    """Full integer-pel search in a +-sr window around the integer part
    of pred_mv; returns (mvx, mvy, SAD) in qpel units. Candidates are
    clamped so the referenced block plus interpolation margin stays
    inside the PAD-replicated plane — coordinate clipping never engages,
    keeping encoder MC identical to decoder per-4x4 MC."""
    p = R.PAD
    hh = epad.shape[0] - 2 * p
    ww = epad.shape[1] - 2 * p
    lo_y, hi_y = -(p - 8), hh - bh + (p - 8)
    lo_x, hi_x = -(p - 8), ww - bw + (p - 8)
    cy = int(np.clip(y + (pred_mv[1] >> 2), lo_y + sr, max(lo_y + sr,
                                                           hi_y - sr)))
    cx = int(np.clip(x + (pred_mv[0] >> 2), lo_x + sr, max(lo_x + sr,
                                                           hi_x - sr)))
    region = epad[cy + p - sr:cy + p + sr + bh,
                  cx + p - sr:cx + p + sr + bw]
    from numpy.lib.stride_tricks import sliding_window_view

    wins = sliding_window_view(region, (bh, bw))
    sads = np.abs(wins.astype(np.int32)
                  - src.astype(np.int32)[None, None]).sum(axis=(2, 3))
    iy, ix = np.unravel_index(np.argmin(sads), sads.shape)
    best = int(sads[iy, ix])
    mvy = (cy - y + int(iy) - sr) * 4
    mvx = (cx - x + int(ix) - sr) * 4
    return mvx, mvy, best


def _subpel_refine(planes, src, y, x, mvx, mvy, best, step, bh=16, bw=16):
    cands = [(best, abs(mvx) + abs(mvy), mvx, mvy)]
    for dy in (-step, 0, step):
        for dx in (-step, 0, step):
            if dx == 0 and dy == 0:
                continue
            pred = R.mc_luma_block(planes, y, x, mvx + dx, mvy + dy, bh, bw)
            cands.append((_sad(pred, src), abs(mvx + dx) + abs(mvy + dy),
                          mvx + dx, mvy + dy))
    s, _, mx, my2 = min(cands)
    return mx, my2, s


def _search_part(planes, src, y, x, pmv, sr, bh, bw):
    mvx, mvy, best = _int_search(planes[0], src, y, x, pmv, sr, bh, bw)
    mvx, mvy, best = _subpel_refine(planes, src, y, x, mvx, mvy, best, 2,
                                    bh, bw)
    mvx, mvy, best = _subpel_refine(planes, src, y, x, mvx, mvy, best, 1,
                                    bh, bw)
    return mvx, mvy, best


def _quant_dc_inter(wdc, qp):
    qbits = 15 + qp // 6
    f = (1 << qbits) // 6
    mf = I._MF[qp % 6][0]
    return (np.sign(wdc) * ((np.abs(wdc) * mf + 2 * f) >> (qbits + 1))
            ).astype(np.int64)


class FrameEncoder:
    """Encodes one I or P frame; owns the per-frame metadata arrays
    needed for the in-loop deblock (shared layout with the decoder)."""

    def __init__(self, mb_w, mb_h, qp, chroma_qp_off=0, search_range=8,
                 variety=False, variety_pcm=True):
        self.mb_w, self.mb_h = mb_w, mb_h
        self.qp = qp
        self.qpc = I.chroma_qp_of(qp, chroma_qp_off)
        self.sr = search_range
        self.variety = variety
        # I_PCM needs CABAC engine re-init mid-slice, which the
        # CAVLC->CABAC entropy transcoder does not support yet
        self.variety_pcm = variety_pcm
        nmb = mb_w * mb_h
        self.kind = np.full(nmb, -1, np.int32)
        self.qp_arr = np.full(nmb, qp, np.int32)
        self.mv_arr = np.zeros((nmb, 16, 2), np.int16)
        self.ref_arr = np.full((nmb, 4), -1, np.int8)
        self.ncoef = np.zeros((nmb, 27), np.int16)

    # ------------------------------------------------------------------
    def encode(self, y, u, v, ref_planes, frame_num, idr_pic_id=0,
               poc_lsb=None):
        """ref_planes = (y,u,v) deblocked recon of the reference, or
        None for an IDR I frame. Returns (nal, (ry,ru,rv) pre-deblock).
        poc_lsb defaults to 2*frame_num (display == coding order)."""
        is_p = ref_planes is not None
        ry = np.zeros(y.shape, np.int64)
        ru = np.zeros(u.shape, np.int64)
        rv = np.zeros(v.shape, np.int64)
        if is_p:
            self.planes = R.qpel_planes(np.asarray(ref_planes[0]))
            self.upad = R.pad_chroma(np.asarray(ref_planes[1]))
            self.vpad = R.pad_chroma(np.asarray(ref_planes[2]))

        bw = BitWriterMSB()
        _write_ue(bw, 0)                          # first_mb
        _write_ue(bw, 5 if is_p else 7)           # slice_type (all slices)
        _write_ue(bw, 0)                          # pps id
        bw.write(frame_num % 16, 4)               # frame_num
        if not is_p:
            _write_ue(bw, idr_pic_id % 16)        # idr_pic_id
        if poc_lsb is None:
            poc_lsb = frame_num * 2
        bw.write(poc_lsb % 256, 8)                # poc lsb (8-bit, SPS)
        if is_p:
            bw.write(0, 1)                        # num_ref_idx_override
            bw.write(0, 1)                        # ref_pic_list_mod
            bw.write(0, 1)                        # adaptive_ref_marking
        else:
            bw.write(0, 1)                        # no_output_of_prior
            bw.write(0, 1)                        # long_term_reference
        _write_se(bw, self.qp - 26)               # slice_qp_delta
        _write_ue(bw, 0)                          # deblocking idc = 0
        _write_se(bw, 0)
        _write_se(bw, 0)

        mc = MotionCtx(self.mb_w, self.mb_h)
        self.ncY = _NcCtx(self.mb_h * 4, self.mb_w * 4)
        self.ncU = _NcCtx(self.mb_h * 2, self.mb_w * 2)
        self.ncV = _NcCtx(self.mb_h * 2, self.mb_w * 2)
        # intra-4x4 mode grid (decoder i4g semantics: -2 unavail,
        # -1 available non-I4x4, >=0 mode)
        self.i4g = np.full((self.mb_h * 4, self.mb_w * 4), -2, np.int32)
        skip_run = 0
        for my in range(self.mb_h):
            for mx in range(self.mb_w):
                skip_run = self._encode_mb(bw, y, u, v, ry, ru, rv,
                                           my, mx, mc, is_p, skip_run)
        if skip_run:
            _write_ue(bw, skip_run)
        bw.write(1, 1)
        bw.align()
        nal = _rbsp_to_nal(bw.bytes(), 1 if is_p else 5, 2 if is_p else 3)
        return nal, (ry.astype(np.uint8), ru.astype(np.uint8),
                     rv.astype(np.uint8))

    # -- mode decision ---------------------------------------------------
    def _encode_mb(self, bw, y, u, v, ry, ru, rv, my, mx, mc, is_p,
                   skip_run):
        mb = my * self.mb_w + mx
        src = y[my * 16:(my + 1) * 16, mx * 16:(mx + 1) * 16]

        if not is_p:
            _ = skip_run
            f = "pcm" if (self.variety and self.variety_pcm
                          and mb % 10 == 9) else None
            self._encode_intra(bw, y, u, v, ry, ru, rv, my, mx, mc,
                               mb_type_offset=0, force=f)
            return 0

        # --- P: search all partition shapes (or the forced one) ---
        forced = None
        if self.variety:
            cyc = ("16x16", "16x8", "8x16", "sub0", "sub1", "sub2",
                   "sub3", "i16", "i4", "pcm")
            forced = cyc[mb % 10]
            if forced == "pcm" and not self.variety_pcm:
                forced = "i4"
        if forced in ("i16", "i4", "pcm"):
            _write_ue(bw, skip_run)
            self._encode_intra(bw, y, u, v, ry, ru, rv, my, mx, mc,
                               mb_type_offset=5, force=forced)
            return 0

        cand = self._search_modes(src, my, mx, mc, forced)
        mbt, parts, sub, total_sad = cand

        # intra fallback (cost proxy), unless a shape is forced
        if forced is None:
            intra_sad = min(
                _sad(I._pred16(ry, my, mx, m), src)
                for m in I._modes16_available(my, mx))
            if intra_sad + 64 < total_sad:
                _write_ue(bw, skip_run)
                self._encode_intra(bw, y, u, v, ry, ru, rv, my, mx, mc,
                                   mb_type_offset=5)
                return 0

        # assemble prediction; transform/quant
        pred = np.zeros((16, 16), np.int64)
        for (px4, py4, w4p, h4p, _pk, mvx, mvy) in parts:
            oy, ox = (py4 - my * 4) * 4, (px4 - mx * 4) * 4
            pred[oy:oy + h4p * 4, ox:ox + w4p * 4] = R.mc_luma_block(
                self.planes, py4 * 4, px4 * 4, mvx, mvy, h4p * 4, w4p * 4)
        predu = np.zeros((8, 8), np.int64)
        predv = np.zeros((8, 8), np.int64)
        for (px4, py4, w4p, h4p, _pk, mvx, mvy) in parts:
            oy, ox = (py4 - my * 4) * 2, (px4 - mx * 4) * 2
            predu[oy:oy + h4p * 2, ox:ox + w4p * 2] = R.mc_chroma_block(
                self.upad, py4 * 2, px4 * 2, mvx, mvy, h4p * 2, w4p * 2)
            predv[oy:oy + h4p * 2, ox:ox + w4p * 2] = R.mc_chroma_block(
                self.vpad, py4 * 2, px4 * 2, mvx, mvy, h4p * 2, w4p * 2)

        lev, cbp_luma = self._quant_luma(src, pred, intra=False)
        c_dc, c_lev, cbp_chroma = self._quant_chroma(u, v, predu, predv,
                                                     my, mx)
        cbp = cbp_luma | (cbp_chroma << 4)

        # --- skip? (16x16 shape, ref0, skip-mv, no residual) ---
        if mbt == 0 and cbp == 0:
            smx, smy = mc.skip_mv(mx, my)
            if (parts[0][5], parts[0][6]) == (smx, smy):
                self._commit_inter(mc, my, mx, parts, mb, kind=0)
                self._recon_inter(ry, ru, rv, my, mx, pred, predu, predv,
                                  None, None, None)
                self._zero_nc(my, mx)
                return skip_run + 1

        # --- emit syntax ---
        _write_ue(bw, skip_run)
        _write_ue(bw, mbt)
        if mbt == 3:                               # P_8x8: sub types
            for s in sub:
                _write_ue(bw, s)
        # (num_ref_idx_l0 == 1: no ref_idx fields)
        # mvds in partition order with the mvp at commit time: recompute
        # predictions progressively (mirror of decode order)
        mvds = []
        for (px4, py4, w4p, h4p, pk, mvx, mvy) in parts:
            pmx, pmy = mc.predict(px4, py4, w4p, h4p, 0, pk)
            mvds.append((mvx - pmx, mvy - pmy))
            mc.fill(px4, py4, w4p, h4p, 0, mvx, mvy)
        for dx, dy in mvds:
            _write_se(bw, dx)
            _write_se(bw, dy)
        _write_ue(bw, int(_INTER_CBP_TO_GOLOMB[cbp]))
        if cbp:
            _write_se(bw, 0)                       # mb_qp_delta
        self._commit_inter(mc, my, mx, parts, mb, kind=1, filled=True)
        self._write_luma_residual(bw, lev, my, mx, cbp_luma, mb,
                                  i16=False)
        self._write_chroma_residual(bw, c_dc, c_lev, my, mx, cbp_chroma)
        self._recon_inter(ry, ru, rv, my, mx, pred, predu, predv,
                          lev if cbp_luma else None,
                          c_dc if cbp_chroma else None,
                          c_lev if cbp_chroma == 2 else None)
        self.i4g[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = -1
        return 0

    def _search_modes(self, src, my, mx, mc, forced):
        """Try partition shapes; return (mb_type, parts, sub_types, sad).
        parts = [(x4, y4, w4, h4, part_kind, mvx, mvy)] in decode order.
        ME for later partitions must see earlier partitions' mvs, so we
        speculatively fill a scratch copy of the motion context."""
        x4, y4 = mx * 4, my * 4
        shapes = [forced] if forced else ["16x16", "16x8", "8x16"]
        best = None
        for shape in shapes:
            scratch_mv = mc.mvg.copy()
            scratch_rf = mc.refg.copy()
            parts = []
            sub = []
            total = 0
            if shape == "16x16":
                geom = [(x4, y4, 4, 4, 0)]
                mbt = 0
            elif shape == "16x8":
                geom = [(x4, y4, 4, 2, 1), (x4, y4 + 2, 4, 2, 2)]
                mbt = 1
            elif shape == "8x16":
                geom = [(x4, y4, 2, 4, 3), (x4 + 2, y4, 2, 4, 4)]
                mbt = 2
            else:                                   # sub0..sub3 (P_8x8)
                st = int(shape[3])
                sub = [st] * 4
                mbt = 3
                geom = []
                np_, pw, ph = _SUB_GEOM[st]
                for i in range(4):
                    bx4 = x4 + (i & 1) * 2
                    by4 = y4 + (i >> 1) * 2
                    for p in range(np_):
                        ox = p if st == 2 else (p & 1 if st == 3 else 0)
                        oy = p if st == 1 else (p >> 1 if st == 3 else 0)
                        geom.append((bx4 + ox * pw, by4 + oy * ph,
                                     pw, ph, 0))
            for (px4, py4, w4p, h4p, pk) in geom:
                pmv = mc.predict.__func__(  # predict on the scratch grids
                    _Scratch(scratch_mv, scratch_rf, mc.w4, mc.h4),
                    px4, py4, w4p, h4p, 0, pk)
                s = src[(py4 - y4) * 4:(py4 - y4) * 4 + h4p * 4,
                        (px4 - x4) * 4:(px4 - x4) * 4 + w4p * 4]
                mvx, mvy, sad = _search_part(self.planes, s, py4 * 4,
                                             px4 * 4, pmv, self.sr,
                                             h4p * 4, w4p * 4)
                parts.append((px4, py4, w4p, h4p, pk, mvx, mvy))
                total += sad
                scratch_rf[py4:py4 + h4p, px4:px4 + w4p] = 0
                scratch_mv[py4:py4 + h4p, px4:px4 + w4p, 0] = mvx
                scratch_mv[py4:py4 + h4p, px4:px4 + w4p, 1] = mvy
            bits_bias = {0: 0, 1: 96, 2: 96, 3: 256}[mbt]
            if best is None or total + bits_bias < best[3] + \
                    {0: 0, 1: 96, 2: 96, 3: 256}[best[0]]:
                best = (mbt, parts, sub, total)
        return best

    def _commit_inter(self, mc, my, mx, parts, mb, kind, filled=False):
        if not filled:
            for (px4, py4, w4p, h4p, _pk, mvx, mvy) in parts:
                mc.fill(px4, py4, w4p, h4p, 0, mvx, mvy)
        self.kind[mb] = kind
        self.ref_arr[mb] = 0
        x4, y4 = mx * 4, my * 4
        self.mv_arr[mb, :, 0] = mc.mvg[y4:y4 + 4, x4:x4 + 4, 0].ravel()
        self.mv_arr[mb, :, 1] = mc.mvg[y4:y4 + 4, x4:x4 + 4, 1].ravel()
        if kind == 0:
            self.i4g[y4:y4 + 4, x4:x4 + 4] = -1

    def _zero_nc(self, my, mx):
        for by in range(4):
            for bx in range(4):
                self.ncY.set(my * 4 + by, mx * 4 + bx, 0)
        for by in range(2):
            for bx in range(2):
                self.ncU.set(my * 2 + by, mx * 2 + bx, 0)
                self.ncV.set(my * 2 + by, mx * 2 + bx, 0)

    # -- transform/quant helpers -----------------------------------------
    def _quant_luma(self, src, pred, intra):
        resid = src.astype(np.int64) - pred
        lev = np.zeros((4, 4, 4, 4), np.int64)
        for by in range(4):
            for bx in range(4):
                w = I.fwd4(resid[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4])
                lev[by, bx] = I.quant4(w, self.qp, intra=intra)
        cbp_luma = 0
        for i8 in range(4):
            b = lev[(i8 >> 1) * 2:(i8 >> 1) * 2 + 2,
                    (i8 & 1) * 2:(i8 & 1) * 2 + 2]
            if np.any(b):
                cbp_luma |= 1 << i8
        return lev, cbp_luma

    def _quant_chroma(self, u, v, predu, predv, my, mx, intra=False):
        qpc = self.qpc
        c_lev, c_dc = {}, {}
        for name, plane, predc in (("u", u, predu), ("v", v, predv)):
            srcc = plane[my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8]
            residc = srcc.astype(np.int64) - predc
            wc = np.zeros((2, 2, 4, 4), np.int64)
            for by in range(2):
                for bx in range(2):
                    wc[by, bx] = I.fwd4(residc[by * 4:by * 4 + 4,
                                               bx * 4:bx * 4 + 4])
            cdc = I._H2 @ wc[:, :, 0, 0] @ I._H2
            c_dc[name] = I.quant_dc(cdc, qpc) if intra else \
                _quant_dc_inter(cdc, qpc)
            lv = np.zeros((2, 2, 4, 4), np.int64)
            for by in range(2):
                for bx in range(2):
                    lv[by, bx] = I.quant4(wc[by, bx], qpc, intra=intra)
                    lv[by, bx, 0, 0] = 0
            c_lev[name] = lv
        has_cdc = bool(np.any(c_dc["u"]) or np.any(c_dc["v"]))
        has_cac = bool(np.any(c_lev["u"]) or np.any(c_lev["v"]))
        cbp_chroma = 2 if has_cac else (1 if has_cdc else 0)
        return c_dc, c_lev, cbp_chroma

    # -- residual writers --------------------------------------------------
    def _write_luma_residual(self, bw, lev, my, mx, cbp_luma, mb, i16):
        for blk in range(16):
            by, bx = _BLK4[blk]
            gy, gx = my * 4 + by, mx * 4 + bx
            present = cbp_luma != 0 if i16 else (cbp_luma >> (blk >> 2)) & 1
            if present:
                nc = self.ncY.nc(gy, gx)
                zz = lev[by, bx].reshape(-1)[ZIGZAG4]
                if i16:
                    zz = zz[1:]
                t = write_residual(bw, zz, nc)
                self.ncY.set(gy, gx, t)
                self.ncoef[mb, 1 + by * 4 + bx] = t
            else:
                self.ncY.set(gy, gx, 0)

    def _write_chroma_residual(self, bw, c_dc, c_lev, my, mx, cbp_chroma):
        if cbp_chroma:
            for name in ("u", "v"):
                write_residual(bw, c_dc[name].reshape(-1)[[0, 1, 2, 3]], -1)
        for name, ctx in (("u", self.ncU), ("v", self.ncV)):
            for blk in range(4):
                by, bx = blk // 2, blk % 2
                gy, gx = my * 2 + by, mx * 2 + bx
                if cbp_chroma == 2:
                    nc = ctx.nc(gy, gx)
                    zz = c_lev[name][by, bx].reshape(-1)[ZIGZAG4][1:]
                    t = write_residual(bw, zz, nc)
                    ctx.set(gy, gx, t)
                else:
                    ctx.set(gy, gx, 0)

    # -- inter recon -------------------------------------------------------
    def _recon_inter(self, ry, ru, rv, my, mx, pred, predu, predv,
                     lev, c_dc, c_lev):
        qp, qpc = self.qp, self.qpc
        out = np.zeros((16, 16), np.int64)
        if lev is not None:
            for by in range(4):
                for bx in range(4):
                    wq = I.dequant4_ac(lev[by, bx], qp)
                    out[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = I.inv4(wq)
        ry[my * 16:(my + 1) * 16, mx * 16:(mx + 1) * 16] = \
            np.clip(pred + out, 0, 255)
        for name, rec, predc in (("u", ru, predu), ("v", rv, predv)):
            outc = np.zeros((8, 8), np.int64)
            if c_dc is not None:
                fc = I._H2 @ c_dc[name] @ I._H2
                dccd = I.dequant_chroma_dc(fc, qpc)
                lv = c_lev[name] if c_lev is not None else \
                    np.zeros((2, 2, 4, 4), np.int64)
                for by in range(2):
                    for bx in range(2):
                        wq = I.dequant4_ac(lv[by, bx], qpc)
                        wq[0, 0] = dccd[by, bx]
                        outc[by * 4:by * 4 + 4,
                             bx * 4:bx * 4 + 4] = I.inv4(wq)
            rec[my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8] = \
                np.clip(predc + outc, 0, 255)

    # -- intra MBs (I slices and intra-in-P) --------------------------------
    def _encode_intra(self, bw, y, u, v, ry, ru, rv, my, mx, mc,
                      mb_type_offset, force=None):
        mb = my * self.mb_w + mx
        src = y[my * 16:(my + 1) * 16, mx * 16:(mx + 1) * 16]
        # choose I16 vs I4x4 by SAD (I4x4 pays a bit-cost bias)
        best16 = None
        for mode in I._modes16_available(my, mx):
            s = _sad(I._pred16(ry, my, mx, mode), src)
            if best16 is None or s < best16[0]:
                best16 = (s, mode)
        use_i4 = force == "i4"
        if force is None:
            # quick I4x4 estimate: DC-mode SAD per block
            i4_est = 0
            for blk in range(16):
                by, bx = _BLK4[blk]
                gy, gx = my * 4 + by, mx * 4 + bx
                sb = src[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
                i4_est += _sad(R.pred4x4(ry, gy, gx, 2, self.mb_w), sb)
            use_i4 = i4_est + 24 * 16 < best16[0]
        if force == "i16":
            use_i4 = False

        if force == "pcm":
            self._encode_pcm(bw, y, u, v, ry, ru, rv, my, mx, mc,
                             mb_type_offset)
            return
        if use_i4:
            self._encode_i4x4(bw, y, u, v, ry, ru, rv, my, mx,
                              mb_type_offset)
            self.kind[mb] = 2
        else:
            I._encode_mb(bw, y, u, v, ry, ru, rv, my, mx, self.qp,
                         self.ncY, self.ncU, self.ncV,
                         mb_type_offset=mb_type_offset,
                         chroma_qp=self.qpc)
            self.i4g[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = -1
            self.kind[mb] = 3
        mc.fill_intra(mx, my)
        self.ref_arr[mb] = -1
        self.qp_arr[mb] = self.qp

    def _encode_pcm(self, bw, y, u, v, ry, ru, rv, my, mx, mc,
                    mb_type_offset):
        """I_PCM macroblock (§7.3.5, mb_type 25): pcm_alignment_zero_
        bit(s) then 256 luma + 2x64 chroma raw sample bytes -- the
        spec's lossless escape. Deblocking reads qp 0 for these MBs
        (h264_cavlc.c:754 role); nnz contexts read 16."""
        mb = my * self.mb_w + mx
        _write_ue(bw, 25 + mb_type_offset)
        bw.write(0, (8 - bw._n) % 8)          # pcm_alignment_zero_bit
        sy = y[my * 16:(my + 1) * 16, mx * 16:(mx + 1) * 16]
        su = u[my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8]
        sv = v[my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8]
        for plane in (sy, su, sv):
            for b8 in np.asarray(plane, np.uint8).ravel():
                bw.write(int(b8), 8)
        ry[my * 16:(my + 1) * 16, mx * 16:(mx + 1) * 16] = sy
        ru[my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8] = su
        rv[my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8] = sv
        self.ncY.t[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 16
        self.ncU.t[my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 16
        self.ncV.t[my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 16
        self.i4g[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = -1
        self.kind[mb] = 4
        mc.fill_intra(mx, my)
        self.ref_arr[mb] = -1
        self.qp_arr[mb] = 0                   # deblock quantizer
        self.ncoef[mb] = 16

    def _encode_i4x4(self, bw, y, u, v, ry, ru, rv, my, mx,
                     mb_type_offset):
        """I_4x4 macroblock: per-block mode search over the 9 modes with
        progressive reconstruction (§8.3.1), CAVLC packing."""
        mb = my * self.mb_w + mx
        qp = self.qp
        src = y[my * 16:(my + 1) * 16, mx * 16:(mx + 1) * 16]
        modes = np.zeros(16, np.int32)
        lev = np.zeros((4, 4, 4, 4), np.int64)
        mode_bits = []
        for blk in range(16):
            by, bx = _BLK4[blk]
            gy, gx = my * 4 + by, mx * 4 + bx
            sb = src[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4].astype(np.int64)
            cand = self._modes4_available(gy, gx)
            best = None
            for m in cand:
                p4 = R.pred4x4(ry, gy, gx, m, self.mb_w)
                s = _sad(p4, sb)
                if best is None or s < best[0]:
                    best = (s, m, p4)
            _s, m, p4 = best
            # quant/recon this block before the next one predicts from it
            w = I.fwd4(sb - p4)
            lv = I.quant4(w, qp, intra=True)
            lev[by, bx] = lv
            rq = I.inv4(I.dequant4_ac(lv, qp))
            ry[gy * 4:gy * 4 + 4, gx * 4:gx * 4 + 4] = \
                np.clip(p4 + rq, 0, 255)
            modes[by * 4 + bx] = m
            # predicted mode (decoder mirror)
            ma = self.i4g[gy, gx - 1] if gx > 0 else -2
            mbv = self.i4g[gy - 1, gx] if gy > 0 else -2
            if ma == -2 or mbv == -2:
                pm = 2
            else:
                pm = min(2 if ma < 0 else ma, 2 if mbv < 0 else mbv)
            if m == pm:
                mode_bits.append((1, None))
            else:
                rem = m if m < pm else m - 1
                mode_bits.append((0, rem))
            self.i4g[gy, gx] = m
        # (an uncoded 8x8 group implies all four blocks quantized to zero,
        # so the per-block recon above is already pred-only for them)
        cbp_luma = 0
        for i8 in range(4):
            b = lev[(i8 >> 1) * 2:(i8 >> 1) * 2 + 2,
                    (i8 & 1) * 2:(i8 & 1) * 2 + 2]
            if np.any(b):
                cbp_luma |= 1 << i8
        # chroma: best mode by SAD, intra quant at qpc
        best_cmode, best_csad = 0, None
        for mode in I._modes8_available(my, mx):
            s = (_sad(I._pred8(ru, my, mx, mode),
                      u[my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8])
                 + _sad(I._pred8(rv, my, mx, mode),
                        v[my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8]))
            if best_csad is None or s < best_csad:
                best_cmode, best_csad = mode, s
        predu = I._pred8(ru, my, mx, best_cmode)
        predv = I._pred8(rv, my, mx, best_cmode)
        c_dc, c_lev, cbp_chroma = self._quant_chroma(u, v, predu, predv,
                                                     my, mx, intra=True)
        cbp = cbp_luma | (cbp_chroma << 4)

        _write_ue(bw, mb_type_offset + 0)          # I_4x4
        for flag, rem in mode_bits:
            bw.write(flag, 1)
            if not flag:
                bw.write(rem, 3)
        _write_ue(bw, best_cmode)
        _write_ue(bw, int(_INTRA_CBP_TO_GOLOMB[cbp]))
        if cbp:
            _write_se(bw, 0)                       # mb_qp_delta
        self._write_luma_residual(bw, lev, my, mx, cbp_luma, mb, i16=False)
        self._write_chroma_residual(bw, c_dc, c_lev, my, mx, cbp_chroma)
        # chroma recon
        qpc = self.qpc
        for name, rec, predc in (("u", ru, predu), ("v", rv, predv)):
            outc = np.zeros((8, 8), np.int64)
            if cbp_chroma:
                fc = I._H2 @ c_dc[name] @ I._H2
                dccd = I.dequant_chroma_dc(fc, qpc)
                lv = c_lev[name] if cbp_chroma == 2 else \
                    np.zeros((2, 2, 4, 4), np.int64)
                for by in range(2):
                    for bx in range(2):
                        wq = I.dequant4_ac(lv[by, bx], qpc)
                        wq[0, 0] = dccd[by, bx]
                        outc[by * 4:by * 4 + 4,
                             bx * 4:bx * 4 + 4] = I.inv4(wq)
            rec[my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8] = \
                np.clip(predc + outc, 0, 255)
        # luma recon for zeroed blocks (uncoded 8x8 groups) was done with
        # residual; redo those blocks as pure prediction is WRONG here —
        # prediction inputs already consumed. Instead the zeroing above
        # happened before any dependent prediction only when residual was
        # already zero; enforce consistency by re-deriving:
        # (handled in _encode_i4x4 consistency check below)

    def _modes4_available(self, gy, gx):
        """Candidate Intra_4x4 modes given neighbor availability."""
        avail_t = gy > 0
        avail_l = gx > 0
        modes = [2]
        if avail_t:
            modes += [0, 3, 7]       # V, DDL, VL (DDL/VL use top-right
            #                          substitution when TR unavailable)
        if avail_l:
            modes += [1, 8]          # H, HU
        if avail_t and avail_l:
            modes += [4, 5, 6]       # DDR, VR, HD
        return modes


class _Scratch:
    """Duck-typed MotionCtx view over scratch grids for speculative ME."""

    def __init__(self, mvg, refg, w4, h4):
        self.mvg, self.refg, self.w4, self.h4 = mvg, refg, w4, h4

    fetch = MotionCtx.fetch


# backwards-compat alias (round-2 early tests)
PFrameEncoder = FrameEncoder


class BFrameEncoder(FrameEncoder):
    """B-frame coding: the 16x16 prediction family (B_L0 / B_L1 / B_Bi)
    with per-list median MV prediction, bi-prediction averaging and
    intra fallback. B frames are non-reference (nal_ref_idc 0), so no
    reconstruction loop is kept."""

    def encode_b(self, y, u, v, ref0_planes, ref1_planes, frame_num,
                 poc_lsb):
        self.planes0 = R.qpel_planes(np.asarray(ref0_planes[0]))
        self.upad0 = R.pad_chroma(np.asarray(ref0_planes[1]))
        self.vpad0 = R.pad_chroma(np.asarray(ref0_planes[2]))
        self.planes1 = R.qpel_planes(np.asarray(ref1_planes[0]))
        self.upad1 = R.pad_chroma(np.asarray(ref1_planes[1]))
        self.vpad1 = R.pad_chroma(np.asarray(ref1_planes[2]))
        # ry carries the running recon for intra prediction neighbors
        ry = np.zeros(y.shape, np.int64)
        ru = np.zeros(u.shape, np.int64)
        rv = np.zeros(v.shape, np.int64)

        bw = BitWriterMSB()
        _write_ue(bw, 0)                          # first_mb
        _write_ue(bw, 6)                          # slice_type B (all)
        _write_ue(bw, 0)                          # pps id
        bw.write(frame_num % 16, 4)
        bw.write(poc_lsb % 256, 8)                # log2_max_poc_lsb = 8
        bw.write(1, 1)                            # direct_spatial_mv_pred
        bw.write(0, 1)                            # num_ref_idx_override
        bw.write(0, 1)                            # ref_pic_list_mod_l0
        bw.write(0, 1)                            # ref_pic_list_mod_l1
        _write_se(bw, self.qp - 26)
        _write_ue(bw, 0)                          # deblocking idc
        _write_se(bw, 0)
        _write_se(bw, 0)

        mc0 = MotionCtx(self.mb_w, self.mb_h)
        mc1 = MotionCtx(self.mb_w, self.mb_h)
        self.ncY = _NcCtx(self.mb_h * 4, self.mb_w * 4)
        self.ncU = _NcCtx(self.mb_h * 2, self.mb_w * 2)
        self.ncV = _NcCtx(self.mb_h * 2, self.mb_w * 2)
        self.i4g = np.full((self.mb_h * 4, self.mb_w * 4), -2, np.int32)
        self.mv1_arr = np.zeros_like(self.mv_arr)
        self.ref1_arr = np.full_like(self.ref_arr, -1)

        for my in range(self.mb_h):
            for mx in range(self.mb_w):
                self._encode_b_mb(bw, y, u, v, ry, ru, rv, my, mx,
                                  mc0, mc1)
        bw.write(1, 1)
        bw.align()
        return _rbsp_to_nal(bw.bytes(), 1, 0)     # non-reference slice

    def _encode_b_mb(self, bw, y, u, v, ry, ru, rv, my, mx, mc0, mc1):
        mb = my * self.mb_w + mx
        x4, y4 = mx * 4, my * 4
        src = y[my * 16:(my + 1) * 16, mx * 16:(mx + 1) * 16]

        pmv0 = mc0.predict(x4, y4, 4, 4, 0)
        pmv1 = mc1.predict(x4, y4, 4, 4, 0)
        mx0, my0, sad0 = _search_part(self.planes0, src, y4 * 4, x4 * 4,
                                      pmv0, self.sr, 16, 16)
        mx1, my1, sad1 = _search_part(self.planes1, src, y4 * 4, x4 * 4,
                                      pmv1, self.sr, 16, 16)
        p0 = R.mc_luma_block(self.planes0, y4 * 4, x4 * 4, mx0, my0)
        p1 = R.mc_luma_block(self.planes1, y4 * 4, x4 * 4, mx1, my1)
        pbi = (p0 + p1 + 1) >> 1
        sadbi = _sad(pbi, src)
        cands = [(sad0 + 32, 1), (sad1 + 32, 2), (sadbi + 64, 3)]
        cands.sort()
        cost, mbt = cands[0]

        intra_sad = min(_sad(I._pred16(ry, my, mx, m), src)
                        for m in I._modes16_available(my, mx))
        if intra_sad + 96 < cost:
            _write_ue(bw, 0)                       # mb_skip_run
            self._encode_intra(bw, y, u, v, ry, ru, rv, my, mx, mc0,
                               mb_type_offset=23)
            mc1.fill_intra(mx, my)
            self.mv1_arr[mb] = 0
            self.ref1_arr[mb] = -1
            return

        use0 = mbt in (1, 3)
        use1 = mbt in (2, 3)
        pred = p0 if mbt == 1 else (p1 if mbt == 2 else pbi)
        pu0 = R.mc_chroma_block(self.upad0, my * 8, mx * 8, mx0, my0)
        pv0 = R.mc_chroma_block(self.vpad0, my * 8, mx * 8, mx0, my0)
        pu1 = R.mc_chroma_block(self.upad1, my * 8, mx * 8, mx1, my1)
        pv1 = R.mc_chroma_block(self.vpad1, my * 8, mx * 8, mx1, my1)
        predu = pu0 if mbt == 1 else (pu1 if mbt == 2
                                      else (pu0 + pu1 + 1) >> 1)
        predv = pv0 if mbt == 1 else (pv1 if mbt == 2
                                      else (pv0 + pv1 + 1) >> 1)

        lev, cbp_luma = self._quant_luma(src, pred, intra=False)
        c_dc, c_lev, cbp_chroma = self._quant_chroma(u, v, predu, predv,
                                                     my, mx)
        cbp = cbp_luma | (cbp_chroma << 4)

        _write_ue(bw, 0)                           # mb_skip_run
        _write_ue(bw, mbt)
        # mvds: L0 then L1 (16x16: ref_idx omitted, one ref per list)
        if use0:
            px, py = mc0.predict(x4, y4, 4, 4, 0)
            _write_se(bw, mx0 - px)
            _write_se(bw, my0 - py)
            mc0.fill(x4, y4, 4, 4, 0, mx0, my0)
        else:
            mc0.fill(x4, y4, 4, 4, -1, 0, 0)
        if use1:
            px, py = mc1.predict(x4, y4, 4, 4, 0)
            _write_se(bw, mx1 - px)
            _write_se(bw, my1 - py)
            mc1.fill(x4, y4, 4, 4, 0, mx1, my1)
        else:
            mc1.fill(x4, y4, 4, 4, -1, 0, 0)
        _write_ue(bw, int(_INTER_CBP_TO_GOLOMB[cbp]))
        if cbp:
            _write_se(bw, 0)                       # mb_qp_delta
        self.kind[mb] = 1
        self.ref_arr[mb] = 0 if use0 else -1
        self.ref1_arr[mb] = 0 if use1 else -1
        self.mv_arr[mb, :, 0] = mx0 if use0 else 0
        self.mv_arr[mb, :, 1] = my0 if use0 else 0
        self.mv1_arr[mb, :, 0] = mx1 if use1 else 0
        self.mv1_arr[mb, :, 1] = my1 if use1 else 0
        self._write_luma_residual(bw, lev, my, mx, cbp_luma, mb,
                                  i16=False)
        self._write_chroma_residual(bw, c_dc, c_lev, my, mx, cbp_chroma)
        self._recon_inter(ry, ru, rv, my, mx, pred, predu, predv,
                          lev if cbp_luma else None,
                          c_dc if cbp_chroma else None,
                          c_lev if cbp_chroma == 2 else None)
        self.i4g[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = -1
