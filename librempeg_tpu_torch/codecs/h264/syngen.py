"""H.264 High-profile decoder-conformance stream generator.

Emits syntactically valid CAVLC streams exercising the High-profile
decode features (8x8 transform + Intra_8x8, scaling matrices, explicit
weighted prediction, multi-ref with ref-list modification, MMCO) with
randomized modes and residual levels. The generator works purely at
the SYNTAX level -- it never reconstructs pixels -- because decoder
conformance only requires that OUR decode of the stream equals the
REFERENCE decoder's decode of the same stream bit-for-bit (the same
oracle FATE uses). MV prediction and nC/total_coeff contexts are
modelled so every emitted value is spec-consistent.

Syntax reference: ISO/IEC 14496-10 §7.3 (behavioral reference
libavcodec/h264_cavlc.c, h264_ps.c).

A copy of librempeg_tpu/codecs/h264/syngen.py (host code, no JAX),
imports rewritten.
"""
from __future__ import annotations

import numpy as np

from librempeg_tpu_torch.codecs.flac.bitio import BitWriterMSB
from librempeg_tpu_torch.codecs.h264 import cavlc
from librempeg_tpu_torch.codecs.h264 import high_tables as HT
from librempeg_tpu_torch.codecs.h264.intra import (_NcCtx, _rbsp_to_nal,
                                             _write_se, _write_ue)

# 4x4 zigzag: raster -> scan position (inverse of HT.ZZ4)
_IZZ4 = np.argsort(np.array(HT.ZZ4))


def _write_scaling_list(bw, values_raster, size):
    """scaling_list() emitting every delta (no defaults escape)."""
    scan = HT.ZZ4 if size == 16 else HT.ZZ8
    last = 8
    for j in range(size):
        v = values_raster[scan[j]]
        _write_se(bw, (v - last + 128) % 256 - 128)
        last = v
    # nextScale never hits 0 here, so nothing more to write


class HighStreamGen:
    def __init__(self, mb_w: int, mb_h: int, *, seed=0, qp=28,
                 scaling="none", transform_8x8=True, weighted=0,
                 num_ref=1, cqp_off=0, cqp_off2=None, deblock=True):
        self.mb_w, self.mb_h = mb_w, mb_h
        self.rng = np.random.default_rng(seed)
        self.qp = qp
        self.scaling = scaling
        self.t8 = transform_8x8
        self.weighted = weighted
        self.num_ref = num_ref
        self.cqp_off = cqp_off
        self.cqp_off2 = cqp_off2
        self.deblock = deblock
        self.frame_num = 0
        self.dpb_fn = []          # short-term frame_nums, newest first
        self.dpb_lt = {}          # long_term_idx -> frame_num
        self.out = bytearray()
        self._scaling4 = None
        self._scaling8 = None

    # ------------------------------------------------------------- headers
    def headers(self):
        self.out += self._sps()
        self.out += self._pps()

    def _sps(self) -> bytes:
        bw = BitWriterMSB()
        bw.write(100, 8)                 # High profile
        bw.write(0, 8)
        bw.write(40, 8)                  # level 4.0
        _write_ue(bw, 0)                 # sps id
        _write_ue(bw, 1)                 # chroma_format_idc 4:2:0
        _write_ue(bw, 0)                 # bit_depth_luma - 8
        _write_ue(bw, 0)                 # bit_depth_chroma - 8
        bw.write(0, 1)                   # no transform bypass
        if self.scaling == "sps":
            bw.write(1, 1)
            self._emit_matrices(bw, include_8x8=True)
        else:
            bw.write(0, 1)
        _write_ue(bw, 0)                 # log2_max_frame_num - 4
        _write_ue(bw, 0)                 # poc type 0
        _write_ue(bw, 4)                 # log2_max_poc_lsb - 4
        _write_ue(bw, max(self.num_ref, 1) + 1)  # max_num_ref_frames
        bw.write(0, 1)
        _write_ue(bw, self.mb_w - 1)
        _write_ue(bw, self.mb_h - 1)
        bw.write(1, 1)                   # frame_mbs_only
        bw.write(1, 1)                   # direct_8x8_inference
        bw.write(0, 1)                   # no crop
        bw.write(0, 1)                   # no vui
        bw.write(1, 1)
        bw.align()
        return _rbsp_to_nal(bw.bytes(), 7, 3)

    def _emit_matrices(self, bw, include_8x8=True):
        if self.scaling in ("sps", "pps"):
            # randomized non-flat lists in a sane range
            self._scaling4 = [
                tuple(int(v) for v in
                      self.rng.integers(8, 40, 16))
                for _ in range(6)]
            self._scaling8 = [
                tuple(int(v) for v in
                      self.rng.integers(8, 40, 64))
                for _ in range(2)]
        for m in self._scaling4:
            bw.write(1, 1)
            _write_scaling_list(bw, m, 16)
        if include_8x8:
            for m in self._scaling8:
                bw.write(1, 1)
                _write_scaling_list(bw, m, 64)

    def _pps(self) -> bytes:
        bw = BitWriterMSB()
        _write_ue(bw, 0)
        _write_ue(bw, 0)
        bw.write(0, 1)                   # CAVLC
        bw.write(0, 1)
        _write_ue(bw, 0)                 # 1 slice group
        _write_ue(bw, max(self.num_ref, 1) - 1)  # num_ref_idx_l0 - 1
        _write_ue(bw, 0)
        bw.write(1 if self.weighted else 0, 1)   # weighted_pred
        bw.write(0, 2)                   # weighted_bipred_idc
        _write_se(bw, self.qp - 26)      # pic_init_qp
        _write_se(bw, 0)
        _write_se(bw, self.cqp_off)
        bw.write(0 if self.deblock else 1, 1)  # deblock control present
        bw.write(0, 1)
        bw.write(0, 1)
        # High-profile tail
        bw.write(1 if self.t8 else 0, 1)   # transform_8x8_mode
        if self.scaling == "pps":
            bw.write(1, 1)
            self._emit_matrices(bw, include_8x8=self.t8)
        else:
            bw.write(0, 1)
        _write_se(bw, self.cqp_off2 if self.cqp_off2 is not None
                  else self.cqp_off)
        bw.write(1, 1)
        bw.align()
        return _rbsp_to_nal(bw.bytes(), 8, 3)

    # ------------------------------------------------------------ residual
    def _rand_levels(self, n, density=0.3, amp=6):
        lv = np.zeros(n, np.int32)
        m = self.rng.random(n) < density
        lv[m] = self.rng.integers(1, amp + 1, int(m.sum())) * \
            self.rng.choice((-1, 1), int(m.sum()))
        return lv

    def _amp(self, kind) -> int:
        """Level bound keeping dequantized coefficients (and the
        reference's int16 IDCT intermediates) inside the spec's §8.5
        conformance range -- real encoders never exceed it, and the
        reference decoder wraps rather than clips when fuzzed past it.
        kind: '4' luma 4x4, '8' luma 8x8, 'dc16' I_16x16 luma DC."""
        sh = self.qp // 6
        w4 = max(max(m) for m in self._scaling4) if self._scaling4 \
            else 16
        w8 = max(max(m) for m in self._scaling8) if self._scaling8 \
            else 16
        if kind == "8":
            f = (58 * w8 << sh) >> 6
        elif kind == "dc16":
            f = 16 * ((29 * w4 >> 4) << max(sh - 2, 0))
        else:
            f = (29 * w4 << (sh + 2)) >> 6
        return max(1, min(6, 2500 // max(f, 1)))

    def _write_luma_4x4s(self, bw, ncY, mx, my, cbp_luma, i16=False):
        for blk in range(16):
            by, bx = [(0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (0, 3),
                      (1, 2), (1, 3), (2, 0), (2, 1), (3, 0), (3, 1),
                      (2, 2), (2, 3), (3, 2), (3, 3)][blk]
            gy, gx = my * 4 + by, mx * 4 + bx
            i8 = blk >> 2
            present = (cbp_luma >> i8) & 1
            if not present:
                ncY.set(gy, gx, 0)
                continue
            n = 15 if i16 else 16
            lv = self._rand_levels(n, amp=self._amp("4"))
            t = cavlc.write_residual(bw, lv, ncY.nc(gy, gx))
            ncY.set(gy, gx, t)

    def _write_luma_8x8s(self, bw, ncY, mx, my, cbp_luma):
        """8x8 groups as 4 interleaved 4x4 scans with the ff nC cache
        semantics (per-sub totals; top-left cell accumulates the sum)."""
        for i8 in range(4):
            if not (cbp_luma >> i8) & 1:
                for i4 in range(4):
                    blk = 4 * i8 + i4
                    by, bx = [(0, 0), (0, 1), (1, 0), (1, 1), (0, 2),
                              (0, 3), (1, 2), (1, 3), (2, 0), (2, 1),
                              (3, 0), (3, 1), (2, 2), (2, 3), (3, 2),
                              (3, 3)][blk]
                    ncY.set(my * 4 + by, mx * 4 + bx, 0)
                continue
            tot = 0
            cells = []
            for i4 in range(4):
                blk = 4 * i8 + i4
                by, bx = [(0, 0), (0, 1), (1, 0), (1, 1), (0, 2),
                          (0, 3), (1, 2), (1, 3), (2, 0), (2, 1),
                          (3, 0), (3, 1), (2, 2), (2, 3), (3, 2),
                          (3, 3)][blk]
                gy, gx = my * 4 + by, mx * 4 + bx
                lv = self._rand_levels(16, density=0.25,
                                       amp=self._amp("8"))
                t = cavlc.write_residual(bw, lv, ncY.nc(gy, gx))
                ncY.set(gy, gx, t)
                cells.append((gy, gx))
                tot += t
            ncY.set(*cells[0], tot)

    def _write_chroma(self, bw, ncU, ncV, mx, my, cbp_chroma):
        if cbp_chroma:
            for _ in range(2):           # chroma DC, nC = -1 table
                lv = self._rand_levels(4, density=0.4,
                                       amp=self._amp("4"))
                cavlc.write_residual(bw, lv, -1)
        for pl, nc in ((0, ncU), (1, ncV)):
            for blk in range(4):
                by, bx = blk >> 1, blk & 1
                gy, gx = my * 2 + by, mx * 2 + bx
                if cbp_chroma == 2:
                    lv = self._rand_levels(15, density=0.25,
                                           amp=self._amp("4"))
                    t = cavlc.write_residual(bw, lv, nc.nc(gy, gx))
                    nc.set(gy, gx, t)
                else:
                    nc.set(gy, gx, 0)

    # -------------------------------------------------------------- frames
    def i_frame(self, mix=("i4", "i8", "i16"), slices=1):
        """IDR frame cycling the given intra MB kinds; `slices` > 1
        splits at raster MB positions (entropy contexts AND intra
        neighbor availability reset per slice, §6.4.9)."""
        nmb = self.mb_w * self.mb_h
        bounds = [nmb * i // slices for i in range(slices + 1)]
        k = 0
        for si in range(slices):
            bw = BitWriterMSB()
            _write_ue(bw, bounds[si])        # first_mb
            _write_ue(bw, 7)                 # slice_type I (all)
            _write_ue(bw, 0)                 # pps id
            bw.write(0, 4)                   # frame_num (IDR -> 0)
            _write_ue(bw, self.frame_num % 16)   # idr_pic_id
            bw.write(0, 8)                   # poc lsb
            bw.write(0, 1)                   # no_output_of_prior_pics
            bw.write(0, 1)                   # long_term_reference_flag
            _write_se(bw, 0)                 # slice_qp_delta
            if not self.deblock:
                _write_ue(bw, 1)         # disable_deblocking_filter_idc
            ncY = _NcCtx(self.mb_h * 4, self.mb_w * 4)
            ncU = _NcCtx(self.mb_h * 2, self.mb_w * 2)
            ncV = _NcCtx(self.mb_h * 2, self.mb_w * 2)
            modes4 = np.full((self.mb_h * 4, self.mb_w * 4), -2,
                             np.int32)
            for mb in range(bounds[si], bounds[si + 1]):
                my, mx = divmod(mb, self.mb_w)
                kind = mix[k % len(mix)]
                k += 1
                self._intra_mb(bw, ncY, ncU, ncV, modes4, my, mx, kind)
            bw.write(1, 1)
            bw.align()
            self.out += _rbsp_to_nal(bw.bytes(), 5, 3)
        self.frame_num = 1
        self.dpb_fn = [0]
        self.dpb_lt = {}
        self.poc = 0

    def _intra_mb(self, bw, ncY, ncU, ncV, modes4, my, mx, kind,
                  p_slice=False):
        base = 5 if p_slice else 0
        if kind == "i16":
            has_t = my > 0 and modes4[my * 4 - 1, mx * 4] != -2
            has_l = mx > 0 and modes4[my * 4, mx * 4 - 1] != -2
            imode = int(self.rng.integers(0, 4))
            # availability: mode 0 needs top, 1 needs left, 3 needs both
            if not has_t and imode in (0, 3):
                imode = 1 if has_l else 2
            if not has_l and imode in (1, 3):
                imode = 0 if has_t else 2
            cbp_c = int(self.rng.integers(0, 3))
            cbp_l = int(self.rng.integers(0, 2)) * 15
            mbt = 1 + imode + 4 * cbp_c + (12 if cbp_l else 0)
            _write_ue(bw, base + mbt)
            _write_ue(bw, self._chroma_mode(my, mx, modes4))
            _write_se(bw, 0)             # mb_qp_delta (always, I_16x16)
            # luma DC (nC from neighbors at (0,0) cell)
            lv = self._rand_levels(16, density=0.4,
                                   amp=self._amp("dc16"))
            cavlc.write_residual(bw, lv, ncY.nc(my * 4, mx * 4))
            self._write_luma_4x4s(bw, ncY, mx, my, 15 if cbp_l else 0,
                                  i16=True)
            self._write_chroma(bw, ncU, ncV, mx, my, cbp_c)
            modes4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = -1
            return
        # I_NxN
        _write_ue(bw, base + 0)
        t8 = kind == "i8" and self.t8
        if self.t8:
            bw.write(1 if t8 else 0, 1)
        if t8:
            for b8 in range(4):
                gy, gx = my * 4 + (b8 >> 1) * 2, mx * 4 + (b8 & 1) * 2
                ma = modes4[gy, gx - 1] if gx > 0 else -2
                mb = modes4[gy - 1, gx] if gy > 0 else -2
                pred = 2 if (ma == -2 or mb == -2) else \
                    min(2 if ma < 0 else ma, 2 if mb < 0 else mb)
                mode = self._legal_i8_mode(my, mx, b8, modes4)
                if mode == pred:
                    bw.write(1, 1)
                else:
                    bw.write(0, 1)
                    bw.write(mode if mode < pred else mode - 1, 3)
                modes4[gy:gy + 2, gx:gx + 2] = mode
        else:
            for blk in range(16):
                by, bx = [(0, 0), (0, 1), (1, 0), (1, 1), (0, 2),
                          (0, 3), (1, 2), (1, 3), (2, 0), (2, 1),
                          (3, 0), (3, 1), (2, 2), (2, 3), (3, 2),
                          (3, 3)][blk]
                gy, gx = my * 4 + by, mx * 4 + bx
                ma = modes4[gy, gx - 1] if gx > 0 else -2
                mb = modes4[gy - 1, gx] if gy > 0 else -2
                pred = 2 if (ma == -2 or mb == -2) else \
                    min(2 if ma < 0 else ma, 2 if mb < 0 else mb)
                mode = self._legal_i4_mode(gy, gx, modes4)
                if mode == pred:
                    bw.write(1, 1)
                else:
                    bw.write(0, 1)
                    bw.write(mode if mode < pred else mode - 1, 3)
                modes4[gy, gx] = mode
        _write_ue(bw, self._chroma_mode(my, mx, modes4))
        cbp_l = int(self.rng.integers(0, 16))
        cbp_c = int(self.rng.integers(0, 3))
        # me(v) intra CBP coding
        cbp = cbp_l | (cbp_c << 4)
        _write_ue(bw, _CBP_TO_GOLOMB_INTRA[cbp])
        if cbp:
            _write_se(bw, 0)             # mb_qp_delta
        if t8:
            self._write_luma_8x8s(bw, ncY, mx, my, cbp_l)
        else:
            self._write_luma_4x4s(bw, ncY, mx, my, cbp_l)
        self._write_chroma(bw, ncU, ncV, mx, my, cbp_c)

    def _legal_i4_mode(self, gy, gx, modes4) -> int:
        """A random 4x4 mode valid for this block's availability
        (frame edges AND slice boundaries via the -2 cells)."""
        has_t = gy > 0 and modes4[gy - 1, gx] != -2
        has_l = gx > 0 and modes4[gy, gx - 1] != -2
        opts = [2]
        if has_t:
            opts += [0]
        if has_l:
            opts += [1, 8]
        if has_t and has_l:
            opts += [4, 5, 6]
        if has_t:
            opts += [3, 7]      # DDL/VL use top(+TR, edge-extended)
        return int(self.rng.choice(opts))

    def _legal_i8_mode(self, my, mx, b8, modes4) -> int:
        gy, gx = my * 4 + (b8 >> 1) * 2, mx * 4 + (b8 & 1) * 2
        has_t = gy > 0 and modes4[gy - 1, gx] != -2
        has_l = gx > 0 and modes4[gy, gx - 1] != -2
        opts = [2]
        if has_t:
            opts += [0, 3, 7]
        if has_l:
            opts += [1, 8]
        if has_t and has_l:
            opts += [4, 5, 6]
        return int(self.rng.choice(opts))

    def _chroma_mode(self, my, mx, modes4) -> int:
        has_l = mx > 0 and modes4[my * 4, mx * 4 - 1] != -2
        has_t = my > 0 and modes4[my * 4 - 1, mx * 4] != -2
        opts = [0]
        if has_l:
            opts.append(1)
        if has_t:
            opts.append(2)
        if has_l and has_t:
            opts.append(3)
        return int(self.rng.choice(opts))

    def p_frame(self, *, skip_prob=0.25, intra_prob=0.1,
                reorder=None, mmco=None, slices=1):
        """One P frame: P_L0_16x16 + P_SKIP (+ scattered intra MBs),
        optional ref-list modification ops and MMCO ops; `slices` > 1
        splits the frame (contexts + availability reset per slice)."""
        nmb = self.mb_w * self.mb_h
        bounds = [nmb * i // slices for i in range(slices + 1)]
        wtab = None
        for si in range(slices):
            wtab = self._p_slice(bounds[si], bounds[si + 1],
                                 skip_prob, intra_prob,
                                 reorder if si == 0 else None,
                                 mmco if si == 0 else None,
                                 marked=si > 0) or wtab
        self.dpb_fn.insert(0, self.frame_num)
        self.frame_num = (self.frame_num + 1) % 16
        return wtab

    def _p_slice(self, first_mb, end_mb, skip_prob, intra_prob,
                 reorder, mmco, marked=False):
        from librempeg_tpu_torch.codecs.h264.inter_enc import MotionCtx

        nref = min(self.num_ref, len(self.dpb_fn) + len(self.dpb_lt))
        bw = BitWriterMSB()
        _write_ue(bw, first_mb)          # first_mb
        _write_ue(bw, 5)                 # slice_type P (all)
        _write_ue(bw, 0)
        bw.write(self.frame_num % 16, 4)
        if not marked:
            self.poc = getattr(self, "poc", 0) + 2
        bw.write(self.poc % 256, 8)      # poc lsb
        if nref != self.num_ref:
            bw.write(1, 1)               # num_ref_idx override
            _write_ue(bw, nref - 1)
        else:
            bw.write(0, 1)
        if reorder:
            bw.write(1, 1)
            for idc, val in reorder:
                _write_ue(bw, idc)
                _write_ue(bw, val)
            _write_ue(bw, 3)
        else:
            bw.write(0, 1)
        wtab = None
        if self.weighted:
            lld = int(self.rng.integers(0, 4))
            cld = int(self.rng.integers(0, 4))
            _write_ue(bw, lld)
            _write_ue(bw, cld)
            wtab = []
            for _ in range(nref):
                wy = int(self.rng.integers(
                    max(1, (1 << lld) - 20), (1 << lld) + 21))
                oy = int(self.rng.integers(-20, 21))
                bw.write(1, 1)
                _write_se(bw, wy)
                _write_se(bw, oy)
                bw.write(1, 1)
                ws = []
                for _ in range(2):
                    wc = int(self.rng.integers(
                        max(1, (1 << cld) - 20), (1 << cld) + 21))
                    oc = int(self.rng.integers(-20, 21))
                    _write_se(bw, wc)
                    _write_se(bw, oc)
                    ws += [wc, oc]
                wtab.append((wy, oy, *ws))
        # dec_ref_pic_marking (same content in every slice of a pic;
        # the DPB model advances once, on the first slice)
        if mmco:
            bw.write(1, 1)               # adaptive marking
            for op, *vals in mmco:
                _write_ue(bw, op)
                for v in vals:
                    _write_ue(bw, v)
            _write_ue(bw, 0)
            if not marked:
                self._model_mmco(mmco)
        else:
            bw.write(0, 1)               # sliding window
            if not marked:
                self._model_sliding()
        _write_se(bw, 0)                 # slice_qp_delta
        if not self.deblock:
            _write_ue(bw, 1)             # disable_deblocking_filter_idc
        # ---- macroblocks ----
        mc = MotionCtx(self.mb_w, self.mb_h)
        ncY = _NcCtx(self.mb_h * 4, self.mb_w * 4)
        ncU = _NcCtx(self.mb_h * 2, self.mb_w * 2)
        ncV = _NcCtx(self.mb_h * 2, self.mb_w * 2)
        modes4 = np.full((self.mb_h * 4, self.mb_w * 4), -2, np.int32)
        run = 0
        for mb in range(first_mb, end_mb):
                my, mx = divmod(mb, self.mb_w)
                r = self.rng.random()
                if r < skip_prob and mb != first_mb:
                    svx, svy = mc.skip_mv(mx, my)
                    mc.fill(mx * 4, my * 4, 4, 4, 0, svx, svy)
                    for yy in range(4):
                        for xx in range(4):
                            ncY.set(my * 4 + yy, mx * 4 + xx, 0)
                    for yy in range(2):
                        for xx in range(2):
                            ncU.set(my * 2 + yy, mx * 2 + xx, 0)
                            ncV.set(my * 2 + yy, mx * 2 + xx, 0)
                    modes4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = -1
                    run += 1
                    continue
                _write_ue(bw, run)       # mb_skip_run
                run = 0
                if r < skip_prob + intra_prob:
                    kind = ("i4", "i8", "i16")[
                        int(self.rng.integers(0, 3))]
                    self._intra_mb(bw, ncY, ncU, ncV, modes4, my, mx,
                                   kind, p_slice=True)
                    mc.fill_intra(mx, my)
                    continue
                # P_L0_16x16
                _write_ue(bw, 0)
                ref = int(self.rng.integers(0, nref))
                if nref > 1:
                    # te(v): bounded truncated exp-golomb
                    if nref == 2:
                        bw.write(1 - ref, 1)
                    else:
                        _write_ue(bw, ref)
                px, py = mc.predict(mx * 4, my * 4, 4, 4, ref)
                tx = int(self.rng.integers(-8, 9))
                ty = int(self.rng.integers(-8, 9))
                _write_se(bw, tx - px)
                _write_se(bw, ty - py)
                mc.fill(mx * 4, my * 4, 4, 4, ref, tx, ty)
                modes4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = -1
                cbp_l = int(self.rng.integers(0, 16))
                cbp_c = int(self.rng.integers(0, 3))
                cbp = cbp_l | (cbp_c << 4)
                _write_ue(bw, _CBP_TO_GOLOMB_INTER[cbp])
                t8 = bool(self.t8 and cbp_l
                          and self.rng.random() < 0.5)
                if self.t8 and cbp_l:
                    bw.write(1 if t8 else 0, 1)
                if cbp:
                    _write_se(bw, 0)     # mb_qp_delta
                if t8:
                    self._write_luma_8x8s(bw, ncY, mx, my, cbp_l)
                else:
                    self._write_luma_4x4s(bw, ncY, mx, my, cbp_l)
                self._write_chroma(bw, ncU, ncV, mx, my, cbp_c)
        if run:
            _write_ue(bw, run)
        bw.write(1, 1)
        bw.align()
        self.out += _rbsp_to_nal(bw.bytes(), 1, 2)
        return wtab

    # ------------------------------------------------- DPB model (syntax)
    def _model_sliding(self):
        # sliding window (§8.2.5.3): keep room for the incoming frame
        cap = max(self.num_ref, 1) + 1        # == SPS max_num_ref_frames
        while self.dpb_fn and \
                len(self.dpb_fn) + len(self.dpb_lt) >= cap:
            self.dpb_fn.pop()

    def _model_mmco(self, ops):
        for op, *vals in ops:
            if op == 1:
                pn = self.frame_num - (vals[0] + 1)
                if pn in self.dpb_fn:
                    self.dpb_fn.remove(pn)
            elif op == 2:
                self.dpb_lt = {k: v for k, v in self.dpb_lt.items()
                               if k != vals[0]}
            elif op == 3:
                pn = self.frame_num - (vals[0] + 1)
                if pn in self.dpb_fn:
                    self.dpb_fn.remove(pn)
                    self.dpb_lt[vals[1]] = pn
            elif op == 5:
                self.dpb_fn = []
                self.dpb_lt = {}

    def bytes(self) -> bytes:
        return bytes(self.out)


def _build_cbp_inverse():
    intra = [47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45,
             46, 16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1,
             2, 4, 8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36,
             40, 38, 41]
    inter = [0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13,
             14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45,
             46, 17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22,
             25, 38, 41]
    return ({c: g for g, c in enumerate(intra)},
            {c: g for g, c in enumerate(inter)})


_CBP_TO_GOLOMB_INTRA, _CBP_TO_GOLOMB_INTER = _build_cbp_inverse()
