"""HEVC CTU-layer syntax, symmetric decode/encode.

One walker covers both directions: in decode mode values come from the
CABAC decoder; in encode (generator) mode a `chooser` supplies legal
values and the CABAC encoder writes them. The shared walker guarantees
the conformance generator and the decoder agree bin-for-bin — any
divergence from the true spec shows up as a mismatch against the
reference decoder (the oracle the tests compare against).

Feature point: intra I slices, 4:2:0, no SAO/PCM/AMP/transform-skip/
sign-hiding/cu-qp-delta. Syntax reference: ITU-T H.265 §7.3.8/§9.3
(behavioral reference libavcodec/hevc/cabac.c,
hevcdec.c).

A copy of librempeg_tpu/codecs/hevc/ctu.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

import numpy as np

from librempeg_tpu_torch.codecs.hevc import tables as T
from librempeg_tpu_torch.core.errors import InvalidData

O = T.CTX_OFFSET

# 4x4 diagonal (up-right) scan position list: index -> (x, y)
def _diag_scan(size: int):
    out = []
    # H.265 §6.5.3 up-right diagonal: generated column-by-column
    i = 0
    x = y = 0
    stop = False
    while not stop:
        while y >= 0:
            if x < size and y < size:
                out.append((x, y))
            y -= 1
            x += 1
        y = x
        x = 0
        if out and len(out) >= size * size:
            stop = True
    return out[: size * size]


def _horiz_scan(size: int):
    return [(x, y) for y in range(size) for x in range(size)]


def _vert_scan(size: int):
    return [(x, y) for x in range(size) for y in range(size)]


_SCAN4 = {0: _diag_scan(4), 1: _horiz_scan(4), 2: _vert_scan(4)}
# sub-block scans (grid of 4x4 groups) share the same generators
_SCAN_SB = {k: {n: ({0: _diag_scan, 1: _horiz_scan, 2: _vert_scan}[k])(n)
                for n in (1, 2, 4, 8)} for k in (0, 1, 2)}

# §9.3.4.2.5 4x4 significance ctxIdxMap
_CTX_MAP_4x4 = (0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8)


class Chooser:
    """Value source for encode mode; override for custom streams."""

    def __init__(self, seed=0, qp=30, density=0.25, amp=6,
                 split_prob=0.35, nxn_prob=0.3):
        self.rng = np.random.default_rng(seed)
        self.density = density
        self.amp = amp
        self.split_prob = split_prob
        self.nxn_prob = nxn_prob

    def split_cu(self, log2, depth, max_depth):
        return int(self.rng.random() < self.split_prob)

    def part_nxn(self):
        return int(self.rng.random() < self.nxn_prob)

    # ---- P-slice choices (defaults give a balanced inter mix) ----
    def cu_skip(self):
        return int(self.rng.random() < 0.2)

    def pred_intra(self):
        return int(self.rng.random() < 0.25)

    def inter_part(self, log2, min_log2):
        # 0=2Nx2N 1=2NxN 2=Nx2N 3=NxN (NxN only at min CB > 8x8)
        opts = [0, 0, 1, 2]
        if log2 == min_log2 and log2 > 3:
            opts.append(3)
        return int(self.rng.choice(opts))

    def merge(self):
        return int(self.rng.random() < 0.4)

    def merge_idx(self, max_merge):
        return int(self.rng.integers(0, max_merge))

    def mvd(self):
        return (int(self.rng.integers(-32, 33)),
                int(self.rng.integers(-32, 33)))

    def mvp_flag(self):
        return int(self.rng.integers(0, 2))

    # ---- B-slice choices ----
    def inter_pred_idc(self, w, h):
        """0 = L0, 1 = L1, 2 = BI (BI illegal for 8x4/4x8 PUs)."""
        if w + h == 12:
            return int(self.rng.integers(0, 2))
        return int(self.rng.choice((0, 1, 2, 2)))

    def rqt_root(self):
        return int(self.rng.random() < 0.7)

    def intra_mode(self):
        return int(self.rng.integers(0, 35))

    def chroma_mode(self):
        # 4 = DM (derived); 0..3 pick from the candidate list
        return int(self.rng.integers(0, 5))

    def cbf(self, cidx):
        return int(self.rng.random() < 0.7)

    # ---- SAO choices (per CTB / component) ----
    def sao_merge(self):
        return int(self.rng.random() < 0.3)

    def sao_type(self):
        return int(self.rng.integers(0, 3))    # 0 off, 1 band, 2 edge

    def sao_offset_abs(self):
        return int(self.rng.integers(0, 8))

    def sao_offset_sign(self):
        return int(self.rng.integers(0, 2))

    def sao_band_pos(self):
        return int(self.rng.integers(0, 32))

    def sao_eo_class(self):
        return int(self.rng.integers(0, 4))

    def levels(self, n):
        lv = np.zeros(n, np.int32)
        m = self.rng.random(n) < self.density
        lv[m] = self.rng.integers(1, self.amp + 1, int(m.sum())) * \
            self.rng.choice((-1, 1), int(m.sum()))
        return lv


class CtuCoder:
    def __init__(self, sps, pps, qp, *, dec=None, enc=None,
                 chooser=None, on_tu=None, on_cu=None, on_pu=None,
                 slice_type=2, max_merge=5, sao_luma=False,
                 sao_chroma=False):
        self.sps = sps
        self.pps = pps
        self.qp = qp
        self.dec = dec
        self.enc = enc
        self.ch = chooser
        self.on_tu = on_tu      # (x0, y0, log2, cidx, coeffs4x4map)
        self.on_cu = on_cu      # (x0, y0, log2, luma_modes, chroma_mode)
        self.on_pu = on_pu      # (x0, y0, w, h, part_mode, part_idx, pu)
        self.slice_type = slice_type
        self.max_merge = max_merge
        self.mvd_l1_zero = False    # B slices: slice-header flag
        self.sao_luma = sao_luma
        self.sao_chroma = sao_chroma
        self._cu_depth = 0          # current CU's cqt depth (ct_depth
        #                             ctx of inter_pred_idc, §9.3.4.2.2)
        # per-CTB SAO params [hctb, wctb, 3, 6]: per component
        # (type 0/1/2, off1..off4 signed, band_pos-or-eo_class)
        self.saog = np.zeros((sps.pic_h_ctb, sps.pic_w_ctb, 3, 6),
                             np.int32)
        # slice id per CTB (multi-slice: SAO merge + CABAC restart)
        self.slice_of_ctb = np.zeros(
            sps.pic_h_ctb * sps.pic_w_ctb, np.int32)
        w, h = sps.width, sps.height
        self.min_cb = 1 << sps.log2_min_cb
        # per-4x4 grids for context/mode derivation
        gw, gh = w // 4, h // 4
        self.depth4 = np.full((gh, gw), -1, np.int8)    # cqt depth
        self.mode4 = np.full((gh, gw), -1, np.int8)     # intra pred mode
        # slice id per 4x4 cell (-1 = not yet decoded): neighbours in a
        # different slice segment are unavailable for every prediction
        # (§6.4.1 zAvailability)
        self.slice4 = np.full((gh, gw), -1, np.int32)
        self.cur_slice = 0
        # cu_skip ctx grid at min-CB granularity (hevcdec.c:2459)
        cw, ch_ = w >> sps.log2_min_cb, h >> sps.log2_min_cb
        self.skipg = np.zeros((ch_, cw), np.int8)
        self.ctb_log2 = sps.log2_ctb

    # ------------------------------------------------------------ engine
    def _bin(self, elem, inc, val=None):
        ctx = O[elem] + inc
        if self.dec is not None:
            return self.dec.decision(ctx)
        self.enc.encode_decision(ctx, int(val))
        return int(val)

    def _bypass(self, val=None):
        if self.dec is not None:
            return self.dec.bypass()
        self.enc.encode_bypass(int(val))
        return int(val)

    def _bypass_bits(self, k, val=None):
        if self.dec is not None:
            return self.dec.bypass_bits(k)
        self.enc.encode_bypass_bits(int(val), k)
        return int(val)

    def _terminate(self, val=None):
        if self.dec is not None:
            return self.dec.terminate()
        self.enc.encode_terminate(int(val))
        return int(val)

    # ----------------------------------------------------------- picture
    def code_picture(self):
        n_ctb = self.sps.pic_w_ctb * self.sps.pic_h_ctb
        self.code_slice(0, n_ctb)

    def code_slice(self, start_ctb: int, end_ctb: int,
                   slice_id: int = 0):
        """Code the CTBs [start_ctb, end_ctb) of one slice segment.
        The caller owns the CABAC engine (fresh per slice segment,
        §9.3.1); picture-wide grids persist across slices."""
        sps = self.sps
        ctb = 1 << self.ctb_log2
        self._slice_start = start_ctb
        self.cur_slice = slice_id
        g4 = ctb // 4
        for i in range(start_ctb, end_ctb):
            self.slice_of_ctb[i] = slice_id
            rx = i % sps.pic_w_ctb
            ry = i // sps.pic_w_ctb
            self.slice4[ry * g4:(ry + 1) * g4,
                        rx * g4:(rx + 1) * g4] = slice_id
            if self.sao_luma or self.sao_chroma:
                self._sao(i, rx, ry)
            self.coding_quadtree(rx * ctb, ry * ctb, self.ctb_log2, 0)
            self._terminate(0 if i < end_ctb - 1 else 1)

    def _avail4(self, gx, gy):
        """Neighbour 4x4 cell availability: decoded AND same slice."""
        if gx < 0 or gy < 0:
            return False
        return self.slice4[gy, gx] == self.cur_slice

    # --------------------------------------------------------------- sao
    def _sao_offset_abs(self, want=None):
        """sao_offset_abs: TR cMax 7, bypass bins (§9.3.3.1)."""
        if self.dec is not None:
            v = 0
            while v < 7 and self._bypass():
                v += 1
            return v
        v = int(want)
        for _ in range(v):
            self._bypass(1)
        if v < 7:
            self._bypass(0)
        return v

    def _sao(self, addr, rx, ry):
        """Per-CTB sao() syntax (§7.3.8.3; hevcdec.c hls_sao_param)."""
        g = self.saog
        merged = False
        if rx > 0 and addr - 1 >= self._slice_start:
            want = self.ch.sao_merge() if self.ch else None
            if self._bin("SAO_MERGE_FLAG", 0, want):
                g[ry, rx] = g[ry, rx - 1]
                merged = True
        if not merged and ry > 0 \
                and addr - self.sps.pic_w_ctb >= self._slice_start:
            want = self.ch.sao_merge() if self.ch else None
            if self._bin("SAO_MERGE_FLAG", 0, want):
                g[ry, rx] = g[ry - 1, rx]
                merged = True
        if merged:
            return
        for cidx in range(3):
            if (cidx == 0 and not self.sao_luma) or \
                    (cidx > 0 and not self.sao_chroma):
                g[ry, rx, cidx] = 0
                continue
            if cidx == 2:
                typ = int(g[ry, rx, 1, 0])   # copied from Cb
            else:
                want = self.ch.sao_type() if self.ch else None
                first = self._bin(
                    "SAO_TYPE_IDX", 0,
                    None if want is None else int(want != 0))
                if first:
                    b = self._bypass(
                        None if want is None else int(want == 2))
                    typ = 2 if b else 1
                else:
                    typ = 0
            g[ry, rx, cidx, 0] = typ
            if typ == 0:
                continue
            offs = [self._sao_offset_abs(
                self.ch.sao_offset_abs() if self.ch else None)
                for _ in range(4)]
            if typ == 1:                     # band
                for i in range(4):
                    if offs[i]:
                        want = self.ch.sao_offset_sign() \
                            if self.ch else None
                        if self._bypass(want):
                            offs[i] = -offs[i]
                want = self.ch.sao_band_pos() if self.ch else None
                pos = self._bypass_bits(5, want)
            else:                            # edge: signs are implied
                offs = [offs[0], offs[1], -offs[2], -offs[3]]
                if cidx == 2:
                    pos = int(g[ry, rx, 1, 5])   # eo class from Cb
                else:
                    want = self.ch.sao_eo_class() if self.ch else None
                    pos = self._bypass_bits(2, want)
            g[ry, rx, cidx, 1:5] = offs
            g[ry, rx, cidx, 5] = pos

    # -------------------------------------------------------------- tree
    def coding_quadtree(self, x0, y0, log2, depth):
        sps = self.sps
        inside = (x0 + (1 << log2) <= sps.width
                  and y0 + (1 << log2) <= sps.height)
        max_depth = sps.log2_ctb - sps.log2_min_cb
        if inside and log2 > sps.log2_min_cb:
            # split_cu_flag, ctx from neighbor depths (§9.3.4.2.2)
            gx, gy = x0 // 4, y0 // 4
            inc = 0
            if self._avail4(gx - 1, gy) and \
                    self.depth4[gy, gx - 1] > depth:
                inc += 1
            if self._avail4(gx, gy - 1) and \
                    self.depth4[gy - 1, gx] > depth:
                inc += 1
            want = None
            if self.ch is not None:
                want = self.ch.split_cu(log2, depth, max_depth)
            split = self._bin("SPLIT_CODING_UNIT_FLAG", inc, want)
        else:
            split = 1 if log2 > sps.log2_min_cb else 0
        if split:
            half = 1 << (log2 - 1)
            for dy in (0, half):
                for dx in (0, half):
                    if x0 + dx < sps.width and y0 + dy < sps.height:
                        self.coding_quadtree(x0 + dx, y0 + dy,
                                             log2 - 1, depth + 1)
            return
        self.coding_unit(x0, y0, log2, depth)

    def coding_unit(self, x0, y0, log2, depth):
        sps = self.sps
        size = 1 << log2
        g0x, g0y = x0 // 4, y0 // 4
        self.depth4[g0y:g0y + size // 4, g0x:g0x + size // 4] = depth
        self._cu_depth = depth
        cbx, cby = x0 >> sps.log2_min_cb, y0 >> sps.log2_min_cb
        ncb = size >> sps.log2_min_cb
        if self.slice_type != 2:
            inc = 0
            if self._avail4(g0x - 1, g0y) and self.skipg[cby, cbx - 1]:
                inc += 1
            if self._avail4(g0x, g0y - 1) and self.skipg[cby - 1, cbx]:
                inc += 1
            want = self.ch.cu_skip() if self.ch else None
            skip = self._bin("SKIP_FLAG", inc, want)
            self.skipg[cby:cby + ncb, cbx:cbx + ncb] = skip
            if skip:
                self.prediction_unit(x0, y0, size, size, 0, 0,
                                     skip=True)
                if self.on_tu:          # implicit TB = CU (deblock
                    self.on_tu(x0, y0, log2, 0, None, -1)  # edge maps)
                return
            want = self.ch.pred_intra() if self.ch else None
            intra = self._bin("PRED_MODE_FLAG", 0, want)
        else:
            self.skipg[cby:cby + ncb, cbx:cbx + ncb] = 0
            intra = 1
        if not intra:
            self.inter_coding_unit(x0, y0, log2)
            return
        part_nxn = 0
        if log2 == sps.log2_min_cb:
            want = self.ch.part_nxn() if self.ch else None
            # PART_MODE bin: 1 = 2Nx2N, 0 -> NxN for intra min-CB
            is2n = self._bin("PART_MODE", 0,
                             None if want is None else (0 if want else 1))
            part_nxn = 0 if is2n else 1
        npu = 4 if part_nxn else 1
        pu_size = size // 2 if part_nxn else size
        # prev_intra_luma_pred_flag for all PUs first (§7.3.8.5)
        wants = []
        prevs = []
        for i in range(npu):
            px = x0 + (i & 1) * pu_size
            py = y0 + (i >> 1) * pu_size
            wants.append(self.ch.intra_mode() if self.ch else None)
            mpm = self._mpm(px, py, x0, y0)
            if self.ch is not None:
                prev = 1 if wants[i] in mpm else 0
            else:
                prev = None
            prevs.append(self._bin("PREV_INTRA_LUMA_PRED_FLAG", 0, prev))
            # store the mode later; the MPM of PU1.. depends on PU0's
            # mode, which is DERIVED after all prev flags... §: the
            # mpm_idx/rem come in a second loop, but mode derivation
            # uses neighbors coded BEFORE this CU plus earlier PUs of
            # this CU. We must therefore compute MPM lists in the
            # second loop (after earlier PUs' modes are known); the
            # first-loop MPM here is only used by the ENCODER to pick
            # prev flags, so in encode mode we set modes eagerly.
            if self.ch is not None:
                self._set_mode(px, py, pu_size, wants[i])
        modes = []
        for i in range(npu):
            px = x0 + (i & 1) * pu_size
            py = y0 + (i >> 1) * pu_size
            mpm = self._mpm(px, py, x0, y0)
            if prevs[i]:
                if self.ch is not None:
                    idx = mpm.index(wants[i])
                else:
                    idx = None
                b0 = self._bypass(None if idx is None else (idx > 0))
                if b0:
                    b1 = self._bypass(
                        None if idx is None else (idx == 2))
                    idx = 2 if b1 else 1
                else:
                    idx = 0
                mode = mpm[idx]
            else:
                if self.ch is not None:
                    srt = sorted(mpm)
                    rem = wants[i]
                    for m in reversed(srt):
                        if rem > m:
                            rem -= 1
                else:
                    rem = None
                rem = self._bypass_bits(5, rem)
                mode = rem
                for m in sorted(mpm):
                    if mode >= m:
                        mode += 1
            modes.append(mode)
            self._set_mode(px, py, pu_size, mode)
        # intra_chroma_pred_mode (§9.3.3.8): 1 ctx bin + 2 bypass
        want_c = self.ch.chroma_mode() if self.ch else None
        dm = self._bin("INTRA_CHROMA_PRED_MODE", 0,
                       None if want_c is None else (want_c != 4))
        if dm:
            cc = self._bypass_bits(
                2, None if want_c is None else want_c)
            cand = [0, 26, 10, 1]
            if modes[0] in cand:
                cand[cand.index(modes[0])] = 34
            chroma_mode = cand[cc]
        else:
            chroma_mode = modes[0]
        if self.on_cu:
            self.on_cu(x0, y0, log2, part_nxn, modes, chroma_mode)
        # transform tree
        intra_split = part_nxn
        max_depth = sps.max_transform_hierarchy_depth_intra + intra_split
        self.transform_tree(x0, y0, x0, y0, log2, 0, 0, intra_split,
                            max_depth, cbf_cb=1, cbf_cr=1, modes=modes,
                            chroma_mode=chroma_mode)

    # ------------------------------------------------------------- inter
    def inter_coding_unit(self, x0, y0, log2):
        """Inter CU: part_mode + PUs + rqt_root_cbf + transform tree
        (hevcdec.c hls_coding_unit MODE_INTER arm)."""
        sps = self.sps
        size = 1 << log2
        at_min = log2 == sps.log2_min_cb
        # part_mode, ff_hevc_part_mode_decode binarization (AMP off)
        want = self.ch.inter_part(log2, sps.log2_min_cb) \
            if self.ch else None
        if self.dec is not None:
            if self._bin("PART_MODE", 0):
                part = 0
            elif self._bin("PART_MODE", 1):
                part = 1
            elif not at_min or log2 == 3:
                part = 2
            elif self._bin("PART_MODE", 2):
                part = 2
            else:
                part = 3
        else:
            part = want
            self._bin("PART_MODE", 0, 1 if part == 0 else 0)
            if part != 0:
                self._bin("PART_MODE", 1, 1 if part == 1 else 0)
                if part not in (0, 1) and at_min and log2 > 3:
                    self._bin("PART_MODE", 2, 1 if part == 2 else 0)
        h2 = size // 2
        if part == 0:
            pus = [(x0, y0, size, size)]
        elif part == 1:
            pus = [(x0, y0, size, h2), (x0, y0 + h2, size, h2)]
        elif part == 2:
            pus = [(x0, y0, h2, size), (x0 + h2, y0, h2, size)]
        else:
            pus = [(x0, y0, h2, h2), (x0 + h2, y0, h2, h2),
                   (x0, y0 + h2, h2, h2), (x0 + h2, y0 + h2, h2, h2)]
        merge = 0
        for i, (px, py, pw, ph) in enumerate(pus):
            merge = self.prediction_unit(px, py, pw, ph, part, i)
        rqt = 1
        if not (part == 0 and merge):
            want = self.ch.rqt_root() if self.ch else None
            rqt = self._bin("NO_RESIDUAL_DATA_FLAG", 0, want)
        if rqt:
            max_depth = sps.max_transform_hierarchy_depth_inter
            self.transform_tree(
                x0, y0, x0, y0, log2, 0, 0, 0, max_depth,
                cbf_cb=1, cbf_cr=1, modes=None, chroma_mode=-1,
                intra=False, inter_split=(max_depth == 0 and part != 0))
        elif self.on_tu:                # implicit TB = CU (deblock)
            self.on_tu(x0, y0, log2, 0, None, -1)

    def prediction_unit(self, x0, y0, w, h, part, idx, skip=False):
        """PU syntax (§7.3.8.6): merge, or per-list mvd + mvp flag.
        P slices have one L0 reference (inter_pred_idc/ref_idx absent);
        B slices add inter_pred_idc and the L1 motion fields."""
        merge = 1
        if not skip:
            want = self.ch.merge() if self.ch else None
            merge = self._bin("MERGE_FLAG", 0, want)
        pu = {"merge": bool(merge), "merge_idx": 0, "mvd": (0, 0),
              "mvp": 0, "idc": 0, "mvd1": (0, 0), "mvp1": 0}
        if merge:
            mi = 0
            if self.max_merge > 1:
                want = self.ch.merge_idx(self.max_merge) \
                    if self.ch else None
                mi = self._bin("MERGE_IDX", 0,
                               None if want is None else int(want > 0))
                if mi:
                    while mi < self.max_merge - 1:
                        if self._bypass(
                                None if want is None
                                else int(want > mi)) == 0:
                            break
                        mi += 1
            pu["merge_idx"] = mi
        else:
            idc = 0
            if self.slice_type == 0:
                idc = self._inter_pred_idc(w, h)
            pu["idc"] = idc
            if idc != 1:                # L0 motion
                pu["mvd"] = self.mvd_coding()
                want = self.ch.mvp_flag() if self.ch else None
                pu["mvp"] = self._bin("MVP_LX_FLAG", 0, want)
            if idc != 0:                # L1 motion
                if not (self.mvd_l1_zero and idc == 2):
                    pu["mvd1"] = self.mvd_coding()
                want = self.ch.mvp_flag() if self.ch else None
                pu["mvp1"] = self._bin("MVP_LX_FLAG", 0, want)
        if self.on_pu:
            self.on_pu(x0, y0, w, h, part, idx, pu)
        return merge

    def _inter_pred_idc(self, w, h):
        """§9.3.4.2.2: bin 0 ctx = cqt depth (PRED_BI), bin 1 ctx 4
        (L0/L1); 8x4 and 4x8 PUs code only the L0/L1 bin
        (hevc cabac ff_hevc_inter_pred_idc_decode)."""
        want = self.ch.inter_pred_idc(w, h) if self.ch else None
        if w + h == 12:
            return self._bin("INTER_PRED_IDC", 4,
                             None if want is None else int(want == 1))
        bi = self._bin("INTER_PRED_IDC", self._cu_depth,
                       None if want is None else int(want == 2))
        if bi:
            return 2
        return self._bin("INTER_PRED_IDC", 4,
                         None if want is None else int(want == 1))

    def mvd_coding(self):
        """§7.3.8.9 (both greater0 flags, then both greater1 flags,
        then per-component remainder+sign; cabac.c:1595)."""
        if self.ch is not None:
            wx, wy = self.ch.mvd()
            ax, ay = abs(wx), abs(wy)
        else:
            wx = wy = ax = ay = None
        g0x = self._bin("ABS_MVD_GREATER0_FLAG", 0,
                        None if ax is None else int(ax > 0))
        g0y = self._bin("ABS_MVD_GREATER0_FLAG", 0,
                        None if ay is None else int(ay > 0))
        g1x = g1y = 0
        # ff quirk kept bit-exactly: greater1 uses ctx offset +1
        if g0x:
            g1x = self._bin("ABS_MVD_GREATER1_FLAG", 1,
                            None if ax is None else int(ax > 1))
        if g0y:
            g1y = self._bin("ABS_MVD_GREATER1_FLAG", 1,
                            None if ay is None else int(ay > 1))
        return (self._mvd_comp(g0x, g1x, wx),
                self._mvd_comp(g0y, g1y, wy))

    def _mvd_comp(self, g0, g1, want):
        if not g0:
            return 0
        if not g1:                    # |mvd| == 1: sign only
            if self.dec is not None:
                return -1 if self._bypass() else 1
            self._bypass(1 if want < 0 else 0)
            return want
        # abs_mvd_minus2: EG1 bypass (cabac.c mvd_decode) + sign
        if self.dec is not None:
            ret, k = 2, 1
            while self._bypass():
                ret += 1 << k
                k += 1
                if k > 30:
                    raise InvalidData("hevc: mvd overflow")
            while k:
                k -= 1
                ret += self._bypass() << k
            return -ret if self._bypass() else ret
        v = abs(want) - 2
        k = 1
        while v >= (1 << k):
            v -= 1 << k
            self._bypass(1)
            k += 1
        self._bypass(0)
        for i in range(k - 1, -1, -1):
            self._bypass((v >> i) & 1)
        self._bypass(1 if want < 0 else 0)
        return want

    # ---------------------------------------------------------- tr. tree
    def transform_tree(self, x0, y0, xb, yb, log2, depth, blk_idx,
                       intra_split, max_depth, cbf_cb, cbf_cr, modes,
                       chroma_mode, intra=True, inter_split=False):
        sps = self.sps
        if log2 <= sps.log2_max_tb and log2 > sps.log2_min_tb \
                and depth < max_depth \
                and not (intra_split and depth == 0):
            want = None
            if self.ch is not None:
                want = int(self.ch.rng.random() < 0.4)
            split = self._bin("SPLIT_TRANSFORM_FLAG", 5 - log2, want)
        else:
            split = 1 if (log2 > sps.log2_max_tb
                          or (intra_split and depth == 0)
                          or (inter_split and depth == 0)) else 0
        # chroma cbf at this level (coded once when log2 > 2)
        if log2 > 2:
            if depth == 0 or cbf_cb:
                want = self.ch.cbf(1) if self.ch else None
                cbf_cb = self._bin("CBF_CB_CR", depth, want)
            else:
                cbf_cb = 0
            if depth == 0 or cbf_cr:
                want = self.ch.cbf(2) if self.ch else None
                cbf_cr = self._bin("CBF_CB_CR", depth, want)
            else:
                cbf_cr = 0
        if split:
            half = 1 << (log2 - 1)
            for i, (dx, dy) in enumerate(((0, 0), (half, 0), (0, half),
                                          (half, half))):
                self.transform_tree(x0 + dx, y0 + dy, x0, y0,
                                    log2 - 1, depth + 1, i,
                                    intra_split, max_depth,
                                    cbf_cb, cbf_cr, modes, chroma_mode,
                                    intra=intra)
            return
        # leaf: cbf_luma (coded unless inter at depth 0 with no chroma
        # cbf, where it is inferred 1 -- §7.3.8.8)
        if intra or depth != 0 or cbf_cb or cbf_cr:
            want = self.ch.cbf(0) if self.ch else None
            cbf_luma = self._bin("CBF_LUMA", 1 if depth == 0 else 0,
                                 want)
        else:
            cbf_luma = 1
        self.transform_unit(x0, y0, xb, yb, log2, depth, blk_idx,
                            cbf_luma, cbf_cb, cbf_cr, modes,
                            chroma_mode)

    def transform_unit(self, x0, y0, xb, yb, log2, depth, blk_idx,
                       cbf_luma, cbf_cb, cbf_cr, modes, chroma_mode):
        # luma residual
        if cbf_luma:
            mode = self._mode_at(x0, y0, modes)
            self.residual_coding(x0, y0, log2, 0, mode)
        else:
            if self.on_tu:
                self.on_tu(x0, y0, log2, 0, None,
                           self._mode_at(x0, y0, modes))
        # chroma at log2 > 2, or at blk_idx == 3 for 4x4 luma leaves
        if log2 > 2:
            cx, cy, clog2 = x0, y0, log2 - 1
            do_chroma = True
        elif blk_idx == 3:
            # four 4x4 luma leaves share one 4x4 chroma TU at the
            # parent's position
            cx, cy, clog2 = xb, yb, 2
            do_chroma = True
        else:
            do_chroma = False
        if do_chroma:
            for cidx, cbf in ((1, cbf_cb), (2, cbf_cr)):
                if cbf:
                    self.residual_coding(cx, cy, clog2, cidx,
                                         chroma_mode)
                elif self.on_tu:
                    self.on_tu(cx, cy, clog2, cidx, None, chroma_mode)

    # ------------------------------------------------------ mode helpers
    def _set_mode(self, x, y, size, mode):
        gx, gy = x // 4, y // 4
        n = size // 4
        self.mode4[gy:gy + n, gx:gx + n] = mode

    def _mode_at(self, x, y, modes):
        return int(self.mode4[y // 4, x // 4])

    def _mpm(self, px, py, cu_x0, cu_y0):
        """Candidate list (§8.4.2): left/above neighbor modes; an
        above neighbor outside the current CTB row reads as DC."""
        gx, gy = px // 4, py // 4
        a = b = 1                         # DC when unavailable
        if self._avail4(gx - 1, gy) and self.mode4[gy, gx - 1] >= 0:
            a = int(self.mode4[gy, gx - 1])
        ctb = 1 << self.ctb_log2
        if self._avail4(gx, gy - 1) and self.mode4[gy - 1, gx] >= 0 \
                and (py % ctb) != 0:
            b = int(self.mode4[gy - 1, gx])
        if a == b:
            if a < 2:
                return [0, 1, 26]
            return [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)]
        m2 = 0 if (a != 0 and b != 0) else (
            1 if (a != 1 and b != 1) else 26)
        return [a, b, m2]

    # ------------------------------------------------- residual syntax
    def residual_coding(self, x0, y0, log2, cidx, pred_mode):
        size = 1 << log2
        # scan selection (§7.4.9.11)
        scan_idx = 0
        if log2 == 2 or (log2 == 3 and cidx == 0):
            if 6 <= pred_mode <= 14:
                scan_idx = 2              # vertical
            elif 22 <= pred_mode <= 30:
                scan_idx = 1              # horizontal
        coeffs = np.zeros((size, size), np.int32)
        n_sb = size // 4
        sb_scan = _SCAN_SB[scan_idx][n_sb]
        pos_scan = _SCAN4[scan_idx]

        # ---- generator: pick levels, find last position ----
        if self.ch is not None:
            lv = self.ch.levels(size * size)
            if not np.any(lv):
                lv[0] = 1                 # cbf said coded: force one
            # place levels in scan order
            full = []
            for si in range(n_sb * n_sb):
                sx, sy = sb_scan[si]
                for px, py in pos_scan:
                    full.append((sx * 4 + px, sy * 4 + py))
            for i, (fx, fy) in enumerate(full):
                coeffs[fy, fx] = lv[i]
            # find last significant in scan order
            last_i = max(i for i, (fx, fy) in enumerate(full)
                         if coeffs[fy, fx])
            last_x, last_y = full[last_i]
        else:
            last_x = last_y = last_i = None
            full = []
            for si in range(n_sb * n_sb):
                sx, sy = sb_scan[si]
                for px, py in pos_scan:
                    full.append((sx * 4 + px, sy * 4 + py))

        # ---- last_sig_coeff x/y (§7.3.8.11: BOTH prefixes, then
        # both suffixes) ----
        if scan_idx == 2 and last_x is not None:
            last_x, last_y = last_y, last_x
        px_info = self._last_prefix(log2, cidx, 0, last_x)
        py_info = self._last_prefix(log2, cidx, 1, last_y)
        lx = self._last_suffix(px_info, last_x)
        ly = self._last_suffix(py_info, last_y)
        if scan_idx == 2:
            lx, ly = ly, lx
        if self.dec is not None:
            # locate the scan index of (lx, ly)
            last_i = next(i for i, p in enumerate(full)
                          if p == (lx, ly))

        last_sb = last_i // 16
        last_in_sb = last_i % 16

        csbf = np.zeros((n_sb, n_sb), np.int8)
        g1_ctx_prev = 1                   # greater1Ctx of previous set
        for si in range(last_sb, -1, -1):
            sx, sy = sb_scan[si]
            infer_dc = 0
            if si == last_sb or si == 0:
                csbf[sy, sx] = 1
            else:
                right = csbf[sy, sx + 1] if sx + 1 < n_sb else 0
                below = csbf[sy + 1, sx] if sy + 1 < n_sb else 0
                inc = min(int(right) + int(below), 1) + (2 if cidx
                                                         else 0)
                want = None
                if self.ch is not None:
                    want = int(any(
                        coeffs[sy * 4 + py, sx * 4 + px]
                        for px, py in pos_scan))
                f = self._bin("SIGNIFICANT_COEFF_GROUP_FLAG", inc, want)
                csbf[sy, sx] = f
                if not f:
                    continue
                infer_dc = 1
            # significant_coeff_flag: positions n_end..1 use the
            # prev-csbf pattern contexts; position 0 is handled apart
            # (inferred, or a fixed ctx -- hevc/cabac.c:1389)
            base = 27 if cidx else 0
            if log2 > 2:
                if cidx == 0:
                    if sx > 0 or sy > 0:
                        base += 3
                    base += (9 if scan_idx == 0 else 15) \
                        if log2 == 3 else 21
                else:
                    base += 9 if log2 == 3 else 12
            right = csbf[sy, sx + 1] if sx + 1 < n_sb else 0
            below = csbf[sy + 1, sx] if sy + 1 < n_sb else 0
            prev = int(right) + 2 * int(below)
            start = last_in_sb - 1 if si == last_sb else 15
            sig = [0] * 16
            if si == last_sb:
                sig[last_in_sb] = 1
            nsig_coded = 1 if si == last_sb else 0
            for n in range(start, 0, -1):
                px, py = pos_scan[n]
                xc, yc = sx * 4 + px, sy * 4 + py
                if log2 == 2:
                    inc = base + _CTX_MAP_4x4[(py << 2) + px]
                else:
                    if prev == 0:
                        v = 2 if (px + py) == 0 else (
                            1 if (px + py) < 3 else 0)
                    elif prev == 1:
                        v = 2 if py == 0 else (1 if py == 1 else 0)
                    elif prev == 2:
                        v = 2 if px == 0 else (1 if px == 1 else 0)
                    else:
                        v = 2
                    inc = base + v
                want = None
                if self.ch is not None:
                    want = int(coeffs[yc, xc] != 0)
                b = self._bin("SIGNIFICANT_COEFF_FLAG", inc, want)
                sig[n] = b
                if b:
                    nsig_coded += 1
            # position 0 of the sub-block
            if si == last_sb and last_in_sb == 0:
                pass                      # already the last coefficient
            elif infer_dc and nsig_coded == 0:
                sig[0] = 1                # inferred DC significance
            else:
                if si == 0:
                    inc = 27 if cidx else 0
                else:
                    inc = base + 2
                want = None
                if self.ch is not None:
                    want = int(coeffs[sy * 4, sx * 4] != 0)
                sig[0] = self._bin("SIGNIFICANT_COEFF_FLAG", inc, want)
            idxs = [n for n in range(15, -1, -1) if sig[n]]
            if not idxs:
                continue
            # greater1 flags (first 8, reverse scan)
            ctx_set = 2 if (cidx == 0 and si > 0) else 0
            if g1_ctx_prev == 0:
                ctx_set += 1
            g1ctx = 1
            g1 = {}
            first_g1_idx = None
            for k, n in enumerate(idxs[:8]):
                want = None
                if self.ch is not None:
                    px, py = pos_scan[n]
                    want = int(abs(int(
                        coeffs[sy * 4 + py, sx * 4 + px])) > 1)
                inc = ctx_set * 4 + min(3, g1ctx) \
                    + (16 if cidx else 0)
                b = self._bin("COEFF_ABS_LEVEL_GREATER1_FLAG", inc,
                              want)
                g1[n] = b
                if b:
                    g1ctx = 0
                    if first_g1_idx is None:
                        first_g1_idx = n
                elif g1ctx:
                    g1ctx = min(3, g1ctx + 1)
            g1_ctx_prev = g1ctx
            # greater2 for the first greater1 coefficient
            g2 = {}
            if first_g1_idx is not None:
                want = None
                if self.ch is not None:
                    px, py = pos_scan[first_g1_idx]
                    want = int(abs(int(
                        coeffs[sy * 4 + py, sx * 4 + px])) > 2)
                g2[first_g1_idx] = self._bin(
                    "COEFF_ABS_LEVEL_GREATER2_FLAG",
                    ctx_set + (4 if cidx else 0), want)
            # signs (bypass, reverse scan; no sign hiding)
            signs = {}
            for n in idxs:
                want = None
                if self.ch is not None:
                    px, py = pos_scan[n]
                    want = int(coeffs[sy * 4 + py, sx * 4 + px] < 0)
                signs[n] = self._bypass(want)
            # remaining levels
            rice = 0
            for k, n in enumerate(idxs):
                base = 1 + g1.get(n, 0) + g2.get(n, 0)
                has_rem = False
                if k < 8:
                    if g1.get(n, 0):
                        if n == first_g1_idx:
                            has_rem = g2.get(n, 0) == 1
                        else:
                            has_rem = True
                else:
                    has_rem = True
                level = base
                if has_rem:
                    want = None
                    if self.ch is not None:
                        px, py = pos_scan[n]
                        want = abs(int(
                            coeffs[sy * 4 + py, sx * 4 + px])) - base
                    rem = self._golomb_rice(rice, want)
                    level = base + rem
                if level > (3 << rice):
                    rice = min(rice + 1, 4)
                if self.dec is not None:
                    px, py = pos_scan[n]
                    coeffs[sy * 4 + py, sx * 4 + px] = \
                        -level if signs[n] else level
        if self.on_tu:
            self.on_tu(x0, y0, log2, cidx, coeffs, pred_mode)

    def _last_prefix(self, log2, cidx, is_y, val):
        """last_significant_coeff_{x,y}_prefix (§9.3.3.2)."""
        elem = ("LAST_SIGNIFICANT_COEFF_Y_PREFIX" if is_y
                else "LAST_SIGNIFICANT_COEFF_X_PREFIX")
        if cidx:
            off, shift = 15, log2 - 2
        else:
            off, shift = 3 * (log2 - 2) + ((log2 - 1) >> 2), \
                (log2 + 1) >> 2
        maxpfx = (log2 << 1) - 1
        if self.ch is not None:
            if val <= 3:
                pfx = val
            else:
                for p in range(4, maxpfx + 1):
                    base = (2 + (p & 1)) << ((p >> 1) - 1)
                    nbits = (p >> 1) - 1
                    if base <= val < base + (1 << nbits):
                        pfx = p
                        break
                else:
                    raise InvalidData("hevc: bad last coordinate")
            for i in range(pfx):
                self._bin(elem, off + (i >> shift), 1)
            if pfx < maxpfx:
                self._bin(elem, off + (pfx >> shift), 0)
            return pfx
        prefix = 0
        while prefix < maxpfx and self._bin(elem,
                                            off + (prefix >> shift)):
            prefix += 1
        return prefix

    def _last_suffix(self, prefix, val):
        """last_significant_coeff_{x,y}_suffix (bypass bins)."""
        if prefix <= 3:
            return prefix
        nbits = (prefix >> 1) - 1
        if self.ch is not None:
            base = (2 + (prefix & 1)) << nbits
            self._bypass_bits(nbits, val - base)
            return val
        sfx = self._bypass_bits(nbits)
        return ((2 + (prefix & 1)) << nbits) + sfx

    def _golomb_rice(self, rice, val=None):
        """coeff_abs_level_remaining (§9.3.3.13)."""
        if self.dec is not None:
            prefix = 0
            while prefix < 32 and self._bypass():
                prefix += 1
            if prefix <= 3:
                return (prefix << rice) + self._bypass_bits(rice)
            nbits = prefix - 3 + rice
            return (((1 << (prefix - 3)) + 3 - 1) << rice) \
                + self._bypass_bits(nbits)
        v = int(val)
        if (v >> rice) < 4:
            prefix = v >> rice
            for _ in range(prefix):
                self._bypass(1)
            self._bypass(0)
            self._bypass_bits(rice, v & ((1 << rice) - 1))
            return v
        # exp-golomb escape
        vv = v - (4 << rice)
        prefix = 4
        while vv >= (1 << (prefix - 3 + rice)):
            vv -= 1 << (prefix - 3 + rice)
            prefix += 1
        for _ in range(prefix):
            self._bypass(1)
        self._bypass(0)
        nbits = prefix - 3 + rice
        base = (((1 << (prefix - 3)) + 3 - 1) << rice)
        self._bypass_bits(nbits, v - base)
        return v
