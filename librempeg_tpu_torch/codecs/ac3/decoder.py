"""AC-3 (ATSC A/52) decoder: syncframe parse, exponent/bit-allocation,
coupling, rematrixing, 512-point IMDCT with KBD(5.0) window.

Behavioral reference (not a translation): ISO A/52 §5-7 as realized in
libavcodec/ac3dec.c / ac3.c / ac3dsp.c; the spec
constant tables live in tables_data.py (tools/extract_ac3_tables.py).
Entropy/bit-allocation is host work; the per-block spectra are
reconstructed as arrays and the IMDCT bank runs through ops/tx (the
same device transform the AAC decoder uses).

Scope: plain AC-3 (bsid <= 8), all acmods + LFE, channel coupling with
phase flags, rematrixing, delta bit allocation, long transforms (the
reference encoder never emits block switching; blksw frames decode via
the even/odd split). The bap-0 mantissas of a dithered channel and of
the coupling channel take libavcodec's dither noise: one av_lfg
generator a decoder, seeded 0 when it is made and never reset (a flush
keeps it, as avcodec_flush_buffers does), drawn in bitstream read order
(`LaggedFibonacci`). The decoder does not model libavcodec's fixed-point
`>> exps` truncation, so comparisons against it are SNR-gated rather
than bit-exact (tests/test_torch_eac3.py: above 95 dB on every
committed stream).

Each decoder decodes on the host, as the JAX module does, and uploads
each output frame once to its `device` (default "cuda").

A copy of librempeg_tpu/codecs/ac3/decoder.py (host code, no JAX), imports
rewritten, with the dither filled in where the JAX decoder leaves zeros
and the layout libavcodec reports (5.1(side) for acmod 7 with LFE).
"""
from __future__ import annotations

import hashlib
import struct

import numpy as np
import torch

from librempeg_tpu_torch.codecs.ac3 import tables_data as T
from librempeg_tpu_torch.codecs.api import CodecInfo, Decoder, register_decoder
from librempeg_tpu_torch.codecs.flac.bitio import BitReaderMSB
from librempeg_tpu_torch.core.errors import InvalidData, Unsupported
from librempeg_tpu_torch.core.frame import AudioFrame
from librempeg_tpu_torch.core.packet import Packet
from librempeg_tpu_torch.core.rational import NOPTS, Rational
from librempeg_tpu_torch.device import resolve

SAMPLE_RATES = (48000, 44100, 32000)
CHANNELS_PER_MODE = (2, 1, 2, 3, 3, 4, 4, 5)
# AC-3 native order (L[,C],R,surrounds) -> canonical FL,FR,FC,rears order
FBW_REORDER = {0: [0, 1], 1: [0], 2: [0, 1], 3: [0, 2, 1],
               4: [0, 1, 2], 5: [0, 2, 1, 3], 6: [0, 1, 2, 3],
               7: [0, 2, 1, 3, 4]}
# LFE inserts after the front channels (FL,FR[,FC]) like the reference
FRONTS = (2, 1, 2, 3, 2, 3, 2, 3)
REMATRIX_BANDS = (13, 25, 37, 61, 253)
QUANT_BITS = (0, 3, 5, 7, 11, 15, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16)
LEVELS = (0, 3, 7, 15, 31)          # bap 1..4 (bap3 7-level direct)

_UNGROUP3 = np.array([[i // 9, (i % 9) // 3, i % 3] for i in range(27)])
_UNGROUP5 = np.array([[i // 25, (i % 25) // 5, i % 5] for i in range(128)])
_UNGROUP11 = np.array([[i // 11, i % 11] for i in range(121)])
# per-bap bit widths for ungrouped reads (grouped baps 1/2/4 read only
# on tuple leaders — handled separately)
_BAP_BITS = np.array([0, 0, 0, 3, 0, 4, 5, 6, 7, 8, 9, 10, 11, 12,
                      14, 16], np.int64)
_QUANT_BITS_ARR = np.array(QUANT_BITS, np.int64)


def _sym(code: int, levels: int) -> float:
    return (code - (levels >> 1)) / levels


# --------------------------------------------------------------------------
# A/52 §7.2.2 bit allocation core, shared with the encoder (the standard
# mandates the identical computation on both sides)
# --------------------------------------------------------------------------

def calc_psd(start, end, dexps, psd, band_psd):
    psd[start:end] = 3072 - (dexps[start:end].astype(np.int32) << 7)
    b = start
    band = T.BIN_TO_BAND_TAB[start]
    while True:
        v = int(psd[b])
        b += 1
        band_end = min(T.BAND_START_TAB[band + 1], end)
        while b < band_end:
            mx = max(v, int(psd[b]))
            adr = min(mx - ((v + int(psd[b]) + 1) >> 1), 255)
            v = mx + T.LOG_ADD_TAB[adr]
            b += 1
        band_psd[band] = v
        band += 1
        if end <= T.BAND_START_TAB[band]:
            break


def calc_mask(start, end, bp, mask, fg, ba, sr_code, sr_shift,
              is_lfe=False):
    excite = np.zeros(50, np.int32)
    bs = T.BIN_TO_BAND_TAB[start]
    be = T.BIN_TO_BAND_TAB[end - 1] + 1
    sd, fd, sg, db = ba["sd"], ba["fd"], ba["sg"], ba["db"]

    def lowcomp1(a, b0, b1, c):
        if b0 + 256 == b1:
            return c
        if b0 > b1:
            return max(a - 64, 0)
        return a

    def lowcomp(a, b0, b1, binn):
        if binn < 7:
            return lowcomp1(a, b0, b1, 384)
        if binn < 20:
            return lowcomp1(a, b0, b1, 320)
        return max(a - 128, 0)

    if bs == 0:
        lc = lowcomp1(0, bp[0], bp[1], 384)
        excite[0] = bp[0] - fg - lc
        lc = lowcomp1(lc, bp[1], bp[2], 384)
        excite[1] = bp[1] - fg - lc
        begin = 7
        fastleak = slowleak = 0
        for band in range(2, 7):
            if not (is_lfe and band == 6):
                lc = lowcomp1(lc, bp[band], bp[band + 1], 384)
            fastleak = int(bp[band]) - fg
            slowleak = int(bp[band]) - sg
            excite[band] = fastleak - lc
            if not (is_lfe and band == 6):
                if bp[band] <= bp[band + 1]:
                    begin = band + 1
                    break
        for band in range(begin, min(be, 22)):
            if not (is_lfe and band == 6):
                lc = lowcomp(lc, bp[band], bp[band + 1], band)
            fastleak = max(fastleak - fd, int(bp[band]) - fg)
            slowleak = max(slowleak - sd, int(bp[band]) - sg)
            excite[band] = max(fastleak - lc, slowleak)
        begin = 22
    else:
        begin = bs
        fastleak = (ba["cplfl"] << 8) + 768
        slowleak = (ba["cplsl"] << 8) + 768

    for band in range(begin, be):
        fastleak = max(fastleak - fd, int(bp[band]) - fg)
        slowleak = max(slowleak - sd, int(bp[band]) - sg)
        excite[band] = max(fastleak, slowleak)

    for band in range(bs, be):
        tmp = db - int(bp[band])
        if tmp > 0:
            excite[band] += tmp >> 2
        hth = T.HEARING_THRESHOLD_TAB[band >> sr_shift][sr_code]
        mask[band] = max(hth, int(excite[band]))


def calc_bap(start, end, psd, mask, snr, floor, bap):
    if snr == -960:
        bap[:] = 0
        return
    # per-band mask value, spread to bins, then the 6-bit psd-mask
    # address lookup — all vectorized
    bands = np.asarray(T.BIN_TO_BAND_TAB[start:end])
    mval = (np.maximum(mask[bands].astype(np.int64) - snr - floor,
                       0) & 0x1FE0) + floor
    addr = np.clip((psd[start:end].astype(np.int64) - mval) >> 5,
                   0, 63)
    bap[start:end] = np.asarray(T.BAP_TAB)[addr]


class BlockState:
    """Per-stream state that persists across the 6 audio blocks and
    across frames (exponents, bit-alloc products, delay buffers)."""

    def __init__(self):
        self.dexps = {}              # ch -> int8[256]
        self.bap = {}
        self.psd = {}
        self.band_psd = {}
        self.mask = {}
        self.delay = {}              # ch -> float[256] overlap
        self.end_freq = {}
        self.start_freq = {}


class LaggedFibonacci:
    """libavutil's av_lfg_init(seed) / av_lfg_get (lfg.c): x[n] = x[n-24]
    + x[n-55] mod 2^32 over a state seeded from MD5. `get(n)` draws the
    next n values; a numpy step computes 24 of them, since each depends
    only on values at least 24 draws back."""

    def __init__(self, seed: int = 0):
        state, tmp = [0] * 64, bytes(16)
        for i in range(8, 64, 4):
            tmp = hashlib.md5(struct.pack("<IB", seed, i) + tmp[5:]).digest()
            state[i:i + 4] = struct.unpack("<4I", tmp)
        # av_lfg_get reads state[index - 55 & 63] first: x[-55..-1]
        self._hist = np.array(state[9:], np.uint32)

    def get(self, n: int) -> np.ndarray:
        buf = np.empty(55 + n, np.uint32)
        buf[:55] = self._hist
        for j in range(55, 55 + n, 24):
            e = min(j + 24, 55 + n)
            np.add(buf[j - 24:e - 24], buf[j - 55:e - 55], out=buf[j:e])
        self._hist = buf[n:].copy()
        return buf[55:]


# ops/tx.imdct + the /2 overlap convention differ from the reference's
# imdct_half + 2^-22 output gain by exactly this constant (calibrated:
# correlation -0.9999998 at gain -512 vs the reference decoder)
OUTPUT_GAIN = -512.0


class Ac3FrameDecoder:
    def __init__(self):
        self.st = BlockState()
        self._window = None
        # ac3_decode_init's av_lfg_init(&s->dith_state, 0)
        self._lfg = LaggedFibonacci(0)
        # persists across frames (decode_band_structure loads the
        # default only at blk 0; later blocks may reuse stale values —
        # reference-compatible)
        self.cpl_band_struct = [0] * 18

    # ------------------------------------------------------------------
    def decode_frame(self, data: bytes):
        if len(data) < 7 or data[0] != 0x0B or data[1] != 0x77:
            raise InvalidData("ac3: bad sync word")
        # bsid sits at bit 40 in BOTH syntaxes (the E-AC-3 header was
        # laid out to keep it there; ac3_parser.c:298 reads ahead)
        bsid_peek = (data[5] >> 3) & 0x1F
        if 11 <= bsid_peek <= 16:
            return self._decode_frame_eac3(data)
        br = BitReaderMSB(data)
        br.read(16)                              # sync
        br.read(16)                              # crc1
        fscod = br.read(2)
        frmsizecod = br.read(6)
        if fscod == 3 or frmsizecod > 37:
            raise InvalidData("ac3: bad fscod/frmsizecod")
        self.sample_rate = SAMPLE_RATES[fscod]
        self.sr_code = fscod
        self.sr_shift = 0                        # bsid > 8 would shift
        self.eac3 = False
        self.num_blocks = 6
        self.strmtyp = -1
        # AC-3 syntax defaults (ac3dec.c:202-210)
        self.snr_offset_strategy = 2
        self.block_switch_syntax = 1
        self.dither_flag_syntax = 1
        self.bit_allocation_syntax = 1
        self.fast_gain_syntax = 0
        self.dba_syntax = 1
        self.skip_syntax = 1
        self.first_cpl_leak = False
        bsid = br.read(5)
        if bsid > 8:
            raise Unsupported(f"ac3: bsid {bsid}")
        br.read(3)                               # bsmod
        acmod = br.read(3)
        self.acmod = acmod
        if (acmod & 1) and acmod != 1:
            br.read(2)                           # cmixlev
        if acmod & 4:
            br.read(2)                           # surmixlev
        if acmod == 2:
            br.read(2)                           # dsurmod
        self.lfeon = br.read(1)
        br.read(5)                               # dialnorm
        if br.read(1):
            br.read(8)                           # compr
        if br.read(1):
            br.read(8)                           # langcod
        if br.read(1):
            br.read(7)                           # mixlevel + roomtyp
        if acmod == 0:
            br.read(5)
            if br.read(1):
                br.read(8)
            if br.read(1):
                br.read(8)
            if br.read(1):
                br.read(7)
        br.read(2)                               # copyrightb, origbs
        if br.read(1):
            br.read(14)                          # timecod1
        if br.read(1):
            br.read(14)                          # timecod2
        if br.read(1):                           # addbsie
            n = br.read(6) + 1
            for _ in range(n):
                br.read(8)

        self.fbw = CHANNELS_PER_MODE[acmod]
        self.channels = self.fbw + self.lfeon
        self.lfe_ch = self.fbw + 1 if self.lfeon else -1

        # persistent bit-alloc defaults
        self._init_frame_state()
        return self._decode_blocks(br)

    def _decode_blocks(self, br) -> np.ndarray:
        nb = self.num_blocks
        out = np.zeros((self.channels, 256 * nb), np.float64)
        for blk in range(nb):
            pcm = self._decode_block(br, blk)
            out[:, blk * 256:(blk + 1) * 256] = pcm
        # reorder to the canonical channel layout
        order = list(FBW_REORDER[self.acmod])
        if self.lfeon:
            order.insert(FRONTS[self.acmod], self.fbw)
        return out[order].astype(np.float32)

    # ------------------------------------------------- E-AC-3 (annex E)
    def _decode_frame_eac3(self, data: bytes) -> np.ndarray:
        """Independent-stream E-AC-3 frame (ETSI TS 102 366 Annex E).
        Behavioral reference: libavcodec/ac3_parser.c eac3_parse_header
        + eac3dec.c ff_eac3_parse_header; AHT/SPX/enhanced-coupling
        feature points are rejected (eac3dec.c:514 class)."""
        br = BitReaderMSB(data)
        br.read(16)                              # sync
        self.eac3 = True
        strmtyp = br.read(2)
        self.strmtyp = strmtyp
        if strmtyp == 3:
            raise InvalidData("eac3: reserved frame type")
        if strmtyp == 1:
            raise Unsupported("eac3: dependent substreams")
        substreamid = br.read(3)
        if substreamid:
            raise Unsupported("eac3: additional substreams")
        frmsiz = br.read(11)
        frame_size = (frmsiz + 1) * 2
        fscod = br.read(2)
        if fscod == 3:
            raise Unsupported("eac3: reduced sample rates")
        self.sr_code = fscod
        self.sr_shift = 0
        self.sample_rate = SAMPLE_RATES[fscod]
        self.num_blocks = (1, 2, 3, 6)[br.read(2)]
        acmod = br.read(3)
        self.acmod = acmod
        self.lfeon = br.read(1)
        br.read(5)                               # bsid (16)
        for _ in range(1 if acmod else 2):
            br.read(5)                           # dialnorm
            if br.read(1):
                br.read(8)                       # compr
        if br.read(1):                           # mixmdate
            if acmod > 2:
                br.read(2)                       # preferred downmix
                if acmod & 1:
                    br.read(6)                   # center mix (ltrt+loro)
                if acmod & 4:
                    br.read(6)                   # surround mix
            if self.lfeon and br.read(1):
                br.read(5)                       # lfe mix level
            if strmtyp == 0:
                for _ in range(1 if acmod else 2):
                    if br.read(1):
                        br.read(6)               # program scale
                if br.read(1):
                    br.read(6)                   # ext program scale
                mde = br.read(2)
                if mde == 1:
                    br.read(5)
                elif mde == 2:
                    br.read(12)
                elif mde == 3:
                    for _ in range(br.read(5) + 2):
                        br.read(8)
                if acmod < 2:
                    for _ in range(1 if acmod else 2):
                        if br.read(1):
                            br.read(14)          # pan info
                if br.read(1):                   # frame mix config
                    for _ in range(self.num_blocks):
                        if self.num_blocks == 1 or br.read(1):
                            br.read(5)
        if br.read(1):                           # infomdate
            br.read(5)                           # bsmod + copyright/orig
            if acmod == 2:
                br.read(4)                       # dsurmod + dheadphonmod
            if acmod >= 6:
                br.read(2)                       # dsurexmod
            for _ in range(1 if acmod else 2):
                if br.read(1):
                    br.read(8)                   # mix level / room type
            br.read(1)                           # source sample rate
        if strmtyp == 0 and self.num_blocks != 6:
            br.read(1)                           # convsync
        if strmtyp == 2 and (self.num_blocks == 6 or br.read(1)):
            br.read(6)                           # orig frame size code
        if br.read(1):                           # addbsie
            addbsil = br.read(6)
            i = 0
            while i < addbsil + 1:
                if i == 0:
                    br.read(7)
                    if br.read(1):               # extension type A
                        br.read(8)
                        i += 1
                else:
                    br.read(8)
                i += 1

        self.fbw = CHANNELS_PER_MODE[acmod]
        self.channels = self.fbw + self.lfeon
        self.lfe_ch = self.fbw + 1 if self.lfeon else -1
        self._init_frame_state()

        # ---- audio frame header (ff_eac3_parse_header role) ----
        nb = self.num_blocks
        CPL = 0
        if nb == 6:
            expstre = br.read(1)
            ahte = br.read(1)
        else:
            expstre, ahte = 1, 0
        self.snr_offset_strategy = br.read(2)
        transproce = br.read(1)
        self.block_switch_syntax = br.read(1)
        if not self.block_switch_syntax:
            self.block_switch = [0] * (self.fbw + 1)
        self.dither_flag_syntax = br.read(1)
        if not self.dither_flag_syntax:
            self.dither_flag = [1] * (self.fbw + 1)
        self.bit_allocation_syntax = br.read(1)
        if not self.bit_allocation_syntax:
            self.ba.update(sd=T.SLOW_DECAY_TAB[2], fd=T.FAST_DECAY_TAB[1],
                           sg=T.SLOW_GAIN_TAB[1], db=T.DB_PER_BIT_TAB[2],
                           fl=T.FLOOR_TAB[7])
        self.fast_gain_syntax = br.read(1)
        self.dba_syntax = br.read(1)
        self.skip_syntax = br.read(1)
        spxattene = br.read(1)

        # coupling use per block
        self.cpl_strategy_exists = [0] * nb
        self.cpl_in_use_blk = [0] * nb
        num_cpl_blocks = 0
        if acmod > 1:
            for blk in range(nb):
                self.cpl_strategy_exists[blk] = \
                    1 if blk == 0 else br.read(1)
                if self.cpl_strategy_exists[blk]:
                    self.cpl_in_use_blk[blk] = br.read(1)
                else:
                    self.cpl_in_use_blk[blk] = self.cpl_in_use_blk[blk - 1]
                num_cpl_blocks += self.cpl_in_use_blk[blk]

        # exponent strategies (frame-level)
        self.frame_exp_strategy = [dict() for _ in range(nb)]
        if expstre:
            for blk in range(nb):
                first = CPL if self.cpl_in_use_blk[blk] else 1
                for ch in range(first, self.fbw + 1):
                    self.frame_exp_strategy[blk][ch] = br.read(2)
        else:
            first = CPL if (acmod > 1 and num_cpl_blocks) else 1
            for ch in range(first, self.fbw + 1):
                code = br.read(5)
                for blk in range(6):
                    self.frame_exp_strategy[blk][ch] = \
                        T.EAC3_FRM_EXPSTR[code][blk]
        if self.lfeon:
            for blk in range(nb):
                self.frame_exp_strategy[blk][self.lfe_ch] = br.read(1)
        if strmtyp == 0 and (nb == 6 or br.read(1)):
            br.read(5 * self.fbw)                # converter exp strategy
        if ahte:
            for ch in range((1 if num_cpl_blocks != 6 else 0),
                            self.channels + 1):
                use = all(self.frame_exp_strategy[blk].get(ch, 1) == 0
                          and not (ch == CPL
                                   and self.cpl_strategy_exists[blk])
                          for blk in range(1, 6))
                if use and br.read(1):
                    raise Unsupported("eac3: AHT")
        if not self.snr_offset_strategy:
            csnr = (br.read(6) - 15) << 4
            snr = (csnr + br.read(4)) << 2
            for ch in range(0, self.channels + 1):
                self.snr_offset[ch] = snr
        if transproce:
            for ch in range(1, self.fbw + 1):
                if br.read(1):
                    br.read(18)                  # transient proc data
        for ch in range(1, self.fbw + 1):
            if spxattene and br.read(1):
                br.read(5)                       # spx atten code
        if nb > 1 and br.read(1):
            nbits = (nb - 1) * (4 + (frame_size - 2).bit_length() - 1)
            for _ in range(nbits):
                br.read(1)                       # block start info
        self.first_cpl_coords = [1] * (self.fbw + 1)
        self.first_cpl_leak = True
        return self._decode_blocks(br)

    # ------------------------------------------------------------------
    def _init_frame_state(self):
        self.cpl_in_use = False
        self.channel_in_cpl = [0] * (self.fbw + 1)      # 1-indexed
        self.phase_flags_in_use = 0
        self.phase_flags = [0] * 18
        self.cpl_coords = {}
        self.dynrng = 1.0
        self.exp_strategy = {}
        self.num_exp_groups = {}
        self.ba = {"sd": 0, "fd": 0, "sg": 0, "db": 0, "fl": 0,
                   "cplfl": 0, "cplsl": 0}
        self.snr_offset = {}
        self.fast_gain = {}
        self.dba_mode = {}
        self.dba = {}
        self.rematrixing_flags = [0] * 4
        self.num_rematrixing_bands = 0
        self.dither_flag = [1] * (self.fbw + 1)
        self.block_switch = [0] * (self.fbw + 1)
        self.first_cpl_coords = [1] * (self.fbw + 1)
        self.cpl_strategy_exists = [0] * 6
        self.cpl_in_use_blk = [0] * 6
        self.num_cpl_bands = 0
        self.cpl_band_sizes = []

    # ------------------------------------------------------------------
    def _decode_block(self, br: BitReaderMSB, blk: int) -> np.ndarray:
        st = self.st
        fbw = self.fbw
        CPL = 0
        eac3 = self.eac3
        if self.block_switch_syntax:
            for ch in range(1, fbw + 1):         # blksw
                self.block_switch[ch] = br.read(1)
        if self.dither_flag_syntax:
            for ch in range(1, fbw + 1):         # dithflag
                self.dither_flag[ch] = br.read(1)
        for _ in range(2 if self.acmod == 0 else 1):    # dynrng
            if br.read(1):
                v = br.read(8)
                e = (v >> 5) - ((v >> 7) << 3) - 5
                self.dynrng = 2.0 ** e * ((v & 0x1F) | 0x20) / 32.0
            elif blk == 0:
                self.dynrng = 1.0

        # spectral extension strategy (E-AC-3)
        if eac3 and (blk == 0 or br.read(1)):
            if br.read(1):
                raise Unsupported("eac3: spectral extension")

        stages = {}                              # ch -> bit alloc stage

        cplstre = self.cpl_strategy_exists[blk] if eac3 else br.read(1)
        if cplstre:
            for ch in range(1, fbw + 1):
                stages[ch] = 3
            stages[CPL] = 3
            self.cpl_in_use = bool(self.cpl_in_use_blk[blk]) if eac3 \
                else bool(br.read(1))
            if self.cpl_in_use:
                if self.acmod < 2:
                    raise InvalidData("ac3: coupling in mono")
                if eac3 and br.read(1):
                    raise Unsupported("eac3: enhanced coupling")
                if eac3 and self.acmod == 2:
                    self.channel_in_cpl[1] = 1
                    self.channel_in_cpl[2] = 1
                else:
                    for ch in range(1, fbw + 1):
                        self.channel_in_cpl[ch] = br.read(1)
                if self.acmod == 2:
                    self.phase_flags_in_use = br.read(1)
                cpl_start = br.read(4)
                cpl_end = br.read(4) + 3
                if cpl_start >= cpl_end:
                    raise InvalidData("ac3: bad coupling range")
                st.start_freq[CPL] = cpl_start * 12 + 37
                st.end_freq[CPL] = cpl_end * 12 + 37
                # band structure (decode_band_structure role): default
                # loaded at blk 0, explicit bits overwrite unless the
                # E-AC-3 "use default" flag is clear
                if blk == 0:
                    self.cpl_band_struct = \
                        list(T.EAC3_DEFAULT_CPL_BAND_STRUCT)
                n_sub = cpl_end - cpl_start
                if not eac3 or br.read(1):
                    for sb in range(n_sub - 1):
                        self.cpl_band_struct[cpl_start + 1 + sb] = \
                            br.read(1)
                sizes = [12]
                for sb in range(1, n_sub):
                    if self.cpl_band_struct[cpl_start + sb]:
                        sizes[-1] += 12
                    else:
                        sizes.append(12)
                self.cpl_band_sizes = sizes
                self.num_cpl_bands = len(sizes)
            else:
                for ch in range(1, fbw + 1):
                    self.channel_in_cpl[ch] = 0
                    self.first_cpl_coords[ch] = 1
                self.first_cpl_leak = eac3
                self.phase_flags_in_use = 0
        elif blk == 0 and not eac3:
            raise InvalidData("ac3: coupling strategy missing in block 0")

        if self.cpl_in_use:                      # coupling coordinates
            coords_exist = False
            for ch in range(1, fbw + 1):
                if self.channel_in_cpl[ch]:
                    if (eac3 and self.first_cpl_coords[ch]) \
                            or br.read(1):
                        self.first_cpl_coords[ch] = 0
                        coords_exist = True
                        master = 3 * br.read(2)
                        coords = []
                        for _ in range(self.num_cpl_bands):
                            cexp = br.read(4)
                            cmant = br.read(4)
                            if cexp == 15:
                                c = cmant / 16.0
                            else:
                                c = (cmant + 16) / 32.0 * 2.0 ** -cexp
                            coords.append(c * 2.0 ** -master)
                        self.cpl_coords[ch] = coords
                    elif blk == 0:
                        raise InvalidData("ac3: missing cpl coords")
                else:
                    self.first_cpl_coords[ch] = 1
            if self.acmod == 2 and coords_exist:
                for bnd in range(self.num_cpl_bands):
                    self.phase_flags[bnd] = (br.read(1)
                                             if self.phase_flags_in_use
                                             else 0)

        if self.acmod == 2:                      # rematrixing
            if (eac3 and blk == 0) or br.read(1):
                nb = 4
                if self.cpl_in_use and st.start_freq[CPL] <= 61:
                    nb -= 1 + (st.start_freq[CPL] == 37)
                self.num_rematrixing_bands = nb
                for bnd in range(nb):
                    self.rematrixing_flags[bnd] = br.read(1)
            elif blk == 0:
                self.num_rematrixing_bands = 0

        # exponent strategies (E-AC-3: read per-frame in the header)
        chans = ([CPL] if self.cpl_in_use else []) + \
            list(range(1, self.channels + 1))
        for ch in chans:
            if eac3:
                self.exp_strategy[ch] = self.frame_exp_strategy[blk][ch]
            else:
                bits = 1 if ch == self.lfe_ch else 2
                self.exp_strategy[ch] = br.read(bits)
            if self.exp_strategy[ch] != 0:       # != REUSE
                stages[ch] = 3

        # channel bandwidth codes
        for ch in range(1, fbw + 1):
            st.start_freq[ch] = 0
            if self.exp_strategy[ch] != 0:
                prev = st.end_freq.get(ch)
                if self.channel_in_cpl[ch]:
                    st.end_freq[ch] = st.start_freq[CPL]
                else:
                    bwcod = br.read(6)
                    if bwcod > 60:
                        raise InvalidData("ac3: bandwidth code > 60")
                    st.end_freq[ch] = bwcod * 3 + 73
                gs = 3 << (self.exp_strategy[ch] - 1)
                self.num_exp_groups[ch] = (st.end_freq[ch] + gs - 4) // gs
                if blk > 0 and st.end_freq[ch] != prev:
                    for c2 in chans:
                        stages[c2] = 3
        if self.cpl_in_use and self.exp_strategy[CPL] != 0:
            gs = 3 << (self.exp_strategy[CPL] - 1)
            self.num_exp_groups[CPL] = (st.end_freq[CPL]
                                        - st.start_freq[CPL]) // gs
        if self.lfeon:
            st.start_freq[self.lfe_ch] = 0
            st.end_freq[self.lfe_ch] = 7
            self.num_exp_groups[self.lfe_ch] = 2

        # exponents
        for ch in chans:
            if self.exp_strategy[ch] != 0:
                dexps = st.dexps.setdefault(ch, np.zeros(260, np.int8))
                absexp = br.read(4) << (1 if ch == CPL else 0)
                start = st.start_freq[ch]
                if ch != CPL:
                    dexps[0] = absexp
                self._decode_exponents(
                    br, self.exp_strategy[ch], self.num_exp_groups[ch],
                    absexp, dexps, start + (0 if ch == CPL else 1))
                if ch != CPL and ch != self.lfe_ch:
                    br.read(2)                   # gainrng

        # bit allocation info
        if self.bit_allocation_syntax:
            if br.read(1):
                self.ba["sd"] = T.SLOW_DECAY_TAB[br.read(2)] \
                    >> self.sr_shift
                self.ba["fd"] = T.FAST_DECAY_TAB[br.read(2)] \
                    >> self.sr_shift
                self.ba["sg"] = T.SLOW_GAIN_TAB[br.read(2)]
                self.ba["db"] = T.DB_PER_BIT_TAB[br.read(2)]
                self.ba["fl"] = T.FLOOR_TAB[br.read(3)]
                for ch in chans:
                    stages[ch] = max(stages.get(ch, 0), 2)
            elif blk == 0:
                raise InvalidData("ac3: missing bit alloc info")

        # SNR offsets (+ fast gains inline for plain AC-3)
        if not eac3 or blk == 0:
            if self.snr_offset_strategy and br.read(1):  # snroffste
                csnr = (br.read(6) - 15) << 4
                snr = 0
                first = chans[0]
                for ch in chans:
                    if ch == first or self.snr_offset_strategy == 2:
                        snr = (csnr + br.read(4)) << 2
                    if blk and self.snr_offset.get(ch) != snr:
                        stages[ch] = max(stages.get(ch, 0), 1)
                    self.snr_offset[ch] = snr
                    if not eac3:
                        prev = self.fast_gain.get(ch)
                        self.fast_gain[ch] = T.FAST_GAIN_TAB[br.read(3)]
                        if blk and prev != self.fast_gain[ch]:
                            stages[ch] = max(stages.get(ch, 0), 2)
            elif not eac3 and blk == 0:
                raise InvalidData("ac3: missing snr offsets in block 0")

        # fast gain (E-AC-3 only)
        if self.fast_gain_syntax and br.read(1):
            for ch in chans:
                prev = self.fast_gain.get(ch)
                self.fast_gain[ch] = T.FAST_GAIN_TAB[br.read(3)]
                if blk and prev != self.fast_gain[ch]:
                    stages[ch] = max(stages.get(ch, 0), 2)
        elif eac3 and blk == 0:
            for ch in chans:
                self.fast_gain[ch] = T.FAST_GAIN_TAB[4]

        # E-AC-3 to AC-3 converter SNR offset
        if self.strmtyp == 0 and br.read(1):
            br.read(10)

        if self.cpl_in_use:                      # coupling leak
            if self.first_cpl_leak or br.read(1):
                fl = br.read(3)
                sl = br.read(3)
                if blk and (fl != self.ba["cplfl"]
                            or sl != self.ba["cplsl"]):
                    stages[CPL] = max(stages.get(CPL, 0), 2)
                self.ba["cplfl"] = fl
                self.ba["cplsl"] = sl
            elif not eac3 and blk == 0:
                raise InvalidData("ac3: missing coupling leak info")
            self.first_cpl_leak = False

        if self.dba_syntax and br.read(1):       # deltbaie
            for ch in chans:
                if ch == self.lfe_ch:
                    continue
                self.dba_mode[ch] = br.read(2)
                if self.dba_mode[ch] == 3:
                    raise InvalidData("ac3: reserved dba strategy")
                stages[ch] = max(stages.get(ch, 0), 2)
            for ch in chans:
                if ch == self.lfe_ch:
                    continue
                if self.dba_mode[ch] == 2:       # NEW
                    nseg = br.read(3) + 1
                    segs = []
                    for _ in range(nseg):
                        segs.append((br.read(5), br.read(4), br.read(3)))
                    self.dba[ch] = segs
        elif blk == 0:
            for ch in chans:
                self.dba_mode[ch] = 0

        # bit allocation computation
        for ch in chans:
            stage = stages.get(ch, 0)
            if stage > 2:
                self._calc_psd(ch)
            if stage > 1:
                self._calc_mask(ch)
            if stage > 0:
                self._calc_bap(ch)

        if self.skip_syntax and br.read(1):      # skiple
            skipl = br.read(9)
            for _ in range(skipl):
                br.read(8)

        # mantissas — the bitstream read order is ch1, [cpl after the
        # first coupled channel], ch2, ...; build that segment order
        # and decode every mantissa of the block in one vectorized pass
        coeffs = np.zeros((self.channels + 1, 256), np.float64)
        cplc = np.zeros(256, np.float64)
        order = []
        got_cpl = False
        for ch in range(1, self.channels + 1):
            order.append((ch, coeffs[ch]))
            if ch <= fbw and self.channel_in_cpl[ch] and not got_cpl:
                order.append((CPL, cplc))
                got_cpl = True
        self._decode_mantissas_block(br, order)
        for ch in range(1, self.channels + 1):
            if ch <= fbw and self.channel_in_cpl[ch]:
                # uncouple
                bin0 = st.start_freq[CPL]
                for bnd, size in enumerate(self.cpl_band_sizes):
                    co = self.cpl_coords.get(ch, [0] * 18)[bnd] * 8.0
                    coeffs[ch][bin0:bin0 + size] = \
                        cplc[bin0:bin0 + size] * co
                    if ch == 2 and self.phase_flags[bnd]:
                        coeffs[ch][bin0:bin0 + size] *= -1.0
                    bin0 += size
                # zero bap-0 coupled bins for non-dithered channels
                if not self.dither_flag[ch]:
                    bap = st.bap[CPL]
                    sl = slice(st.start_freq[CPL], st.end_freq[CPL])
                    coeffs[ch][sl][bap[sl] == 0] = 0.0

        # rematrixing
        if self.acmod == 2:
            end = min(st.end_freq[1], st.end_freq[2])
            for bnd in range(self.num_rematrixing_bands):
                if self.rematrixing_flags[bnd]:
                    b0 = REMATRIX_BANDS[bnd]
                    b1 = min(end, REMATRIX_BANDS[bnd + 1])
                    t0 = coeffs[1][b0:b1].copy()
                    coeffs[1][b0:b1] = t0 + coeffs[2][b0:b1]
                    coeffs[2][b0:b1] = t0 - coeffs[2][b0:b1]

        # IMDCT + window + overlap-add
        return self._imdct_blocks(coeffs)

    # ------------------------------------------------------------------
    def _decode_exponents(self, br, strat, ngrps, absexp, dexps, j):
        gsize = strat + (1 if strat == 3 else 0)
        prev = absexp
        for _ in range(ngrps):
            expacc = br.read(7)
            if expacc >= 125:
                raise InvalidData("ac3: expacc out of range")
            for d in _UNGROUP5[expacc]:
                prev += int(d) - 2
                if not 0 <= prev <= 24:
                    raise InvalidData("ac3: exponent out of range")
                for _ in range(gsize):
                    dexps[j] = prev
                    j += 1

    def _calc_psd(self, ch):
        st = self.st
        start, end = st.start_freq[ch], st.end_freq[ch]
        psd = st.psd.setdefault(ch, np.zeros(256, np.int32))
        band_psd = st.band_psd.setdefault(ch, np.zeros(50, np.int32))
        calc_psd(start, end, st.dexps[ch], psd, band_psd)

    def _calc_mask(self, ch):
        st = self.st
        mask = st.mask.setdefault(ch, np.zeros(50, np.int32))
        calc_mask(st.start_freq[ch], st.end_freq[ch], st.band_psd[ch],
                  mask, self.fast_gain[ch], self.ba, self.sr_code,
                  self.sr_shift, is_lfe=ch == self.lfe_ch)
        if self.dba_mode.get(ch, 0) in (1, 2) and ch in self.dba:
            band = T.BIN_TO_BAND_TAB[self.st.start_freq[ch]]
            for off, length, val in self.dba[ch]:
                band += off
                delta = (val - 3) * 128 if val >= 4 else (val - 4) * 128
                for _ in range(length):
                    if band >= 50:
                        raise InvalidData("ac3: dba band overflow")
                    mask[band] += delta
                    band += 1

    def _calc_bap(self, ch):
        st = self.st
        bap = st.bap.setdefault(ch, np.zeros(256, np.uint8))
        calc_bap(st.start_freq[ch], st.end_freq[ch], st.psd[ch],
                 st.mask[ch], self.snr_offset[ch], self.ba["fl"], bap)

    def _decode_mantissas_block(self, br, order):
        """Decode every mantissa of one block in one vectorized pass.

        Bit widths are fully determined by the bap sequence in read
        order: grouped baps (1: 3 levels x3 in 5 bits, 2: 5 levels x3
        in 7 bits, 4: 11 levels x2 in 7 bits) consume bits only on the
        first member of each tuple — tuples span channel boundaries and
        leftovers die with the block (7.3.5 semantics, matching the
        reference's grouped-mantissa state) — so per-bin widths follow
        from occurrence counts, offsets are a cumsum, and all values
        extract in parallel from the byte buffer.
        """
        st = self.st
        segs = [(ch, out, st.start_freq[ch], st.end_freq[ch])
                for ch, out in order]
        baps = np.concatenate(
            [st.bap[ch][s:e] for ch, _, s, e in segs]).astype(np.int64)
        nb = len(baps)
        if nb == 0:
            return
        width = _BAP_BITS[baps]
        lead = {}
        for b, gsz, w in ((1, 3, 5), (2, 3, 7), (4, 2, 7)):
            isb = baps == b
            occ = np.cumsum(isb) - 1
            ld = isb & (occ % gsz == 0)
            width[ld] = w
            lead[b] = (np.flatnonzero(isb), ld)
        off = br.pos + np.concatenate(
            ([0], np.cumsum(width[:-1], dtype=np.int64)))
        total = int(width.sum())
        if br.pos + total > len(br.data) * 8:
            raise InvalidData("ac3: mantissa overrun")
        cache = getattr(self, "_mantbuf", None)
        if cache is None or cache[0] is not br.data:
            buf = np.frombuffer(br.data, np.uint8).astype(np.int64)
            buf = np.concatenate([buf, np.zeros(3, np.int64)])
            self._mantbuf = cache = (br.data, buf)
        buf = cache[1]
        b0 = off >> 3
        win = (buf[b0] << 16) | (buf[b0 + 1] << 8) | buf[b0 + 2]
        raw = (win >> (24 - (off & 7) - width)) & ((1 << width) - 1)
        # symmetric quantizers reconstruct at 2*(code-L/2)/L (A/52
        # Table 7.17: bap-1 levels are +-2/3), matching the reference's
        # Q24 convention where asymmetric full scale is +-0.5 -- on our
        # +-1 mantissa scale both families need the same 2x
        vals = np.zeros(nb, np.float64)
        for b, tab, lev in ((1, _UNGROUP3, 3), (2, _UNGROUP5, 5),
                            (4, _UNGROUP11, 11)):
            occ, ld = lead[b]
            if not len(occ):
                continue
            gsz = tab.shape[1]
            codes = np.minimum(raw[occ[::gsz]], len(tab) - 1)
            k = np.arange(len(occ))
            vals[occ] = (tab[codes[k // gsz], k % gsz]
                         - (lev >> 1)) * 2.0 / lev
        m3 = baps == 3
        vals[m3] = (raw[m3] - 3) * 2.0 / 7.0
        m5 = baps == 5
        vals[m5] = (raw[m5] - 7) * 2.0 / 15.0
        hi = baps >= 6
        if hi.any():
            qb = _QUANT_BITS_ARR[baps[hi]]
            v = raw[hi]
            v = v - (v >> (qb - 1)) * (1 << qb)   # two's complement
            vals[hi] = v / (1 << qb) * 2.0
        # ac3dec.c's dither: each bap-0 mantissa of the coupling channel
        # and of a channel whose dithflag is set (never the LFE) takes
        # ((lfg >> 8) * 181 >> 8) - 5931008 in Q23, drawn in read order
        dith = baps == 0
        if dith.any():
            dith &= np.repeat(
                [ch == 0 or (ch != self.lfe_ch and bool(self.dither_flag[ch]))
                 for ch, _, _, _ in segs], [e - s for _, _, s, e in segs])
            k = int(dith.sum())
            if k:
                r = self._lfg.get(k).astype(np.int64)
                vals[dith] = ((((r >> 8) * 181) >> 8) - 5931008) / 2.0 ** 23
        br.pos += total
        pos = 0
        for ch, out, s, e in segs:
            n = e - s
            out[s:e] = vals[pos:pos + n] * \
                np.exp2(-st.dexps[ch][s:e].astype(np.float64))
            pos += n

    # ------------------------------------------------------------------
    def _imdct_blocks(self, coeffs) -> np.ndarray:
        # host numpy matmuls on purpose: the transforms are 256-point
        # per block and a per-block device dispatch costs more than the
        # whole math (this decode path is host-side entropy anyway)
        from librempeg_tpu_torch.ops import tx

        if self._window is None:
            w = np.asarray(tx.kbd_window(256, 5.0))
            self._window = np.concatenate([w, w[::-1]])
            self._inv256 = tx._mdct_inv_basis(256).T.copy()
            self._inv128 = tx._mdct_inv_basis(128).T.copy()
        spec = coeffs[1:self.channels + 1] * self.dynrng
        segs = spec @ self._inv256                # [nch, 512]
        for ch in range(1, min(self.fbw, self.channels) + 1):
            if self.block_switch[ch]:
                # blksw: two 128-coefficient transforms (even/odd)
                t1 = spec[ch - 1, 0::2] @ self._inv128
                t2 = spec[ch - 1, 1::2] @ self._inv128
                segs[ch - 1] = np.concatenate([t1, t2])
        segs *= self._window[None]
        out = np.zeros((self.channels, 256), np.float64)
        for ch in range(1, self.channels + 1):
            prev = self.st.delay.get(ch, np.zeros(256))
            out[ch - 1] = (prev + segs[ch - 1, :256]) * \
                (OUTPUT_GAIN / 2.0)
            self.st.delay[ch] = segs[ch - 1, 256:].copy()
        return out


@register_decoder
class Ac3Decoder(Decoder):
    INFO = CodecInfo(name="ac3", long_name="ATSC A/52 (AC-3 / E-AC-3)",
                     codec_type="audio")
    ALIASES = ("eac3",)
    #: the sample format of the frames it returns
    sample_fmt = "fltp"

    def __init__(self, params=None, device="cuda", **opts):
        self.device = resolve(device)
        self._dec = Ac3FrameDecoder()
        self._pts = 0
        # container-declared encoder priming (mkv CodecDelay ->
        # skip_samples side-data role)
        self._skip = 0
        if params is not None:
            self._skip = int(params.extra.get("skip_samples", 0))
        super().__init__(params, **opts)

    def decode(self, pkt: Packet):
        from librempeg_tpu_torch.formats.ac3 import _frame_info

        data = bytes(pkt.data)
        frames = []
        pos = 0
        while pos + 8 <= len(data):
            info = _frame_info(data, pos)
            if info is None:
                pos += 1
                continue
            size, _, layout, _, samples = info
            chunk = data[pos:pos + size]
            if len(chunk) < size:
                break
            pcm = self._dec.decode_frame(chunk)
            drop = 0
            if self._skip:
                drop = min(self._skip, pcm.shape[1])
                self._skip -= drop
                pcm = pcm[:, drop:]
                if not pcm.shape[1]:
                    pos += size
                    continue
            pts = pkt.pts if pkt.pts != NOPTS and not frames \
                else self._pts
            # trimmed priming samples shift presentation forward: the
            # first decodable sample of this frame is `drop` samples
            # after the packet's nominal timestamp (the reference
            # subtracts the CodecDelay from track timestamps instead;
            # same presentation either way)
            if drop and pts != NOPTS:
                pts += drop
            f = AudioFrame(
                data=torch.from_numpy(np.ascontiguousarray(pcm))
                .to(self.device), sample_rate=self._dec.sample_rate,
                sample_fmt="fltp",
                layout=layout, pts=pts,
                time_base=Rational(1, self._dec.sample_rate))
            self._pts = (f.pts if f.pts != NOPTS else self._pts) \
                + pcm.shape[1]
            frames.append(f)
            pos += size
        return frames
