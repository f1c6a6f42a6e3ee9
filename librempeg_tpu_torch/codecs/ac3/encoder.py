"""AC-3 (ATSC A/52) encoder: MDCT, exponent strategy/coding, the
normative shared bit-allocation loop with CBR SNR-offset search,
grouped mantissa quantization, CRC-stamped syncframes.

Behavioral reference: libavcodec/ac3enc.c +
ac3enc_template.c (structure only — exponent smoothing, strategy runs,
SNR-offset bisection); the bit-allocation core (decoder.calc_psd/
calc_mask/calc_bap) is shared with the decoder as A/52 §7.2.2 requires.
Validated by round-trips through BOTH our decoder and the reference
decoder (SNR gates), and size/quality parity vs the reference encoder.

The encoder fetches each frame once from the device it lies on.

A copy of librempeg_tpu/codecs/ac3/encoder.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.codecs.ac3 import tables_data as T
from librempeg_tpu_torch.codecs.ac3.decoder import calc_bap, calc_mask, calc_psd
from librempeg_tpu_torch.codecs.api import CodecInfo, Encoder, register_encoder
from librempeg_tpu_torch.codecs.flac.bitio import BitWriterMSB
from librempeg_tpu_torch.core.errors import Unsupported
from librempeg_tpu_torch.core.packet import Packet
from librempeg_tpu_torch.core.rational import Rational

SAMPLE_RATES = (48000, 44100, 32000)
BITRATES = (32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
            320, 384, 448, 512, 576, 640)
# channels -> acmod (mono=1, stereo=2, 3.0=3, 4.0=6? keep L/R layouts)
ACMOD_FOR_CHANNELS = {1: 1, 2: 2}
QUANT_BITS = (0, 0, 0, 3, 0, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16)
# default bandwidth code per [fbw_channels-1][sr_code][bitrate index]
# (ac3enc.c:206 tuning; end_freq = code*3 + 73)
BANDWIDTH_TAB = (
    ((0, 0, 0, 12, 16, 32, 48, 48, 48, 48, 48, 48, 48, 48, 48, 48,
      48, 48, 48),
     (0, 0, 0, 16, 20, 36, 56, 56, 56, 56, 56, 56, 56, 56, 56, 56,
      56, 56, 56),
     (0, 0, 0, 32, 40, 60, 60, 60, 60, 60, 60, 60, 60, 60, 60, 60,
      60, 60, 60)),
    ((0, 0, 0, 0, 0, 0, 0, 20, 24, 32, 48, 48, 48, 48, 48, 48, 48,
      48, 48),
     (0, 0, 0, 0, 0, 0, 4, 24, 28, 36, 56, 56, 56, 56, 56, 56, 56,
      56, 56),
     (0, 0, 0, 0, 0, 0, 20, 44, 52, 60, 60, 60, 60, 60, 60, 60, 60,
      60, 60)),
)

_CRC16_POLY = 0x8005


def _crc16(data: bytes, init: int = 0) -> int:
    """CRC-16/ANSI as av_crc uses it (bit-reversed table algorithm,
    then the caller byte-swaps)."""
    crc = init
    for byte in data:
        crc ^= byte
        for _ in range(8):
            if crc & 1:
                crc = (crc >> 1) ^ 0xA001    # reflected 0x8005
            else:
                crc >>= 1
    return crc


def _solve_crc1(frame: bytearray, size58: int) -> int:
    """crc1 value making CRC over frame[2:size58] zero (A/52 §5.4.1.2;
    linearity in GF(2) -> solve a 16x16 system on the crc1 bits)."""
    base = _crc16(bytes(frame[2:size58]))
    cols = []
    n = size58 - 2
    for bit in range(16):
        probe = bytearray(n)
        if bit < 8:
            probe[1] = 1 << bit
        else:
            probe[0] = 1 << (bit - 8)
        cols.append(_crc16(bytes(probe)))
    # gaussian elimination over GF(2): find x with sum(cols[i]*x_i)=base
    rows = list(cols)
    x = [0] * 16
    pivots = []
    aug = [(rows[i], 1 << i) for i in range(16)]
    for bit in range(16):
        piv = None
        for i, (v, _) in enumerate(aug):
            if (v >> bit) & 1 and all(p != i for p in pivots):
                piv = i
                break
        if piv is None:
            continue
        pivots.append(piv)
        for i in range(16):
            if i != piv and (aug[i][0] >> bit) & 1:
                aug[i] = (aug[i][0] ^ aug[piv][0],
                          aug[i][1] ^ aug[piv][1])
    sol = 0
    rem = base
    for i in pivots:
        v, mask = aug[i]
        bit = (v & -v).bit_length() - 1
        if (rem >> bit) & 1:
            sol ^= mask
            rem ^= v
    if rem != 0:
        raise AssertionError("ac3: crc1 system unsolvable")
    return sol


@register_encoder
class Ac3Encoder(Encoder):
    INFO = CodecInfo(name="ac3", long_name="ATSC A/52A (AC-3)",
                     codec_type="audio")
    SAMPLE_FMTS = ("fltp",)
    OPTIONS = {"bit_rate": True, "b": True}

    def __init__(self, sample_rate=48000, channels=2, bit_rate=0,
                 device=None, **opts):
        # `device` is the chain's; each frame is fetched from its own
        if sample_rate not in SAMPLE_RATES:
            raise Unsupported(f"ac3: sample rate {sample_rate}")
        if channels not in ACMOD_FOR_CHANNELS:
            raise Unsupported(f"ac3: {channels} channels")
        self.sample_rate = sample_rate
        self.channels = channels
        self.acmod = ACMOD_FOR_CHANNELS[channels]
        if not bit_rate:
            bit_rate = 96000 * channels
        kbps = min(BITRATES, key=lambda b: abs(b * 1000 - bit_rate))
        self.frmsizecod = 2 * BITRATES.index(kbps)
        self.fscod = SAMPLE_RATES.index(sample_rate)
        self.frame_size = T.FRAME_SIZE_TAB[self.frmsizecod][
            self.fscod] * 2
        self.bit_rate = kbps * 1000
        # sr_code row order in the tab is 48k, 44.1k, 32k (= fscod)
        bw_code = BANDWIDTH_TAB[channels - 1][self.fscod][
            BITRATES.index(kbps)]
        if bw_code == 0:
            raise Unsupported(
                f"ac3: bitrate {kbps}k too low for {channels} ch")
        self.end_freq = bw_code * 3 + 73
        self._pend = np.zeros((channels, 0), np.float32)
        self._hist = np.zeros((channels, 256), np.float64)
        self._pts = 0
        from librempeg_tpu_torch.ops import tx

        w = np.asarray(tx.kbd_window(256, 5.0))
        self._window = np.concatenate([w, w[::-1]])
        self._fwd = np.asarray(tx._mdct_fwd_basis(256)).T.copy()
        # decoder gain convention (decoder.py OUTPUT_GAIN): coeffs are
        # scaled so that imdct+window+OLA times (G/2) reproduces input
        self._coef_scale = 1.0 / -256.0

    # ------------------------------------------------------------- API
    def codec_parameters(self):
        from librempeg_tpu_torch.formats.api import CodecParameters

        return CodecParameters(
            codec_type="audio", codec_id="ac3",
            sample_rate=self.sample_rate, nb_channels=self.channels,
            bit_rate=self.bit_rate, frame_size=1536)

    def encode(self, frame):
        from librempeg_tpu_torch.codecs.pcm import to_float

        x = frame.data
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = to_float(x, frame.sample_fmt).cpu().numpy()
        if x.ndim == 1:
            x = x[None]
        self._pend = np.concatenate([self._pend, x], axis=1)
        out = []
        while self._pend.shape[1] >= 1536:
            blk = self._pend[:, :1536]
            self._pend = self._pend[:, 1536:]
            out.append(self._encode_frame(blk))
        return out

    def flush(self):
        out = []
        if self._pend.shape[1]:
            pad = 1536 - self._pend.shape[1]
            out.append(self._encode_frame(
                np.pad(self._pend, ((0, 0), (0, pad)))))
            self._pend = np.zeros((self.channels, 0), np.float32)
        return out

    def packets(self, frames):
        for f in frames:
            yield from self.encode(f)
        yield from self.flush()

    # ------------------------------------------------------ transforms
    def _mdct6(self, pcm: np.ndarray) -> np.ndarray:
        """[ch, 1536] -> [6, ch, 256] coefficients."""
        nch = self.channels
        buf = np.concatenate([self._hist, pcm.astype(np.float64)],
                             axis=1)
        self._hist = buf[:, 1536:].copy()
        coefs = np.zeros((6, nch, 256))
        for b in range(6):
            seg = buf[:, 256 * b:256 * b + 512] * self._window[None]
            coefs[b] = (seg @ self._fwd) * self._coef_scale
        return coefs

    # ------------------------------------------------------- exponents
    @staticmethod
    def _exp_max(c: np.ndarray) -> np.ndarray:
        """Largest legal exponent per bin: |c|*2^e < 1, e in [0,24]."""
        a = np.abs(c)
        with np.errstate(divide="ignore"):
            e = np.floor(-np.log2(np.maximum(a, 1e-30)) - 1e-9)
        return np.clip(e, 0, 24).astype(np.int32)

    def _exp_strategies(self, emax: np.ndarray):
        """Per-block strategy (0=reuse, 1=D15, 2=D25, 3=D45) and the
        shared exponent set per run (min over blocks, smoothed)."""
        strats = [1] * 6
        for b in range(1, 6):
            diff = np.abs(emax[b] - emax[b - 1]).sum()
            strats[b] = 0 if diff <= 500 else 1   # EXP_DIFF_THRESHOLD
        # choose coding grain by run length (ac3enc.c strategy rule)
        runs = []
        b = 0
        while b < 6:
            e = b + 1
            while e < 6 and strats[e] == 0:
                e += 1
            runs.append((b, e))
            b = e
        for s, e in runs:
            n = e - s
            strats[s] = 3 if n == 1 else (2 if n <= 3 else 1)
        return strats, runs

    def _encode_exps(self, emax: np.ndarray, strat: int) -> np.ndarray:
        """Legal exponent track: grouped (gsize), delta in [-2,2],
        first exponent <= 15; only ever lowers emax (safe)."""
        end = self.end_freq
        gsize = strat + (1 if strat == 3 else 0)
        e = emax[:end].copy()
        e[0] = min(e[0], 15)
        ngrps = (end + 3 * gsize - 4) // (3 * gsize)
        # group values: min over members (bins 1..) so |m|<1 holds
        n_in = 1 + ngrps * 3 * gsize
        pad = np.full(n_in - end, 24, np.int32)
        full = np.concatenate([e, pad])
        grp = full[1:].reshape(ngrps * 3, gsize).min(axis=1)
        track = np.concatenate([[full[0]], grp]).astype(np.int32)
        # delta limit +-2 in both directions (backward then forward)
        for i in range(len(track) - 2, -1, -1):
            track[i] = min(track[i], track[i + 1] + 2)
        track[0] = min(track[0], 15)
        for i in range(1, len(track)):
            track[i] = min(track[i], track[i - 1] + 2)
        dexps = np.zeros(256, np.int32)
        dexps[0] = track[0]
        reps = np.repeat(track[1:], gsize)
        dexps[1:1 + len(reps)] = reps
        return dexps, track, ngrps

    # -------------------------------------------------------- mantissas
    @staticmethod
    def _quantize(c, exp, bap):
        """Mantissa code per bin for its bap (A/52 §7.3.3)."""
        m = c * np.exp2(exp.astype(np.float64))
        if bap == 0:
            return 0
        # symmetric quantizers reconstruct 2*(code - L/2)/L
        if bap in (1, 2, 4):
            levels = (0, 3, 5, 0, 11)[bap]
            v = int(np.round(m * levels / 2.0)) + (levels >> 1)
            return max(0, min(levels - 1, v))
        if bap == 3:
            v = int(np.round(m * 7 / 2.0)) + 3
            return max(0, min(6, v))
        if bap == 5:
            v = int(np.round(m * 15 / 2.0)) + 7
            return max(0, min(14, v))
        qb = QUANT_BITS[bap]
        v = int(np.round(m * (1 << (qb - 1))))
        v = max(-(1 << (qb - 1)), min((1 << (qb - 1)) - 1, v))
        return v & ((1 << qb) - 1)

    # ----------------------------------------------------------- frame
    def _encode_frame(self, pcm: np.ndarray) -> Packet:
        nch = self.channels
        end = self.end_freq
        coefs = self._mdct6(pcm)                 # [6, ch, 256]
        # exponents per channel
        ch_strats = []
        ch_dexps = []                            # [6][ch] arrays
        ch_tracks = {}
        ch_ngrps = {}
        for ch in range(nch):
            emax = self._exp_max(coefs[:, ch, :])
            strats, runs = self._exp_strategies(emax)
            dexps_blocks = [None] * 6
            for s, e in runs:
                run_emax = emax[s:e].min(axis=0)
                dexps, track, ngrps = self._encode_exps(
                    run_emax, strats[s])
                for b in range(s, e):
                    dexps_blocks[b] = dexps
                ch_tracks[(s, ch)] = track
                ch_ngrps[(s, ch)] = ngrps
            ch_strats.append(strats)
            ch_dexps.append(dexps_blocks)

        # psd per (block, ch) — identical within a run
        psds = {}
        for ch in range(nch):
            for b in range(6):
                if ch_strats[ch][b] != 0:
                    psd = np.zeros(256, np.int32)
                    bpsd = np.zeros(50, np.int32)
                    calc_psd(0, end, ch_dexps[ch][b], psd, bpsd)
                    psds[(b, ch)] = (psd, bpsd)
                else:
                    psds[(b, ch)] = psds[(b - 1, ch)]

        ba = {"sd": T.SLOW_DECAY_TAB[2], "fd": T.FAST_DECAY_TAB[1],
              "sg": T.SLOW_GAIN_TAB[1], "db": T.DB_PER_BIT_TAB[3],
              "fl": T.FLOOR_TAB[7], "cplfl": 0, "cplsl": 0}
        self._ba_codes = (2, 1, 1, 3, 7)
        fgaincod = 4
        fg = T.FAST_GAIN_TAB[fgaincod]
        masks = {}
        for ch in range(nch):
            for b in range(6):
                if ch_strats[ch][b] != 0:
                    mask = np.zeros(50, np.int32)
                    calc_mask(0, end, psds[(b, ch)][1], mask, fg, ba,
                              self.fscod, 0)
                    masks[(b, ch)] = mask
                else:
                    masks[(b, ch)] = masks[(b - 1, ch)]

        avail = self.frame_size * 8

        def assemble(csnr, fsnrs):
            """Build the whole frame for the SNR offsets; returns
            bytes or None when it doesn't fit."""
            baps = {}
            for ch in range(nch):
                snr = (((csnr - 15) << 4) + fsnrs[ch]) << 2
                for b in range(6):
                    key = (b, ch)
                    if ch_strats[ch][b] != 0 or b == 0:
                        bap = np.zeros(256, np.uint8)
                        calc_bap(0, end, psds[key][0], masks[key],
                                 snr, ba["fl"], bap)
                        baps[key] = bap
                    else:
                        baps[key] = baps[(b - 1, ch)]
            bw = BitWriterMSB()
            bw.write(0x0B77, 16)
            bw.write(0, 16)              # crc1 (stamped later)
            bw.write(self.fscod, 2)
            bw.write(self.frmsizecod, 6)
            bw.write(8, 5)               # bsid
            bw.write(0, 3)               # bsmod
            bw.write(self.acmod, 3)
            if self.acmod == 2:
                bw.write(0, 2)           # dsurmod
            bw.write(0, 1)               # lfeon
            bw.write(31, 5)              # dialnorm
            bw.write(0, 1)               # compre
            bw.write(0, 1)               # langcode
            bw.write(0, 1)               # audprodie
            bw.write(0, 2)               # copyrightb, origbs
            bw.write(0, 1)               # timecod1e
            bw.write(0, 1)               # timecod2e
            bw.write(0, 1)               # addbsie
            for b in range(6):
                self._write_block(bw, b, coefs[b], ch_strats,
                                  ch_dexps, ch_tracks, ch_ngrps,
                                  baps, csnr, fsnrs, fgaincod)
                if bw._n + len(bw._buf) * 8 > avail - 18:
                    return None
            bw.align()
            if len(bw._buf) > self.frame_size - 2:
                return None
            return bytes(bw._buf)

        # SNR offset bisection: largest combined code that still fits,
        # then greedy per-channel fine-offset bumps (ac3enc.c
        # bit_alloc run with snroffst bisection + fine passes)
        lo, hi = 0, 1023
        best = assemble(0, [0] * nch)
        if best is None:
            raise Unsupported("ac3: frame does not fit at zero snr")
        while lo < hi:
            mid = (lo + hi + 1) // 2
            got = assemble(mid >> 4, [mid & 15] * nch)
            if got is not None:
                best, lo = got, mid
            else:
                hi = mid - 1
        csnr = lo >> 4
        fsnrs = [lo & 15] * nch
        improved = True
        while improved:
            improved = False
            for ch in range(nch):
                if fsnrs[ch] < 15:
                    trial = list(fsnrs)
                    trial[ch] += 1
                    got = assemble(csnr, trial)
                    if got is not None:
                        best, fsnrs = got, trial
                        improved = True
        frame = bytearray(self.frame_size)
        frame[:len(best)] = best
        # CRCs (ac3enc.c output_frame_end)
        size58 = ((self.frame_size >> 2) + (self.frame_size >> 4)) << 1
        crc1 = _solve_crc1(frame, size58)
        frame[2] = crc1 >> 8
        frame[3] = crc1 & 0xFF
        crc2 = _crc16(bytes(frame[size58:self.frame_size - 2]))
        crc2 = ((crc2 & 0xFF) << 8) | (crc2 >> 8)
        if crc2 == 0x0B77:
            frame[self.frame_size - 3] ^= 0x1
            crc2 ^= 0x8005
        frame[-2] = crc2 >> 8
        frame[-1] = crc2 & 0xFF
        pkt = Packet(data=bytes(frame), pts=self._pts, dts=self._pts,
                     duration=1536,
                     time_base=Rational(1, self.sample_rate))
        self._pts += 1536
        return pkt

    def _write_block(self, bw, blk, coefs, ch_strats, ch_dexps,
                     ch_tracks, ch_ngrps, baps, csnr, fsnrs, fgaincod):
        nch = self.channels
        end = self.end_freq
        for _ in range(nch):
            bw.write(0, 1)               # blksw
        for _ in range(nch):
            bw.write(0, 1)               # dithflag
        for _ in range(2 if self.acmod == 0 else 1):
            bw.write(0, 1)               # dynrnge
        if blk == 0:
            bw.write(1, 1)               # cplstre
            bw.write(0, 1)               # cplinu
        else:
            bw.write(0, 1)
        if self.acmod == 2:
            if blk == 0:
                bw.write(1, 1)           # rematstr
                for _ in range(4):
                    bw.write(0, 1)       # rematflg
            else:
                bw.write(0, 1)
        for ch in range(nch):            # exponent strategies
            bw.write(ch_strats[ch][blk], 2)
        for ch in range(nch):            # bandwidth codes
            if ch_strats[ch][blk] != 0:
                bw.write((end - 73) // 3, 6)
        for ch in range(nch):            # exponents
            strat = ch_strats[ch][blk]
            if strat == 0:
                continue
            track = ch_tracks[(blk, ch)]
            ngrps = ch_ngrps[(blk, ch)]
            bw.write(int(track[0]), 4)
            prev = int(track[0])
            gi = 1
            for _ in range(ngrps):
                acc = 0
                for k in range(3):
                    d = int(track[gi]) - prev + 2
                    assert 0 <= d <= 4
                    prev = int(track[gi])
                    acc = acc * 5 + d
                    gi += 1
                bw.write(acc, 7)
            bw.write(0, 2)               # gainrng
        if blk == 0:
            bw.write(1, 1)               # baie
            sd, fd, sg, db, fl = self._ba_codes
            bw.write(sd, 2)
            bw.write(fd, 2)
            bw.write(sg, 2)
            bw.write(db, 2)
            bw.write(fl, 3)
        else:
            bw.write(0, 1)
        if blk == 0:
            bw.write(1, 1)               # snroffste
            bw.write(csnr, 6)
            for ch in range(nch):
                bw.write(fsnrs[ch], 4)
                bw.write(fgaincod, 3)
        else:
            bw.write(0, 1)
        bw.write(0, 1)                   # deltbaie
        bw.write(0, 1)                   # skiple
        # mantissas, channel order. Grouped baps (1/2/4) put the whole
        # group code at the FIRST member's stream position (the later
        # members consume no bits); groups span channels and die at
        # block end (§7.3.5) — so collect codes first, then emit.
        seq = []                         # (bap, code) in stream order
        for ch in range(nch):
            bap = baps[(blk, ch)]
            dexps = ch_dexps[ch][blk]
            c = coefs[ch]
            for i in range(end):
                b = int(bap[i])
                if b:
                    seq.append((b, self._quantize(
                        float(c[i]), dexps[i], b)))
        grouped = {1: [], 2: [], 4: []}  # member indices into seq
        for idx, (b, _) in enumerate(seq):
            if b in grouped:
                grouped[b].append(idx)
        emit = {}                        # seq idx -> (value, width)
        for b, gsz, width in ((1, 3, 5), (2, 3, 7), (4, 2, 7)):
            base = (0, 3, 5, 0, 11)[b]
            mem = grouped[b]
            for g0 in range(0, len(mem), gsz):
                grp = mem[g0:g0 + gsz]
                acc = 0
                for k in range(gsz):
                    acc = acc * base + (seq[grp[k]][1]
                                        if k < len(grp) else 0)
                emit[grp[0]] = (acc, width)
        for idx, (b, code) in enumerate(seq):
            if b in grouped:
                if idx in emit:
                    bw.write(*emit[idx])
            else:
                bw.write(code, QUANT_BITS[b])
