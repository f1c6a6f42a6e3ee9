"""Opus CELT layer decoder (RFC 6716 §4.3).

Host entropy (range-coded symbols + backwards raw bits) drives the
band-energy / bit-allocation / PVQ machinery; synthesis (IMDCT,
low-overlap windowing, postfilter, deemphasis) runs as vectorized
numpy over whole frames -- the same split the framework's other audio
decoders use (serial bit work on host, transforms as arrays).

Behavioral reference: libavcodec/opus/dec_celt.c, celt.c (bit
allocation), pvq.c (band quantization/folding). Reimplemented from
those semantics; the IMDCT convention (out[n] = scale * sum_k X[k] *
(-1)^k sin(pi/B (n+1/2)(k+1/2)), scale = -1/32768) was verified
numerically against the reference's av_tx.

A copy of librempeg_tpu/codecs/opus/celt.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

import math

import numpy as np

from librempeg_tpu_torch.codecs.opus import tables_data as T
from librempeg_tpu_torch.codecs.opus.rc import RangeDecoder

MAX_BANDS = 21


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero; Python // floors --
    the difference matters wherever the bit-budget bookkeeping goes
    negative, i.e. exactly the low-bitrate paths)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q
SHORT_BLOCKSIZE = 120
OVERLAP = 120
MAX_FRAME_SIZE = 960
MAX_FINE_BITS = 8
VECTORS = 11
ALLOC_STEPS = 6
FINE_OFFSET = 21
QTHETA_OFFSET = 4
QTHETA_OFFSET_TWOPHASE = 16
POSTFILTER_MINPERIOD = 15
ENERGY_SILENCE = -28.0
SPREAD_NONE = 0
SPREAD_NORMAL = 2
SPREAD_AGGRESSIVE = 3
EMPH_COEFF = 0.8500061035

_FREQ_BANDS = np.array(T.FREQ_BANDS, np.int32)
_FREQ_RANGE = np.array(T.FREQ_RANGE, np.int32)
_LOG_FREQ_RANGE = np.array(T.LOG_FREQ_RANGE, np.int32)
_WINDOW = np.array(T.WINDOW_PADDED[8:8 + OVERLAP], np.float32)
_WINDOW2 = np.array(T.WINDOW2, np.float32)
_PVQ_U = T.PVQ_U
_PVQ_U_ROW = T.PVQ_U_ROW

# IMDCT basis matrices per block size (cached)
_IMDCT = {}


def _imdct_mat(B: int) -> np.ndarray:
    m = _IMDCT.get(B)
    if m is None:
        n = np.arange(B)[:, None]
        k = np.arange(B)[None, :]
        m = (-1.0 / 32768.0) * ((-1.0) ** k) \
            * np.sin(np.pi / B * (n + 0.5) * (k + 0.5))
        _IMDCT[B] = m = m.astype(np.float64)
    return m


def pvq_u(n: int, k: int) -> int:
    lo, hi = min(n, k), max(n, k)
    return _PVQ_U[_PVQ_U_ROW[lo] + hi]


def pvq_v(n: int, k: int) -> int:
    return pvq_u(n, k) + pvq_u(n, k + 1)


def _cwrsi(N: int, K: int, i: int):
    """PVQ index -> pulse vector (pvq.c celt_cwrsi); returns (y, norm)."""
    y = []
    norm = 0
    while N > 2:
        if K >= N:
            p = pvq_u(N, K + 1)
            s = -1 if i >= p else 0
            if s:
                i -= p
            k0 = K
            q = pvq_u(N, N)
            if q > i:
                K = N
                while True:
                    K -= 1
                    p = pvq_u(K, N)
                    if p <= i:
                        break
            else:
                while True:
                    p = pvq_u(K, N)
                    if p <= i:
                        break
                    K -= 1
            i -= p
            val = (k0 - K + s) ^ s
            norm += val * val
            y.append(val)
        else:
            p = pvq_u(K, N)
            q = pvq_u(K + 1, N)
            if p <= i < q:
                i -= p
                y.append(0)
            else:
                s = -1 if i >= q else 0
                if s:
                    i -= q
                k0 = K
                while True:
                    K -= 1
                    p = pvq_u(K, N)
                    if p <= i:
                        break
                i -= p
                val = (k0 - K + s) ^ s
                norm += val * val
                y.append(val)
        N -= 1
    # N == 2
    p = 2 * K + 1
    s = -1 if i >= p else 0
    if s:
        i -= p
    k0 = K
    K = (i + 1) // 2
    if K:
        i -= 2 * K - 1
    val = (k0 - K + s) ^ s
    norm += val * val
    y.append(val)
    # N == 1
    s = -i
    val = (K + s) ^ s
    norm += val * val
    y.append(val)
    return np.array(y, np.int64), norm


def _bits2pulses(cache, off, bits):
    low, high = 0, cache[off]
    bits -= 1
    for _ in range(6):
        center = (low + high + 1) >> 1
        if cache[off + center] >= bits:
            high = center
        else:
            low = center
    lowv = -1 if low == 0 else cache[off + low]
    return low if (bits - lowv <= cache[off + high] - bits) else high


def _pulses2bits(cache, off, pulses):
    return 0 if pulses == 0 else cache[off + pulses] + 1


def _haar1(X, N0, stride):
    N0 >>= 1
    for i in range(stride):
        idx0 = stride * (2 * np.arange(N0)) + i
        idx1 = stride * (2 * np.arange(N0) + 1) + i
        x0 = X[idx0].copy()
        x1 = X[idx1].copy()
        X[idx0] = (x0 + x1) * math.sqrt(0.5)
        X[idx1] = (x0 - x1) * math.sqrt(0.5)


def _interleave_hadamard(X, N0, stride, hadamard):
    order = T.HADAMARD_ORDER[stride - 2:] if hadamard \
        else T.HADAMARD_ORDER[30:]
    tmp = np.empty(N0 * stride, X.dtype)
    for i in range(stride):
        tmp[np.arange(N0) * stride + i] = X[order[i] * N0:
                                            order[i] * N0 + N0]
    X[:N0 * stride] = tmp


def _deinterleave_hadamard(X, N0, stride, hadamard):
    order = T.HADAMARD_ORDER[stride - 2:] if hadamard \
        else T.HADAMARD_ORDER[30:]
    tmp = np.empty(N0 * stride, X.dtype)
    for i in range(stride):
        tmp[order[i] * N0: order[i] * N0 + N0] = \
            X[np.arange(N0) * stride + i]
    X[:N0 * stride] = tmp


def _exp_rotation_impl(X, off, length, stride, c, s):
    for i in range(length - stride):
        x1 = X[off + i]
        x2 = X[off + i + stride]
        X[off + i + stride] = c * x2 + s * x1
        X[off + i] = c * x1 - s * x2
    for i in range(length - 2 * stride - 1, -1, -1):
        x1 = X[off + i]
        x2 = X[off + i + stride]
        X[off + i + stride] = c * x2 + s * x1
        X[off + i] = c * x1 - s * x2


def _exp_rotation(X, length, stride, K, spread):
    if 2 * K >= length or spread == SPREAD_NONE:
        return
    gain = length / (length + (20 - 5 * spread) * K)
    theta = math.pi * gain * gain / 4
    c = np.float32(math.cos(theta))
    s = np.float32(math.sin(theta))
    stride2 = 0
    if length >= stride << 3:
        stride2 = 1
        while (stride2 * stride2 + stride2) * stride + (stride >> 2) \
                < length:
            stride2 += 1
    length //= stride
    for i in range(stride):
        if stride2:
            _exp_rotation_impl(X, i * length, length, stride2, s, c)
        _exp_rotation_impl(X, i * length, length, 1, c, s)


def _extract_collapse_mask(y, N, B):
    if B <= 1:
        return 1
    N0 = N // B
    mask = 0
    for i in range(B):
        if np.any(y[i * N0:(i + 1) * N0]):
            mask |= 1 << i
    return mask


def _renormalize(X, off, N, gain):
    g = 1e-15 + float(np.sum(np.square(
        X[off:off + N].astype(np.float64))))
    g = gain / math.sqrt(g)
    X[off:off + N] *= np.float32(g)


def _celt_cos(x):
    x = ((x * x) + 4096) >> 13

    def round_mul16(a, b):
        return (a * b + 16384) >> 15

    x = (32767 - x) + round_mul16(
        x, -7651 + round_mul16(x, 8277 + round_mul16(-626, x)))
    return x + 1


def _log2tan(isin, icos):
    def round_mul16(a, b):
        return (a * b + 16384) >> 15

    lc = icos.bit_length()
    ls = isin.bit_length()
    icos <<= 15 - lc
    isin <<= 15 - ls
    return ((ls << 11) - (lc << 11)
            + round_mul16(isin, round_mul16(isin, -2597) + 7932)
            - round_mul16(icos, round_mul16(icos, -2597) + 7932))


def _compute_qn(N, b, offset, pulse_cap, stereo):
    N2 = 2 * N - 1
    if stereo and N == 2:
        N2 -= 1
    qb = min(b - pulse_cap - (4 << 3), (b + N2 * offset) // N2, 8 << 3)
    if qb < (1 << 3 >> 1):
        return 1
    return ((T.QN_EXP2[qb & 0x7] >> (14 - (qb >> 3))) + 1) >> 1 << 1


class CeltDecoder:
    """Persistent CELT state for one stream (dec_celt.c CeltFrame)."""

    def __init__(self, output_channels: int, apply_phase_inv=True):
        self.output_channels = output_channels
        self.apply_phase_inv = apply_phase_inv
        self.seed = 0
        # per "block" (channel slot) state
        self.energy = np.zeros((2, MAX_BANDS), np.float32)
        self.prev_energy = np.full((2, 2, MAX_BANDS), ENERGY_SILENCE,
                                   np.float32)
        self.buf = np.zeros((2, 2048), np.float32)
        self.pf_period = [0, 0]
        self.pf_period_old = [0, 0]
        self.pf_period_new = [0, 0]
        self.pf_gains = np.zeros((2, 3), np.float32)
        self.pf_gains_old = np.zeros((2, 3), np.float32)
        self.pf_gains_new = np.zeros((2, 3), np.float32)
        self.emph_coeff = [0.0, 0.0]

    def flush(self):
        """Reset inter-frame state (ff_celt_flush role) — called when
        a packet stream switches away from the CELT layer."""
        if getattr(self, "_flushed", False):
            return
        self.energy[:] = 0
        self.prev_energy[:] = ENERGY_SILENCE
        self.buf[:] = 0
        self.pf_period = [0, 0]
        self.pf_period_old = [0, 0]
        self.pf_period_new = [0, 0]
        self.pf_gains[:] = 0
        self.pf_gains_old[:] = 0
        self.pf_gains_new[:] = 0
        self.emph_coeff = [0.0, 0.0]
        self.seed = 0
        self._flushed = True

    def _rng(self):
        self.seed = (1664525 * self.seed + 1013904223) & 0xFFFFFFFF
        return self.seed

    # ------------------------------------------------------------------
    def decode_frame(self, rc: RangeDecoder, channels: int,
                     frame_size: int, start_band: int, end_band: int
                     ) -> np.ndarray:
        """Decode one CELT frame; returns [output_channels, frame_size]
        float32 PCM at 48 kHz."""
        f = self
        self._flushed = False
        self.channels = channels
        self.start_band = start_band
        self.end_band = end_band
        self.framebits = rc.rb_bytes * 8
        self.silence = 0
        self.anticollapse = 0
        size = (frame_size // SHORT_BLOCKSIZE).bit_length() - 1
        self.size = size
        self.coeffs = np.zeros((2, MAX_FRAME_SIZE), np.float32)
        self.collapse_masks = np.zeros((2, MAX_BANDS), np.int64)

        consumed = rc.tell()
        if consumed >= self.framebits:
            self.silence = 1
        elif consumed == 1:
            self.silence = rc.dec_log(15)
        if self.silence:
            consumed = self.framebits
            rc.total_bits += self.framebits - rc.tell()

        consumed = self._parse_postfilter(rc, consumed)

        self.transient = 0
        if size != 0 and consumed + 3 <= self.framebits:
            self.transient = rc.dec_log(3)
        self.blocks = (1 << size) if self.transient else 1
        self.blocksize = frame_size // self.blocks

        if channels == 1:
            self.energy[0] = np.maximum(self.energy[0], self.energy[1])

        self._decode_coarse_energy(rc)
        self._decode_tf_changes(rc)
        self._bitalloc(rc)
        self._decode_fine_energy(rc)
        self._quant_bands(rc)

        if self.anticollapse_needed:
            self.anticollapse = rc.get_raw(1)

        self._decode_final_energy(rc)

        for ch in range(channels):
            if self.anticollapse:
                self._anticollapse(ch)
            self._denormalize(ch)

        downmix = False
        if self.output_channels < channels:
            self.coeffs[0, :frame_size] += self.coeffs[1, :frame_size]
            downmix = True
        elif self.output_channels > channels:
            self.coeffs[1] = self.coeffs[0]

        if self.silence:
            self.energy[:] = ENERGY_SILENCE
            self.coeffs[:] = 0.0

        out = np.zeros((self.output_channels, frame_size), np.float32)
        B = self.blocksize
        imdct_size = SHORT_BLOCKSIZE if self.transient \
            else SHORT_BLOCKSIZE << size
        mat = _imdct_mat(imdct_size)
        for ch in range(self.output_channels):
            buf = self.buf[ch]
            for j in range(self.blocks):
                dst = 1024 + j * B
                x = self.coeffs[ch, j::self.blocks][:B].astype(np.float64)
                y = (mat @ x).astype(np.float32)
                buf[dst + OVERLAP // 2:dst + OVERLAP // 2 + B] = y
                # lapped low-overlap window against the previous tail
                self._fmul_window(buf, dst)
            if downmix:
                buf[1024:1024 + frame_size] *= 0.5

            self._postfilter(ch, frame_size)

            # deemphasis
            x = buf[1024 - frame_size:1024]
            coeff = self.emph_coeff[ch]
            y = np.empty(frame_size, np.float32)
            c = np.float32(EMPH_COEFF)
            for i in range(frame_size):
                coeff = x[i] + coeff * c
                y[i] = coeff
            out[ch] = y
            if not math.isfinite(coeff) or abs(coeff) > 1e30:
                coeff = 0.0
            self.emph_coeff[ch] = float(coeff)

        if channels == 1:
            self.energy[1] = self.energy[0]

        for ch in range(2):
            if not self.transient:
                self.prev_energy[ch][1] = self.prev_energy[ch][0]
                self.prev_energy[ch][0] = self.energy[ch]
            else:
                self.prev_energy[ch][0] = np.minimum(
                    self.prev_energy[ch][0], self.energy[ch])
            self.prev_energy[ch][0][:start_band] = ENERGY_SILENCE
            self.energy[ch][:start_band] = 0.0
            self.prev_energy[ch][0][end_band:] = ENERGY_SILENCE
            self.energy[ch][end_band:] = 0.0

        self.seed = rc.range & 0xFFFFFFFF
        return out

    # ------------------------------------------------------------------
    def _fmul_window(self, buf, dst):
        """float_dsp vector_fmul_window over the 120-sample lap region
        at buf[dst .. dst+120): combines the previous tail (src0) with
        the new first half (src1 = buf[dst+60:dst+120]) in place."""
        ln = OVERLAP // 2
        s0 = buf[dst:dst + ln].copy()
        s1 = buf[dst + ln:dst + 2 * ln].copy()
        win = _WINDOW
        i = np.arange(ln)
        wi = win[i]
        wj = win[2 * ln - 1 - i]
        buf[dst + i] = s0 * wj - s1[::-1] * wi
        buf[dst + 2 * ln - 1 - i] = s0 * wi + s1[::-1] * wj

    def _postfilter(self, ch, frame_len):
        buf = self.buf[ch]
        self._pf_transition(ch, buf, 1024)
        self.pf_period_old[ch] = self.pf_period[ch]
        self.pf_gains_old[ch] = self.pf_gains[ch]
        self.pf_period[ch] = self.pf_period_new[ch]
        self.pf_gains[ch] = self.pf_gains_new[ch]
        if frame_len > OVERLAP:
            self._pf_transition(ch, buf, 1024 + OVERLAP)
            flen = frame_len - 2 * OVERLAP
            if self.pf_gains[ch][0] > 1e-7 and flen > 0:
                base = 1024 + 2 * OVERLAP
                period = self.pf_period[ch]
                g0, g1, g2 = (float(v) for v in self.pf_gains[ch])
                x4 = buf[base - period - 2]
                x3 = buf[base - period - 1]
                x2 = buf[base - period + 0]
                x1 = buf[base - period + 1]
                for i in range(flen):
                    x0 = buf[base + i - period + 2]
                    buf[base + i] += np.float32(
                        g0 * x2 + g1 * (x1 + x3) + g2 * (x0 + x4))
                    x4, x3, x2, x1 = x3, x2, x1, x0
            self.pf_period_old[ch] = self.pf_period[ch]
            self.pf_gains_old[ch] = self.pf_gains[ch]
        buf[:1024 + OVERLAP // 2] = buf[frame_len:
                                        frame_len + 1024 + OVERLAP // 2]

    def _pf_transition(self, ch, buf, base):
        T0 = self.pf_period_old[ch]
        T1 = self.pf_period[ch]
        if self.pf_gains[ch][0] == 0.0 and \
                self.pf_gains_old[ch][0] == 0.0:
            return
        g00, g01, g02 = (float(v) for v in self.pf_gains_old[ch])
        g10, g11, g12 = (float(v) for v in self.pf_gains[ch])
        x1 = buf[base - T1 + 1]
        x2 = buf[base - T1]
        x3 = buf[base - T1 - 1]
        x4 = buf[base - T1 - 2]
        for i in range(OVERLAP):
            w = float(_WINDOW2[i])
            x0 = buf[base + i - T1 + 2]
            buf[base + i] += np.float32(
                (1.0 - w) * g00 * buf[base + i - T0]
                + (1.0 - w) * g01 * (buf[base + i - T0 - 1]
                                     + buf[base + i - T0 + 1])
                + (1.0 - w) * g02 * (buf[base + i - T0 - 2]
                                     + buf[base + i - T0 + 2])
                + w * g10 * x2 + w * g11 * (x1 + x3)
                + w * g12 * (x0 + x4))
            x4, x3, x2, x1 = x3, x2, x1, x0

    def _parse_postfilter(self, rc, consumed):
        self.pf_gains_new[0][:] = 0
        self.pf_gains_new[1][:] = 0
        if self.start_band == 0 and consumed + 16 <= self.framebits:
            if rc.dec_log(1):
                octave = rc.dec_uint(6)
                period = (16 << octave) + rc.get_raw(4 + octave) - 1
                gain = 0.09375 * (rc.get_raw(3) + 1)
                tapset = rc.dec_cdf(T.MODEL_TAPSET) \
                    if rc.tell() + 2 <= self.framebits else 0
                taps = T.POSTFILTER_TAPS[tapset]
                for ch in range(2):
                    self.pf_period_new[ch] = max(period,
                                                 POSTFILTER_MINPERIOD)
                    self.pf_gains_new[ch] = np.float32(gain) \
                        * np.asarray(taps, np.float32)
            consumed = rc.tell()
        return consumed

    def _decode_coarse_energy(self, rc):
        alpha = T.ALPHA_COEF[self.size]
        beta = T.BETA_COEF[self.size]
        model = T.COARSE_ENERGY_DIST[self.size][0]
        if rc.tell() + 3 <= self.framebits and rc.dec_log(3):
            alpha = 0.0
            beta = 1.0 - 4915.0 / 32768.0
            model = T.COARSE_ENERGY_DIST[self.size][1]
        prev = [0.0, 0.0]
        for i in range(MAX_BANDS):
            for ch in range(self.channels):
                if i < self.start_band or i >= self.end_band:
                    self.energy[ch][i] = 0.0
                    continue
                available = self.framebits - rc.tell()
                if available >= 15:
                    k = min(i, 20) << 1
                    value = float(rc.dec_laplace(model[k] << 7,
                                                 model[k + 1] << 6))
                elif available >= 2:
                    x = rc.dec_cdf(T.MODEL_ENERGY_SMALL)
                    value = float((x >> 1) ^ -(x & 1))
                elif available >= 1:
                    value = -float(rc.dec_log(1))
                else:
                    value = -1.0
                self.energy[ch][i] = max(-9.0, float(
                    self.energy[ch][i])) * alpha + prev[ch] + value
                prev[ch] += beta * value

    def _decode_tf_changes(self, rc):
        self.tf_change = [0] * MAX_BANDS
        diff = 0
        tf_changed = 0
        tf_select = 0
        bits = 2 if self.transient else 4
        consumed = rc.tell()
        tf_select_bit = int(self.size != 0 and
                            consumed + bits + 1 <= self.framebits)
        for i in range(self.start_band, self.end_band):
            if consumed + bits + tf_select_bit <= self.framebits:
                diff ^= rc.dec_log(bits)
                consumed = rc.tell()
                tf_changed |= diff
            self.tf_change[i] = diff
            bits = 4 if self.transient else 5
        ts = T.TF_SELECT[self.size][self.transient]
        if tf_select_bit and ts[0][tf_changed] != ts[1][tf_changed]:
            tf_select = rc.dec_log(1)
        for i in range(self.start_band, self.end_band):
            self.tf_change[i] = ts[tf_select][self.tf_change[i]]

    # -- bit allocation (celt.c ff_celt_bitalloc, decode side) --------
    def _bitalloc(self, rc):
        f = self
        chan = f.channels
        size = f.size

        def normc(bits):
            return bits << (chan - 1) << size >> 2

        if rc.tell() + 4 <= f.framebits:
            f.spread = rc.dec_cdf(T.MODEL_SPREAD)
        else:
            f.spread = SPREAD_NORMAL

        caps = [normc((T.STATIC_CAPS[size][chan - 1][i] + 64)
                      * int(_FREQ_RANGE[i])) for i in range(MAX_BANDS)]
        f.caps = caps

        dynalloc = 6
        boost = [0] * MAX_BANDS
        tbits_8ths = f.framebits << 3
        for i in range(f.start_band, f.end_band):
            quanta = int(_FREQ_RANGE[i]) << (chan - 1) << size
            quanta = min(quanta << 3, max(6 << 3, quanta))
            b_dynalloc = dynalloc
            while rc.tell_frac() + (b_dynalloc << 3) < tbits_8ths \
                    and boost[i] < caps[i]:
                if not rc.dec_log(b_dynalloc):
                    break
                boost[i] += quanta
                tbits_8ths -= quanta
                b_dynalloc = 1
            if boost[i]:
                dynalloc = max(dynalloc - 1, 2)

        f.alloc_trim = 5
        if rc.tell_frac() + (6 << 3) <= tbits_8ths:
            f.alloc_trim = rc.dec_cdf(T.MODEL_ALLOC_TRIM)

        tbits_8ths = (f.framebits << 3) - rc.tell_frac() - 1
        f.anticollapse_needed = 0
        if f.transient and size >= 2 and tbits_8ths >= (size + 2) << 3:
            f.anticollapse_needed = 1 << 3
        tbits_8ths -= f.anticollapse_needed

        skip_bit = 0
        if tbits_8ths >= 1 << 3:
            skip_bit = 1 << 3
        tbits_8ths -= skip_bit

        intensitystereo_bit = 0
        dualstereo_bit = 0
        if chan == 2:
            intensitystereo_bit = \
                T.LOG2_FRAC[f.end_band - f.start_band]
            if intensitystereo_bit <= tbits_8ths:
                tbits_8ths -= intensitystereo_bit
                if tbits_8ths >= 1 << 3:
                    dualstereo_bit = 1 << 3
                    tbits_8ths -= 1 << 3
            else:
                intensitystereo_bit = 0

        threshold = [0] * MAX_BANDS
        trim_offset = [0] * MAX_BANDS
        for i in range(f.start_band, f.end_band):
            trim = f.alloc_trim - 5 - size
            band = int(_FREQ_RANGE[i]) * (f.end_band - i - 1)
            duration = size + 3
            scale = duration + chan - 1
            threshold[i] = max(3 * int(_FREQ_RANGE[i]) << duration >> 4,
                               chan << 3)
            trim_offset[i] = trim * (band << scale) >> 6
            if int(_FREQ_RANGE[i]) << size == 1:
                trim_offset[i] -= chan << 3

        skip_startband = f.start_band
        low, high = 1, VECTORS - 1
        while low <= high:
            center = (low + high) >> 1
            done = total = 0
            for i in range(f.end_band - 1, f.start_band - 1, -1):
                bandbits = normc(int(_FREQ_RANGE[i])
                                 * T.STATIC_ALLOC[center][i])
                if bandbits:
                    bandbits = max(bandbits + trim_offset[i], 0)
                bandbits += boost[i]
                if bandbits >= threshold[i] or done:
                    done = 1
                    total += min(bandbits, caps[i])
                elif bandbits >= chan << 3:
                    total += chan << 3
            if total > tbits_8ths:
                high = center - 1
            else:
                low = center + 1
        high = low
        low -= 1

        bits1 = [0] * MAX_BANDS
        bits2 = [0] * MAX_BANDS
        for i in range(f.start_band, f.end_band):
            bits1[i] = normc(int(_FREQ_RANGE[i]) * T.STATIC_ALLOC[low][i])
            bits2[i] = caps[i] if high >= VECTORS else \
                normc(int(_FREQ_RANGE[i]) * T.STATIC_ALLOC[high][i])
            if bits1[i]:
                bits1[i] = max(bits1[i] + trim_offset[i], 0)
            if bits2[i]:
                bits2[i] = max(bits2[i] + trim_offset[i], 0)
            if low:
                bits1[i] += boost[i]
            bits2[i] += boost[i]
            if boost[i]:
                skip_startband = i
            bits2[i] = max(bits2[i] - bits1[i], 0)

        low, high = 0, 1 << ALLOC_STEPS
        for _ in range(ALLOC_STEPS):
            center = (low + high) >> 1
            done = total = 0
            for j in range(f.end_band - 1, f.start_band - 1, -1):
                bandbits = bits1[j] + (center * bits2[j] >> ALLOC_STEPS)
                if bandbits >= threshold[j] or done:
                    done = 1
                    total += min(bandbits, caps[j])
                elif bandbits >= chan << 3:
                    total += chan << 3
            if total > tbits_8ths:
                high = center
            else:
                low = center

        done = total = 0
        pulses = [0] * MAX_BANDS
        for i in range(f.end_band - 1, f.start_band - 1, -1):
            bandbits = bits1[i] + (low * bits2[i] >> ALLOC_STEPS)
            if bandbits >= threshold[i] or done:
                done = 1
            else:
                bandbits = (chan << 3) if bandbits >= chan << 3 else 0
            bandbits = min(bandbits, caps[i])
            pulses[i] = bandbits
            total += bandbits
        f.pulses = pulses

        f.coded_bands = f.end_band
        while True:
            j = f.coded_bands - 1
            if j == skip_startband:
                tbits_8ths += skip_bit
                break
            remaining = tbits_8ths - total
            bandbits = _cdiv(remaining, int(_FREQ_BANDS[j + 1])
                             - int(_FREQ_BANDS[f.start_band]))
            remaining -= bandbits * (int(_FREQ_BANDS[j + 1])
                                     - int(_FREQ_BANDS[f.start_band]))
            allocation = pulses[j] + bandbits * int(_FREQ_RANGE[j])
            allocation += max(
                remaining - (int(_FREQ_BANDS[j])
                             - int(_FREQ_BANDS[f.start_band])), 0)
            if allocation >= max(threshold[j], (chan + 1) << 3):
                if rc.dec_log(1):
                    break
                total += 1 << 3
                allocation -= 1 << 3
            total -= pulses[j]
            if intensitystereo_bit:
                total -= intensitystereo_bit
                intensitystereo_bit = \
                    T.LOG2_FRAC[j - f.start_band]
                total += intensitystereo_bit
            pulses[j] = (chan << 3) if allocation >= chan << 3 else 0
            total += pulses[j]
            f.coded_bands -= 1

        f.intensity_stereo = 0
        f.dual_stereo = 0
        if intensitystereo_bit:
            f.intensity_stereo = f.start_band + rc.dec_uint(
                f.coded_bands + 1 - f.start_band)
        if f.intensity_stereo <= f.start_band:
            tbits_8ths += dualstereo_bit
        elif dualstereo_bit:
            f.dual_stereo = rc.dec_log(1)

        remaining = tbits_8ths - total
        bandbits = _cdiv(remaining, int(_FREQ_BANDS[f.coded_bands])
                         - int(_FREQ_BANDS[f.start_band]))
        remaining -= bandbits * (int(_FREQ_BANDS[f.coded_bands])
                                 - int(_FREQ_BANDS[f.start_band]))
        for i in range(f.start_band, f.coded_bands):
            bits = min(remaining, int(_FREQ_RANGE[i]))
            pulses[i] += bits + bandbits * int(_FREQ_RANGE[i])
            remaining -= bits

        f.fine_bits = [0] * MAX_BANDS
        f.fine_priority = [0] * MAX_BANDS
        extrabits = 0
        i = f.start_band
        for i in range(f.start_band, f.coded_bands):
            N = int(_FREQ_RANGE[i]) << size
            prev_extra = extrabits
            pulses[i] += extrabits
            if N > 1:
                extrabits = max(pulses[i] - caps[i], 0)
                pulses[i] -= extrabits
                dof = N * chan + int(chan == 2 and N > 2
                                     and not f.dual_stereo
                                     and i < f.intensity_stereo)
                temp = dof * (int(_LOG_FREQ_RANGE[i]) + (size << 3))
                offset = (temp >> 1) - dof * FINE_OFFSET
                if N == 2:
                    offset += dof << 1
                if pulses[i] + offset < 2 * (dof << 3):
                    offset += temp >> 2
                elif pulses[i] + offset < 3 * (dof << 3):
                    offset += temp >> 3
                fine_bits = _cdiv(
                    pulses[i] + offset + (dof << 2), dof << 3)
                max_bits = min((pulses[i] >> 3) >> (chan - 1),
                               MAX_FINE_BITS)
                max_bits = max(max_bits, 0)
                f.fine_bits[i] = max(0, min(fine_bits, max_bits))
                f.fine_priority[i] = int(
                    f.fine_bits[i] * (dof << 3) >= pulses[i] + offset)
                pulses[i] -= f.fine_bits[i] << (chan - 1) << 3
            else:
                extrabits = max(pulses[i] - (chan << 3), 0)
                pulses[i] -= extrabits
                f.fine_bits[i] = 0
                f.fine_priority[i] = 1
            if extrabits > 0:
                fineextra = min(extrabits >> (chan + 2),
                                MAX_FINE_BITS - f.fine_bits[i])
                f.fine_bits[i] += fineextra
                fineextra <<= chan + 2
                f.fine_priority[i] = int(
                    fineextra >= extrabits - prev_extra)
                extrabits -= fineextra
        f.remaining = extrabits
        for i in range(f.coded_bands, f.end_band):
            f.fine_bits[i] = pulses[i] >> (chan - 1) >> 3
            pulses[i] = 0
            f.fine_priority[i] = int(f.fine_bits[i] < 1)

    def _decode_fine_energy(self, rc):
        for i in range(self.start_band, self.end_band):
            if not self.fine_bits[i]:
                continue
            for ch in range(self.channels):
                q2 = rc.get_raw(self.fine_bits[i])
                offset = (q2 + 0.5) \
                    * (1 << (14 - self.fine_bits[i])) / 16384.0 - 0.5
                self.energy[ch][i] += offset

    def _decode_final_energy(self, rc):
        bits_left = self.framebits - rc.tell()
        for priority in range(2):
            i = self.start_band
            while i < self.end_band and bits_left >= self.channels:
                if self.fine_priority[i] != priority or \
                        self.fine_bits[i] >= MAX_FINE_BITS:
                    i += 1
                    continue
                for ch in range(self.channels):
                    q2 = rc.get_raw(1)
                    offset = (q2 - 0.5) \
                        * (1 << (14 - self.fine_bits[i] - 1)) / 16384.0
                    self.energy[ch][i] += offset
                    bits_left -= 1
                i += 1

    def _anticollapse(self, ch):
        f = self
        X = self.coeffs[ch]
        for i in range(f.start_band, f.end_band):
            depth = (1 + f.pulses[i]) // (int(_FREQ_RANGE[i]) << f.size)
            thresh = 2.0 ** (-1.0 - 0.125 * depth)
            sqrt_1 = 1.0 / math.sqrt(int(_FREQ_RANGE[i]) << f.size)
            off = int(_FREQ_BANDS[i]) << f.size
            prev0 = float(self.prev_energy[ch][0][i])
            prev1 = float(self.prev_energy[ch][1][i])
            if f.channels == 1:
                prev0 = max(prev0, float(self.prev_energy[1][0][i]))
                prev1 = max(prev1, float(self.prev_energy[1][1][i]))
            ediff = max(0.0, float(self.energy[ch][i])
                        - min(prev0, prev1))
            r = 2.0 ** (1 - ediff)
            if f.size == 3:
                r *= math.sqrt(2)
            r = min(thresh, r) * sqrt_1
            renormalize = False
            for k in range(1 << f.size):
                if not (int(self.collapse_masks[ch][i]) & (1 << k)):
                    for j in range(int(_FREQ_RANGE[i])):
                        X[off + (j << f.size) + k] = \
                            r if (self._rng() & 0x8000) else -r
                    renormalize = True
            if renormalize:
                _renormalize(X, off, int(_FREQ_RANGE[i]) << f.size, 1.0)

    def _denormalize(self, ch):
        f = self
        X = self.coeffs[ch]
        for i in range(f.start_band, f.end_band):
            off = int(_FREQ_BANDS[i]) << f.size
            n = int(_FREQ_RANGE[i]) << f.size
            log_norm = float(self.energy[ch][i]) + T.MEAN_ENERGY[i]
            norm = 2.0 ** min(log_norm, 32.0)
            X[off:off + n] *= np.float32(norm)

    # -- band quantization (celt.c ff_celt_quant_bands + pvq.c) -------
    def _quant_bands(self, rc):
        f = self
        norm1 = np.zeros(8 * 100, np.float32)
        norm2 = np.zeros(8 * 100, np.float32)
        totalbits = (f.framebits << 3) - f.anticollapse_needed
        update_lowband = True
        lowband_offset = 0
        for i in range(f.start_band, f.end_band):
            band_offset = int(_FREQ_BANDS[i]) << f.size
            band_size = int(_FREQ_RANGE[i]) << f.size
            X = self.coeffs[0]
            Y = self.coeffs[1] if f.channels == 2 else None
            cm = [(1 << f.blocks) - 1, (1 << f.blocks) - 1]

            consumed = rc.tell_frac()
            if i != f.start_band:
                f.remaining -= consumed
            f.remaining2 = totalbits - consumed - 1
            b = 0
            if i <= f.coded_bands - 1:
                curr_balance = _cdiv(f.remaining, min(3, f.coded_bands - i))
                b = max(0, min(16383, min(f.remaining2 + 1,
                                          f.pulses[i] + curr_balance)))

            if (int(_FREQ_BANDS[i]) - int(_FREQ_RANGE[i])
                    >= int(_FREQ_BANDS[f.start_band])
                    or i == f.start_band + 1) and \
                    (update_lowband or lowband_offset == 0):
                lowband_offset = i

            if i == f.start_band + 1:
                count = (int(_FREQ_RANGE[i])
                         - int(_FREQ_RANGE[i - 1])) << f.size
                norm1[band_offset:band_offset + count] = \
                    norm1[band_offset - count:band_offset]
                if f.channels == 2:
                    norm2[band_offset:band_offset + count] = \
                        norm2[band_offset - count:band_offset]

            effective_lowband = -1
            if lowband_offset != 0 and (f.spread != SPREAD_AGGRESSIVE
                                        or f.blocks > 1
                                        or f.tf_change[i] < 0):
                effective_lowband = max(
                    int(_FREQ_BANDS[f.start_band]),
                    int(_FREQ_BANDS[lowband_offset])
                    - int(_FREQ_RANGE[i]))
                foldstart = lowband_offset
                while True:
                    foldstart -= 1
                    if int(_FREQ_BANDS[foldstart]) <= effective_lowband:
                        break
                foldend = lowband_offset - 1
                while True:
                    foldend += 1
                    if foldend >= i or int(_FREQ_BANDS[foldend]) >= \
                            effective_lowband + int(_FREQ_RANGE[i]):
                        break
                cm[0] = cm[1] = 0
                for j in range(foldstart, foldend):
                    cm[0] |= int(self.collapse_masks[0][j])
                    cm[1] |= int(
                        self.collapse_masks[f.channels - 1][j])

            if f.dual_stereo and i == f.intensity_stereo:
                f.dual_stereo = 0
                sb = int(_FREQ_BANDS[f.start_band]) << f.size
                norm1[sb:band_offset] = (norm1[sb:band_offset]
                                         + norm2[sb:band_offset]) / 2

            nl1 = norm1[effective_lowband << f.size:] \
                if effective_lowband != -1 else None
            nl2 = norm2[effective_lowband << f.size:] \
                if effective_lowband != -1 else None

            if f.dual_stereo:
                cm[0] = self._quant_band(
                    rc, i, X, band_offset, None, 0, band_size, b >> 1,
                    f.blocks, nl1, f.size, norm1, band_offset, 0, 1.0,
                    cm[0])
                cm[1] = self._quant_band(
                    rc, i, Y, band_offset, None, 0, band_size, b >> 1,
                    f.blocks, nl2, f.size, norm2, band_offset, 0, 1.0,
                    cm[1])
            else:
                cm[0] = self._quant_band(
                    rc, i, X, band_offset, Y, band_offset, band_size,
                    b, f.blocks, nl1, f.size, norm1, band_offset, 0,
                    1.0, cm[0] | cm[1])
                cm[1] = cm[0]

            self.collapse_masks[0][i] = cm[0]
            self.collapse_masks[f.channels - 1][i] = cm[1]
            f.remaining += f.pulses[i] + consumed
            update_lowband = b > band_size << 3

    def _alg_unquant(self, rc, X, off, N, K, blocks, gain):
        idx = rc.dec_uint(pvq_v(N, K))
        y, norm = _cwrsi(N, K, idx)
        g = gain / math.sqrt(norm)
        X[off:off + N] = (y * g).astype(np.float32)
        _exp_rotation(X[off:off + N], N, blocks, K, self.spread)
        return _extract_collapse_mask(y, N, blocks)

    def _stereo_merge(self, X, Y, offx, offy, mid, N):
        x = X[offx:offx + N]
        y = Y[offy:offy + N]
        xp = float(np.dot(x.astype(np.float64), y.astype(np.float64)))
        side = float(np.dot(y.astype(np.float64),
                            y.astype(np.float64)))
        xp *= mid
        e0 = mid * mid + side - 2 * xp
        e1 = mid * mid + side + 2 * xp
        if e0 < 6e-4 or e1 < 6e-4:
            Y[offy:offy + N] = x
            return
        gain0 = 1.0 / math.sqrt(e0)
        gain1 = 1.0 / math.sqrt(e1)
        xm = (np.float32(mid) * x).astype(np.float32)
        v0 = (np.float32(gain0) * (xm - y)).astype(np.float32)
        v1 = (np.float32(gain1) * (xm + y)).astype(np.float32)
        X[offx:offx + N] = v0
        Y[offy:offy + N] = v1

    def _quant_band(self, rc, band, X, offx, Y, offy, N, b, blocks,
                    lowband, duration, lowband_out, lo_off, level,
                    gain, fill):
        """pvq.c quant_band_template, decode side. lowband is an array
        slice (or None); lowband_out/lo_off receive folding output."""
        f = self
        stereo = Y is not None
        split = stereo
        imid = iside = 0
        N0 = N
        N_B = N // blocks
        N_B0 = N_B
        B0 = blocks
        time_divide = 0
        recombine = 0
        inv = 0
        mid = side = 0.0
        longblocks = B0 == 1
        cm = 0

        if N == 1:
            arrs = [(X, offx)] + ([(Y, offy)] if stereo else [])
            for arr, off in arrs:
                sign = 0
                if f.remaining2 >= 1 << 3:
                    sign = rc.get_raw(1)
                    f.remaining2 -= 1 << 3
                arr[off] = 1.0 - 2.0 * sign
            if lowband_out is not None:
                lowband_out[lo_off] = X[offx]
            return 1

        lowband_arr = lowband
        if not stereo and level == 0:
            tf_change = f.tf_change[band]
            if tf_change > 0:
                recombine = tf_change
            if lowband_arr is not None and \
                    (recombine or ((N_B & 1) == 0 and tf_change < 0)
                     or B0 > 1):
                lowband_arr = lowband_arr[:N].copy()
            for k in range(recombine):
                if lowband_arr is not None:
                    _haar1(lowband_arr, N >> k, 1 << k)
                fill = T.BIT_INTERLEAVE[fill & 0xF] | \
                    T.BIT_INTERLEAVE[fill >> 4] << 2
            blocks >>= recombine
            N_B <<= recombine
            while (N_B & 1) == 0 and tf_change < 0:
                if lowband_arr is not None:
                    _haar1(lowband_arr, N_B, blocks)
                fill |= fill << blocks
                blocks <<= 1
                N_B >>= 1
                time_divide += 1
                tf_change += 1
            B0 = blocks
            N_B0 = N_B
            if B0 > 1 and lowband_arr is not None:
                _deinterleave_hadamard(lowband_arr, N_B >> recombine,
                                       B0 << recombine, longblocks)

        ci = T.CACHE_INDEX[(duration + 1) * MAX_BANDS + band]
        cache = T.CACHE_BITS
        if not stereo and duration >= 0 and \
                b > cache[ci + cache[ci]] + 12 and N > 2:
            N >>= 1
            Y = X
            offy = offx + N
            split = True
            duration -= 1
            if blocks == 1:
                fill = (fill & 1) | (fill << 1)
            blocks = (blocks + 1) >> 1

        if split:
            stereo_now = stereo
            pulse_cap = int(_LOG_FREQ_RANGE[band]) + duration * 8
            offset = (pulse_cap >> 1) - (
                QTHETA_OFFSET_TWOPHASE if stereo_now and N == 2
                else QTHETA_OFFSET)
            qn = 1 if (stereo_now and band >= f.intensity_stereo) \
                else _compute_qn(N, b, offset, pulse_cap, stereo_now)
            tell = rc.tell_frac()
            itheta = 0
            if qn != 1:
                if stereo_now and N > 2:
                    itheta = rc.dec_uint_step(qn // 2)
                elif stereo_now or B0 > 1:
                    itheta = rc.dec_uint(qn + 1)
                else:
                    itheta = rc.dec_uint_tri(qn)
                itheta = itheta * 16384 // qn
            elif stereo_now:
                inv = rc.dec_log(2) if (b > 2 << 3
                                        and f.remaining2 > 2 << 3) else 0
                if not f.apply_phase_inv:
                    inv = 0
                itheta = 0
            qalloc = rc.tell_frac() - tell
            b -= qalloc

            orig_fill = fill
            if itheta == 0:
                imid = 32767
                iside = 0
                fill &= (1 << blocks) - 1
                delta = -16384
            elif itheta == 16384:
                imid = 0
                iside = 32767
                fill &= ((1 << blocks) - 1) << blocks
                delta = 16384
            else:
                imid = _celt_cos(itheta)
                iside = _celt_cos(16384 - itheta)
                delta = (((N - 1) << 7)
                         * _log2tan(iside, imid) + 16384) >> 15
            mid = imid / 32768.0
            side = iside / 32768.0

            if N == 2 and stereo_now:
                mbits = b
                sbits = (1 << 3) if (itheta != 0
                                     and itheta != 16384) else 0
                mbits -= sbits
                c = itheta > 8192
                f.remaining2 -= qalloc + sbits
                if c:
                    x2a, x2o, y2a, y2o = Y, offy, X, offx
                else:
                    x2a, x2o, y2a, y2o = X, offx, Y, offy
                sign = rc.get_raw(1) if sbits else 0
                sign = 1 - 2 * sign
                cm = self._quant_band(rc, band, x2a, x2o, None, 0, N,
                                      mbits, blocks, lowband_arr,
                                      duration, lowband_out, lo_off,
                                      level, gain, orig_fill)
                y2a[y2o] = -sign * x2a[x2o + 1]
                y2a[y2o + 1] = sign * x2a[x2o]
                X[offx] *= np.float32(mid)
                X[offx + 1] *= np.float32(mid)
                Y[offy] *= np.float32(side)
                Y[offy + 1] *= np.float32(side)
                tmp = float(X[offx])
                X[offx] = np.float32(tmp - Y[offy])
                Y[offy] = np.float32(tmp + Y[offy])
                tmp = float(X[offx + 1])
                X[offx + 1] = np.float32(tmp - Y[offy + 1])
                Y[offy + 1] = np.float32(tmp + Y[offy + 1])
            else:
                if B0 > 1 and not stereo_now and (itheta & 0x3fff):
                    if itheta > 8192:
                        delta -= delta >> (4 - duration)
                    else:
                        delta = min(0, delta
                                    + (N << 3 >> (5 - duration)))
                mbits = max(0, min(b, _cdiv(b - delta, 2)))
                sbits = b - mbits
                f.remaining2 -= qalloc

                next_lowband2 = None
                nl2_off = 0
                if lowband_arr is not None and not stereo_now:
                    next_lowband2 = lowband_arr
                    nl2_off = N
                next_lowband_out1 = None
                nlo_off = 0
                next_level = level
                if stereo_now:
                    next_lowband_out1 = lowband_out
                    nlo_off = lo_off
                else:
                    next_level = level + 1

                rebalance = f.remaining2
                if mbits >= sbits:
                    cm = self._quant_band(
                        rc, band, X, offx, None, 0, N, mbits, blocks,
                        lowband_arr, duration, next_lowband_out1,
                        nlo_off, next_level,
                        1.0 if stereo_now else gain * mid, fill)
                    rebalance = mbits - (rebalance - f.remaining2)
                    if rebalance > 3 << 3 and itheta != 0:
                        sbits += rebalance - (3 << 3)
                    cmt = self._quant_band(
                        rc, band, Y, offy, None, 0, N, sbits, blocks,
                        (next_lowband2[nl2_off:]
                         if next_lowband2 is not None else None),
                        duration, None, 0, next_level, gain * side,
                        fill >> blocks)
                    cm |= cmt << ((B0 >> 1) & (int(stereo_now) - 1))
                else:
                    cm = self._quant_band(
                        rc, band, Y, offy, None, 0, N, sbits, blocks,
                        (next_lowband2[nl2_off:]
                         if next_lowband2 is not None else None),
                        duration, None, 0, next_level, gain * side,
                        fill >> blocks)
                    cm <<= (B0 >> 1) & (int(stereo_now) - 1)
                    rebalance = sbits - (rebalance - f.remaining2)
                    if rebalance > 3 << 3 and itheta != 16384:
                        mbits += rebalance - (3 << 3)
                    cm |= self._quant_band(
                        rc, band, X, offx, None, 0, N, mbits, blocks,
                        lowband_arr, duration, next_lowband_out1,
                        nlo_off, next_level,
                        1.0 if stereo_now else gain * mid, fill)
        else:
            ci = T.CACHE_INDEX[(duration + 1) * MAX_BANDS + band]
            q = _bits2pulses(T.CACHE_BITS, ci, b)
            curr_bits = _pulses2bits(T.CACHE_BITS, ci, q)
            f.remaining2 -= curr_bits
            while f.remaining2 < 0 and q > 0:
                f.remaining2 += curr_bits
                q -= 1
                curr_bits = _pulses2bits(T.CACHE_BITS, ci, q)
                f.remaining2 -= curr_bits
            if q != 0:
                K = q if q < 8 else (8 + (q & 7)) << ((q >> 3) - 1)
                cm = self._alg_unquant(rc, X, offx, N, K, blocks, gain)
            else:
                cm_mask = (1 << blocks) - 1
                fill &= cm_mask
                if fill:
                    if lowband_arr is None:
                        for j in range(N):
                            X[offx + j] = np.float32(
                                _s32(self._rng()) >> 20)
                        cm = cm_mask
                    else:
                        for j in range(N):
                            X[offx + j] = lowband_arr[j] + (
                                (1.0 / 256) if (self._rng() & 0x8000)
                                else (-1.0 / 256))
                        cm = fill
                    _renormalize(X, offx, N, gain)
                else:
                    X[offx:offx + N] = 0.0

        if stereo:
            if N > 2:
                self._stereo_merge(X, Y, offx, offy, mid, N)
            if inv:
                Y[offy:offy + N0] *= -1.0
        elif level == 0:
            if B0 > 1:
                _interleave_hadamard(X[offx:offx + N_B * B0],
                                     N_B >> recombine,
                                     B0 << recombine, longblocks)
            N_B = N_B0
            blocks = B0
            for _ in range(time_divide):
                blocks >>= 1
                N_B <<= 1
                cm |= cm >> blocks
                _haar1(X[offx:], N_B, blocks)
            for k in range(recombine):
                cm = T.BIT_DEINTERLEAVE[cm]
                _haar1(X[offx:], N0 >> k, 1 << k)
            blocks <<= recombine
            if lowband_out is not None:
                n = math.sqrt(N0)
                for i in range(N0):
                    lowband_out[lo_off + i] = np.float32(n) * X[offx + i]
            cm &= (1 << blocks) - 1
        return cm


def _s32(v: int) -> int:
    return v - (1 << 32) if v >= 1 << 31 else v
