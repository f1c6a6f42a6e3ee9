"""Opus SILK decoder (RFC 6716 §4.2) — the LP layer.

Produces float samples at the SILK internal rate (8/12/16 kHz); the
codec layer resamples to 48 kHz. The entropy decode and all quantized
reconstruction paths follow the spec's fixed-point arithmetic exactly
(C-style truncation, 32-bit wrap/saturation where mandated); synthesis
runs in float like the reference decoder.

Behavioral reference: libavcodec/opus/silk.c (reimplemented; output
cross-validated against a harness driving the reference's own
ff_silk_decode_superframe and end-to-end against the reference CLI in
tests/test_opus_silk.py).

A copy of librempeg_tpu/codecs/opus/silk.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

import numpy as np

from librempeg_tpu_torch.codecs.opus import silk_tables as ST

SILK_HISTORY = 322
SILK_MAX_LAG = 288 + 2          # 288 + LTP_ORDER // 2
LTP_ORDER = 5

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def _mulh(a: int, b: int) -> int:
    """High 32 bits of the signed 64-bit product."""
    return (a * b) >> 32


def _mull(a: int, b: int, s: int) -> int:
    return (a * b) >> s


def _round_mull(a: int, b: int, s: int) -> int:
    return (((a * b) >> (s - 1)) + 1) >> 1


def _sat32(x: int) -> int:
    return _I32_MIN if x < _I32_MIN else (_I32_MAX if x > _I32_MAX
                                          else x)


def _ilog(x: int) -> int:
    return x.bit_length()


class SilkFrame:
    __slots__ = ("coded", "log_gain", "nlsf", "lpc", "output",
                 "lpc_history", "primarylag", "prev_voiced")

    def __init__(self):
        self.output = np.zeros(2 * SILK_HISTORY, np.float32)
        self.lpc_history = np.zeros(2 * SILK_HISTORY, np.float32)
        self.flush()

    def flush(self):
        self.coded = 0
        self.log_gain = 0
        self.nlsf = np.zeros(16, np.int64)
        self.lpc = np.zeros(16, np.float32)
        self.output[:] = 0
        self.lpc_history[:] = 0
        self.primarylag = 0
        self.prev_voiced = 0


def _stabilize_lsf(nlsf, order, min_delta):
    """RFC 6716 4.2.7.5.4 (silk.c silk_stabilize_lsf)."""
    for _ in range(20):
        min_diff = 0
        k = 0
        for i in range(order + 1):
            low = nlsf[i - 1] if i != 0 else 0
            high = nlsf[i] if i != order else 32768
            diff = (high - low) - min_delta[i]
            if diff < min_diff:
                min_diff = diff
                k = i
        if min_diff == 0:
            return
        if k == 0:
            nlsf[0] = min_delta[0]
        elif k == order:
            nlsf[order - 1] = 32768 - min_delta[order]
        else:
            min_center = sum(min_delta[:k]) + (min_delta[k] >> 1)
            max_center = 32768 - sum(min_delta[k + 1:order + 1]) \
                - (min_delta[k] >> 1)
            center = int(nlsf[k - 1]) + int(nlsf[k])
            center = (center >> 1) + (center & 1)
            center = min(max_center, max(min_center, center))
            nlsf[k - 1] = center - (min_delta[k] >> 1)
            nlsf[k] = nlsf[k - 1] + min_delta[k]
    # fallback: sort + push apart
    arr = sorted(int(v) for v in nlsf[:order])
    for i in range(order):
        nlsf[i] = arr[i]
    if nlsf[0] < min_delta[0]:
        nlsf[0] = min_delta[0]
    for i in range(1, order):
        nlsf[i] = max(nlsf[i], min(nlsf[i - 1] + min_delta[i], 32767))
    if nlsf[order - 1] > 32768 - min_delta[order]:
        nlsf[order - 1] = 32768 - min_delta[order]
    for i in range(order - 2, -1, -1):
        if nlsf[i] > nlsf[i + 1] - min_delta[i + 1]:
            nlsf[i] = nlsf[i + 1] - min_delta[i + 1]


def _is_lpc_stable(lpc, order):
    """RFC 6716 4.2.7.5.7 prediction-gain test (silk_is_lpc_stable),
    including the RFC 8251 §6 overflow-means-unstable rule."""
    dc_resp = 0
    row = [0] * 16
    for k in range(order):
        dc_resp += lpc[k]
        row[k] = lpc[k] * 4096
    if dc_resp >= 4096:
        return False
    totalinvgain = 1 << 30
    k = order - 1
    while True:
        if abs(row[k]) > 16773022:
            return False
        rc = -(row[k] * 128)
        gaindiv = (1 << 30) - _mulh(rc, rc)
        totalinvgain = _mulh(totalinvgain, gaindiv) << 2
        if k == 0:
            return totalinvgain >= 107374
        fbits = _ilog(gaindiv)
        gain = ((1 << 29) - 1) // (gaindiv >> (fbits + 1 - 16))
        error = (1 << 29) - _mull(gaindiv << (15 + 16 - fbits), gain,
                                  16)
        gain = (gain << 16) + ((error * gain) >> 13)
        prevrow = list(row)
        for j in range(k):
            x = _sat32(prevrow[j]
                       - _round_mull(prevrow[k - j - 1], rc, 31))
            tmp = _round_mull(x, gain, fbits)
            if tmp < _I32_MIN or tmp > _I32_MAX:
                return False
            row[j] = tmp
        k -= 1


def _lsp2poly(lsp, pol, half_order):
    pol[0] = 65536
    pol[1] = -lsp[0]
    for i in range(1, half_order):
        pol[i + 1] = pol[i - 1] * 2 - _round_mull(lsp[2 * i], pol[i],
                                                  16)
        for j in range(i, 1, -1):
            pol[j] += pol[j - 2] - _round_mull(lsp[2 * i], pol[j - 1],
                                               16)
        pol[1] -= lsp[2 * i]


def _lsf2lpc(nlsf, order):
    """RFC 6716 4.2.7.5.6/5.8 NLSF -> float LPC (silk_lsf2lpc)."""
    ordering = ST.LSF_ORDERING_NBMB if order == 10 else \
        ST.LSF_ORDERING_WB
    lsp = [0] * 16
    for k in range(order):
        index = int(nlsf[k]) >> 8
        offset = int(nlsf[k]) & 255
        k2 = ordering[k]
        v = ST.COSINE[index] * 256
        v += (ST.COSINE[index + 1] - ST.COSINE[index]) * offset
        lsp[k2] = (v + 4) >> 3
    p = [0] * 9
    q = [0] * 9
    _lsp2poly(lsp, p, order >> 1)          # even LSPs (indexes 2*i)
    _lsp2poly(lsp[1:], q, order >> 1)      # odd LSPs
    lpc32 = [0] * 16
    for k in range(order >> 1):
        p_tmp = p[k + 1] + p[k]
        q_tmp = q[k + 1] - q[k]
        lpc32[k] = -q_tmp - p_tmp
        lpc32[order - k - 1] = q_tmp - p_tmp
    lpc = [0] * 16
    fit = False
    for _ in range(10):
        maxabs = 0
        k = 0
        for j in range(order):
            x = abs(lpc32[j])
            if x > maxabs:
                maxabs = x
                k = j
        maxabs = (maxabs + 16) >> 5               # Q17 -> Q12
        if maxabs <= 32767:
            fit = True
            break
        # bandwidth expansion toward fitting int16
        maxabs = min(maxabs, 163838)
        chirp_base = chirp = 65470 - (((maxabs - 32767) << 14)
                                      // ((maxabs * (k + 1)) >> 2))
        for k in range(order):
            lpc32[k] = _round_mull(lpc32[k], chirp, 16)
            chirp = (chirp_base * chirp + 32768) >> 16
    if not fit:
        # time's up: clamp (spec-mandated low-bit drop)
        for k in range(order):
            x = (lpc32[k] + 16) >> 5
            lpc[k] = max(-32768, min(32767, x))
            lpc32[k] = lpc[k] << 5
    else:
        for k in range(order):
            lpc[k] = (lpc32[k] + 16) >> 5
    i = 1
    while i <= 16 and not _is_lpc_stable(lpc[:order], order):
        chirp_base = chirp = 65536 - (1 << i)
        for k in range(order):
            lpc32[k] = _round_mull(lpc32[k], chirp, 16)
            lpc[k] = (lpc32[k] + 16) >> 5
            chirp = (chirp_base * chirp + 32768) >> 16
        i += 1
    return np.array([c / 4096.0 for c in lpc[:order]], np.float32)


class SilkDecoder:
    def __init__(self, output_channels: int):
        self.output_channels = output_channels
        self.frame = [SilkFrame(), SilkFrame()]
        self.prev_stereo_weights = [0.0, 0.0]
        self.stereo_weights = [0.0, 0.0]
        self.prev_coded_channels = 0
        self.midonly = 0
        self.nlsf_interp_factor = 4

    def flush(self):
        self.frame[0].flush()
        self.frame[1].flush()
        self.prev_stereo_weights = [0.0, 0.0]
        self.prev_coded_channels = 0

    # -- LPC -----------------------------------------------------------
    def _decode_lpc(self, rc, frame, voiced):
        wb = self.wb
        order = 16 if wb else 10
        lsf_i1 = rc.dec_cdf(ST.MODEL_LSF_S1[wb][voiced])
        sel = ST.LSF_S2_MODEL_SEL_WB if wb else ST.LSF_S2_MODEL_SEL_NBMB
        lsf_i2 = []
        for i in range(order):
            idx = rc.dec_cdf(ST.MODEL_LSF_S2[sel[lsf_i1][i]]) - 4
            if idx == -4:
                idx -= rc.dec_cdf(ST.MODEL_LSF_S2_EXT)
            elif idx == 4:
                idx += rc.dec_cdf(ST.MODEL_LSF_S2_EXT)
            lsf_i2.append(idx)
        # undo backwards prediction
        qstep = 9830 if wb else 11796
        wsel = ST.LSF_WEIGHT_SEL_WB if wb else ST.LSF_WEIGHT_SEL_NBMB
        pw = ST.LSF_PRED_WEIGHTS_WB if wb else ST.LSF_PRED_WEIGHTS_NBMB
        lsf_res = [0] * order
        for i in range(order - 1, -1, -1):
            v = lsf_i2[i] * 1024
            if lsf_i2[i] < 0:
                v += 102
            elif lsf_i2[i] > 0:
                v -= 102
            v = (v * qstep) >> 16
            if i + 1 < order:
                v += (lsf_res[i + 1] * pw[wsel[lsf_i1][i]][i]) >> 8
            lsf_res[i] = v
        cb = ST.LSF_CODEBOOK_WB if wb else ST.LSF_CODEBOOK_NBMB
        mw = ST.MODEL_LSF_WEIGHT_WB if wb else ST.MODEL_LSF_WEIGHT_NBMB
        nlsf = np.zeros(16, np.int64)
        for i in range(order):
            value = cb[lsf_i1][i] * 128 \
                + _ctrunc_div(lsf_res[i] * 16384, mw[lsf_i1][i])
            nlsf[i] = max(0, min(value, 32767))
        spacing = ST.LSF_MIN_SPACING_WB if wb else \
            ST.LSF_MIN_SPACING_NBMB
        _stabilize_lsf(nlsf, order, spacing)

        has_leadin = 0
        lpc_leadin = None
        if self.subframes == 4:
            offset = rc.dec_cdf(ST.MODEL_LSF_INTERP_OFFSET)
            if offset != 4 and frame.coded:
                has_leadin = 1
                if offset != 0:
                    nlsf_leadin = frame.nlsf.copy()
                    for i in range(order):
                        nlsf_leadin[i] = frame.nlsf[i] + (
                            (int(nlsf[i]) - int(frame.nlsf[i]))
                            * offset >> 2)
                    lpc_leadin = _lsf2lpc(nlsf_leadin, order)
                else:
                    lpc_leadin = frame.lpc[:order].copy()
            else:
                offset = 4
            self.nlsf_interp_factor = offset
        else:
            self.nlsf_interp_factor = 4
        lpc = _lsf2lpc(nlsf, order)
        frame.nlsf[:order] = nlsf[:order]
        frame.lpc = np.zeros(16, np.float32)
        frame.lpc[:order] = lpc
        return lpc_leadin, lpc, order, has_leadin

    # -- excitation ----------------------------------------------------
    def _decode_excitation(self, rc, flength, qoffset_high, active,
                           voiced):
        seed = rc.dec_cdf(ST.MODEL_LCG_SEED)
        shellblocks = ST.SHELL_BLOCKS[self.bandwidth][
            self.subframes >> 2]
        ratelevel = rc.dec_cdf(ST.MODEL_EXC_RATE[voiced])
        pulsecount = [0] * shellblocks
        lsbcount = [0] * shellblocks
        for i in range(shellblocks):
            # 17 escapes to one more LSB per pulse, up to 10 levels
            p = rc.dec_cdf(ST.MODEL_PULSE_COUNT[ratelevel])
            if p == 17:
                lsb = 0
                while p == 17:
                    lsb += 1
                    if lsb == 10:
                        break
                    p = rc.dec_cdf(ST.MODEL_PULSE_COUNT[9])
                if lsb == 10:
                    p = rc.dec_cdf(ST.MODEL_PULSE_COUNT[10])
                lsbcount[i] = lsb
            pulsecount[i] = p
        exc = [0] * (shellblocks * 16)
        loc_models = ST.MODEL_PULSE_LOCATION
        for i in range(shellblocks):
            if pulsecount[i] == 0:
                continue

            def count_children(model, total):
                if total == 0:
                    return 0, 0
                off = ((total - 1 + 5) * (total - 1)) >> 1
                c0 = rc.dec_cdf(loc_models[model][off:])
                return c0, total - c0

            base = 16 * i
            b1 = count_children(0, pulsecount[i])
            for bi, bv in enumerate(b1):
                b2 = count_children(1, bv)
                for ci, cv in enumerate(b2):
                    b3 = count_children(2, cv)
                    for di, dv in enumerate(b3):
                        d0, d1 = count_children(3, dv)
                        pos = base + bi * 8 + ci * 4 + di * 2
                        exc[pos] = d0
                        exc[pos + 1] = d1
        for i in range(shellblocks << 4):
            for _ in range(lsbcount[i >> 4]):
                exc[i] = (exc[i] << 1) | rc.dec_cdf(
                    ST.MODEL_EXCITATION_LSB)
        for i in range(shellblocks << 4):
            if exc[i] != 0:
                sign = rc.dec_cdf(ST.MODEL_EXCITATION_SIGN[
                    active + voiced][qoffset_high][
                    min(pulsecount[i >> 4], 6)])
                if sign == 0:
                    exc[i] = -exc[i]
        out = np.zeros(shellblocks * 16, np.float32)
        qoff = ST.QUANT_OFFSET[voiced][qoffset_high]
        for i in range(shellblocks << 4):
            value = exc[i]
            e = value * 256 | qoff
            if value < 0:
                e += 20
            elif value > 0:
                e -= 20
            seed = (196314165 * seed + 907633515) & 0xFFFFFFFF
            if seed & 0x80000000:
                e = -e
            seed = (seed + value) & 0xFFFFFFFF
            out[i] = np.float32(e / 8388608.0)
        return out

    # -- one 20/10ms SILK frame ---------------------------------------
    def _decode_frame(self, rc, frame_num, channel, coded_channels,
                      active, active1, redundant):
        frame = self.frame[channel]
        if coded_channels == 2 and channel == 0:
            n = rc.dec_cdf(ST.MODEL_STEREO_S1)
            wi0 = rc.dec_cdf(ST.MODEL_STEREO_S2) + 3 * (n // 5)
            ws0 = rc.dec_cdf(ST.MODEL_STEREO_S3)
            wi1 = rc.dec_cdf(ST.MODEL_STEREO_S2) + 3 * (n % 5)
            ws1 = rc.dec_cdf(ST.MODEL_STEREO_S3)
            w = []
            for wi, ws in ((wi0, ws0), (wi1, ws1)):
                w.append(ST.STEREO_WEIGHTS[wi] + (
                    ((ST.STEREO_WEIGHTS[wi + 1]
                      - ST.STEREO_WEIGHTS[wi]) * 6554) >> 16)
                    * (ws * 2 + 1))
            self.stereo_weights[0] = (w[0] - w[1]) / 8192.0
            self.stereo_weights[1] = w[1] / 8192.0
            self.midonly = 0 if active1 else \
                rc.dec_cdf(ST.MODEL_MID_ONLY)
        if not active:
            qoffset_high = rc.dec_cdf(ST.MODEL_FRAME_TYPE_INACTIVE)
            voiced = 0
        else:
            t = rc.dec_cdf(ST.MODEL_FRAME_TYPE_ACTIVE)
            qoffset_high = t & 1
            voiced = t >> 1

        # subframe gains (4.2.7.4)
        sf_gain = []
        for i in range(self.subframes):
            if i == 0 and (frame_num == 0 or not frame.coded):
                x = rc.dec_cdf(ST.MODEL_GAIN_HIGHBITS[active + voiced])
                log_gain = (x << 3) | rc.dec_cdf(ST.MODEL_GAIN_LOWBITS)
                if frame.coded:
                    log_gain = max(log_gain, frame.log_gain - 16)
            else:
                delta = rc.dec_cdf(ST.MODEL_GAIN_DELTA)
                log_gain = max((delta << 1) - 16,
                               frame.log_gain + delta - 4)
                log_gain = max(0, min(63, log_gain))
            frame.log_gain = log_gain
            lg = (log_gain * 0x1D1C71 >> 16) + 2090
            ipart = lg >> 7
            fpart = lg & 127
            lingain = (1 << ipart) + \
                ((-174 * fpart * (128 - fpart) >> 16) + fpart) \
                * ((1 << ipart) >> 7)
            sf_gain.append(np.float32(lingain / 65536.0))

        lpc_leadin, lpc_body, order, has_leadin = \
            self._decode_lpc(rc, frame, voiced)

        # pitch lags + LTP filter (4.2.7.6)
        sf_pitchlag = [0] * self.subframes
        sf_ltptaps = [None] * self.subframes
        if voiced:
            lag_absolute = (not frame_num) or (not frame.prev_voiced)
            if not lag_absolute:
                delta = rc.dec_cdf(ST.MODEL_PITCH_DELTA)
                if delta:
                    primarylag = frame.primarylag + delta - 9
                else:
                    lag_absolute = True
            if lag_absolute:
                low_models = (ST.MODEL_PITCH_LOWBITS_NB,
                              ST.MODEL_PITCH_LOWBITS_MB,
                              ST.MODEL_PITCH_LOWBITS_WB)
                high = rc.dec_cdf(ST.MODEL_PITCH_HIGHBITS)
                low = rc.dec_cdf(low_models[self.bandwidth])
                primarylag = ST.PITCH_MIN_LAG[self.bandwidth] + \
                    high * ST.PITCH_SCALE[self.bandwidth] + low
            frame.primarylag = primarylag
            if self.subframes == 2:
                if self.bandwidth == 0:
                    offs = ST.PITCH_OFFSET_NB10MS[rc.dec_cdf(
                        ST.MODEL_PITCH_CONTOUR_NB10MS)]
                else:
                    offs = ST.PITCH_OFFSET_MBWB10MS[rc.dec_cdf(
                        ST.MODEL_PITCH_CONTOUR_MBWB10MS)]
            else:
                if self.bandwidth == 0:
                    offs = ST.PITCH_OFFSET_NB20MS[rc.dec_cdf(
                        ST.MODEL_PITCH_CONTOUR_NB20MS)]
                else:
                    offs = ST.PITCH_OFFSET_MBWB20MS[rc.dec_cdf(
                        ST.MODEL_PITCH_CONTOUR_MBWB20MS)]
            for i in range(self.subframes):
                sf_pitchlag[i] = max(
                    ST.PITCH_MIN_LAG[self.bandwidth],
                    min(primarylag + offs[i],
                        ST.PITCH_MAX_LAG[self.bandwidth]))
            ltpfilter = rc.dec_cdf(ST.MODEL_LTP_FILTER)
            fsel = (ST.MODEL_LTP_FILTER0_SEL, ST.MODEL_LTP_FILTER1_SEL,
                    ST.MODEL_LTP_FILTER2_SEL)
            ftaps = (ST.LTP_FILTER0_TAPS, ST.LTP_FILTER1_TAPS,
                     ST.LTP_FILTER2_TAPS)
            for i in range(self.subframes):
                index = rc.dec_cdf(fsel[ltpfilter])
                sf_ltptaps[i] = np.array(
                    [t / 128.0 for t in ftaps[ltpfilter][index]],
                    np.float32)

        if voiced and frame_num == 0:
            ltpscale = ST.LTP_SCALE_FACTOR[rc.dec_cdf(
                ST.MODEL_LTP_SCALE_INDEX)] / 16384.0
        else:
            ltpscale = 15565.0 / 16384.0
        ltpscale = np.float32(ltpscale)

        residual = np.zeros(SILK_MAX_LAG + SILK_HISTORY, np.float32)
        exc = self._decode_excitation(rc, self.flength, qoffset_high,
                                      active, voiced)
        residual[SILK_MAX_LAG:SILK_MAX_LAG + len(exc)] = exc

        if self.output_channels == channel or redundant:
            return

        # synthesis (4.2.7.9)
        sfl = self.sflength
        for i in range(self.subframes):
            coeff = lpc_leadin if (i < 2 and has_leadin) else lpc_body
            dsto = SILK_HISTORY + i * sfl           # into frame.output
            reso = SILK_MAX_LAG + i * sfl           # into residual
            lpco = SILK_HISTORY + i * sfl           # into lpc_history
            gain = sf_gain[i]
            if voiced:
                if i < 2 or self.nlsf_interp_factor == 4:
                    out_end = -i * sfl
                    scale = ltpscale
                else:
                    out_end = -(i - 2) * sfl
                    scale = np.float32(1.0)
                # re-whitening of past output through the current LPC
                start = -sf_pitchlag[i] - LTP_ORDER // 2
                dst = self.frame[channel].output
                for j in range(start, out_end):
                    s = dst[dsto + j] - np.float32(np.dot(
                        coeff,
                        dst[dsto + j - order:dsto + j][::-1]))
                    residual[reso + j] = np.float32(
                        min(1.0, max(-1.0, float(s)))) * scale / gain
                if out_end:
                    rescale = sf_gain[i - 1] / sf_gain[i]
                    residual[reso + out_end:reso] *= rescale
                # LTP synthesis (sequential IIR on the residual)
                taps = sf_ltptaps[i]
                lagoff = reso - sf_pitchlag[i] + LTP_ORDER // 2
                for j in range(sfl):
                    s = residual[reso + j] + np.float32(np.dot(
                        taps,
                        residual[lagoff + j - LTP_ORDER + 1:
                                 lagoff + j + 1][::-1]))
                    residual[reso + j] = s
            # LPC synthesis
            lh = self.frame[channel].lpc_history
            dst = self.frame[channel].output
            for j in range(sfl):
                s = residual[reso + j] * gain + np.float32(np.dot(
                    coeff, lh[lpco + j - order:lpco + j][::-1]))
                lh[lpco + j] = s
                dst[dsto + j] = np.float32(
                    min(1.0, max(-1.0, float(s))))

        frame.prev_voiced = voiced
        fl = self.flength
        frame.lpc_history[:SILK_HISTORY] = \
            frame.lpc_history[fl:fl + SILK_HISTORY]
        frame.output[:SILK_HISTORY] = \
            frame.output[fl:fl + SILK_HISTORY]
        frame.coded = 1

    def _unmix_ms(self, l_out, r_out):
        fl = self.flength
        mid = self.frame[0].output
        side = self.frame[1].output
        mo = SILK_HISTORY - fl
        so = SILK_HISTORY - fl
        w0p, w1p = self.prev_stereo_weights
        w0, w1 = self.stereo_weights
        n1 = ST.STEREO_INTERP_LEN[self.bandwidth]
        for i in range(n1):
            i0 = w0p + i * (w0 - w0p) / n1
            i1 = w1p + i * (w1 - w1p) / n1
            p0 = 0.25 * (mid[mo + i - 2] + 2 * mid[mo + i - 1]
                         + mid[mo + i])
            l_out[i] = min(1.0, max(-1.0, (1 + i1) * mid[mo + i - 1]
                                    + side[so + i - 1] + i0 * p0))
            r_out[i] = min(1.0, max(-1.0, (1 - i1) * mid[mo + i - 1]
                                    - side[so + i - 1] - i0 * p0))
        for i in range(n1, fl):
            p0 = 0.25 * (mid[mo + i - 2] + 2 * mid[mo + i - 1]
                         + mid[mo + i])
            l_out[i] = min(1.0, max(-1.0, (1 + w1) * mid[mo + i - 1]
                                    + side[so + i - 1] + w0 * p0))
            r_out[i] = min(1.0, max(-1.0, (1 - w1) * mid[mo + i - 1]
                                    - side[so + i - 1] - w0 * p0))
        self.prev_stereo_weights = list(self.stereo_weights)

    def decode_superframe(self, rc, bandwidth, coded_channels,
                          duration_ms):
        """Decode one SILK superframe; returns [out_ch, n] float32 at
        the internal rate (silk.c ff_silk_decode_superframe)."""
        if bandwidth > 2 or coded_channels > 2 or duration_ms > 60:
            raise ValueError("silk: invalid parameters")
        nb_frames = 1 + (duration_ms > 20) + (duration_ms > 40)
        self.subframes = duration_ms // nb_frames // 5
        self.sflength = 20 * (bandwidth + 2)
        self.flength = self.sflength * self.subframes
        self.bandwidth = bandwidth
        self.wb = 1 if bandwidth == 2 else 0
        if coded_channels > self.prev_coded_channels:
            self.frame[1].flush()
        self.prev_coded_channels = coded_channels

        active = [[0] * 6, [0] * 6]
        redundancy = [0, 0]
        for i in range(coded_channels):
            for j in range(nb_frames):
                active[i][j] = rc.dec_log(1)
            redundancy[i] = rc.dec_log(1)
        for i in range(coded_channels):
            if redundancy[i] and duration_ms > 20:
                redundancy[i] = rc.dec_cdf(
                    ST.MODEL_LBRR_FLAGS_40 if duration_ms == 40
                    else ST.MODEL_LBRR_FLAGS_60)
        # LBRR frames: fully parsed, output discarded
        for i in range(nb_frames):
            for j in range(coded_channels):
                if redundancy[j] & (1 << i):
                    active1 = 0 if (j == 0
                                    and not (redundancy[1] & (1 << i))
                                    ) else 1
                    self._decode_frame(rc, i, j, coded_channels, 1,
                                       active1, 1)
            self.midonly = 0

        out = np.zeros((self.output_channels,
                        nb_frames * self.flength), np.float32)
        for i in range(nb_frames):
            for j in range(coded_channels):
                if self.midonly and j == 1:
                    break
                active1 = active[1][i] if coded_channels > 1 else 0
                self._decode_frame(rc, i, j, coded_channels,
                                   active[j][i], active1, 0)
            if self.midonly and self.frame[1].coded:
                self.frame[1].flush()
            fl = self.flength
            if coded_channels == 1 or self.output_channels == 1:
                seg = self.frame[0].output[
                    SILK_HISTORY - fl - 2:SILK_HISTORY - 2]
                for j in range(self.output_channels):
                    out[j, i * fl:(i + 1) * fl] = seg
            else:
                self._unmix_ms(out[0, i * fl:(i + 1) * fl],
                               out[1, i * fl:(i + 1) * fl])
            self.midonly = 0
        return out


def _ctrunc_div(a: int, b: int) -> int:
    """C truncating integer division."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q
