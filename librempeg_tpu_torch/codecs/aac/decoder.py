"""AAC-LC decoder.

Port of librempeg_tpu/codecs/aac/decoder.py. The bitstream parse, the
inverse quantisation, M/S and intensity stereo, TNS and the windowed
overlap-add are host copies; each channel's IMDCT runs on `device`
(tx.imdct, one float32 product) with one fetch per call, and each
decoded frame is uploaded to `device`. Analog of libavcodec/aac/aacdec.c's LC profile path:
ADTS framing, SCE/CPE, all four window sequences (ONLY_LONG,
LONG_START, EIGHT_SHORT with window grouping, LONG_STOP), sine + KBD
window shapes with cross-frame shape tracking, all spectral codebooks
1-11 (+ESC), scalefactor delta decoding, M/S stereo, inverse quant,
device IMDCT + overlap-add. TNS and PNS are round-2 scope (rejected
explicitly, not silently).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from librempeg_tpu_torch.codecs.aac import tables_data as T
from librempeg_tpu_torch.codecs.api import CodecInfo, Decoder, register_decoder
from librempeg_tpu_torch.codecs.flac.bitio import BitReaderMSB
from librempeg_tpu_torch.core.errors import InvalidData, Unsupported
from librempeg_tpu_torch.core.frame import AudioFrame
from librempeg_tpu_torch.core.packet import Packet
from librempeg_tpu_torch.core.rational import Rational
from librempeg_tpu_torch.core.samplefmt import ChannelLayout
from librempeg_tpu_torch.device import resolve
from librempeg_tpu_torch.ops import tx

FRAME = 1024
SF_OFFSET = 100


class _Vlc:
    def __init__(self, codes, bits):
        self.lut = {}
        self.max_len = 0
        for i, (c, ln) in enumerate(zip(codes, bits)):
            self.lut[(ln, c)] = i
            self.max_len = max(self.max_len, ln)

    def read(self, br: BitReaderMSB) -> int:
        code = 0
        for ln in range(1, self.max_len + 1):
            code = (code << 1) | br.read(1)
            sym = self.lut.get((ln, code))
            if sym is not None:
                return sym
        raise InvalidData("AAC: invalid huffman code")


_SCF_VLC = _Vlc(T.SCF_CODES, T.SCF_BITS)
_SPEC_VLC = [_Vlc(T.SPECTRAL_CODES[i], T.SPECTRAL_BITS[i])
             for i in range(11)]

# codebook properties: (dimension, LAV, signed)
_CB_PROPS = {1: (4, 1, True), 2: (4, 1, True), 3: (4, 2, False),
             4: (4, 2, False), 5: (2, 4, True), 6: (2, 4, True),
             7: (2, 7, False), 8: (2, 7, False), 9: (2, 12, False),
             10: (2, 12, False), 11: (2, 16, False)}


def _decode_cb_values(br: BitReaderMSB, cb: int, n: int) -> np.ndarray:
    """Decode n spectral values with codebook cb."""
    dim, lav, signed = _CB_PROPS[cb]
    vlc = _SPEC_VLC[cb - 1]
    mod = 2 * lav + 1 if signed else lav + 1
    off = lav if signed else 0
    out = np.zeros(n, np.int64)
    i = 0
    while i < n:
        idx = vlc.read(br)
        vals = []
        for d in range(dim - 1, -1, -1):
            vals.append((idx // (mod ** d)) % mod - off)
        if not signed:
            for k in range(dim):
                if vals[k]:
                    if br.read(1):
                        vals[k] = -vals[k]
        if cb == 11:
            for k in range(dim):
                if abs(vals[k]) == 16:
                    nbits = 4
                    while br.read(1):
                        nbits += 1
                    esc = br.read(nbits)
                    mag = (1 << nbits) + esc
                    vals[k] = -mag if vals[k] < 0 else mag
        out[i:i + dim] = vals[:n - i]
        i += dim
    return out


def _parse_ics_info(br: BitReaderMSB):
    """-> (seq, shape, max_sfb, window_groups) — groups is a list of
    window counts (length 1 for long sequences)."""
    br.read(1)                    # ics_reserved
    seq = br.read(2)
    shape = br.read(1)
    if seq == 2:
        max_sfb = br.read(4)
        grouping = br.read(7)
        groups = [1]
        for b in range(6, -1, -1):
            if (grouping >> b) & 1:
                groups[-1] += 1
            else:
                groups.append(1)
        return seq, shape, max_sfb, groups
    max_sfb = br.read(6)
    if br.read(1):
        raise Unsupported("AAC: predictor data")
    return seq, shape, max_sfb, [1]


def _tns_coef(code: int, res_bits: int, compress: int) -> float:
    """Inverse-quantized TNS reflection coefficient (§4.6.9.3): matches
    the reference's tns_tmp2_map tables exactly."""
    n = 1 << (res_bits - compress)
    half = n >> 1
    iqfac = ((1 << (res_bits - 1)) - 0.5) / (math.pi / 2.0)
    iqfac_m = ((1 << (res_bits - 1)) + 0.5) / (math.pi / 2.0)
    if code == 0:
        return 0.0
    if code < half:
        return -math.sin(code / iqfac)
    return math.sin((n - code) / iqfac_m)


def _parse_tns(br: BitReaderMSB, short: bool):
    """tns_data() -> per-window list of (length, order, direction,
    lpc[order]) filters."""
    nwin = 8 if short else 1
    lbits, obits, fbits = (4, 3, 1) if short else (6, 5, 2)
    out = []
    for _ in range(nwin):
        filters = []
        n_filt = br.read(fbits)
        coef_res = br.read(1) if n_filt else 0
        for _ in range(n_filt):
            length = br.read(lbits)
            order = br.read(obits)
            if order:
                direction = br.read(1)
                compress = br.read(1)
                bits = coef_res + 3 - compress
                refl = [_tns_coef(br.read(bits), coef_res + 3, compress)
                        for _ in range(order)]
                # reflection -> direct-form LPC (§4.6.9.3 conversion)
                lpc = [0.0] * (order + 1)
                lpc[0] = 1.0
                for m in range(1, order + 1):
                    b = [lpc[i] + refl[m - 1] * lpc[m - i]
                         for i in range(1, m)]
                    lpc[1:m] = b
                    lpc[m] = refl[m - 1]
            else:
                direction, lpc = 0, [1.0]
            filters.append((length, order, direction, lpc))
        out.append(filters)
    return out


def _tns_apply(spec: np.ndarray, tns, max_sfb: int, bands: list[int],
               max_band: int) -> None:
    """All-pole TNS synthesis filtering over the coded band ranges
    (aacdec.c apply_tns, decode direction). spec is [1024] or [8,128]."""
    wins = spec if spec.ndim == 2 else spec[None, :]
    nbins = wins.shape[1]
    for w in range(wins.shape[0]):
        bottom = len(bands) - 1
        for (length, order, direction, lpc) in tns[w % len(tns)]:
            top = bottom
            bottom = max(0, top - length)
            order = min(order, 20)
            if not order:
                continue
            lo = bands[min(bottom, max_band, max_sfb)]
            hi = min(bands[min(top, max_band, max_sfb)], nbins)
            if hi <= lo:
                continue
            x = wins[w]
            idxs = range(hi - 1, lo - 1, -1) if direction else \
                range(lo, hi)
            step = -1 if direction else 1
            for i in idxs:
                acc = x[i]
                for j in range(1, order + 1):
                    k = i - step * j
                    if (lo <= k < hi):
                        acc -= lpc[j] * x[k]
                x[i] = acc


def _decode_ics(br: BitReaderMSB, global_gain: int, max_sfb: int,
                swb: list[int], groups: list[int] | None = None
                ) -> np.ndarray:
    """Decode one individual_channel_stream. For long sequences returns
    [FRAME]; for EIGHT_SHORT (groups with >1 total windows) returns
    [8, 128] window spectra."""
    if groups is None:
        groups = [1]
    short = sum(groups) > 1
    ngroups = len(groups)
    nbands = ngroups * max_sfb
    # section data: run-length bits are 3 for short windows, 5 for long;
    # sections never cross group boundaries
    cbs = np.zeros(nbands, np.int32)
    rbits = 3 if short else 5
    esc = (1 << rbits) - 1
    for g in range(ngroups):
        b = 0
        while b < max_sfb:
            cb = br.read(4)
            run = 0
            while True:
                r = br.read(rbits)
                run += r
                if r != esc:
                    break
            for i in range(b, min(b + run, max_sfb)):
                cbs[g * max_sfb + i] = cb
            b += run
            if run == 0:
                raise InvalidData("AAC: zero-length section")
    # scalefactors: DPCM from global_gain; noise (PNS, cb 13) runs its
    # own chain seeded at global_gain-90 with a 9-bit PCM first delta
    sfs = np.zeros(nbands, np.int32)
    sf = global_gain
    sf_noise = global_gain - 90
    sf_is = 0
    noise_first = True
    for i in range(nbands):
        if cbs[i] == 0:
            continue
        if cbs[i] == 13:             # NOISE_BT
            if noise_first:
                sf_noise += br.read(9) - 256
                noise_first = False
            else:
                sf_noise += _SCF_VLC.read(br) - 60
            sfs[i] = sf_noise
            continue
        if cbs[i] in (14, 15):      # intensity: own chain from 0
            sf_is += _SCF_VLC.read(br) - 60
            sfs[i] = sf_is
            continue
        sf += _SCF_VLC.read(br) - 60
        sfs[i] = sf
    # pulse/tns/gain
    if br.read(1):
        raise Unsupported("AAC: pulse data")
    tns = _parse_tns(br, short) if br.read(1) else None
    if br.read(1):
        raise Unsupported("AAC: gain control")
    # spectral data
    rng = np.random.default_rng(1234)

    def band_values(cb, n, sf):
        if cb == 13:                 # PNS: random vector, band L2 norm
            noise = rng.standard_normal(n)
            norm = np.sqrt(np.sum(noise ** 2)) or 1.0
            return noise / norm * 2.0 ** ((sf - SF_OFFSET) / 4.0)
        q = _decode_cb_values(br, cb, n)
        step = 2.0 ** ((sf - SF_OFFSET) / 4.0)
        return np.sign(q) * np.abs(q).astype(np.float64) ** (4 / 3) * step

    if not short:
        spec = np.zeros(FRAME, np.float64)
        for i in range(nbands):
            lo, hi = swb[i], swb[i + 1]
            cb = int(cbs[i])
            if cb == 0 or cb in (14, 15):   # IS bands carry no spectrum
                continue
            spec[lo:hi] = band_values(cb, hi - lo, int(sfs[i]))
        return spec, cbs, sfs, tns
    # EIGHT_SHORT: per group, band values are window-interleaved
    spec = np.zeros((8, 128), np.float64)
    win0 = 0
    for g, glen in enumerate(groups):
        for i in range(max_sfb):
            lo, hi = swb[i], swb[i + 1]
            idx = g * max_sfb + i
            cb = int(cbs[idx])
            if cb == 0 or cb in (14, 15):
                continue
            vals = band_values(cb, (hi - lo) * glen, int(sfs[idx]))
            spec[win0:win0 + glen, lo:hi] = vals.reshape(glen, hi - lo)
        win0 += glen
    return spec, cbs, sfs, tns


class AacFrameDecoder:
    def __init__(self, device="cuda"):
        self.device = resolve(device)
        self.overlap: dict[int, np.ndarray] = {}
        self.prev_shape: dict[int, int] = {}
        self.rate = 44100
        self.channels = 2
        self.sbr: dict[tuple, object] = {}   # (ele, tag) -> Sbr
        self.sbr_active = False

    def decode_adts(self, data: bytes):
        if len(data) < 7 or data[0] != 0xFF or (data[1] & 0xF0) != 0xF0:
            raise InvalidData("AAC: bad ADTS sync")
        no_crc = data[1] & 1
        rate_idx = (data[2] >> 2) & 0xF
        channels = ((data[2] & 1) << 2) | (data[3] >> 6)
        self.rate = T.SAMPLE_RATES[rate_idx]
        self.channels = channels
        hdr = 7 if no_crc else 9
        br = BitReaderMSB(data[hdr:])
        swb = list(T.SWB_OFFSET_1024[rate_idx])
        if swb[-1] != FRAME:
            swb = swb + [FRAME]
        swb128 = list(T.SWB_OFFSET_128[rate_idx])
        if swb128[-1] != 128:
            swb128 = swb128 + [128]
        tns_max = (T.TNS_MAX_BANDS_1024[rate_idx],
                   T.TNS_MAX_BANDS_128[rate_idx])
        return self._raw_data_block(br, swb, swb128, tns_max)

    def decode_raw(self, data: bytes, rate_idx: int, channels: int):
        """Raw AAC frame (mp4/flv payload: no ADTS header; config comes
        from the AudioSpecificConfig extradata)."""
        self.rate = T.SAMPLE_RATES[rate_idx]
        self.channels = channels
        br = BitReaderMSB(data)
        swb = list(T.SWB_OFFSET_1024[rate_idx])
        if swb[-1] != FRAME:
            swb = swb + [FRAME]
        swb128 = list(T.SWB_OFFSET_128[rate_idx])
        if swb128[-1] != 128:
            swb128 = swb128 + [128]
        tns_max = (T.TNS_MAX_BANDS_1024[rate_idx],
                   T.TNS_MAX_BANDS_128[rate_idx])
        return self._raw_data_block(br, swb, swb128, tns_max)

    def _raw_data_block(self, br: BitReaderMSB, swb, swb128, tns_max):
        specs = []                  # (spec, seq, shape)

        def apply_ms(s0, s1, mask, bands, glen_list):
            gi = 0
            for g, glen in enumerate(glen_list):
                for i in range(len(bands) - 1):
                    if mask[g * (len(bands) - 1) + i]:
                        lo, hi = bands[i], bands[i + 1]
                        if s0.ndim == 1:
                            m = s0[lo:hi].copy()
                            sd = s1[lo:hi].copy()
                            s0[lo:hi] = m + sd
                            s1[lo:hi] = m - sd
                        else:
                            m = s0[gi:gi + glen, lo:hi].copy()
                            sd = s1[gi:gi + glen, lo:hi].copy()
                            s0[gi:gi + glen, lo:hi] = m + sd
                            s1[gi:gi + glen, lo:hi] = m - sd
                gi += glen

        elements = []                 # (kind, key, n_specs_before)
        while True:
            ele = br.read(3)
            if ele == 7:              # END
                break
            if ele == 6:              # FIL: 4-bit count (no instance tag)
                cnt = br.read(4)
                if cnt == 15:
                    cnt += br.read(8) - 1
                end_pos = br.pos + 8 * cnt
                if cnt and elements:
                    ext_type = br.read(4)
                    if ext_type in (13, 14):   # EXT_SBR_DATA(_CRC)
                        from librempeg_tpu_torch.codecs.aac.sbr import Sbr

                        kind, key, _ = elements[-1]
                        sbr = self.sbr.get(key)
                        if sbr is None:
                            sbr = self.sbr[key] = Sbr()
                        self.sbr_active = True
                        try:
                            sbr.decode_extension(
                                br, kind, ext_type == 14, self.rate)
                        except (InvalidData, IndexError):
                            sbr._turnoff()
                br.pos = end_pos
                continue
            tag = br.read(4)          # instance tag
            if ele in (0, 1):
                elements.append(
                    ("SCE" if ele == 0 else "CPE", (ele, tag),
                     len(specs)))
            if ele == 0:              # SCE
                gg = br.read(8)
                seq, shape, max_sfb, groups = _parse_ics_info(br)
                bands = swb128 if seq == 2 else swb
                spec, _, _, tns = _decode_ics(br, gg, max_sfb, bands,
                                              groups)
                if tns:
                    _tns_apply(spec, tns, max_sfb, bands,
                               tns_max[1] if seq == 2 else tns_max[0])
                specs.append((spec, seq, shape))
            elif ele == 1:            # CPE
                common = br.read(1)
                if not common:
                    raise Unsupported("AAC: CPE without common_window")
                seq, shape, max_sfb, groups = _parse_ics_info(br)
                bands = swb128 if seq == 2 else swb
                ms = br.read(2)
                n = len(groups) * max_sfb
                ms_mask = None
                if ms == 1:
                    ms_mask = [br.read(1) for _ in range(n)]
                elif ms == 2:
                    ms_mask = [1] * n
                gg0 = br.read(8)
                s0, _, _, tns0 = _decode_ics(br, gg0, max_sfb, bands,
                                             groups)
                gg1 = br.read(8)
                s1, cbs1, sfs1, tns1 = _decode_ics(br, gg1, max_sfb,
                                                   bands, groups)
                is_band = [int(c) in (14, 15) for c in cbs1]
                if ms_mask:
                    mask = [m and not is_band[i]
                            for i, m in enumerate(ms_mask)]
                    apply_ms(s0, s1, mask, bands[:max_sfb + 1], groups)
                # intensity stereo: right band is a scaled copy of left
                gi = 0
                for g, glen in enumerate(groups):
                    for i in range(max_sfb):
                        idx = g * max_sfb + i
                        if not is_band[idx]:
                            continue
                        d = 1.0 if int(cbs1[idx]) == 15 else -1.0
                        if ms_mask and ms_mask[idx]:
                            d = -d
                        sc = d * 2.0 ** (-0.25 * int(sfs1[idx]))
                        lo, hi = bands[i], bands[i + 1]
                        if s0.ndim == 1:
                            s1[lo:hi] = sc * s0[lo:hi]
                        else:
                            s1[gi:gi + glen, lo:hi] = \
                                sc * s0[gi:gi + glen, lo:hi]
                    gi += glen
                mb = tns_max[1] if seq == 2 else tns_max[0]
                if tns0:
                    _tns_apply(s0, tns0, max_sfb, bands, mb)
                if tns1:
                    _tns_apply(s1, tns1, max_sfb, bands, mb)
                specs.append((s0, seq, shape))
                specs.append((s1, seq, shape))
            else:
                raise Unsupported(f"AAC: element type {ele}")
        out = np.zeros((len(specs), FRAME), np.float32)
        for c, (spec, seq, shape) in enumerate(specs):
            out[c] = self._reconstruct(c, spec, seq, shape)
        if self.sbr_active:
            # HE-AAC: every SBR element upsamples 2x (aacdec.c
            # spectral_to_sample -> ff_aac_sbr_apply). SBR takes the
            # +-1-scaled core samples (the QMF analysis scale factor
            # supplies the +-32768 internal scaling, aacsbr_template.c
            # ctx init comment) and returns +-1 output.
            up = np.zeros((len(specs), 2 * FRAME), np.float32)
            for kind, key, c0 in elements:
                nch = 2 if kind == "CPE" else 1
                sbr = self.sbr.get(key)
                if sbr is None:
                    raise Unsupported("AAC: mixed SBR/non-SBR elements")
                res = sbr.apply(kind, [out[c0 + i] / 32768.0
                                       for i in range(nch)])
                for i in range(nch):
                    up[c0 + i] = res[i]
            return up
        return out / 32768.0

    # -- windowing / overlap-add -------------------------------------
    @staticmethod
    def _half(shape: int, n: int, rising: bool) -> np.ndarray:
        """Rising/falling half (length n) of a 2n analysis window.
        kbd_window(n) IS the rising half of a 2n KBD window (cumsum of
        an n-term Kaiser kernel); both shapes are symmetric."""
        if shape:
            w = tx.kbd_window(n, 4.0 if n >= 1024 else 6.0)
        else:
            w = tx.sine_window(2 * n)[:n]
        return w if rising else w[::-1]

    def _imdct(self, spec: np.ndarray) -> np.ndarray:
        """tx.imdct of float32(spec) on the device, fetched as float64."""
        x = torch.from_numpy(spec.astype(np.float32)).to(self.device)
        return tx.imdct(x).cpu().numpy().astype(np.float64)

    def _reconstruct(self, c: int, spec, seq: int, shape: int):
        prev_shape = self.prev_shape.get(c, shape)
        buf = np.zeros(2 * FRAME)
        if seq == 2:                 # EIGHT_SHORT
            t = self._imdct(spec)      # tx.imdct gain is length-invariant
            for w in range(8):
                rise = self._half(prev_shape if w == 0 else shape,
                                  128, True)
                fall = self._half(shape, 128, False)
                seg = t[w] * np.concatenate([rise, fall])
                o = 448 + 128 * w
                buf[o:o + 256] += seg
        else:
            t = self._imdct(spec[None, :])[0]
            if seq == 3:             # LONG_STOP: short rise at 448
                left = np.concatenate([
                    np.zeros(448), self._half(prev_shape, 128, True),
                    np.ones(448)])
            else:
                left = self._half(prev_shape, 1024, True)
            if seq == 1:             # LONG_START: short fall at 1472
                right = np.concatenate([
                    np.ones(448), self._half(shape, 128, False),
                    np.zeros(448)])
            else:
                right = self._half(shape, 1024, False)
            buf[:FRAME] = t[:FRAME] * left
            buf[FRAME:] = t[FRAME:] * right
        prev = self.overlap.get(c, np.zeros(FRAME))
        out = (prev + buf[:FRAME]) / 2.0
        self.overlap[c] = buf[FRAME:]
        self.prev_shape[c] = shape
        return out.astype(np.float32)


@register_decoder
class AacDecoder(Decoder):
    INFO = CodecInfo(name="aac", long_name="AAC (Advanced Audio Coding) LC",
                     codec_type="audio")
    #: the sample format of the frames it returns
    sample_fmt = "fltp"

    def __init__(self, params=None, device="cuda", **opts):
        self._dec = AacFrameDecoder(device)
        self._pts = 0
        self._asc = None          # (rate_idx, channels) from extradata
        super().__init__(params, **opts)

    def configure(self, params):
        asc = bytes(params.extradata or b"")
        if len(asc) >= 2:
            obj = asc[0] >> 3
            rate_idx = ((asc[0] & 7) << 1) | (asc[1] >> 7)
            channels = (asc[1] >> 3) & 15
            if obj in (1, 2) and rate_idx < 13:
                self._asc = (rate_idx, channels or params.nb_channels or 2)

    def decode(self, pkt: Packet):
        data = bytes(pkt.data)
        if self._asc is not None and not (
                len(data) >= 2 and data[0] == 0xFF
                and (data[1] & 0xF0) == 0xF0):
            pcm = self._dec.decode_raw(data, *self._asc)
        else:
            pcm = self._dec.decode_adts(data)
        # HE-AAC: SBR doubles the output rate (2048 samples/frame)
        rate = self._dec.rate * (pcm.shape[1] // FRAME)
        f = AudioFrame(
            data=torch.from_numpy(pcm).to(self._dec.device),
            sample_rate=rate, sample_fmt="fltp",
            layout=ChannelLayout.default(pcm.shape[0]),
            pts=pkt.pts if pkt.pts >= 0 else self._pts,
            time_base=Rational(1, rate))
        self._pts += pcm.shape[1]
        return [f]
