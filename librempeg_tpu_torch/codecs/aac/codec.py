"""AAC-LC encoder (long windows) + ADTS framing.

Port of librempeg_tpu/codecs/aac/codec.py (analog of libavcodec's
aacenc.c + aaccoder.c twoloop): ONLY_LONG window sequence, sine
windows, per-band scalefactors under the psy model's masking
thresholds, Huffman spectral coding, CPE stereo, a one-pass rate loop.

Split: the pending samples stay on `device`; each frame is windowed
there in the JAX package's float32 order (buf * win * 65536) and goes
through tx.mdct (one float32 product), and its [channels, 1024]
spectrum is fetched in one .cpu(). The psy model, the quantiser, the
rate loop, the Huffman coder and the ADTS header are host copies. The
HE-AAC fill payload (the JAX package's SBR stream generator) is not
carried.
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.codecs.aac import tables_data as T
from librempeg_tpu_torch.codecs.api import CodecInfo, Encoder, register_encoder
from librempeg_tpu_torch.codecs.flac.bitio import BitWriterMSB
from librempeg_tpu_torch.core.errors import Unsupported
from librempeg_tpu_torch.core.frame import AudioFrame
from librempeg_tpu_torch.core.options import Option, OptionTable
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import Rational
from librempeg_tpu_torch.device import resolve
from librempeg_tpu_torch.ops import tx
from librempeg_tpu_torch.utils.stagetimer import stage

FRAME = 1024
SF_OFFSET = 100


def _rate_index(rate: int) -> int:
    try:
        return T.SAMPLE_RATES.index(rate)
    except ValueError:
        raise Unsupported(f"AAC: unsupported sample rate {rate}")


def quantize_band(x: np.ndarray, sf: int) -> np.ndarray:
    """Spec quantizer: q = floor(|x/step|^0.75 + 0.4054), step=2^((sf-100)/4)."""
    step = 2.0 ** ((sf - SF_OFFSET) / 4.0)
    q = np.floor(np.abs(x / step) ** 0.75 + 0.4054)
    return (np.sign(x) * np.minimum(q, 8191)).astype(np.int32)


def dequantize_band(q: np.ndarray, sf: int) -> np.ndarray:
    step = 2.0 ** ((sf - SF_OFFSET) / 4.0)
    return np.sign(q) * np.abs(q).astype(np.float64) ** (4.0 / 3.0) * step


def _escape_value(bw: BitWriterMSB, v: int) -> None:
    """Codebook-11 escape sequence for |v| >= 16."""
    n = v.bit_length() - 1          # v in [2^n, 2^(n+1))
    for _ in range(n - 4):
        bw.write(1, 1)
    bw.write(0, 1)
    bw.write(v - (1 << n), n)


def _encode_band_cb11(bw: BitWriterMSB, q: np.ndarray) -> None:
    """Spectral pairs with codebook 11 (unsigned, LAV 16 w/ escape)."""
    codes, bits = T.CODES_11, T.BITS_11
    for i in range(0, len(q), 2):
        a, b = int(q[i]), int(q[i + 1])
        ua, ub = min(abs(a), 16), min(abs(b), 16)
        idx = ua * 17 + ub
        bw.write(codes[idx], bits[idx])
        if a:
            bw.write(1 if a < 0 else 0, 1)
        if b:
            bw.write(1 if b < 0 else 0, 1)
        if ua == 16:
            _escape_value(bw, abs(a))
        if ub == 16:
            _escape_value(bw, abs(b))


def pick_codebook(maxabs: int) -> int:
    """Smallest codebook covering the band's max magnitude
    (aaccoder's find-min-book role)."""
    if maxabs == 0:
        return 0
    if maxabs <= 1:
        return 2
    if maxabs <= 2:
        return 4
    if maxabs <= 4:
        return 6
    if maxabs <= 7:
        return 8
    if maxabs <= 12:
        return 10
    return 11


def _encode_band(bw: BitWriterMSB, q: np.ndarray, cb: int) -> None:
    """Huffman-encode one band's quantized values with codebook cb."""
    if cb == 11:
        _encode_band_cb11(bw, q)
        return
    codes = T.SPECTRAL_CODES[cb - 1]
    bits = T.SPECTRAL_BITS[cb - 1]
    signed = cb in (1, 2, 5, 6)
    dim = 4 if cb <= 4 else 2
    lav = {1: 1, 2: 1, 3: 2, 4: 2, 5: 4, 6: 4, 7: 7, 8: 7,
           9: 12, 10: 12}[cb]
    mod = 2 * lav + 1 if signed else lav + 1
    off = lav if signed else 0
    pad = (-len(q)) % dim
    if pad:
        q = np.concatenate([q, np.zeros(pad, q.dtype)])
    for i in range(0, len(q), dim):
        vals = [int(v) for v in q[i:i + dim]]
        idx = 0
        for v in vals:
            idx = idx * mod + ((v + off) if signed else abs(v))
        bw.write(codes[idx], bits[idx])
        if not signed:
            for v in vals:
                if v:
                    bw.write(1 if v < 0 else 0, 1)


class _ChannelCoder:
    """Per-channel spectral coding state for one frame.

    Noise shaping (aaccoder.c twoloop role): per band, the largest
    scalefactor whose measured quantization distortion stays under the
    psy model's masking threshold -- i.e. the cheapest quantization
    that keeps the noise inaudible. The encoder's outer loop scales the
    thresholds uniformly to meet the bit budget."""

    def __init__(self, spec: np.ndarray, swb_offsets: list[int],
                 thr: np.ndarray, bw_frac: float = 1.0):
        self.offsets = swb_offsets
        nbands = len(swb_offsets) - 1
        keep = max(4, int(round(nbands * bw_frac)))
        self.sfs = np.zeros(nbands, np.int32)
        self.cbs = np.zeros(nbands, np.int32)
        self.quant: list[np.ndarray] = []
        for b in range(nbands):
            lo, hi = swb_offsets[b], swb_offsets[b + 1]
            band = spec[lo:hi]
            en = float(np.dot(band, band)) if hi > lo else 0.0
            if b >= keep or en <= thr[b]:
                # zeroing noise is already below the mask
                self.sfs[b] = SF_OFFSET
                self.cbs[b] = 0
                self.quant.append(np.zeros(hi - lo, np.int32))
                continue
            # smallest legal sf: |q|max <= 8191 (quantize_band clips,
            # so saturation is detected from the band peak directly)
            amax = float(np.max(np.abs(band)))
            sf_min = max(0, SF_OFFSET + int(np.ceil(
                4.0 * np.log2(max(amax, 1e-9)
                              / (8191.0 - 0.5) ** (4.0 / 3.0)))))
            # binary search the largest sf with distortion <= threshold
            lo_sf, hi_sf = sf_min, 255
            best_sf, best_q = None, None
            while lo_sf <= hi_sf:
                mid = (lo_sf + hi_sf) // 2
                q = quantize_band(band, mid)
                d = band - dequantize_band(q, mid)
                if float(np.dot(d, d)) <= thr[b]:
                    best_sf, best_q = mid, q
                    lo_sf = mid + 1
                else:
                    hi_sf = mid - 1
            if best_sf is None:         # even the finest legal sf fails
                best_sf = sf_min
                best_q = quantize_band(band, sf_min)
            q = best_q
            sf = best_sf
            if not np.any(q):
                self.sfs[b] = SF_OFFSET
                self.cbs[b] = 0
                self.quant.append(q)
                continue
            self.sfs[b] = sf
            self.cbs[b] = pick_codebook(int(np.max(np.abs(q))))
            self.quant.append(q)
        # the scf codebook carries deltas in [-60, 60]: clamp every
        # coded band into [min_sf, min_sf + 60] (coarsening a quiet
        # band only ever LOWERS its sf here, so distortion shrinks and
        # the masking condition still holds)
        coded = [b for b in range(nbands) if self.cbs[b]]
        if coded:
            min_sf = min(int(self.sfs[b]) for b in coded)
            for b in coded:
                if int(self.sfs[b]) > min_sf + 60:
                    self.sfs[b] = min_sf + 60
                    lo, hi = swb_offsets[b], swb_offsets[b + 1]
                    self.quant[b] = quantize_band(spec[lo:hi],
                                                  int(self.sfs[b]))
                    if not np.any(self.quant[b]):
                        self.cbs[b] = 0
                        self.sfs[b] = SF_OFFSET
                        continue
                    self.cbs[b] = pick_codebook(
                        int(np.max(np.abs(self.quant[b]))))
        self.global_gain = int(next(
            (self.sfs[b] for b in range(nbands) if self.cbs[b]), SF_OFFSET))

    def write_ics(self, bw: BitWriterMSB, max_sfb: int) -> None:
        nbands = max_sfb
        # section_data: runs of equal codebook
        b = 0
        while b < nbands:
            cb = int(self.cbs[b])
            run = 1
            while b + run < nbands and int(self.cbs[b + run]) == cb:
                run += 1
            bw.write(cb, 4)
            r = run
            while r >= 31:
                bw.write(31, 5)
                r -= 31
            bw.write(r, 5)
            b += run
        # scale_factor_data: delta-coded from global_gain
        prev = self.global_gain
        for b in range(nbands):
            if self.cbs[b] == 0:
                continue
            d = int(self.sfs[b]) - prev
            prev = int(self.sfs[b])
            bw.write(T.SCF_CODES[d + 60], T.SCF_BITS[d + 60])
        # no pulse, no tns, no gain control
        bw.write(0, 1)
        bw.write(0, 1)
        bw.write(0, 1)
        # spectral_data
        for b in range(nbands):
            if self.cbs[b]:
                _encode_band(bw, self.quant[b], int(self.cbs[b]))


@register_encoder
class AacEncoder(Encoder):
    INFO = CodecInfo(name="aac", long_name="AAC (Advanced Audio Coding) LC",
                     codec_type="audio")
    OPTIONS = OptionTable(
        Option("aac_quality", float, 14.0, min=1.0, max=60.0,
               help="per-band max quantized magnitude target"),
        Option("bit_rate", int, 0, alias="b", min=0, max=1 << 26,
               help="target bitrate (bits/s); 0 = constant quality"),
        Option("adts", bool, True, help="emit ADTS frames (vs raw)"),
    )

    def __init__(self, sample_rate=44100, channels=2, device="cuda", **opts):
        super().__init__(**opts)
        if channels not in (1, 2):
            raise Unsupported("AAC: mono or stereo only (round 1)")
        self.device = resolve(device)
        self.sample_rate = sample_rate
        self.channels = channels
        self.rate_idx = _rate_index(sample_rate)
        self.time_base = Rational(1, sample_rate)
        self._hist = torch.zeros((channels, FRAME), dtype=torch.float32,
                                 device=self.device)
        self._pend = torch.zeros((channels, 0), dtype=torch.float32,
                                 device=self.device)
        self._frame_no = 0
        swb = list(T.SWB_OFFSET_1024[self.rate_idx])
        if swb[-1] != FRAME:
            swb = swb + [FRAME]
        self.swb = swb
        self.max_sfb = len(swb) - 1
        self._win = torch.from_numpy(
            tx.sine_window(2 * FRAME).astype(np.float32)).to(self.device)
        # reactive rate control (ratecontrol.c one-pass role): the
        # quality knob (max quantized magnitude) drives bits/frame
        self._rc_q = float(self.opts["aac_quality"])
        self._rc_buffer = 0.0
        self._psy = None          # lazy PsyModel
        #: bytes of an SBR extension payload to carry in a FIL element
        #: of every frame coded while it is set (generate_he_stream)
        self.fill_payload = None

    def codec_parameters(self):
        from librempeg_tpu_torch.formats.api import CodecParameters

        return CodecParameters(
            codec_type="audio", codec_id="aac",
            sample_rate=self.sample_rate, nb_channels=self.channels,
            frame_size=FRAME)

    # -- encoding -----------------------------------------------------
    def encode(self, frame: AudioFrame):
        from librempeg_tpu_torch.codecs.pcm import to_float

        x = frame.data
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = to_float(x.to(self.device), frame.sample_fmt)
        self._pend = torch.cat([self._pend, x], dim=1)
        out = []
        while self._pend.shape[1] >= FRAME:
            blk = self._pend[:, :FRAME]
            self._pend = self._pend[:, FRAME:]
            out.append(self._encode_frame(blk))
        return out

    def flush(self):
        out = []
        if self._pend.shape[1]:
            pad = FRAME - self._pend.shape[1]
            blk = torch.nn.functional.pad(self._pend, (0, pad))
            self._pend = self._pend.new_zeros((self.channels, 0))
            out.append(self._encode_frame(blk))
        # one trailing frame to flush the MDCT overlap
        out.append(self._encode_frame(self._hist.new_zeros(
            (self.channels, FRAME))))
        return out

    def _encode_frame(self, blk: torch.Tensor) -> Packet:
        with stage("aac.mdct"):
            buf = torch.cat([self._hist, blk], dim=1)  # [ch, 2048]
            self._hist = blk
            # the spec's IMDCT convention carries a 1/N scale where our
            # tx pairs 1 with 2/N: compensate with the factor 2 here so
            # decoded amplitude matches
            windowed = buf * self._win[None, :] * (2.0 * 32768.0)
            spec = tx.mdct(windowed).cpu().numpy()  # [ch, 1024]
        with stage("aac.quant"):
            return self._code_frame(spec)

    def _code_frame(self, spec: np.ndarray) -> Packet:
        """The host half of a frame: psy thresholds, the rate loop's
        quantisation passes, the payload and its ADTS header."""

        if self._psy is None:
            from librempeg_tpu_torch.codecs.aac.psy import PsyModel

            self._psy = PsyModel(self.swb, self.sample_rate)
        thr = [self._psy.thresholds(spec[c])
               for c in range(self.channels)]

        if self.opts["bit_rate"] > 0:
            q = self._rc_q
        else:
            q = self.opts["aac_quality"]
        # below quality 2 the knob saturates: trade bandwidth for rate
        # instead (what low-bitrate encoders do)
        bw_frac = 1.0 if q >= 2.0 else max(0.25, q / 2.0)
        q = max(q, 1.0)
        # quality knob -> uniform threshold scale (higher q = tighter)
        scale = (14.0 / q) ** 2

        # outer loop (CBR): scale the masking thresholds uniformly
        # until the frame lands near the per-frame budget
        budget = (self.opts["bit_rate"] * FRAME / self.sample_rate
                  if self.opts["bit_rate"] > 0 else 0.0)
        raw = b""
        for _ in range(5):
            coders = [_ChannelCoder(spec[c], self.swb,
                                    thr[c] * scale, bw_frac)
                      for c in range(self.channels)]
            raw = self._payload(coders)
            if budget <= 0:
                break
            bits = len(raw) * 8
            ratio = bits / max(budget, 1.0)
            if 0.85 <= ratio <= 1.1:
                break
            scale *= max(0.25, min(4.0, ratio ** 1.5))
        if self.opts["bit_rate"] > 0:
            target = self.opts["bit_rate"] * FRAME / self.sample_rate
            bits = len(raw) * 8
            self._rc_buffer += bits - target
            # proportional + integral correction of the quality knob
            ratio = bits / max(target, 1.0)
            corr = 1.0 + max(-0.4, min(0.4,
                                       self._rc_buffer / (8 * target)))
            self._rc_q = float(np.clip(
                self._rc_q * (ratio * corr) ** -0.5, 0.3, 60.0))
        data = self._adts(raw) + raw if self.opts["adts"] else raw
        pts = self._frame_no * FRAME
        self._frame_no += 1
        return Packet(data=data, pts=pts, dts=pts, duration=FRAME,
                      flags=PktFlags.KEY, time_base=self.time_base)

    def _payload(self, coders) -> bytes:
        bw = BitWriterMSB()
        if self.channels == 2:
            bw.write(1, 3)          # CPE
            bw.write(0, 4)          # instance tag
            bw.write(1, 1)          # common_window
            self._write_ics_info(bw)
            bw.write(0, 2)          # ms_mask_present: none
            for c in coders:
                bw.write(c.global_gain, 8)
                c.write_ics(bw, self.max_sfb)
        else:
            bw.write(0, 3)          # SCE
            bw.write(0, 4)
            bw.write(coders[0].global_gain, 8)
            self._write_ics_info(bw)
            coders[0].write_ics(bw, self.max_sfb)
        if self.fill_payload is not None:
            # extension_payload carrier (SBR lives here): FIL element
            # with a byte count covering the 4-bit type + payload
            data = self.fill_payload
            cnt = len(data) + 1     # +1 byte: ext type + 4 align bits
            assert cnt < 15 + 255
            bw.write(6, 3)          # FIL
            if cnt >= 15:
                bw.write(15, 4)
                bw.write(cnt - 14, 8)
            else:
                bw.write(cnt, 4)
            bw.write(13, 4)         # EXT_SBR_DATA
            for b in data:
                bw.write(b, 8)
            bw.write(0, 4)          # align to cnt bytes
        bw.write(7, 3)              # END
        bw.align()
        return bw.bytes()

    def _write_ics_info(self, bw: BitWriterMSB) -> None:
        bw.write(0, 1)              # ics_reserved
        bw.write(0, 2)              # window_sequence: ONLY_LONG
        bw.write(0, 1)              # window_shape: sine
        bw.write(self.max_sfb, 6)
        bw.write(0, 1)              # predictor_data_present

    def _adts(self, raw: bytes) -> bytes:
        ln = len(raw) + 7
        bw = BitWriterMSB()
        bw.write(0xFFF, 12)         # sync
        bw.write(0, 1)              # MPEG-4
        bw.write(0, 2)              # layer
        bw.write(1, 1)              # no CRC
        bw.write(1, 2)              # profile: AAC LC (object type 2 - 1)
        bw.write(self.rate_idx, 4)
        bw.write(0, 1)              # private
        bw.write(self.channels, 3)  # channel configuration
        bw.write(0, 1)              # original
        bw.write(0, 1)              # home
        bw.write(0, 1)              # copyright id
        bw.write(0, 1)              # copyright start
        bw.write(ln, 13)
        bw.write(0x7FF, 11)         # buffer fullness: VBR
        bw.write(0, 2)              # frames - 1
        return bw.bytes()
