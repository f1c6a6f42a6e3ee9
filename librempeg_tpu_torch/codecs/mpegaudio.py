"""MPEG audio Layer II (MP2) decoder.

Analog of libavcodec/mpegaudiodec_*.c for Layer II:
bit allocation per ISO 11172-3 Table B.2 (a-d), scfsi/scalefactors,
grouped and ungrouped sample requantization, and the 32-band polyphase
synthesis filterbank (matrixing as one 64x32 matmul per granule — the
MXU-shaped formulation; the spec's D window from mpegaudio_tables.py).
Layer III (MP3) needs the hybrid filterbank + Huffman layer and is a
later round. SNR-gated against the reference decoder in tests.

Each decoder decodes on the host, as the JAX module does, and uploads
each output frame once to its `device` (default "cuda").

A copy of librempeg_tpu/codecs/mpegaudio.py (host code, no JAX), imports
rewritten; the synthesis window is libavcodec's, nothing is trimmed for
the synthesis, and a packet's skip side data is dropped as libavcodec's
decode.c drops it (tests/test_torch_libav_audio.py).
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.codecs.api import CodecInfo, Decoder, register_decoder
from librempeg_tpu_torch.codecs.flac.bitio import BitReaderMSB
from librempeg_tpu_torch.codecs.mpegaudio_tables import ENWINDOW
from librempeg_tpu_torch.core.errors import InvalidData, Unsupported
from librempeg_tpu_torch.core.frame import AudioFrame
from librempeg_tpu_torch.core.packet import Packet
from librempeg_tpu_torch.core.rational import NOPTS, Rational, rescale_q
from librempeg_tpu_torch.core.samplefmt import ChannelLayout
from librempeg_tpu_torch.core.sidedata import skip_side_data, trim
from librempeg_tpu_torch.device import resolve
from librempeg_tpu_torch.formats.mp3 import FrameHeader

SBLIMIT_TAB = (27, 30, 8, 12, 30)
QUANT_STEPS = (3, 5, 7, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095,
               8191, 16383, 32767, 65535)
QUANT_BITS = (-5, -7, 3, -10, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16)

# ISO 11172-3 Table B.2 allocation tables (row: nbal then qindex list)
_ALLOC_1 = (
    [(4, (0, 2, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16))] * 3
    + [(4, (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 16))] * 8
    + [(3, (0, 1, 2, 3, 4, 5, 16))] * 12
    + [(2, (0, 1, 16))] * 7)
_ALLOC_3 = (
    [(4, (0, 1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15))] * 2
    + [(3, (0, 1, 3, 4, 5, 6, 7))] * 10)
_ALLOC_4 = (
    [(4, (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14))] * 4
    + [(3, (0, 1, 3, 4, 5, 6, 7))] * 7
    + [(2, (0, 1, 3))] * 19)
ALLOC_TABLES = (_ALLOC_1, _ALLOC_1, _ALLOC_3, _ALLOC_3, _ALLOC_4)

_SCF = np.array([2.0 ** (-(i // 3))
                 * (1.0, 0.7937005259, 0.6299605249)[i % 3]
                 for i in range(64)])

# synthesis matrixing N[i][k] = cos((16+i)(2k+1)pi/64)
_N = np.cos(np.pi / 64.0 * np.outer(np.arange(64) + 16,
                                    2 * np.arange(32) + 1))
# D window: ISO Table 3-B.3, built from the integer half the reference
# stores as libavcodec's ff_mpa_synth_init builds it: D[512 - i] is
# -D[i] but where i is a multiple of 64 (taps 320, 384 and 448 keep
# their sign; the JAX package flips them too)
_D = np.zeros(512)
_half = np.asarray(ENWINDOW, np.float64)
for _i in range(257):
    _D[_i] = _half[_i]
    if _i:
        _D[512 - _i] = _half[_i] if _i % 64 == 0 else -_half[_i]
_D /= 1 << 15


def _select_table(bitrate: int, nch: int, freq: int) -> int:
    chbr = bitrate // 1000 // nch
    if (freq == 48000 and chbr >= 56) or (56 <= chbr <= 80):
        return 0
    if freq != 48000 and chbr >= 96:
        return 1
    if freq != 32000 and chbr <= 48:
        return 2
    return 3


# the ISO pseudo-code synthesis (matrix V fifo + D window) over
# requantised samples in [-2, 2) gives twice libavcodec's output (the
# least-squares gain against it is 1 to 1e-5, test_torch_libav_audio.py);
# its first sample is libavcodec's first, so nothing is trimmed (the
# JAX package trims 481 samples, which its window's three flipped taps
# made look like a delay)
OUTPUT_GAIN = 0.5


class Mp2FrameDecoder:
    def __init__(self, channels: int):
        self.nch = channels
        self.v = [np.zeros(1024) for _ in range(channels)]

    def decode_frame(self, data: bytes, hdr: FrameHeader) -> np.ndarray:
        nch = 1 if hdr.channels == 1 else 2
        mode_bits = data[3] >> 6
        js_bound = ((data[3] >> 4) & 3) * 4 + 4
        protected = not (data[1] & 1)
        br = BitReaderMSB(data, bit_pos=48 if protected else 32)
        table = _select_table(hdr.bitrate, nch, hdr.sample_rate)
        alloc = ALLOC_TABLES[table]
        sblimit = SBLIMIT_TAB[table]
        bound = js_bound if mode_bits == 1 else sblimit  # joint stereo
        bound = min(bound, sblimit)

        ba = np.zeros((nch, sblimit), np.int32)
        for sb in range(bound):
            nbal = alloc[sb][0]
            for ch in range(nch):
                ba[ch, sb] = br.read(nbal)
        for sb in range(bound, sblimit):
            v = br.read(alloc[sb][0])
            ba[0, sb] = ba[1 % nch, sb] = v

        scfsi = np.zeros((nch, sblimit), np.int32)
        for sb in range(sblimit):
            for ch in range(nch):
                if ba[ch, sb]:
                    scfsi[ch, sb] = br.read(2)
        sf = np.zeros((nch, sblimit, 3), np.int32)
        for sb in range(sblimit):
            for ch in range(nch):
                if not ba[ch, sb]:
                    continue
                mode = scfsi[ch, sb]
                if mode == 0:
                    sf[ch, sb] = [br.read(6), br.read(6), br.read(6)]
                elif mode == 1:
                    a, b = br.read(6), br.read(6)
                    sf[ch, sb] = [a, a, b]
                elif mode == 2:
                    a = br.read(6)
                    sf[ch, sb] = [a, a, a]
                else:
                    a, b = br.read(6), br.read(6)
                    sf[ch, sb] = [a, b, b]

        sb_samples = np.zeros((nch, 36, 32))   # 32 subbands (upper ones zero)
        for k in range(3):
            for gr in range(0, 12, 3):
                for sb in range(sblimit):
                    stereo_shared = sb >= bound
                    chans = 1 if stereo_shared else nch
                    vals = {}
                    for ch in range(chans):
                        b = ba[ch, sb]
                        if not b:
                            continue
                        qidx = alloc[sb][1][b - 1]
                        bits = QUANT_BITS[qidx]
                        steps = QUANT_STEPS[qidx]
                        if bits < 0:             # grouped triple
                            v = br.read(-bits)
                            cs = (v % steps, (v // steps) % steps,
                                  v // (steps * steps))
                            vals[ch] = [(c - (steps >> 1)) * (4.0 / steps)
                                        for c in cs]
                        else:
                            # l1-style: (mant - 2^n + 1) * 2^n/(2^n-1)
                            # normalized back by 2^-n (n = bits-1)
                            n = bits - 1
                            norm = ((1 << bits) / ((1 << bits) - 1)
                                    * 2.0 / (1 << n))
                            vals[ch] = [
                                (br.read(bits) - (1 << n) + 1) * norm
                                for _ in range(3)]
                    for ch in range(nch):
                        src = vals.get(ch if ch < chans else 0)
                        if src is None:
                            continue
                        s = _SCF[sf[ch if ch < chans else ch, sb, k]]
                        for m in range(3):
                            sb_samples[ch, k * 12 + gr + m, sb] = \
                                src[m] * s
        # polyphase synthesis
        out = np.zeros((nch, 1152))
        for ch in range(nch):
            for g in range(36):
                self.v[ch] = np.roll(self.v[ch], 64)
                self.v[ch][:64] = _N @ sb_samples[ch, g]
                u = np.zeros(512)
                for i in range(8):
                    u[64 * i:64 * i + 32] = self.v[ch][128 * i:128 * i + 32]
                    u[64 * i + 32:64 * i + 64] = \
                        self.v[ch][128 * i + 96:128 * i + 128]
                w = u * _D
                out[ch, g * 32:(g + 1) * 32] = w.reshape(16, 32).sum(axis=0)
        out *= OUTPUT_GAIN
        return out.astype(np.float32)


@register_decoder
class Mp2Decoder(Decoder):
    INFO = CodecInfo(name="mp2", long_name="MP2 (MPEG audio layer 2)",
                     codec_type="audio")
    #: the sample format of the frames it returns
    sample_fmt = "fltp"

    def __init__(self, params=None, device="cuda", **opts):
        self.device = resolve(device)
        self._dec = None
        self._pts = 0
        self._pending_skip = 0          # start skip still pending (side data)
        super().__init__(params, **opts)

    def decode(self, pkt: Packet):
        data = bytes(pkt.data)
        hdr = FrameHeader.parse(data)
        if hdr is None:
            raise InvalidData("mp2: bad frame header")
        if hdr.layer != 2:
            raise Unsupported(f"mpegaudio: layer {hdr.layer} "
                              "(only layer II this round)")
        if self._dec is None:
            self._dec = Mp2FrameDecoder(hdr.channels)
        self._pending_skip, discard = skip_side_data(pkt,
                                                     self._pending_skip)
        pcm = self._dec.decode_frame(data, hdr)
        pts = pkt.pts if pkt.pts != NOPTS else self._pts
        self._pts = pts + pcm.shape[1]
        tb = pkt.time_base if pkt.time_base.valid and pkt.time_base.num \
            else Rational(1, hdr.sample_rate)
        pcm, drop, self._pending_skip = trim(pcm, self._pending_skip,
                                             discard)
        if not pcm.shape[1]:
            return []
        if drop and pts != NOPTS:
            pts += rescale_q(drop, Rational(1, hdr.sample_rate), tb)
        return [AudioFrame(
            data=torch.from_numpy(np.ascontiguousarray(pcm)).to(self.device),
            sample_rate=hdr.sample_rate, sample_fmt="fltp",
            layout=ChannelLayout.default(pcm.shape[0]), pts=pts,
            time_base=tb)]
