"""ADPCM codec family: IMA-WAV, Microsoft, Yamaha (decode + encode).

Analog of libavcodec/adpcm.c / adpcmenc.c for the
common WAV-carried variants. Decoding is formulated TPU-style: blocks
are independent, so the sequential scan runs over the ~505 in-block
sample steps while everything vectorizes across (blocks x channels) —
the same shape a lax.scan-over-samples/vmap-over-blocks device kernel
takes.
Each decoder uploads each output frame once to its `device` (default
"cuda"); each encoder fetches each frame once from the device it lies on.

A copy of librempeg_tpu/codecs/adpcm.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.codecs.api import (
    CodecInfo,
    Decoder,
    Encoder,
    register_decoder,
    register_encoder,
)
from librempeg_tpu_torch.core.errors import InvalidData
from librempeg_tpu_torch.core.frame import AudioFrame
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import NOPTS, Rational
from librempeg_tpu_torch.device import resolve

# IMA/DVI tables (IMA ADPCM spec)
STEP_TABLE = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767], np.int32)
INDEX_TABLE = np.array([-1, -1, -1, -1, 2, 4, 6, 8], np.int32)

# Microsoft ADPCM tables
MS_ADAPT = np.array([230, 230, 230, 230, 307, 409, 512, 614,
                     768, 614, 512, 409, 307, 230, 230, 230], np.int32)
MS_C1 = np.array([256, 512, 0, 192, 240, 460, 392], np.int32)
MS_C2 = np.array([0, -256, 0, 64, 0, -208, -232], np.int32)


def _ima_step(pred, index, nib):
    """One IMA update, vectorized over arbitrary leading dims."""
    step = STEP_TABLE[index]
    diff = step >> 3
    diff = diff + np.where(nib & 1, step >> 2, 0)
    diff = diff + np.where(nib & 2, step >> 1, 0)
    diff = diff + np.where(nib & 4, step, 0)
    pred = np.where(nib & 8, pred - diff, pred + diff)
    pred = np.clip(pred, -32768, 32767)
    index = np.clip(index + INDEX_TABLE[nib & 7], 0, 88)
    return pred, index


def ima_samples_per_block(block_align: int, channels: int) -> int:
    return (block_align - 4 * channels) * 2 // channels + 1


def ms_samples_per_block(block_align: int, channels: int) -> int:
    return (block_align - 7 * channels) * 2 // channels + 2


@register_decoder
class AdpcmImaWavDecoder(Decoder):
    """IMA ADPCM in WAV blocks (wFormatTag 0x0011)."""

    INFO = CodecInfo(name="adpcm_ima_wav", long_name="ADPCM IMA WAV",
                     codec_type="audio")
    #: the sample format of the frames it returns
    sample_fmt = "s16p"

    def __init__(self, params=None, device="cuda", **opts):
        self.device = resolve(device)
        super().__init__(params, **opts)
        p = params
        self.channels = p.nb_channels
        self.rate = p.sample_rate
        self.block_align = p.block_align

    def decode(self, pkt: Packet):
        data = bytes(pkt.data)
        ba, ch = self.block_align, self.channels
        if ba < 4 * ch + 4 * ch or (ba - 4 * ch) % (4 * ch):
            raise InvalidData("adpcm_ima_wav: bad block_align")
        nb = len(data) // ba
        if nb == 0:
            return []
        spb = ima_samples_per_block(ba, ch)
        blocks = np.frombuffer(data[:nb * ba], np.uint8).reshape(nb, ba)
        # per-channel 4-byte headers
        hdr = blocks[:, :4 * ch].reshape(nb, ch, 4)
        pred = (hdr[:, :, 0].astype(np.int32)
                | (hdr[:, :, 1].astype(np.int32) << 8))
        pred = np.where(pred >= 0x8000, pred - 0x10000, pred)
        index = np.clip(hdr[:, :, 2].astype(np.int32), 0, 88)
        out = np.zeros((nb, ch, spb), np.int16)
        out[:, :, 0] = pred                       # header sample is output
        body = blocks[:, 4 * ch:]                 # [nb, (spb-1)*ch/2]
        # data: per channel 4-byte (8-nibble) groups, channels interleaved
        grp = body.reshape(nb, -1, ch, 4)         # [nb, ngrp, ch, 4]
        lo = (grp & 15).astype(np.int32)
        hi = (grp >> 4).astype(np.int32)
        nibs = np.stack([lo, hi], axis=-1).reshape(nb, grp.shape[1], ch, 8)
        nibs = nibs.transpose(0, 2, 1, 3).reshape(nb, ch, -1)
        for s in range(spb - 1):
            pred, index = _ima_step(pred, index, nibs[:, :, s])
            out[:, :, s + 1] = pred
        pcm = out.transpose(0, 2, 1).reshape(-1, ch).T   # [ch, samples]
        return [self._frame(pcm, pkt)]

    def _frame(self, pcm, pkt):
        from librempeg_tpu_torch.core.samplefmt import ChannelLayout

        return AudioFrame(
            data=torch.from_numpy(np.ascontiguousarray(
                pcm.astype(np.int16))).to(self.device),
            sample_rate=self.rate, sample_fmt="s16p",
            layout=ChannelLayout.default(self.channels),
            pts=pkt.pts,
            time_base=pkt.time_base
            if pkt.time_base.valid and pkt.time_base.num
            else Rational(1, self.rate))


@register_decoder
class AdpcmMsDecoder(Decoder):
    """Microsoft ADPCM (wFormatTag 0x0002)."""

    INFO = CodecInfo(name="adpcm_ms", long_name="ADPCM Microsoft",
                     codec_type="audio")
    sample_fmt = "s16p"

    def __init__(self, params=None, device="cuda", **opts):
        self.device = resolve(device)
        super().__init__(params, **opts)
        self.channels = params.nb_channels
        self.rate = params.sample_rate
        self.block_align = params.block_align

    def decode(self, pkt: Packet):
        data = bytes(pkt.data)
        ba, ch = self.block_align, self.channels
        nb = len(data) // ba
        if nb == 0:
            return []
        spb = ms_samples_per_block(ba, ch)
        blocks = np.frombuffer(data[:nb * ba], np.uint8).reshape(nb, ba)
        pos = 0
        bpred = np.clip(blocks[:, pos:pos + ch].astype(np.int32), 0, 6)
        pos += ch

        def rd16(p):
            v = (blocks[:, p:p + 2 * ch:2].astype(np.int32)
                 | (blocks[:, p + 1:p + 2 * ch:2].astype(np.int32) << 8))
            return np.where(v >= 0x8000, v - 0x10000, v)

        idelta = rd16(pos)
        pos += 2 * ch
        s1 = rd16(pos)
        pos += 2 * ch
        s2 = rd16(pos)
        pos += 2 * ch
        c1 = MS_C1[bpred]
        c2 = MS_C2[bpred]
        out = np.zeros((nb, ch, spb), np.int16)
        out[:, :, 0] = s2
        out[:, :, 1] = s1
        body = blocks[:, pos:]
        nibs = np.stack([(body >> 4), (body & 15)], axis=-1) \
            .reshape(nb, -1).astype(np.int32)       # [nb, nsamp*ch]
        nibs = nibs[:, :(spb - 2) * ch].reshape(nb, spb - 2, ch) \
            .transpose(0, 2, 1)                     # [nb, ch, spb-2]
        for s in range(spb - 2):
            n = nibs[:, :, s]
            signed = np.where(n >= 8, n - 16, n)
            pred = (s1 * c1 + s2 * c2) // 256 + signed * idelta
            pred = np.clip(pred, -32768, 32767)
            s2 = s1
            s1 = pred
            idelta = np.maximum(16, MS_ADAPT[n] * idelta // 256)
            out[:, :, s + 2] = pred
        pcm = out.transpose(0, 2, 1).reshape(-1, ch).T
        return [AdpcmImaWavDecoder._frame(self, pcm, pkt)]


@register_decoder
class AdpcmYamahaDecoder(Decoder):
    """Yamaha ADPCM (wFormatTag 0x0020); state persists across blocks."""

    INFO = CodecInfo(name="adpcm_yamaha", long_name="ADPCM Yamaha",
                     codec_type="audio")
    sample_fmt = "s16p"

    def __init__(self, params=None, device="cuda", **opts):
        self.device = resolve(device)
        super().__init__(params, **opts)
        self.channels = params.nb_channels
        self.rate = params.sample_rate
        self._pred = np.zeros(self.channels, np.int32)
        self._step = np.full(self.channels, 127, np.int32)

    def decode(self, pkt: Packet):
        data = np.frombuffer(bytes(pkt.data), np.uint8)
        ch = self.channels
        nibs = np.stack([data & 15, data >> 4], axis=-1).reshape(-1)
        ns = len(nibs) // ch
        nibs = nibs[:ns * ch].reshape(ns, ch).astype(np.int32)
        out = np.zeros((ch, ns), np.int16)
        pred, step = self._pred, self._step
        for s in range(ns):
            n = nibs[s]
            delta = ((2 * (n & 7) + 1) * step) >> 3
            pred = np.clip(np.where(n & 8, pred - delta, pred + delta),
                           -32768, 32767)
            step = np.clip((step * _YAMAHA_IDX[n & 7]) >> 8, 127, 24576)
            out[:, s] = pred
        self._pred, self._step = pred, step
        return [AdpcmImaWavDecoder._frame(self, out, pkt)]


_YAMAHA_IDX = np.array([230, 230, 230, 230, 307, 409, 512, 614], np.int32)


# ---------------------------------------------------------------------------
# encoders (round-trip + reference-decodable streams)
# ---------------------------------------------------------------------------

class _AdpcmEncoderBase(Encoder):
    def __init__(self, sample_rate=44100, channels=2, channel_layout=None,
                 device=None, **opts):
        # `device` is the chain's; each frame is fetched from its own
        super().__init__(**opts)
        self.rate = sample_rate
        self.channels = channels
        self.time_base = Rational(1, sample_rate)
        self._next_pts = 0
        self._pend = np.zeros((channels, 0), np.int16)

    def codec_parameters(self):
        from librempeg_tpu_torch.formats.api import CodecParameters

        return CodecParameters(
            codec_type="audio", codec_id=self.INFO.name,
            sample_rate=self.rate, nb_channels=self.channels,
            block_align=self.block_align,
            frame_size=self.samples_per_block,
            # AVCodecContext's default bit rate, which libavcodec's
            # ADPCM encoders leave as it is (the WAV header's byte rate)
            bit_rate=128000)

    def encode(self, frame):
        x = frame.data
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        if x.dtype != np.int16:
            x = np.clip(np.round(np.asarray(x, np.float64) * 32768.0),
                        -32768, 32767).astype(np.int16)
        self._pend = np.concatenate([self._pend, x], axis=1)
        return self._drain(final=False)

    def flush(self):
        if self._pend.shape[1]:
            spb = self.samples_per_block
            pad = (-self._pend.shape[1]) % spb
            self._pend = np.pad(self._pend, ((0, 0), (0, pad)),
                                mode="edge")
        return self._drain(final=True)

    def _drain(self, final):
        spb = self.samples_per_block
        pkts = []
        while self._pend.shape[1] >= spb:
            blk = self._pend[:, :spb]
            self._pend = self._pend[:, spb:]
            payload = self._encode_block(blk)
            pkts.append(Packet(data=payload, pts=self._next_pts,
                               dts=self._next_pts, duration=spb,
                               flags=PktFlags.KEY,
                               time_base=self.time_base))
            self._next_pts += spb
        return pkts


@register_encoder
class AdpcmImaWavEncoder(_AdpcmEncoderBase):
    INFO = CodecInfo(name="adpcm_ima_wav", long_name="ADPCM IMA WAV",
                     codec_type="audio")

    def __init__(self, **kw):
        super().__init__(**kw)
        self.block_align = 1024 * self.channels
        self.samples_per_block = ima_samples_per_block(self.block_align,
                                                       self.channels)
        self._index = np.zeros(self.channels, np.int32)

    def _encode_block(self, blk):
        ch = self.channels
        pred = blk[:, 0].astype(np.int32)
        index = self._index.copy()
        hdr = b""
        for c in range(ch):
            hdr += int(pred[c] & 0xFFFF).to_bytes(2, "little")
            hdr += bytes([int(index[c]), 0])
        ns = blk.shape[1] - 1
        nibs = np.zeros((ch, ns), np.uint8)
        for s in range(ns):
            target = blk[:, s + 1].astype(np.int32)
            step = STEP_TABLE[index]
            diff = target - pred
            nib = np.where(diff < 0, 8, 0).astype(np.int32)
            ad = np.abs(diff)
            m4 = ad >= step
            nib |= np.where(m4, 4, 0)
            ad = ad - np.where(m4, step, 0)
            m2 = ad >= (step >> 1)
            nib |= np.where(m2, 2, 0)
            ad = ad - np.where(m2, step >> 1, 0)
            m1 = ad >= (step >> 2)
            nib |= np.where(m1, 1, 0)
            pred, index = _ima_step(pred, index, nib)
            nibs[:, s] = nib
        self._index = index
        # pack: per channel 8-nibble (4-byte) groups, channel-interleaved
        g = nibs.reshape(ch, -1, 8)                  # [ch, ngrp, 8]
        lo = g[:, :, 0::2]
        hi = g[:, :, 1::2]
        packed = (lo | (hi << 4)).astype(np.uint8)   # [ch, ngrp, 4]
        body = packed.transpose(1, 0, 2).reshape(-1).tobytes()
        return hdr + body


@register_encoder
class AdpcmMsEncoder(_AdpcmEncoderBase):
    INFO = CodecInfo(name="adpcm_ms", long_name="ADPCM Microsoft",
                     codec_type="audio")

    def __init__(self, **kw):
        super().__init__(**kw)
        self.block_align = 1024 * self.channels
        self.samples_per_block = ms_samples_per_block(self.block_align,
                                                      self.channels)

    def _encode_block(self, blk):
        ch = self.channels
        s2 = blk[:, 0].astype(np.int32)
        s1 = blk[:, 1].astype(np.int32)
        bpred = np.zeros(ch, np.int32)               # coeff pair 0 (1, 0)
        idelta = np.maximum(
            16, np.mean(np.abs(np.diff(blk.astype(np.int32), axis=1)),
                        axis=1).astype(np.int32) >> 2)
        hdr = bytes(int(b) for b in bpred)
        for arr in (idelta, s1, s2):
            for c in range(ch):
                hdr += int(arr[c] & 0xFFFF).to_bytes(2, "little")
        c1 = MS_C1[bpred]
        c2 = MS_C2[bpred]
        ns = blk.shape[1] - 2
        nibs = np.zeros((ns, ch), np.int32)
        for s in range(ns):
            target = blk[:, s + 2].astype(np.int32)
            base = (s1 * c1 + s2 * c2) // 256
            n = np.clip(np.round((target - base)
                                 / np.maximum(idelta, 1)).astype(np.int32),
                        -8, 7)
            pred = np.clip(base + n * idelta, -32768, 32767)
            nibs[s] = n & 15
            s2 = s1
            s1 = pred
            idelta = np.maximum(16, MS_ADAPT[n & 15] * idelta // 256)
        flat = nibs.reshape(-1)                      # sample-major, ch inner
        hi = flat[0::2]
        lo = flat[1::2]
        return hdr + (hi << 4 | lo).astype(np.uint8).tobytes()
