"""FLAC lossless audio codec: decoder + encoder.

Analog of libavcodec/flacdec.c and the native lossless
encoder flacenc.c (SURVEY.md §2.2 "native lossless encoders").

TPU-relevant structure: fixed/LPC *analysis* (encoder) is a parallel FIR
over the block — batched device work; LPC *reconstruction* (decoder) is
an integer IIR, expressed as a lax.scan when run on device; rice
entropy coding stays on the host (numpy/Python here, C++ when hot).

Supported: 16/24-bit, mono/stereo, fixed + LPC subframes, all stereo
decorrelation modes (LR/LS/RS/MS), rice partitions (both coding
methods). Encoder uses fixed predictors with per-block best-order
selection and mid/side decision — the behavior class of the reference's
compression_level 0-2.

The decoder decodes on the host and uploads each frame once to its
`device`; the encoder fetches each frame once from its device. Two
repairs of the JAX module: a fixed-blocksize frame starts at frame_no x
STREAMINFO's max block size (the JAX decoder multiplies by the frame's
own size, so a short last frame gets the wrong pts), and the encoder's
last packet carries the final STREAMINFO (total samples, MD5) as
`new_extradata` side data, which the FLAC muxer writes back at close.
A snapshot writes the held packet out first (`release`); an encoder
restored from one did not hash the samples before the cut, so its
STREAMINFO gives the MD5 as unknown (zeros).

A copy of librempeg_tpu/codecs/flac/codec.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

import hashlib
import struct

import numpy as np
import torch

from librempeg_tpu_torch.codecs.api import (
    CodecInfo,
    Decoder,
    Encoder,
    register_decoder,
    register_encoder,
)
from librempeg_tpu_torch.codecs.flac.bitio import (
    BitReaderMSB,
    BitWriterMSB,
    crc8,
    crc16,
    utf8_code,
    utf8_decode,
)
from librempeg_tpu_torch.core.errors import InvalidData, Unsupported
from librempeg_tpu_torch.core.frame import AudioFrame
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import NOPTS, Rational
from librempeg_tpu_torch.core.samplefmt import ChannelLayout
from librempeg_tpu_torch.device import resolve

_BLOCKSIZE_CODES = {
    192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5,
    256: 8, 512: 9, 1024: 10, 2048: 11, 4096: 12, 8192: 13, 16384: 14,
    32768: 15,
}
_RATE_CODES = {
    88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
    24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11,
}
_SIZE_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}

_FIXED_COEFS = [
    [],
    [1],
    [2, -1],
    [3, -3, 1],
    [4, -6, 4, -1],
]


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


def parse_streaminfo(block: bytes) -> dict:
    (min_bs, max_bs) = struct.unpack(">HH", block[:4])
    min_fs = int.from_bytes(block[4:7], "big")
    max_fs = int.from_bytes(block[7:10], "big")
    packed = int.from_bytes(block[10:18], "big")
    rate = packed >> 44
    channels = ((packed >> 41) & 7) + 1
    bps = ((packed >> 36) & 31) + 1
    total = packed & ((1 << 36) - 1)
    return {"min_blocksize": min_bs, "max_blocksize": max_bs,
            "min_framesize": min_fs, "max_framesize": max_fs,
            "sample_rate": rate, "channels": channels, "bps": bps,
            "total_samples": total, "md5": block[18:34]}


def _decode_residual(br: BitReaderMSB, n: int, order: int) -> np.ndarray:
    """Rice-coded residual section (both 4- and 5-bit parameter modes)."""
    method = br.read(2)
    if method > 1:
        raise InvalidData("FLAC: reserved residual method")
    plen = 4 if method == 0 else 5
    esc = (1 << plen) - 1
    porder = br.read(4)
    nparts = 1 << porder
    if n % nparts:
        raise InvalidData("FLAC: bad partition order")
    psize = n // nparts
    out = np.zeros(n, np.int64)
    idx = order  # residuals start at sample `order`
    for p in range(nparts):
        count = psize - (order if p == 0 else 0)
        k = br.read(plen)
        if k == esc:
            bits = br.read(5)
            for i in range(count):
                out[idx] = br.read_signed(bits) if bits else 0
                idx += 1
        else:
            for i in range(count):
                q = br.read_unary()
                v = (q << k) | br.read(k) if k else q
                out[idx] = (v >> 1) ^ -(v & 1)  # zigzag
                idx += 1
    return out


def _decode_subframe(br: BitReaderMSB, n: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise InvalidData("FLAC: bad subframe padding bit")
    ftype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
    bps -= wasted
    if ftype == 0:        # constant
        v = br.read_signed(bps)
        out = np.full(n, v, np.int64)
    elif ftype == 1:      # verbatim
        out = np.array([br.read_signed(bps) for _ in range(n)], np.int64)
    elif 8 <= ftype <= 12:  # fixed, order = ftype - 8
        order = ftype - 8
        warm = [br.read_signed(bps) for _ in range(order)]
        resid = _decode_residual(br, n, order)
        out = np.zeros(n, np.int64)
        out[:order] = warm
        coefs = _FIXED_COEFS[order]
        r = resid
        for i in range(order, n):
            p = 0
            for j, c in enumerate(coefs):
                p += c * out[i - 1 - j]
            out[i] = r[i] + p
    elif ftype >= 32:     # LPC, order = ftype - 31
        order = ftype - 31
        warm = [br.read_signed(bps) for _ in range(order)]
        prec = br.read(4) + 1
        shift = br.read_signed(5)
        coefs = [br.read_signed(prec) for _ in range(order)]
        resid = _decode_residual(br, n, order)
        out = np.zeros(n, np.int64)
        out[:order] = warm
        for i in range(order, n):
            p = 0
            for j in range(order):
                p += coefs[j] * out[i - 1 - j]
            out[i] = resid[i] + (p >> shift)
    else:
        raise InvalidData(f"FLAC: reserved subframe type {ftype}")
    return out << wasted


def _decode_stereo(br, n, bps, ch_code):
    """Stereo decorrelation modes: 8=left/side, 9=right/side (side is
    subframe 0, coded at bps+1), 10=mid/side."""
    if ch_code == 8:        # LS: left (bps), side (bps+1)
        left = _decode_subframe(br, n, bps)
        side = _decode_subframe(br, n, bps + 1)
        return np.stack([left, left - side])
    if ch_code == 9:        # RS: side (bps+1), right (bps)
        side = _decode_subframe(br, n, bps + 1)
        right = _decode_subframe(br, n, bps)
        return np.stack([right + side, right])
    # MS: mid (bps), side (bps+1)
    mid = _decode_subframe(br, n, bps)
    side = _decode_subframe(br, n, bps + 1)
    m2 = (mid << 1) | (side & 1)
    return np.stack([(m2 + side) >> 1, (m2 - side) >> 1])


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def _rice_encode(bw: BitWriterMSB, resid: np.ndarray, plen: int = 4) -> None:
    """One rice partition set (partition order 0 — single partition)."""
    bw.write(0 if plen == 4 else 1, 2)  # coding method
    bw.write(0, 4)                      # partition order 0
    u = (resid << 1) ^ (resid >> 63)    # zigzag (int64 arithmetic shift)
    mean = max(1, int(np.mean(np.abs(resid))))
    k = min(30, max(0, int(mean).bit_length() - 1))
    esc = (1 << plen) - 1
    if k >= esc:
        k = esc - 1
    bw.write(k, plen)
    for v in u:
        v = int(v)
        q = v >> k
        bw.write_unary(q)
        if k:
            bw.write(v & ((1 << k) - 1), k)


def _fixed_residuals(x: np.ndarray, max_order: int = 4) -> list[np.ndarray]:
    res = [x.astype(np.int64)]
    for o in range(1, max_order + 1):
        res.append(np.diff(res[-1]))
    return res


def _encode_subframe(bw: BitWriterMSB, x: np.ndarray, bps: int) -> None:
    n = len(x)
    x = x.astype(np.int64)
    if np.all(x == x[0]):
        bw.write(0, 1)
        bw.write(0, 6)          # constant
        bw.write(0, 1)          # no wasted bits
        bw.write_signed(int(x[0]), bps)
        return
    # pick best fixed order by residual magnitude sum
    diffs = _fixed_residuals(x)
    costs = [np.abs(d[o:]).sum() if len(d) > 4 else 1 << 62
             for o, d in enumerate(diffs)]
    order = int(np.argmin(costs))
    bw.write(0, 1)
    bw.write(8 + order, 6)      # fixed subframe
    bw.write(0, 1)              # wasted bits
    for i in range(order):
        bw.write_signed(int(x[i]), bps)
    full = np.zeros(n, np.int64)
    full[order:] = diffs[order]
    _rice_encode(bw, full[order:])


def encode_frame(samples: np.ndarray, frame_no: int, rate: int, bps: int
                 ) -> bytes:
    """[channels, n] int -> one FLAC frame (fixed-blocking)."""
    channels, n = samples.shape
    bw = BitWriterMSB()
    bw.write(0x3FFE, 14)
    bw.write(0, 1)
    bw.write(0, 1)             # fixed blocksize stream
    bs_code = _BLOCKSIZE_CODES.get(n, 7)
    bw.write(bs_code, 4)
    rate_code = _RATE_CODES.get(rate, 13)
    bw.write(rate_code, 4)

    # stereo decorrelation decision: plain LR vs mid/side
    ch_code = channels - 1
    use_ms = False
    if channels == 2:
        l, r = samples[0].astype(np.int64), samples[1].astype(np.int64)
        side = l - r
        mid = (l + r) >> 1
        cost_lr = np.abs(np.diff(l)).sum() + np.abs(np.diff(r)).sum()
        cost_ms = np.abs(np.diff(mid)).sum() + np.abs(np.diff(side)).sum()
        if cost_ms < cost_lr:
            use_ms = True
            ch_code = 10
    bw.write(ch_code, 4)
    bw.write(_SIZE_CODES[bps], 3)
    bw.write(0, 1)
    hdr_tail = utf8_code(frame_no)
    for b in hdr_tail:
        bw.write(b, 8)
    if bs_code == 7:
        bw.write(n - 1, 16)
    if rate_code == 13:
        bw.write(rate, 16)
    # crc-8 over header so far
    bw.align()
    partial = bw.bytes()
    bw2 = BitWriterMSB()
    for b in partial:
        bw2.write(b, 8)
    bw2.write(crc8(partial), 8)
    if channels == 2 and use_ms:
        l, r = samples[0].astype(np.int64), samples[1].astype(np.int64)
        _encode_subframe(bw2, (l + r) >> 1, bps)
        _encode_subframe(bw2, l - r, bps + 1)
    else:
        for c in range(channels):
            _encode_subframe(bw2, samples[c], bps)
    bw2.align()
    body = bw2.bytes()
    return body + struct.pack(">H", crc16(body))


def build_streaminfo(rate: int, channels: int, bps: int, total: int,
                     blocksize: int, md5: bytes = b"\0" * 16) -> bytes:
    packed = (rate << 44) | ((channels - 1) << 41) | ((bps - 1) << 36) | total
    return (struct.pack(">HH", blocksize, blocksize)
            + b"\x00\x00\x00" * 2
            + packed.to_bytes(8, "big") + md5)


# ---------------------------------------------------------------------------
# Codec classes
# ---------------------------------------------------------------------------


@register_decoder
class FlacDecoder(Decoder):
    INFO = CodecInfo(name="flac", long_name="FLAC (Free Lossless Audio "
                     "Codec)", codec_type="audio")

    def __init__(self, params=None, device="cuda", **opts):
        self.device = resolve(device)
        super().__init__(params, **opts)

    def configure(self, params):
        self.streaminfo = (parse_streaminfo(params.extradata)
                           if len(params.extradata) >= 34 else
                           {"sample_rate": params.sample_rate,
                            "channels": params.nb_channels, "bps": 16})
        #: the sample format of the frames it returns
        self.sample_fmt = "s16p" if self.streaminfo["bps"] <= 16 else "s32p"

    def decode(self, pkt: Packet):
        data = bytes(pkt.data)
        br = BitReaderMSB(data)
        if br.read(14) != 0x3FFE:
            raise InvalidData("FLAC: lost frame sync")
        br.read(1)
        blocking = br.read(1)
        bs_code = br.read(4)
        rate_code = br.read(4)
        ch_code = br.read(4)
        size_code = br.read(3)
        br.read(1)
        frame_no = utf8_decode(br)
        if bs_code == 6:
            n = br.read(8) + 1
        elif bs_code == 7:
            n = br.read(16) + 1
        else:
            n = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608, 8: 256,
                 9: 512, 10: 1024, 11: 2048, 12: 4096, 13: 8192,
                 14: 16384, 15: 32768}[bs_code]
        if rate_code == 12:
            br.read(8)
        elif rate_code in (13, 14):
            br.read(16)
        rate = self.streaminfo["sample_rate"]
        bps = ({1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}.get(size_code)
               or self.streaminfo["bps"])
        br.read(8)  # crc8
        if ch_code < 8:
            subs = [_decode_subframe(br, n, bps) for _ in range(ch_code + 1)]
            out = np.stack(subs)
        else:
            out = _decode_stereo(br, n, bps, ch_code)
        # fixed blocksize: every frame but the last has the stream's
        # block size, so the frame number counts in STREAMINFO's
        start = (frame_no * (self.streaminfo.get("max_blocksize") or n)
                 if blocking == 0 else frame_no)
        dtype = np.int16 if bps <= 16 else np.int32
        return [AudioFrame(
            data=torch.from_numpy(out.astype(dtype)).to(self.device),
            sample_rate=rate,
            sample_fmt="s16p" if bps <= 16 else "s32p",
            layout=ChannelLayout.default(out.shape[0]),
            pts=start, time_base=Rational(1, rate))]


@register_encoder
class FlacEncoder(Encoder):
    INFO = CodecInfo(name="flac", long_name="FLAC (Free Lossless Audio "
                     "Codec)", codec_type="audio")

    BLOCKSIZE = 4096

    def __init__(self, sample_rate=44100, channels=2, bps=16, device=None,
                 **opts):
        # `device` is the chain's; each frame is fetched from its own
        super().__init__(**opts)
        self.sample_rate = sample_rate
        self.channels = channels
        self.bps = bps
        self.time_base = Rational(1, sample_rate)
        self._pend = np.zeros((channels, 0), np.int32)
        self._frame_no = 0
        self._total = 0
        self._md5 = hashlib.md5()
        self._hashed = 0       # samples this instance has hashed
        self._held = None      # the newest packet: the last one carries
        #                        the final STREAMINFO

    def codec_parameters(self):
        from librempeg_tpu_torch.formats.api import CodecParameters

        return CodecParameters(
            codec_type="audio", codec_id="flac",
            sample_rate=self.sample_rate, nb_channels=self.channels,
            extradata=build_streaminfo(self.sample_rate, self.channels,
                                       self.bps, 0, self.BLOCKSIZE))

    def encode(self, frame: AudioFrame):
        x = frame.data
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if x.dtype != torch.int16 and self.bps == 16:
            from librempeg_tpu_torch.codecs.pcm import from_float, to_float

            x = from_float(to_float(x, frame.sample_fmt), "s16p")
        x = x.cpu().numpy()
        self._pend = np.concatenate([self._pend, x.astype(np.int32)], axis=1)
        out = []
        while self._pend.shape[1] >= self.BLOCKSIZE:
            blk = self._pend[:, :self.BLOCKSIZE]
            self._pend = self._pend[:, self.BLOCKSIZE:]
            out += self._hold(self._emit(blk))
        return out

    def _hold(self, pkt: Packet) -> list:
        """Hold back the newest packet and return the one before it."""
        out = [] if self._held is None else [self._held]
        self._held = pkt
        return out

    def release(self) -> list:
        """Give out the held packet, keeping the stream open (a
        snapshot writes it before it reads the encoder's fields)."""
        out = [] if self._held is None else [self._held]
        self._held = None
        return out

    def _emit(self, blk: np.ndarray) -> Packet:
        inter = blk.T.astype("<i2" if self.bps == 16 else "<i4")
        self._md5.update(inter.tobytes())
        self._hashed += blk.shape[1]
        data = encode_frame(blk, self._frame_no, self.sample_rate, self.bps)
        pts = self._frame_no * self.BLOCKSIZE
        self._frame_no += 1
        self._total += blk.shape[1]
        return Packet(data=data, pts=pts, dts=pts, duration=blk.shape[1],
                      flags=PktFlags.KEY, time_base=self.time_base)

    def flush(self):
        out = []
        if self._pend.shape[1]:
            blk = self._pend
            self._pend = np.zeros((self.channels, 0), np.int32)
            out = self._hold(self._emit(blk))
        if self._held is None:
            return out
        last, self._held = self._held, None
        # flacenc.c's AV_PKT_DATA_NEW_EXTRADATA: the final STREAMINFO
        last.side_data["new_extradata"] = build_streaminfo(
            self.sample_rate, self.channels, self.bps, self._total,
            self.BLOCKSIZE, self.md5)
        return out + [last]

    @property
    def md5(self) -> bytes:
        """The MD5 of the interleaved input, or zeros (FLAC's
        "unknown") where this instance did not hash every sample: a
        restored encoder's `_total` counts samples before the cut."""
        if self._hashed != self._total:
            return b"\0" * 16
        return self._md5.digest()

    @property
    def total_samples(self) -> int:
        return self._total
