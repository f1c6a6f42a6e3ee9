"""MP3 (MPEG audio Layer III) decoder: MPEG-1, MPEG-2 and 2.5 (LSF).

Analog of libavcodec/mpegaudiodec_float.c's Layer III
path: side info + bit reservoir, scalefactors (MPEG-1 scfsi groups and
the LSF scalefac_compress partitions), two-stage Huffman (big-values
pairs with linbits escapes, count1 quadruples), power-4/3
requantization from per-band exponents, short-block reorder, MS
stereo, alias reduction, the hybrid filterbank (36/12-point IMDCT as
matmuls with the four window shapes + per-subband overlap-add and
frequency inversion), then the 32-band polyphase synthesis shared with
the Layer II decoder. Tables are ISO 11172-3/13818-3 Table B.7/B.8
spec data (codecs/mp3tables.py, extracted). SNR-gated against the
reference decoder in tests/test_mp3dec.py.

Each decoder decodes on the host, as the JAX module does, and uploads
each output frame once to its `device` (default "cuda").

A copy of librempeg_tpu/codecs/mp3dec.py (host code, no JAX), imports
rewritten; the synthesis is mpegaudio.py's (libavcodec's window, no
trim), and a packet's skip side data (the LAME tag's gapless trim from
formats/mp3.py) is dropped as libavcodec's decode.c drops it.
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.codecs import mp3tables as T
from librempeg_tpu_torch.codecs.api import CodecInfo, Decoder, register_decoder
from librempeg_tpu_torch.codecs.flac.bitio import BitReaderMSB
from librempeg_tpu_torch.codecs.mpegaudio import OUTPUT_GAIN, _D, _N
from librempeg_tpu_torch.core.errors import InvalidData
from librempeg_tpu_torch.core.frame import AudioFrame
from librempeg_tpu_torch.core.packet import Packet
from librempeg_tpu_torch.core.rational import NOPTS, Rational, rescale_q
from librempeg_tpu_torch.core.samplefmt import ChannelLayout
from librempeg_tpu_torch.core.sidedata import skip_side_data, trim
from librempeg_tpu_torch.device import resolve
from librempeg_tpu_torch.formats.mp3 import FrameHeader

SLEN1 = (0, 0, 0, 0, 3, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4)
SLEN2 = (0, 1, 2, 3, 0, 1, 2, 3, 1, 2, 3, 1, 2, 3, 2, 3)
PRETAB = (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 3,
          2, 0)
LSF_NSF = (((6, 5, 5, 5), (9, 9, 9, 9), (6, 9, 9, 9)),
           ((6, 5, 7, 3), (9, 9, 12, 6), (6, 9, 12, 6)),
           ((11, 10, 0, 0), (18, 18, 0, 0), (15, 18, 0, 0)),
           ((7, 7, 7, 0), (12, 12, 12, 0), (6, 15, 12, 0)),
           ((6, 6, 6, 3), (12, 9, 9, 6), (6, 12, 9, 6)),
           ((8, 8, 5, 0), (15, 12, 9, 0), (6, 18, 9, 0)))

# big-value tables as direct prefix LUTs
_HUFF_LUT = []
for _entries in T.HUFF_TABLES:
    _ml = max(ln for _, ln, _, _ in _entries)
    _lut = np.full((1 << _ml, 3), -1, np.int32)   # (x, y, len)
    for _c, _ln, _x, _y in _entries:
        _b = _c << (_ml - _ln)
        _lut[_b:_b + (1 << (_ml - _ln))] = (_x, _y, _ln)
    _HUFF_LUT.append((_lut, _ml))

_QUAD_LUT = []
for _t in range(2):
    _ml = max(T.QUAD_BITS[_t])
    _lut = np.full((1 << _ml, 2), -1, np.int32)   # (value, len)
    for _v in range(16):
        _c, _ln = T.QUAD_CODES[_t][_v], T.QUAD_BITS[_t][_v]
        _b = _c << (_ml - _ln)
        _lut[_b:_b + (1 << (_ml - _ln))] = (_v, _ln)
    _QUAD_LUT.append((_lut, _ml))


def _imdct_mat(n):
    i = np.arange(n)[:, None]
    k = np.arange(n // 2)[None, :]
    return np.cos(np.pi / (2 * n) * (2 * i + 1 + n // 2) * (2 * k + 1))


_IM36 = _imdct_mat(36)
_IM12 = _imdct_mat(12)

_WIN = np.zeros((4, 36))
_WIN[0] = np.sin(np.pi / 36 * (np.arange(36) + 0.5))
_WIN[1][:18] = _WIN[0][:18]
_WIN[1][18:24] = 1.0
_WIN[1][24:30] = np.sin(np.pi / 12 * (np.arange(24, 30) - 18 + 0.5))
_WIN[3][:6] = 0.0
_WIN[3][6:12] = np.sin(np.pi / 12 * (np.arange(6, 12) - 6 + 0.5))
_WIN[3][12:18] = 1.0
_WIN[3][18:] = _WIN[0][18:]
_WIN12 = np.sin(np.pi / 12 * (np.arange(12) + 0.5))

_CI = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142,
                -0.0037])
_CS = 1.0 / np.sqrt(1.0 + _CI * _CI)
_CA = _CI * _CS

_IS_TAB = np.tan(np.arange(7) * np.pi / 12.0)


def _sr_index(hdr: FrameHeader) -> int:
    base = {44100: 0, 48000: 1, 32000: 2,
            22050: 0, 24000: 1, 16000: 2,
            11025: 0, 12000: 1, 8000: 2}[hdr.sample_rate]
    if hdr.version_bits == 3:
        return base
    if hdr.version_bits == 2:
        return base + 3
    return base + 6


class Granule:
    __slots__ = ("part2_3_length", "big_values", "global_gain",
                 "scalefac_compress", "block_type", "mixed",
                 "table_select", "subblock_gain", "region0", "region1",
                 "preflag", "scalefac_scale", "count1table", "scfsi",
                 "sf", "long_end", "short_start", "xr")


class Mp3FrameDecoder:
    def __init__(self, channels: int):
        self.nch = channels
        self.v = [np.zeros(1024) for _ in range(channels)]
        self.overlap = np.zeros((channels, 32, 18))
        self.reservoir = b""

    # -- side info ----------------------------------------------------
    def _side_info(self, br, nch, lsf, sr_idx):
        main_data_begin = br.read(8 if lsf else 9)
        br.read((1 if nch == 1 else 2) if lsf
                else (5 if nch == 1 else 3))
        if lsf:
            scfsi = [[0] * 4 for _ in range(nch)]
        else:
            scfsi = [[br.read(1) for _ in range(4)] for _ in range(nch)]
        ngr = 1 if lsf else 2
        band_long = T.BAND_SIZE_LONG[sr_idx]
        idx_long = np.concatenate([[0], np.cumsum(band_long)])
        grans = [[None] * nch for _ in range(ngr)]
        for gr in range(ngr):
            for ch in range(nch):
                g = Granule()
                g.scfsi = scfsi[ch]
                g.part2_3_length = br.read(12)
                g.big_values = br.read(9)
                if g.big_values > 288:
                    raise InvalidData("mp3: big_values > 288")
                g.global_gain = br.read(8)
                g.scalefac_compress = br.read(9 if lsf else 4)
                if br.read(1):                 # window switching
                    g.block_type = br.read(2)
                    if g.block_type == 0:
                        raise InvalidData("mp3: reserved block type")
                    g.mixed = br.read(1)
                    g.table_select = [br.read(5), br.read(5), 0]
                    g.subblock_gain = [br.read(3) for _ in range(3)]
                    if g.block_type == 2:
                        g.region0 = 36 if sr_idx != 8 else 72
                    else:
                        g.region0 = 36 if sr_idx <= 2 \
                            else (54 if sr_idx != 8 else 108)
                    g.region1 = 576
                else:
                    g.block_type = 0
                    g.mixed = 0
                    g.table_select = [br.read(5) for _ in range(3)]
                    r0 = br.read(4)
                    r1 = br.read(3)
                    g.subblock_gain = [0, 0, 0]
                    g.region0 = 2 * int(idx_long[min(r0 + 1, 22)] // 2)
                    g.region1 = 2 * int(
                        idx_long[min(r0 + 1 + r1 + 1, 22)] // 2)
                if g.block_type == 2:
                    g.long_end = (8 if not lsf else 6) if g.mixed else 0
                    g.short_start = 3 if g.mixed else 0
                else:
                    g.long_end = 22
                    g.short_start = 13
                g.preflag = 0 if lsf else br.read(1)
                g.scalefac_scale = br.read(1)
                g.count1table = br.read(1)
                grans[gr][ch] = g
        return main_data_begin, grans

    # -- scalefactors (flat array, reference layout) -----------------
    def _scalefactors_mpeg1(self, br, g: Granule, gr, prev):
        s1, s2 = SLEN1[g.scalefac_compress], SLEN2[g.scalefac_compress]
        sf = [0] * 40
        j = 0
        if g.block_type == 2:
            n = 17 if g.mixed else 18
            for i in range(n):
                sf[j] = br.read(s1) if s1 else 0
                j += 1
            for i in range(18):
                sf[j] = br.read(s2) if s2 else 0
                j += 1
        else:
            for k in range(4):
                n = 6 if k == 0 else 5
                if gr == 1 and g.scfsi[k]:
                    sf[j:j + n] = prev.sf[j:j + n]
                    j += n
                else:
                    sl = s1 if k < 2 else s2
                    for i in range(n):
                        sf[j] = br.read(sl) if sl else 0
                        j += 1
        g.sf = sf

    def _scalefactors_lsf(self, br, g: Granule, intensity_ch: bool):
        sf = g.scalefac_compress

        # reference lsf_sf_expand semantics: repeated modulo split
        def expand(v, n1, n2, n3):
            out = [0, 0, 0, 0]
            for idx, n in ((3, n3), (2, n2), (1, n1)):
                if n:
                    out[idx] = v % n
                    v //= n
            out[0] = v
            return out

        if intensity_ch:
            sf >>= 1
            if sf < 180:
                slen = expand(sf, 6, 6, 0)
                t2 = 3
            elif sf < 244:
                slen = expand(sf - 180, 4, 4, 0)
                t2 = 4
            else:
                slen = expand(sf - 244, 3, 0, 0)
                t2 = 5
        else:
            if sf < 400:
                slen = expand(sf, 5, 4, 4)
                t2 = 0
            elif sf < 500:
                slen = expand(sf - 400, 5, 4, 0)
                t2 = 1
            else:
                slen = expand(sf - 500, 3, 0, 0)
                t2 = 2
                g.preflag = 1
        t1 = (2 if g.mixed else 1) if g.block_type == 2 else 0
        out = [0] * 40
        j = 0
        for k in range(4):
            n = LSF_NSF[t2][t1][k]
            sl = slen[k]
            for _ in range(n):
                out[j] = br.read(sl) if sl else 0
                j += 1
        g.sf = out

    # -- huffman ------------------------------------------------------
    def _huffman(self, br, g: Granule, part2_start: int):
        x = np.zeros(576)
        pos = 0
        end = part2_start + g.part2_3_length

        def peek(n):
            save = br.pos
            v = br.read(n)
            br.pos = save
            return v

        bounds = (min(g.region0, g.big_values * 2),
                  min(g.region1, g.big_values * 2), g.big_values * 2)
        start = 0
        for r in range(3):
            tsel = g.table_select[r]
            tab, linbits = T.HUFF_DATA[tsel]
            use = _HUFF_LUT[tab - 1] if tab > 0 else None
            for _ in range(0, bounds[r] - start, 2):
                if pos + 2 > 576:
                    raise InvalidData("mp3: huffman overflow")
                if use is None:
                    pos += 2
                    continue
                lut, ml = use
                vx, vy, ln = lut[peek(ml)]
                if ln < 0:
                    raise InvalidData("mp3: bad huffman code")
                br.pos += int(ln)
                for j, v in ((pos, int(vx)), (pos + 1, int(vy))):
                    if v == 15 and linbits:
                        v += br.read(linbits)
                    if v and br.read(1):
                        v = -v
                    x[j] = v
                pos += 2
            start = bounds[r]
        lut, ml = _QUAD_LUT[g.count1table]
        while br.pos < end and pos <= 572:
            v, ln = lut[peek(ml)]
            br.pos += int(ln)
            for k, bit in enumerate(((v >> 3) & 1, (v >> 2) & 1,
                                     (v >> 1) & 1, int(v) & 1)):
                s = int(bit)
                if s and br.read(1):
                    s = -s
                x[pos + k] = s
            pos += 4
        if br.pos > end:
            x[max(0, pos - 4):pos] = 0
        br.pos = end
        return x

    # -- exponents + requantize (reference layout) -------------------
    def _requantize(self, g: Granule, sr_idx: int, x: np.ndarray):
        band_long = T.BAND_SIZE_LONG[sr_idx]
        band_short = T.BAND_SIZE_SHORT[sr_idx]
        gain = g.global_gain - 210
        shift = g.scalefac_scale + 1
        exps = np.zeros(576)
        p = 0
        for i in range(g.long_end):
            v0 = gain - ((g.sf[i] + (PRETAB[i] if g.preflag else 0))
                         << shift)
            exps[p:p + band_long[i]] = v0
            p += band_long[i]
        if g.short_start < 13:
            k = g.long_end
            gains = [gain - (sg << 3) for sg in g.subblock_gain]
            for i in range(g.short_start, 13):
                ln = band_short[i]
                for w in range(3):
                    v0 = gains[w] - (g.sf[k] << shift)
                    k += 1
                    exps[p:p + ln] = v0
                    p += ln
        g.xr = np.sign(x) * np.abs(x) ** (4.0 / 3.0) \
            * 2.0 ** (exps / 4.0)

    def _reorder(self, g: Granule, sr_idx: int):
        if g.block_type != 2:
            return
        band_short = T.BAND_SIZE_SHORT[sr_idx]
        xr = g.xr
        out = xr.copy()
        pos = 36 if g.mixed else 0
        for sfb in range(g.short_start, 13):
            size = band_short[sfb]
            src = xr[pos:pos + 3 * size]
            out[pos:pos + 3 * size] = src.reshape(3, size).T.reshape(-1)
            pos += 3 * size
        g.xr = out

    def _alias(self, g: Granule):
        if g.block_type == 2 and not g.mixed:
            return
        nb = 1 if (g.block_type == 2 and g.mixed) else 31
        xr = g.xr
        idx = np.arange(8)
        for sb in range(1, nb + 1):
            base = 18 * sb
            lo = xr[base - 1 - idx].copy()
            hi = xr[base + idx].copy()
            xr[base - 1 - idx] = lo * _CS - hi * _CA
            xr[base + idx] = hi * _CS + lo * _CA

    def _hybrid(self, g: Granule, ch: int) -> np.ndarray:
        out = np.zeros((18, 32))
        xr = g.xr.reshape(32, 18)
        for sb in range(32):
            bt = g.block_type
            if g.mixed and sb < 2:
                bt = 0
            if bt == 2:
                raw = np.zeros(36)
                xw = xr[sb].reshape(6, 3).T     # [3 windows, 6 coeffs]
                for w in range(3):
                    raw[6 + 6 * w:18 + 6 * w] += (_IM12 @ xw[w]) * _WIN12
            else:
                raw = (_IM36 @ xr[sb]) * _WIN[bt]
            out[:, sb] = raw[:18] + self.overlap[ch, sb]
            self.overlap[ch, sb] = raw[18:]
        out[1::2, 1::2] *= -1                  # frequency inversion
        return out

    def _joint_stereo(self, gs, mode_ext: int, sr_idx: int, lsf: bool):
        l, r = gs[0].xr, gs[1].xr
        ms = bool(mode_ext & 2)
        intensity = bool(mode_ext & 1)
        bound = 576
        if intensity and not lsf and gs[1].block_type != 2:
            g1 = gs[1]
            band_long = T.BAND_SIZE_LONG[sr_idx]
            idx_long = np.concatenate([[0], np.cumsum(band_long)])
            nz = np.nonzero(r)[0]
            last = nz[-1] + 1 if len(nz) else 0
            sfb = int(np.searchsorted(idx_long, last))
            bound = int(idx_long[min(sfb, 22)])
            pos = bound
            for sband in range(sfb, 22):
                size = band_long[sband]
                is_pos = g1.sf[sband] if sband < 21 else 0
                if is_pos < 7:
                    ratio = _IS_TAB[is_pos]
                    seg = l[pos:pos + size].copy()
                    l[pos:pos + size] = seg * (ratio / (1 + ratio))
                    r[pos:pos + size] = seg * (1 / (1 + ratio))
                elif ms:
                    isq = np.sqrt(0.5)
                    a = l[pos:pos + size].copy()
                    b = r[pos:pos + size].copy()
                    l[pos:pos + size] = (a + b) * isq
                    r[pos:pos + size] = (a - b) * isq
                pos += size
        if ms:
            isq = np.sqrt(0.5)
            a = l[:bound].copy()
            b = r[:bound].copy()
            l[:bound] = (a + b) * isq
            r[:bound] = (a - b) * isq

    # -- main ---------------------------------------------------------
    def decode_frame(self, data: bytes, hdr: FrameHeader):
        nch = hdr.channels
        lsf = hdr.version_bits != 3
        sr_idx = _sr_index(hdr)
        mode = (data[3] >> 6) & 3
        mode_ext = (data[3] >> 4) & 3
        protected = not (data[1] & 1)
        br = BitReaderMSB(data, bit_pos=48 if protected else 32)
        main_begin, grans = self._side_info(br, nch, lsf, sr_idx)

        side_bytes = (br.pos + 7) // 8
        main_data = data[side_bytes:]
        if main_begin > len(self.reservoir):
            self.reservoir = (self.reservoir + main_data)[-511:]
            return np.zeros((nch, 0), np.float32)
        buf = (self.reservoir[len(self.reservoir) - main_begin:]
               + main_data) if main_begin else main_data
        self.reservoir = (self.reservoir + main_data)[-511:]
        mbr = BitReaderMSB(buf + b"\x00" * 16)

        ngr = len(grans)
        out = np.zeros((nch, 576 * ngr), np.float32)
        for gr in range(ngr):
            gs = []
            for ch in range(nch):
                g = grans[gr][ch]
                part2_start = mbr.pos
                if lsf:
                    self._scalefactors_lsf(
                        mbr, g, bool(mode_ext & 1) and ch == 1)
                else:
                    self._scalefactors_mpeg1(mbr, g, gr,
                                             grans[0][ch] if gr else None)
                x = self._huffman(mbr, g, part2_start)
                self._requantize(g, sr_idx, x)
                self._reorder(g, sr_idx)
                gs.append(g)
            if nch == 2 and mode == 1:
                self._joint_stereo(gs, mode_ext, sr_idx, lsf)
            for ch in range(nch):
                g = gs[ch]
                self._alias(g)
                t = self._hybrid(g, ch)
                for i in range(18):
                    self.v[ch] = np.roll(self.v[ch], 64)
                    self.v[ch][:64] = _N @ t[i]
                    u = np.zeros(512)
                    for k in range(8):
                        u[64 * k:64 * k + 32] = \
                            self.v[ch][128 * k:128 * k + 32]
                        u[64 * k + 32:64 * k + 64] = \
                            self.v[ch][128 * k + 96:128 * k + 128]
                    w = u * _D
                    s0 = gr * 576 + i * 32
                    out[ch, s0:s0 + 32] = w.reshape(16, 32).sum(axis=0)
        out *= OUTPUT_GAIN
        return out.astype(np.float32)


@register_decoder
class Mp3Decoder(Decoder):
    INFO = CodecInfo(name="mp3", long_name="MP3 (MPEG audio layer 3)",
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
        # Packets may carry several MPEG frames or split one across a
        # boundary (mpegts PES payloads); keep a carry buffer and an
        # in-band resync like the reference's mpegaudio parser, and
        # dispatch layer II frames to the layer-2 frame decoder
        # (mpegaudiodec decodes layers I-III under one codec id).
        carry = getattr(self, "_buf", b"")
        tick = getattr(self, "_tick", None)
        if not carry and pkt.pts != NOPTS:
            # trust sample-accurate continuity over per-PES pts jitter;
            # resync only on a real discontinuity (> 2 frames off)
            if tick is None or abs(pkt.pts - self._pts) > 2 * tick:
                self._pts = pkt.pts
        buf = carry + bytes(pkt.data)
        pos = 0
        out = []
        self._pending_skip, discard = skip_side_data(pkt,
                                                     self._pending_skip)
        tb = (pkt.time_base
              if pkt.time_base.valid and pkt.time_base.num else None)
        while True:
            hdr = None
            while pos + 4 <= len(buf):
                hdr = FrameHeader.parse(buf[pos:pos + 4])
                if hdr is not None:
                    break
                pos += 1
            if hdr is None or pos + hdr.frame_size > len(buf):
                break
            data = buf[pos:pos + hdr.frame_size]
            pos += hdr.frame_size
            if hdr.layer == 2:
                from librempeg_tpu_torch.codecs.mpegaudio import \
                    Mp2FrameDecoder

                if not isinstance(self._dec, Mp2FrameDecoder):
                    self._dec = Mp2FrameDecoder(hdr.channels)
            elif hdr.layer == 3:
                if not isinstance(self._dec, Mp3FrameDecoder):
                    self._dec = Mp3FrameDecoder(hdr.channels)
            else:
                continue                          # layer I: skip frame
            pcm = self._dec.decode_frame(data, hdr)
            if pcm.shape[1] == 0:
                # its main data began before the reservoir (the first
                # frame after a seek): no samples, but the frame's length
                # counts against the start skip, as libavcodec's decode
                # of it does
                self._pending_skip = max(0, self._pending_skip
                                         - hdr.samples)
                continue
            ftb = tb or Rational(1, hdr.sample_rate)
            pts = self._pts
            self._tick = round(pcm.shape[1] * ftb.den
                               / (hdr.sample_rate * ftb.num))
            self._pts += self._tick
            # the start skip runs on over frames; the end discard is the
            # packet's, for the last frame it holds
            last = FrameHeader.parse(buf[pos:pos + 4]) is None
            pcm, drop, self._pending_skip = trim(
                pcm, self._pending_skip, discard if last else 0)
            if not pcm.shape[1]:
                continue
            out.append(AudioFrame(
                data=torch.from_numpy(np.ascontiguousarray(pcm))
                .to(self.device), sample_rate=hdr.sample_rate,
                sample_fmt="fltp",
                layout=ChannelLayout.default(pcm.shape[0]),
                pts=pts + rescale_q(drop, Rational(1, hdr.sample_rate), ftb),
                time_base=ftb))
        self._buf = buf[pos:]
        if not out and carry == b"" and pos == 0 and len(buf) >= 4:
            raise InvalidData("mp3: bad frame header")
        return out
