"""JPEG / MJPEG encoder.

Port of librempeg_tpu/codecs/jpeg/encoder.py (analog of
libavcodec/mjpegenc.c). Each plane is uploaded once and transformed and
quantised on `device`: the float32 orthonormal DCT (TF32 off,
device.py) with the JPEG scaling folded in, then rounding half away
from zero, or with trellis the RD lattice of ops/trellis.viterbi_rl.
The levels are fetched once per plane; the host interleaves them into
MCU order, the native library (native/bitstream.cpp, the port's copy)
Huffman-codes the scan, and the JFIF headers are written here. Uses the
Annex K tables (like the reference's default tables).

A float contract: a level may differ from the JAX package's only where
the DCT lands on a rounding boundary.
"""
from __future__ import annotations

import functools
import struct

import numpy as np
import torch

from librempeg_tpu_torch.codecs.api import CodecInfo, Encoder, register_encoder
from librempeg_tpu_torch.codecs.jpeg import tables as T
from librempeg_tpu_torch.core.errors import Unsupported
from librempeg_tpu_torch.core.frame import VideoFrame
from librempeg_tpu_torch.core.options import Option, OptionTable
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import NOPTS, Rational
from librempeg_tpu_torch.device import resolve
from librempeg_tpu_torch.native import build as native
from librempeg_tpu_torch.ops import dct8x8
from librempeg_tpu_torch.ops.trellis import viterbi_rl
from librempeg_tpu_torch.utils.stagetimer import stage

_CONSTS: dict = {}


def _consts(dev: torch.device) -> tuple:
    """(JPEG scale [8, 8] float32, ZIGZAG int64) on `dev`, made once."""
    c = _CONSTS.get(str(dev))
    if c is None:
        c = _CONSTS[str(dev)] = (
            torch.as_tensor(_jpeg_scale(), dtype=torch.float32, device=dev),
            torch.as_tensor(T.ZIGZAG, dtype=torch.int64, device=dev))
    return c


def _dct_coeffs(plane: torch.Tensor) -> torch.Tensor:
    """uint8 plane [H, W] (multiples of 8) -> [nblocks, 8, 8] float32
    JPEG-scaled DCT coefficients."""
    scale, _ = _consts(plane.device)
    x = plane.to(torch.float32) - 128.0
    return dct8x8.fdct(dct8x8.to_blocks(x)) * scale


def _plane_to_coeffs(plane: torch.Tensor, qtab: torch.Tensor) -> torch.Tensor:
    """uint8 plane [H, W] -> [nblocks, 64] int16 zigzag quantised levels
    (rounding half away from zero like the reference's quantiser)."""
    _, zigzag = _consts(plane.device)
    q = _dct_coeffs(plane) / qtab.reshape(8, 8).to(torch.float32)
    half = torch.where(q >= 0, 0.5, -0.5)
    lev = torch.trunc(q + half).to(torch.int32)
    return lev.reshape(-1, 64)[:, zigzag].to(torch.int16)


@functools.lru_cache(maxsize=None)
def _huff_lengths(bits: tuple, vals: tuple) -> dict:
    """DHT (BITS, VALS) -> {symbol: code length}."""
    out = {}
    k = 0
    for ln, cnt in enumerate(bits, start=1):
        for _ in range(cnt):
            out[vals[k]] = ln
            k += 1
    return out


@functools.lru_cache(maxsize=None)
def _ac_bits_tables(chroma: bool):
    """Trellis bit-cost tables for the Annex K AC Huffman coder:
    (bits_notlast, bits_last) int32 [64 runs, 12 size categories].
    Runs > 15 decompose into ZRL codes; a last event additionally
    pays the EOB (exact except for a last coefficient at position
    63, where baseline JPEG omits EOB -- a constant few-bit
    overcount on that rare ending)."""
    bits = T.AC_CHROMA_BITS if chroma else T.AC_LUMA_BITS
    vals = T.AC_CHROMA_VALS if chroma else T.AC_LUMA_VALS
    ln = _huff_lengths(tuple(int(x) for x in bits),
                       tuple(int(x) for x in vals))
    zrl = ln[0xF0]
    eob = ln[0x00]
    b0 = np.zeros((64, 12), np.int32)
    for run in range(64):
        for size in range(1, 12):
            sym = ((run % 16) << 4) | size
            b0[run, size] = (run // 16) * zrl + ln.get(sym, 64) + size
    b1 = b0 + eob
    return b0, b1


def size_category(mag: torch.Tensor) -> torch.Tensor:
    """JPEG size category of magnitudes >= 1: their bit length, the JAX
    package's float ceil(log2(mag + 1)) computed exactly (frexp's
    exponent of an integer-valued float is its bit length)."""
    return torch.frexp(mag.to(torch.float32))[1].to(torch.int32)


def _plane_to_coeffs_rd(plane: torch.Tensor, qtab: torch.Tensor, lam: float,
                        chroma: bool) -> torch.Tensor:
    """Trellis variant of _plane_to_coeffs: RD-optimal AC levels under
    the component's Huffman table, conventional DC rounding.

    Behavioral counterpart of the reference's FMT_MJPEG trellis branch
    (mpegvideo_enc.c:4075); the lattice is ops/trellis.viterbi_rl.
    """
    dev = plane.device
    _, zigzag = _consts(dev)
    zzc = _dct_coeffs(plane).reshape(-1, 64)[:, zigzag]
    qt = qtab.reshape(-1)[zigzag].to(torch.float32)[None, :]
    mag = zzc.abs()
    l0 = torch.round(mag / qt).to(torch.int32)
    cands = torch.stack([l0.clamp(1, 1023), (l0 - 1).clamp(1, 1023)], -1)
    dist_c = (cands.to(torch.float32) * qt[..., None] - mag[..., None]) ** 2
    b0, b1 = _ac_bits_tables(chroma)
    zz = viterbi_rl(zzc, cands, dist_c, size_category(cands),
                    torch.as_tensor(b0, dtype=torch.float32, device=dev),
                    torch.as_tensor(b1, dtype=torch.float32, device=dev),
                    lam, 1)
    dc0 = zzc[:, 0]
    zz[:, 0] = torch.trunc(dc0 / qt[0, 0] + torch.where(dc0 >= 0, 0.5, -0.5)
                           ).to(torch.int32)
    return zz.to(torch.int16)


@functools.lru_cache(maxsize=None)
def _jpeg_scale() -> np.ndarray:
    """Orthonormal-DCT -> JPEG reference DCT scaling, per coefficient,
    derived numerically exactly as the JAX package derives it (the same
    seed and float64 arithmetic), as float32."""
    rng = np.random.default_rng(0)
    # JPEG reference DCT: S(k,l)=1/4 C(k)C(l) sum x cos cos
    j = np.arange(8)
    cos = np.cos((2 * j[None, :] + 1) * j[:, None] * np.pi / 16)
    cmat = np.ones(8)
    cmat[0] = 1 / np.sqrt(2)
    x = rng.standard_normal((8, 8))
    jpeg = 0.25 * np.outer(cmat, cmat) * (cos @ x @ cos.T)
    B = dct8x8._ortho_basis()
    ortho = B @ x @ B.T
    with np.errstate(divide="ignore", invalid="ignore"):
        s = jpeg / ortho
    s[~np.isfinite(s)] = 1.0
    return s.astype(np.float32)


def _dqt_segment(tid: int, q: np.ndarray) -> bytes:
    zz = q.reshape(-1)[T.ZIGZAG]
    return struct.pack(">HB", 2 + 1 + 64, tid) + bytes(
        int(v) for v in zz)


def _dht_segment(tc: int, th: int, bits: np.ndarray, vals: np.ndarray) -> bytes:
    body = bytes([tc << 4 | th]) + bytes(bits) + bytes(vals)
    return struct.pack(">H", 2 + len(body)) + body


@register_encoder
class JpegEncoder(Encoder):
    INFO = CodecInfo(name="mjpeg", long_name="Motion JPEG / JPEG",
                     codec_type="video")
    OPTIONS = OptionTable(
        Option("quality", int, 90, alias="q", min=1, max=100),
        Option("trellis", int, 0, min=0, max=2,
               help="RD (trellis) AC coefficient quantization"),
    )

    def __init__(self, width=0, height=0, pix_fmt="yuvj420p", device="cuda",
                 **opts):
        super().__init__(**opts)
        self.device = resolve(device)
        self.width, self.height = width, height
        self.pix_fmt = pix_fmt
        self.time_base = Rational(1, 25)
        self._next_pts = 0

    def codec_parameters(self):
        from librempeg_tpu_torch.formats.api import CodecParameters

        return CodecParameters(
            codec_type="video", codec_id="mjpeg",
            width=self.width, height=self.height, pix_fmt=self.pix_fmt)

    def encode(self, frame: VideoFrame):
        # the JAX package drops the trellis option here
        # (encoder.py:186-187); the port passes it through
        data = encode_jpeg(frame, quality=self.opts["quality"],
                           trellis=self.opts["trellis"], device=self.device)
        pts = frame.pts if frame.pts != NOPTS else self._next_pts
        self._next_pts = pts + 1
        return [Packet(data=data, pts=pts, dts=pts, duration=1,
                       flags=PktFlags.KEY, time_base=frame.time_base)]


def _pad_edge(plane: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Replicate the last row and column out to [ph, pw]."""
    h, w = plane.shape
    if (h, w) == (ph, pw):
        return plane
    dev = plane.device
    rows = torch.arange(ph, device=dev).clamp(max=h - 1)
    cols = torch.arange(pw, device=dev).clamp(max=w - 1)
    return plane[rows][:, cols]


def encode_jpeg(frame: VideoFrame, quality: int = 90, trellis: int = 0,
                device="cuda") -> bytes:
    """Encode one VideoFrame (yuvj420p/yuvj444p/yuvj422p/yuv4xxp/gray)
    as JPEG, its planes transformed and quantised on `device`."""
    if not native.available():
        raise Unsupported("native extension unavailable for JPEG encode")
    dev = resolve(device)
    fmt = frame.format
    if fmt in ("yuvj420p", "yuv420p"):
        sampling = [(2, 2), (1, 1), (1, 1)]
    elif fmt in ("yuvj444p", "yuv444p"):
        sampling = [(1, 1), (1, 1), (1, 1)]
    elif fmt in ("yuvj422p", "yuv422p"):
        sampling = [(2, 1), (1, 1), (1, 1)]
    elif fmt == "gray":
        sampling = [(1, 1)]
    else:
        raise Unsupported(f"JPEG encode from {fmt}")
    ncomp = len(sampling)
    w, h = frame.width, frame.height
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcus_x = -(-w // (8 * hmax))
    mcus_y = -(-h // (8 * vmax))
    mcu_count = mcus_x * mcus_y

    lq = T.quant_for_quality(T.STD_LUMA_QUANT, quality)
    cq = T.quant_for_quality(T.STD_CHROMA_QUANT, quality)
    # lambda follows the frame's quality point (the reference scales its
    # trellis lambda with qscale^2; the quality-folded tables play that
    # role)
    lam = 0.85 * float(np.mean(lq.reshape(-1)[1:])) ** 2

    # per-component quantised zigzag blocks in raster block order
    comp_blocks = []
    for i in range(ncomp):
        ch, cv = sampling[i]
        nbx, nby = mcus_x * ch, mcus_y * cv
        q = lq if i == 0 else cq
        with stage("jpeg.device"):
            plane = frame.planes[i]
            plane = (plane.to(dev) if isinstance(plane, torch.Tensor)
                     else torch.from_numpy(np.ascontiguousarray(plane)).to(dev))
            plane = _pad_edge(plane, nby * 8, nbx * 8)
            qt = torch.from_numpy(q.reshape(-1)).to(dev)
            if trellis:
                zz = _plane_to_coeffs_rd(plane, qt, lam, i > 0)
            else:
                zz = _plane_to_coeffs(plane, qt)
        with stage("jpeg.fetch"):
            zz = zz.cpu().numpy()
        comp_blocks.append((zz, nbx, nby, ch, cv))

    with stage("jpeg.scan"):
        # interleave into MCU order
        blocks_per_mcu = sum(s[0] * s[1] for s in sampling)
        inter = np.zeros((mcu_count * blocks_per_mcu, 64), np.int16)
        offset = 0
        for zz, nbx, nby, ch, cv in comp_blocks:
            order = np.arange(nby * nbx).reshape(
                mcus_y, cv, mcus_x, ch).transpose(0, 2, 1, 3).reshape(-1)
            dst = (np.arange(mcu_count)[:, None] * blocks_per_mcu + offset
                   + np.arange(ch * cv)[None, :]).reshape(-1)
            inter[dst] = zz[order]
            offset += ch * cv

        cspec = [{"h": s[0], "v": s[1], "dc": 0 if i == 0 else 1,
                  "ac": 0 if i == 0 else 1} for i, s in enumerate(sampling)]
        dct_tabs = [(T.DC_LUMA_BITS, T.DC_LUMA_VALS),
                    (T.DC_CHROMA_BITS, T.DC_CHROMA_VALS)]
        act_tabs = [(T.AC_LUMA_BITS, T.AC_LUMA_VALS),
                    (T.AC_CHROMA_BITS, T.AC_CHROMA_VALS)]
        scan = native.jpeg_encode_scan(inter, cspec, dct_tabs, act_tabs,
                                       mcu_count)

    # headers
    out = bytearray()
    out += b"\xFF\xD8"                       # SOI
    out += b"\xFF\xE0" + struct.pack(">H", 16) + b"JFIF\0" + \
        bytes([1, 1, 0]) + struct.pack(">HH", 1, 1) + bytes([0, 0])
    out += b"\xFF\xDB" + _dqt_segment(0, lq)
    if ncomp > 1:
        out += b"\xFF\xDB" + _dqt_segment(1, cq)
    out += b"\xFF\xC0" + struct.pack(">HBHHB", 8 + 3 * ncomp, 8, h, w, ncomp)
    for i in range(ncomp):
        out += bytes([i + 1, sampling[i][0] << 4 | sampling[i][1],
                      0 if i == 0 else 1])
    out += b"\xFF\xC4" + _dht_segment(0, 0, T.DC_LUMA_BITS, T.DC_LUMA_VALS)
    out += b"\xFF\xC4" + _dht_segment(1, 0, T.AC_LUMA_BITS, T.AC_LUMA_VALS)
    if ncomp > 1:
        out += b"\xFF\xC4" + _dht_segment(0, 1, T.DC_CHROMA_BITS,
                                          T.DC_CHROMA_VALS)
        out += b"\xFF\xC4" + _dht_segment(1, 1, T.AC_CHROMA_BITS,
                                          T.AC_CHROMA_VALS)
    out += b"\xFF\xDA" + struct.pack(">HB", 6 + 2 * ncomp, ncomp)
    for i in range(ncomp):
        out += bytes([i + 1, 0 if i == 0 else 0x11])
    out += bytes([0, 63, 0])
    out += scan
    out += b"\xFF\xD9"                       # EOI
    return bytes(out)
