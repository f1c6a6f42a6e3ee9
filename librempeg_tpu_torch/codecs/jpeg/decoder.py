"""JPEG / MJPEG decoder.

Port of librempeg_tpu/codecs/jpeg/decoder.py (analog of
libavcodec/mjpegdec.c). The host parses markers, validates the tables
and runs the serial Huffman scan decode in the native library
(native/bitstream.cpp, the port's copy), then puts each component's
blocks in raster order with numpy. Each component's coefficients are
uploaded once, as int16, and the per-pixel half runs on `device`:
dequant, de-zigzag (a gather with tables.UNZIGZAG), the integer
simple_idct (ops/dct8x8.idct_int, bit-exact with the JAX package's
int32 arithmetic), the level shift, the clamp and the block placement.

Supports baseline sequential DCT (SOF0; SOF1 extended sequential with
8-bit samples decodes identically), grayscale and 4:4:4 / 4:2:2 /
4:2:0 / 4:1:1 subsampling, restart intervals, and multi-frame MJPEG
streams (one packet = one JPEG image).
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from librempeg_tpu_torch.codecs.api import CodecInfo, Decoder, register_decoder
from librempeg_tpu_torch.codecs.jpeg import tables as T
from librempeg_tpu_torch.core import pixfmt as pf
from librempeg_tpu_torch.core.errors import InvalidData, Unsupported
from librempeg_tpu_torch.core.frame import VideoFrame
from librempeg_tpu_torch.core.rational import Rational
from librempeg_tpu_torch.device import resolve
from librempeg_tpu_torch.native import build as native
from librempeg_tpu_torch.ops import dct8x8
from librempeg_tpu_torch.utils.stagetimer import stage

# markers
SOI, EOI, SOS, DQT, DHT, DRI = 0xD8, 0xD9, 0xDA, 0xDB, 0xC4, 0xDD
SOF0, SOF1, SOF2 = 0xC0, 0xC1, 0xC2

_UNZIGZAG: dict = {}


def _blocks_to_plane(coeffs_zz: torch.Tensor, qtab: torch.Tensor, h8: int,
                     w8: int) -> torch.Tensor:
    """[nblocks, 64] zigzag int16 -> [h8*8, w8*8] uint8 plane, on the
    coefficients' device: dequant, de-zigzag, integer IDCT, level shift,
    clamp, block placement."""
    dev = coeffs_zz.device
    unzz = _UNZIGZAG.get(str(dev))
    if unzz is None:
        unzz = _UNZIGZAG[str(dev)] = torch.as_tensor(
            T.UNZIGZAG, dtype=torch.int64, device=dev)
    dq = coeffs_zz.to(torch.int32) * qtab[None, :]
    raster = dq[:, unzz].reshape(-1, 8, 8)
    pix = (dct8x8.idct_int(raster) + 128).clamp(0, 255).to(torch.uint8)
    return dct8x8.from_blocks(pix, h8 * 8, w8 * 8)


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "dc", "ac")

    def __init__(self):
        self.cid = 0
        self.h = self.v = 1
        self.tq = self.dc = self.ac = 0


@register_decoder
class JpegDecoder(Decoder):
    INFO = CodecInfo(name="mjpeg", long_name="Motion JPEG / JPEG",
                     codec_type="video")

    def __init__(self, params=None, device="cuda", **opts):
        self.device = resolve(device)
        super().__init__(params, **opts)

    def decode(self, pkt):
        frame = decode_jpeg(bytes(pkt.data), device=self.device)
        tb = pkt.time_base if pkt.time_base.valid and pkt.time_base.num else \
            Rational(1, 25)
        return [frame.replace(pts=pkt.pts, time_base=tb)]


def decode_jpeg(data: bytes, device="cuda") -> VideoFrame:
    """Decode one JPEG image to a VideoFrame (yuvj* / gray) whose planes
    lie on `device`."""
    if len(data) < 4 or data[0] != 0xFF or data[1] != SOI:
        raise InvalidData("not a JPEG (missing SOI)")
    pos = 2
    qtabs: dict[int, np.ndarray] = {}
    dc_tables: dict[int, tuple] = {}
    ac_tables: dict[int, tuple] = {}
    comps: list[_Component] = []
    width = height = 0
    restart = 0
    progressive = False

    while pos < len(data) - 1:
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        pos += 2
        if marker in (SOI, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == EOI:
            break
        if pos + 2 > len(data):
            raise InvalidData("truncated JPEG segment")
        seglen = struct.unpack(">H", data[pos:pos + 2])[0]
        seg = data[pos + 2: pos + seglen]
        if marker == DQT:
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                p += 1
                if pq == 0:
                    qtabs[tq] = np.frombuffer(seg[p:p + 64], np.uint8
                                              ).astype(np.int32)
                    p += 64
                else:
                    qtabs[tq] = np.frombuffer(seg[p:p + 128], ">u2"
                                              ).astype(np.int32)
                    p += 128
        elif marker == DHT:
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                bits = np.frombuffer(seg[p + 1:p + 17], np.uint8)
                n = int(bits.sum())
                vals = np.frombuffer(seg[p + 17:p + 17 + n], np.uint8)
                (dc_tables if tc == 0 else ac_tables)[th] = (bits, vals)
                p += 17 + n
        elif marker in (SOF0, SOF1, SOF2):
            if marker == SOF2:
                progressive = True
            prec = seg[0]
            if prec != 8:
                raise Unsupported(f"JPEG precision {prec}")
            height, width = struct.unpack(">HH", seg[1:5])
            ncomp = seg[5]
            comps = []
            for c in range(ncomp):
                comp = _Component()
                comp.cid = seg[6 + 3 * c]
                comp.h = seg[7 + 3 * c] >> 4
                comp.v = seg[7 + 3 * c] & 15
                comp.tq = seg[8 + 3 * c]
                comps.append(comp)
        elif marker == DRI:
            restart = struct.unpack(">H", seg[:2])[0]
        elif marker == SOS:
            ns = seg[0]
            for i in range(ns):
                cs = seg[1 + 2 * i]
                tn = seg[2 + 2 * i]
                for comp in comps:
                    if comp.cid == cs:
                        comp.dc = tn >> 4
                        comp.ac = tn & 15
            scan_start = pos + seglen
            return _decode_scan(data, scan_start, comps, qtabs,
                                dc_tables, ac_tables, width, height,
                                restart, progressive, resolve(device))
        pos += seglen
    raise InvalidData("JPEG: no SOS marker found")


def _decode_scan(data, scan_start, comps, qtabs, dc_tables, ac_tables,
                 width, height, restart, progressive, device) -> VideoFrame:
    if progressive:
        raise Unsupported("progressive JPEG (baseline only)")
    if not native.available():
        raise Unsupported("native extension unavailable for JPEG decode")
    # All of this is file-controlled; validate before it reaches the
    # native scan decoder (the reference guards the same way: mjpegdec.c
    # table/index validation).
    if not comps:
        raise InvalidData("JPEG: SOS before SOF / no components")
    for c in comps:
        if not (1 <= c.h <= 4 and 1 <= c.v <= 4):
            raise InvalidData(f"JPEG: bad sampling factors {c.h}x{c.v}")
        if not (0 <= c.dc < 4 and 0 <= c.ac < 4):
            raise InvalidData("JPEG: huffman table index out of range")
        if c.dc not in dc_tables or c.ac not in ac_tables:
            raise InvalidData("JPEG: scan references undefined huffman table")
        if c.tq not in qtabs:
            raise InvalidData("JPEG: scan references undefined quant table")
    for kind, tabs in (("dc", dc_tables), ("ac", ac_tables)):
        for th, (bits, vals) in tabs.items():
            n = int(np.asarray(bits).sum())
            if n == 0 or n > 256 or n > len(vals):
                raise InvalidData(f"JPEG: malformed {kind} huffman table "
                                  f"{th}: {n} codes, {len(vals)} values")
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcus_x = -(-width // (8 * hmax))
    mcus_y = -(-height // (8 * vmax))
    mcu_count = mcus_x * mcus_y

    cspec = [{"h": c.h, "v": c.v, "dc": c.dc, "ac": c.ac} for c in comps]
    empty = (np.zeros(16, np.uint8), np.zeros(0, np.uint8))
    dct = [dc_tables.get(i, empty) for i in range(4)]
    act = [ac_tables.get(i, empty) for i in range(4)]
    with stage("jpeg.scan"):
        # scan data ends at EOI (the native reader stops at any marker)
        coeffs = native.jpeg_decode_scan(
            data[scan_start:], cspec, dct, act, mcu_count, restart)

    with stage("jpeg.device"):
        # split interleaved MCU blocks into per-component raster grids
        blocks_per_mcu = sum(c.h * c.v for c in comps)
        planes = []
        offset = 0
        for c in comps:
            nbx = mcus_x * c.h
            nby = mcus_y * c.v
            # this component's blocks inside each MCU, in MCU order
            sel = (np.arange(mcu_count)[:, None] * blocks_per_mcu + offset
                   + np.arange(c.h * c.v)[None, :]).reshape(-1)
            # MCU order -> raster block order
            order = np.arange(mcu_count * c.h * c.v).reshape(
                mcus_y, mcus_x, c.v, c.h).transpose(0, 2, 1, 3).reshape(-1)
            comp_blocks = np.ascontiguousarray(coeffs[sel][order])
            q = torch.from_numpy(qtabs[c.tq]).to(device)
            planes.append(_blocks_to_plane(
                torch.from_numpy(comp_blocks).to(device), q, nby, nbx))
            offset += c.h * c.v
        return _assemble_frame(planes, comps, width, height, hmax, vmax)


def _assemble_frame(planes, comps, width, height, hmax, vmax) -> VideoFrame:
    if len(comps) == 1:
        return VideoFrame(planes=(planes[0][:height, :width].contiguous(),),
                          format="gray", width=width, height=height,
                          color_range="jpeg").validate()
    if len(comps) != 3:
        raise Unsupported(f"JPEG with {len(comps)} components")
    sampling = (hmax // comps[1].h, vmax // comps[1].v)
    fmt_map = {(1, 1): "yuvj444p", (2, 1): "yuvj422p", (2, 2): "yuvj420p",
               (4, 1): "yuv411p", (1, 2): "yuv440p"}
    fmt = fmt_map.get(sampling)
    if fmt is None:
        raise Unsupported(f"JPEG sampling {sampling}")
    desc = pf.get(fmt)
    out = []
    for i, p in enumerate(planes):
        ph, pw = desc.plane_shape(i, height, width)
        out.append(p[:ph, :pw].contiguous())
    return VideoFrame(planes=tuple(out), format=fmt, width=width,
                      height=height, color_range="jpeg").validate()
