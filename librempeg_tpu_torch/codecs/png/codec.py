"""PNG decoder + encoder.

Analog of libavcodec/pngdec.c, pngenc.c: zlib inflate /
deflate (Python's zlib is the same C library the reference links),
row predictors in the native C++ extension, chunk plumbing here.

Supports 8/16-bit gray, RGB, RGBA (the formats the scale engine speaks);
palette and interlaced images are decoded via explicit expansion.

A copy of librempeg_tpu/codecs/png/codec.py (host code, no JAX),
imports rewritten. The row filters run only in the native library: where
it is unavailable, decode and encode raise (the JAX package falls back
to Python). `_unfilter_py` and `_filter_py` are their plain versions,
which the tests hold the native code to. The decoder's frames carry
tensors on its device; the encoder fetches planes from theirs.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from librempeg_tpu_torch.codecs.api import (
    CodecInfo,
    Decoder,
    Encoder,
    register_decoder,
    register_encoder,
)
from librempeg_tpu_torch.core.errors import InvalidData, Unsupported
from librempeg_tpu_torch.core.frame import VideoFrame
from librempeg_tpu_torch.core.options import Option, OptionTable
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import NOPTS, Rational
from librempeg_tpu_torch.device import resolve
from librempeg_tpu_torch.native import build as native

_SIG = b"\x89PNG\r\n\x1a\n"

# color type -> (channels, base format name fn(bitdepth))
_COLOR_TYPES = {
    0: (1, lambda d: "gray" if d == 8 else "gray16le"),
    2: (3, lambda d: "rgb24" if d == 8 else "rgb48le"),
    3: (1, lambda d: "pal8"),
    4: (2, lambda d: "ya8"),
    6: (4, lambda d: "rgba" if d == 8 else "rgba64le"),
}


def decode_png(data: bytes) -> VideoFrame:
    if not data.startswith(_SIG):
        raise InvalidData("not a PNG")
    pos = 8
    width = height = 0
    bit_depth = 8
    color_type = 2
    interlace = 0
    palette = None
    trns = None
    idat = bytearray()
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8: pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            (width, height, bit_depth, color_type, _comp, _filt,
             interlace) = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(chunk, np.uint8)
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
    if not width or not idat:
        raise InvalidData("PNG: missing IHDR/IDAT")
    if interlace:
        raise Unsupported("interlaced PNG (Adam7)")
    if bit_depth not in (8, 16):
        raise Unsupported(f"PNG bit depth {bit_depth}")
    if color_type not in _COLOR_TYPES:
        raise InvalidData(f"PNG color type {color_type}")

    channels, fmt_fn = _COLOR_TYPES[color_type]
    bpp = channels * bit_depth // 8
    stride = width * bpp
    raw = zlib.decompress(bytes(idat))
    if len(raw) < height * (stride + 1):
        raise InvalidData("PNG: truncated image data")
    if not native.available():
        raise Unsupported("native extension unavailable for PNG decode")
    img = native.png_unfilter(raw, height, stride, bpp)
    img = img.reshape(height, stride)

    if color_type == 3:  # palette -> rgb24/rgba
        if palette is None:
            raise InvalidData("PNG: palette missing")
        idx = img.reshape(height, width)
        if trns is not None:
            a = np.full(256, 255, np.uint8)
            a[:len(trns)] = trns
            rgba = np.zeros((height, width, 4), np.uint8)
            rgba[..., :3] = palette[idx]
            rgba[..., 3] = a[idx]
            return VideoFrame(planes=(rgba,), format="rgba", width=width,
                              height=height, color_range="jpeg")
        return VideoFrame(planes=(palette[idx],), format="rgb24",
                          width=width, height=height, color_range="jpeg")
    if color_type == 4:  # gray+alpha -> rgba
        ga = img.reshape(height, width, 2)
        rgba = np.zeros((height, width, 4), np.uint8)
        rgba[..., 0] = rgba[..., 1] = rgba[..., 2] = ga[..., 0]
        rgba[..., 3] = ga[..., 1]
        return VideoFrame(planes=(rgba,), format="rgba", width=width,
                          height=height, color_range="jpeg")

    fmt = fmt_fn(bit_depth)
    if bit_depth == 16:
        # PNG is big-endian; our 16-bit formats are little-endian
        arr = img.reshape(height, width, channels, 2)[..., ::-1].copy()
        arr = arr.view(np.uint16).reshape(height, width, channels)
        plane = arr if channels > 1 else arr[..., 0]
    else:
        plane = (img.reshape(height, width, channels) if channels > 1
                 else img.reshape(height, width))
    return VideoFrame(planes=(plane,), format=fmt, width=width,
                      height=height, color_range="jpeg").validate()


def _unfilter_py(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros(h * stride, np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ft = raw[y * (stride + 1)]
        row = raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)].astype(np.int32)
        o = out[y * stride:(y + 1) * stride]
        if ft == 0:
            o[:] = row
        elif ft == 2:
            o[:] = (row + prev) & 255
        else:
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if ft == 1:
                    v = row[x] + a
                elif ft == 3:
                    v = row[x] + ((a + b) >> 1)
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                    v = row[x] + pr
                cur[x] = v & 255
            o[:] = cur
        prev = o.astype(np.int32)
    return out


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_py(img: np.ndarray, h: int, stride: int, bpp: int) -> bytes:
    """The plain version of the native png_filter: per row, the filter
    of least sum of absolute differences (the first of equals)."""
    rows = img.reshape(h, stride).astype(np.int32)
    out = bytearray()
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        x = rows[y]
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])[:stride]
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])[:stride]
        cands = [(x - p) & 255 for p in (0, a, prev, (a + prev) >> 1,
                                         _paeth(a, prev, c))]
        sums = [int(np.minimum(t, 256 - t).sum()) for t in cands]
        f = int(np.argmin(sums))
        out += bytes([f]) + cands[f].astype(np.uint8).tobytes()
        prev = x
    return bytes(out)


def encode_png(frame: VideoFrame, compression: int = 6) -> bytes:
    fmt = frame.format
    p0 = frame.planes[0]
    plane = p0.cpu().numpy() if isinstance(p0, torch.Tensor) else \
        np.asarray(p0)
    if fmt == "gray":
        color_type, channels, depth = 0, 1, 8
        img = plane
    elif fmt == "rgb24":
        color_type, channels, depth = 2, 3, 8
        img = plane
    elif fmt == "rgba":
        color_type, channels, depth = 6, 4, 8
        img = plane
    elif fmt == "rgb48le":
        color_type, channels, depth = 2, 3, 16
        img = plane.astype(">u2").view(np.uint8).reshape(frame.height, -1)
    elif fmt == "gray16le":
        color_type, channels, depth = 0, 1, 16
        img = plane.astype(">u2").view(np.uint8).reshape(frame.height, -1)
    else:
        raise Unsupported(f"PNG encode from {fmt}")
    h, w = frame.height, frame.width
    bpp = channels * depth // 8
    stride = w * bpp
    flat = np.ascontiguousarray(img).reshape(h, stride)
    if not native.available():
        raise Unsupported("native extension unavailable for PNG encode")
    filtered = native.png_filter(flat, h, stride, bpp)
    out = bytearray(_SIG)

    def chunk(tag: bytes, body: bytes):
        out.extend(struct.pack(">I", len(body)))
        out.extend(tag)
        out.extend(body)
        out.extend(struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0))
    chunk(b"IDAT", zlib.compress(bytes(filtered), compression))
    chunk(b"IEND", b"")
    return bytes(out)


@register_decoder
class PngDecoder(Decoder):
    INFO = CodecInfo(name="png", long_name="PNG", codec_type="video")

    def __init__(self, params=None, device="cuda", **opts):
        self.device = resolve(device)
        super().__init__(params, **opts)

    def decode(self, pkt: Packet):
        f = decode_png(bytes(pkt.data))
        tb = pkt.time_base if pkt.time_base.valid and pkt.time_base.num else \
            Rational(1, 25)
        return [f.to_device(self.device).replace(pts=pkt.pts, time_base=tb)]


@register_encoder
class PngEncoder(Encoder):
    INFO = CodecInfo(name="png", long_name="PNG", codec_type="video")
    OPTIONS = OptionTable(
        Option("compression_level", int, 6, min=0, max=9),
    )

    def __init__(self, width=0, height=0, pix_fmt="rgb24", device=None,
                 **opts):
        # `device` is the chain's; the planes are fetched from theirs
        super().__init__(**opts)
        self.width, self.height = width, height
        self.pix_fmt = pix_fmt
        self.time_base = Rational(1, 25)
        self._next_pts = 0

    def codec_parameters(self):
        from librempeg_tpu_torch.formats.api import CodecParameters

        return CodecParameters(codec_type="video", codec_id="png",
                               width=self.width, height=self.height,
                               pix_fmt=self.pix_fmt)

    def encode(self, frame: VideoFrame):
        data = encode_png(frame, self.opts["compression_level"])
        pts = frame.pts if frame.pts != NOPTS else self._next_pts
        self._next_pts = pts + 1
        return [Packet(data=data, pts=pts, dts=pts, duration=1,
                       flags=PktFlags.KEY, time_base=frame.time_base)]
