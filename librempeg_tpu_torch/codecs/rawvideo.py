"""Raw video codec: packet bytes <-> planar frames.

Port of librempeg_tpu/codecs/rawvideo.py (rawdec.c / rawenc.c analogs)
for the pixel formats the port speaks. The decoder splits a packet into
its planes on the host and uploads them to `device`, the encoder
fetches a frame's planes once to pack them. lavfi's video packets
(formats/lavfi.py) come through this decoder.
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
from librempeg_tpu_torch.core import pixfmt as pf
from librempeg_tpu_torch.core.errors import InvalidData
from librempeg_tpu_torch.core.frame import VideoFrame
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import NOPTS, Rational
from librempeg_tpu_torch.device import resolve


def bytes_to_frame(data: bytes, fmt: str, width: int, height: int
                   ) -> VideoFrame:
    """A packet's bytes -> a frame of numpy planes (host)."""
    d = pf.get(fmt)
    if len(data) < d.buffer_size(height, width):
        raise InvalidData(
            f"rawvideo: need {d.buffer_size(height, width)} bytes, "
            f"got {len(data)}")
    dt = np.uint8 if d.bit_depth <= 8 else (
        np.float32 if d.is_float else np.uint16)
    planes = []
    off = 0
    for i, p in enumerate(d.planes):
        ph, pw = d.plane_shape(i, height, width)
        ncomp = len(p.components)
        n = ph * pw * ncomp * d.bytes_per_component
        arr = np.frombuffer(data[off:off + n], dt)
        shape = (ph, pw) if ncomp == 1 else (ph, pw, ncomp)
        planes.append(arr.reshape(shape))
        off += n
    return VideoFrame(planes=tuple(planes), format=fmt, width=width,
                      height=height)


def frame_to_bytes(frame: VideoFrame) -> bytes:
    return b"".join(np.ascontiguousarray(
        p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
    ).tobytes() for p in frame.planes)


@register_decoder
class RawVideoDecoder(Decoder):
    INFO = CodecInfo(name="rawvideo", long_name="raw video",
                     codec_type="video")

    def __init__(self, params=None, device="cuda", **opts):
        self.device = resolve(device)
        super().__init__(params, **opts)

    def configure(self, params):
        self.width = params.width
        self.height = params.height
        self.fmt = params.pix_fmt or "yuv420p"

    def decode(self, pkt: Packet):
        # a writable buffer, so that the planes upload without a copy
        f = bytes_to_frame(bytearray(pkt.data), self.fmt, self.width,
                           self.height)
        tb = pkt.time_base if pkt.time_base.valid and pkt.time_base.num \
            else Rational(1, 25)
        return [f.to_device(self.device).replace(pts=pkt.pts,
                                                 time_base=tb)]


@register_encoder
class RawVideoEncoder(Encoder):
    INFO = CodecInfo(name="rawvideo", long_name="raw video",
                     codec_type="video")

    def __init__(self, width=0, height=0, pix_fmt="yuv420p", device=None,
                 **opts):
        # `device` is the chain's; the planes are fetched from theirs
        super().__init__(**opts)
        self.width, self.height = width, height
        self.pix_fmt = pix_fmt
        self.time_base = Rational(1, 25)
        self._next_pts = 0

    def codec_parameters(self):
        from librempeg_tpu_torch.formats.api import CodecParameters

        return CodecParameters(codec_type="video", codec_id="rawvideo",
                               width=self.width, height=self.height,
                               pix_fmt=self.pix_fmt)

    def encode(self, frame: VideoFrame):
        pts = frame.pts if frame.pts != NOPTS else self._next_pts
        self._next_pts = pts + 1
        return [Packet(data=frame_to_bytes(frame), pts=pts, dts=pts,
                       duration=1, flags=PktFlags.KEY,
                       time_base=frame.time_base)]
