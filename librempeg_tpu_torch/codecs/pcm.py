"""PCM codec family: raw sample (de)serialization and sample-format
conversion.

Port of librempeg_tpu/codecs/pcm.py (libavcodec/pcm.c analog). The byte
packing is a host copy; the decoder uploads each packet's samples to
`device` as a [channels, samples] tensor in the codec's native width,
and the encoder fetches its frame's samples once to pack them. DECODERS
and ENCODERS list the names this module registers, one class each.

`to_float` and `from_float` take tensors on any device and keep the JAX
package's scaling (s16/2^15, s32/2^31, u8 offset-binary) and its
round-half-to-even (torch.round, as np.rint). One deviation:
`from_float(..., "s32")` clamps before the integer cast, so +1.0 gives
2147483647 where the JAX package clips in float32 and wraps to -2^31.
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
from librempeg_tpu_torch.core.errors import Unsupported
from librempeg_tpu_torch.core.frame import AudioFrame
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import NOPTS, Rational
from librempeg_tpu_torch.core.samplefmt import ChannelLayout
from librempeg_tpu_torch.device import resolve


def _alaw_table() -> np.ndarray:
    """A-law byte -> s16 decode table (ITU-T G.711)."""
    out = np.zeros(256, np.int16)
    for a in range(256):
        v = a ^ 0x55
        t = (v & 0x0F) << 4
        seg = (v & 0x70) >> 4
        if seg == 0:
            t += 8
        elif seg == 1:
            t += 0x108
        else:
            t = (t + 0x108) << (seg - 1)
        out[a] = t if v & 0x80 else -t  # sign bit set -> positive
    return out


def _mulaw_table() -> np.ndarray:
    """mu-law byte -> s16 decode table (ITU-T G.711)."""
    out = np.zeros(256, np.int16)
    for u in range(256):
        v = ~u & 0xFF
        seg = (v >> 4) & 0x07
        mant = v & 0x0F
        val = ((mant << 3) + 0x84) << seg
        val -= 0x84
        out[u] = -val if v & 0x80 else val
    return out


_PCM_SPECS: dict[str, dict] = {
    "pcm_u8": dict(dtype="u1", bits=8),
    "pcm_s16le": dict(dtype="<i2", bits=16),
    "pcm_s16be": dict(dtype=">i2", bits=16),
    "pcm_s24le": dict(dtype=None, bits=24),
    "pcm_s32le": dict(dtype="<i4", bits=32),
    "pcm_s32be": dict(dtype=">i4", bits=32),
    "pcm_f32le": dict(dtype="<f4", bits=32),
    "pcm_f32be": dict(dtype=">f4", bits=32),
    "pcm_f64le": dict(dtype="<f8", bits=64),
    "pcm_alaw": dict(dtype="u1", bits=8, table=_alaw_table),
    "pcm_mulaw": dict(dtype="u1", bits=8, table=_mulaw_table),
}

_SAMPLE_FMT = {
    "pcm_u8": "u8", "pcm_s16le": "s16", "pcm_s16be": "s16",
    "pcm_s24le": "s32", "pcm_s32le": "s32", "pcm_s32be": "s32",
    "pcm_f32le": "flt", "pcm_f32be": "flt", "pcm_f64le": "dbl",
    "pcm_alaw": "s16", "pcm_mulaw": "s16",
}

#: codec names with a decoder / an encoder here
DECODERS = tuple(_PCM_SPECS)
ENCODERS = tuple(n for n, s in _PCM_SPECS.items() if "table" not in s)


def _decode_bytes(codec: str, data: bytes, channels: int) -> np.ndarray:
    """bytes -> [channels, samples] array in the codec's native width
    (native byte order)."""
    spec = _PCM_SPECS[codec]
    if codec == "pcm_s24le":
        raw = np.frombuffer(data, np.uint8)
        raw = raw[: len(raw) - len(raw) % 3].reshape(-1, 3).astype(np.uint32)
        v = raw[:, 0] | raw[:, 1] << 8 | raw[:, 2] << 16
        v = v.astype(np.int32)
        v = (v << 8) >> 8  # sign extend 24 -> 32
        flat = v
    else:
        flat = np.frombuffer(data, spec["dtype"])
        if "table" in spec:
            flat = spec["table"]()[flat]
        flat = flat.astype(flat.dtype.newbyteorder("="))
    n = len(flat) - len(flat) % channels
    return np.ascontiguousarray(flat[:n].reshape(-1, channels).T)


def _encode_array(codec: str, samples: np.ndarray) -> bytes:
    """[channels, samples] -> interleaved bytes in the codec's width."""
    spec = _PCM_SPECS[codec]
    inter = np.ascontiguousarray(samples.T)
    if codec == "pcm_s24le":
        v = inter.astype(np.int32).reshape(-1)
        b = np.zeros((len(v), 3), np.uint8)
        b[:, 0] = v & 0xFF
        b[:, 1] = (v >> 8) & 0xFF
        b[:, 2] = (v >> 16) & 0xFF
        return b.tobytes()
    if "table" in spec:
        raise NotImplementedError(f"{codec} encoding")
    return inter.astype(spec["dtype"]).tobytes()


class PcmDecoder(Decoder):
    """Decoder of one PCM codec (`codec` names it): each packet becomes
    one frame whose samples lie on `device`."""

    INFO = CodecInfo(name="pcm", long_name="PCM", codec_type="audio")

    def __init__(self, codec: str, params=None, device="cuda", **opts):
        if codec not in _PCM_SPECS:
            raise ValueError(f"unknown PCM codec {codec!r}")
        self.codec = codec
        self.device = resolve(device)
        #: the sample format of the frames it returns
        self.sample_fmt = _SAMPLE_FMT[codec] + "p"
        super().__init__(params, **opts)

    def configure(self, params):
        self.sample_rate = params.sample_rate
        self.channels = params.nb_channels
        # the stream's layout where its container has one (a WAV's
        # channel mask), else the default of its channel count
        lay = params.ch_layout
        self.layout = lay if lay and lay.mask else \
            ChannelLayout.default(self.channels)

    def decode(self, pkt: Packet):
        data = _decode_bytes(self.codec, pkt.data, self.channels)
        return [AudioFrame(
            data=torch.from_numpy(data).to(self.device),
            sample_rate=self.sample_rate,
            sample_fmt=self.sample_fmt,
            layout=self.layout,
            pts=pkt.pts,
            time_base=pkt.time_base if pkt.time_base.valid
            and pkt.time_base.num else Rational(1, self.sample_rate),
        )]


class PcmEncoder(Encoder):
    """Encoder of one PCM codec: converts the frame's samples to the
    codec's width on their device, then fetches them once to pack."""

    INFO = CodecInfo(name="pcm", long_name="PCM", codec_type="audio")

    def __init__(self, codec: str, sample_rate=48000, channels=2,
                 device=None, **opts):
        # `device` is the chain's; the conversion runs where each frame's
        # samples lie
        if codec not in ENCODERS:
            raise ValueError(f"no PCM encoder {codec!r}")
        super().__init__(**opts)
        self.codec = codec
        self.sample_rate = sample_rate
        self.channels = channels
        self.time_base = Rational(1, sample_rate)
        self._next_pts = 0

    def codec_parameters(self):
        from librempeg_tpu_torch.formats.api import CodecParameters

        bits = _PCM_SPECS[self.codec]["bits"]
        return CodecParameters(
            codec_type="audio",
            codec_id=self.codec,
            sample_rate=self.sample_rate,
            nb_channels=self.channels,
            block_align=self.channels * (bits // 8),
            bit_rate=self.sample_rate * self.channels * bits,
        )

    def encode(self, frame: AudioFrame):
        x = frame.data
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        target_float = _SAMPLE_FMT[self.codec] in ("flt", "dbl")
        if x.is_floating_point() and not target_float:
            # float [-1,1) planar -> integer target (swr semantics);
            # a cast alone would truncate everything to silence
            if self.codec == "pcm_s24le":
                raise Unsupported("pcm_s24le: no float -> s24 conversion")
            x = from_float(x.to(torch.float32), _SAMPLE_FMT[self.codec])
        elif target_float and not x.is_floating_point():
            x = to_float(x, frame.sample_fmt)
        data = _encode_array(self.codec, x.cpu().numpy())
        pts = frame.pts if frame.pts != NOPTS else self._next_pts
        self._next_pts = pts + frame.nb_samples
        return [Packet(
            data=data, pts=pts, dts=pts, duration=frame.nb_samples,
            flags=PktFlags.KEY, time_base=Rational(1, frame.sample_rate),
        )]


# -- sample format conversion (samplefmt/audioconvert analog) ---------------

def to_float(samples: torch.Tensor, sample_fmt: str) -> torch.Tensor:
    """Any integer/float PCM tensor -> float32 in [-1, 1), on the same
    device: s16/2^15, s32/2^31, u8 offset-binary."""
    base = sample_fmt.rstrip("p")
    if base in ("flt", "dbl"):
        return samples.to(torch.float32)
    if base == "s16":
        return samples.to(torch.float32) / 32768.0
    if base == "s32":
        return samples.to(torch.float32) / 2147483648.0
    if base == "u8":
        return (samples.to(torch.float32) - 128.0) / 128.0
    raise ValueError(f"unknown sample format {sample_fmt}")


def from_float(samples: torch.Tensor, sample_fmt: str) -> torch.Tensor:
    """float32 [-1,1) -> the target format, rounded half to even and
    clipped (the JAX package's dither argument has no caller and is
    not carried; resample.Ditherer dithers)."""
    base = sample_fmt.rstrip("p")
    if base == "flt":
        return samples.to(torch.float32)
    if base == "dbl":
        return samples.to(torch.float64)
    scale, off, lo, hi, dt = _INT_FORMATS.get(base, (None,) * 5)
    if scale is None:
        raise ValueError(f"unknown sample format {sample_fmt}")
    x = samples * scale
    if off:
        x = x + off
    return clip_to_int(torch.round(x), lo, hi, dt)


#: base format -> (scale, offset, min, max, dtype) of the integer formats
_INT_FORMATS = {
    "u8": (128.0, 128.0, 0, 255, torch.uint8),
    "s16": (32768.0, 0.0, -32768, 32767, torch.int16),
    "s32": (2147483648.0, 0.0, -2 ** 31, 2 ** 31 - 1, torch.int32),
}


def clip_to_int(y: torch.Tensor, lo: int, hi: int, dtype) -> torch.Tensor:
    """Integer-valued float32 samples -> dtype, clamped to [lo, hi] in
    int64 (a float32 clamp cannot hold 2^31 - 1: it rounds to 2^31,
    which wraps)."""
    return y.to(torch.int64).clamp(lo, hi).to(dtype)


def _register(base, codec: str, register) -> None:
    """Register `base` bound to one PCM codec under the codec's name."""
    def init(self, *args, **kw):
        base.__init__(self, codec, *args, **kw)

    register(type(f"{base.__name__}_{codec}", (base,), {
        "INFO": CodecInfo(name=codec, long_name=f"PCM {codec[4:]}",
                          codec_type="audio"),
        "__init__": init}))


for _name in DECODERS:
    _register(PcmDecoder, _name, register_decoder)
for _name in ENCODERS:
    _register(PcmEncoder, _name, register_encoder)
