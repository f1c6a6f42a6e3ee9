"""xfade, minterpolate, showwaves, showspectrum, afir, testsrc.

Port of librempeg_tpu/filters/video3.py (vf_xfade.c, vf_minterpolate.c,
avf_showwaves.c, avf_showspectrum.c, af_afir.c, vsrc_testsrc.c).

xfade and minterpolate are tensor code on the frame's device, in the
float32 operations of the JAX package's eager calls (neither filter is
PURE, so the JAX package never fuses them). minterpolate's block search
is ops/pallas/mesearch.full_search_mc with the whole frame as one tile:
the full-search kernel (csrc/fsearch.cu) on a CUDA frame, the plain
search on a CPU frame, equal on the integer luma planes it is given. xfade's dissolve draws
jax.random.uniform(jax.random.PRNGKey(0), shape) in the JAX package,
the same noise on every frame; _jax_uniform makes those bits with no
JAX (threefry-2x32, 20 rounds, on key (0, 0), with the partitionable
counter layout of JAX 0.9: the row-major index's high and low 32-bit
words, the two output words XORed).

showwaves, showspectrum and afir are numpy host code in the JAX package
and stay host code here, so that their outputs are the same bits;
showwaves and showspectrum upload each picture to the audio's device.
testsrc is a host source filter (CPU tensors).
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.core.errors import EndOfStream, InvalidData
from librempeg_tpu_torch.core.frame import VideoFrame
from librempeg_tpu_torch.core.options import Option, OptionTable
from librempeg_tpu_torch.core.rational import NOPTS, Rational
from librempeg_tpu_torch.filters.filter import (
    Filter,
    PadDesc,
    SourceFilter,
    StreamProps,
    register_filter,
)
from librempeg_tpu_torch.ops.fdiv import fdiv

_XFADE_TRANSITIONS = ("fade", "wipeleft", "wiperight", "wipeup",
                      "wipedown", "dissolve")

_M32 = 0xFFFFFFFF


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011, as JAX runs it)
    on int64 tensors holding 32-bit words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _jax_uniform(shape, device) -> torch.Tensor:
    """jax.random.uniform(jax.random.PRNGKey(0), shape) as float32."""
    n = int(np.prod(shape))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(0, 0, idx >> 32, idx & _M32)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000          # [1, 2) in float bits
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(shape)


def _u8(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x).clamp(0, 255).to(torch.uint8)


@register_filter
class XFadeFilter(Filter):
    """Crossfade between two inputs (vf_xfade.c): the first input plays
    until `offset`, the transition runs for `duration`, then the second
    input continues."""

    NAME = "xfade"
    DESCRIPTION = "Cross fade one video with another."
    INPUTS = (PadDesc("main", "video"), PadDesc("xfade", "video"))
    OPT_ORDER = ("transition", "duration", "offset")
    OPTIONS = OptionTable(
        Option("transition", str, "fade"),
        Option("duration", float, 1.0, min=0.01, max=60.0),
        Option("offset", float, 0.0, min=0.0, max=1e5),
    )
    FRAMESYNC = True

    def configure(self, in_props):
        if self.opts["transition"] not in _XFADE_TRANSITIONS:
            raise InvalidData(
                f"xfade: unknown transition {self.opts['transition']!r}")
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        self._noise: dict = {}
        return self.out_props

    def _progress(self, t: float) -> float:
        off, dur = self.opts["offset"], self.opts["duration"]
        return min(1.0, max(0.0, (t - off) / dur))

    def _dissolve_noise(self, shape, device) -> torch.Tensor:
        key = (tuple(shape), str(device))
        if key not in self._noise:
            self._noise[key] = _jax_uniform(shape, device)
        return self._noise[key]

    def filter_frames(self, frames):
        a, b = frames
        tb = a.time_base if a.time_base.valid and a.time_base.num \
            else Rational(1, 25)
        t = a.pts * tb.num / tb.den if a.pts != NOPTS else 0.0
        p = self._progress(t)
        if p <= 0.0:
            return [(0, a)]
        if p >= 1.0:
            return [(0, b.replace(pts=a.pts, time_base=a.time_base))]
        kind = self.opts["transition"]
        p32 = float(np.float32(p))
        planes = []
        for pa, pb in zip(a.planes, b.planes):
            xa = torch.as_tensor(pa).to(torch.float32)
            xb = torch.as_tensor(pb).to(xa.device, torch.float32)
            h, w = xa.shape[:2]
            dev = xa.device
            if kind == "fade":
                planes.append(_u8(xa * float(np.float32(1 - p))
                                  + xb * p32))
                continue
            if kind == "dissolve":
                mask = self._dissolve_noise(xa.shape, dev) < p32
            elif kind in ("wipeleft", "wiperight"):
                xs = fdiv(torch.arange(w, device=dev, dtype=torch.float32)[
                    None, :], float(max(1, w - 1)))
                mask = xs < p32 if kind == "wipeleft" else \
                    xs > float(np.float32(1 - p))
            else:                                  # wipeup / wipedown
                ys = fdiv(torch.arange(h, device=dev, dtype=torch.float32)[
                    :, None], float(max(1, h - 1)))
                mask = ys < p32 if kind == "wipedown" else \
                    ys > float(np.float32(1 - p))
            if xa.dim() == 3 and mask.dim() == 2:
                mask = mask[..., None]
            planes.append(_u8(torch.where(mask, xb, xa)))
        return [(0, a.replace(planes=tuple(planes)))]


@register_filter
class MInterpolateFilter(Filter):
    """Motion-compensated frame-rate conversion (vf_minterpolate.c, mci
    mode): between consecutive frames A and B, the block search of B
    against A, then the blend of A moved forward by alpha * mv and B
    moved back by (1 - alpha) * mv."""

    NAME = "minterpolate"
    DESCRIPTION = "Motion-compensated frame interpolation."
    OPT_ORDER = ("fps",)
    OPTIONS = OptionTable(
        Option("fps", str, "50"),
        Option("search_range", int, 8, min=2, max=16),
    )

    def configure(self, in_props):
        self.in_props = in_props
        p = in_props[0].copy()
        r = str(self.opts["fps"])
        self._fps = (Rational(*map(int, r.split("/"))) if "/" in r
                     else Rational(int(float(r)), 1))
        p.frame_rate = self._fps
        p.time_base = Rational(self._fps.den, self._fps.num)
        self.out_props = [p]
        self._prev = None
        self._out_n = 0
        return self.out_props

    def _emit(self, frame, pts):
        return frame.replace(pts=pts,
                             time_base=self.out_props[0].time_base)

    def filter_frame(self, frame, pad=0):
        in_tb = frame.time_base if frame.time_base.valid \
            and frame.time_base.num else Rational(1, 25)
        outs = []
        if self._prev is None:
            self._prev = frame
            return []
        t0 = self._prev.pts * in_tb.num / in_tb.den
        t1 = frame.pts * in_tb.num / in_tb.den
        out_tb = self.out_props[0].time_base
        while True:
            t = self._out_n * out_tb.num / out_tb.den
            if t >= t1 - 1e-9:
                break
            if t <= t0 + 1e-9:
                outs.append((0, self._emit(self._prev, self._out_n)))
            else:
                alpha = (t - t0) / max(1e-9, t1 - t0)
                outs.append((0, self._emit(
                    self._mci(self._prev, frame, alpha), self._out_n)))
            self._out_n += 1
        self._prev = frame
        return outs

    def _mci(self, a, b, alpha: float):
        from librempeg_tpu_torch.ops import motion
        from librempeg_tpu_torch.ops.pallas import mesearch

        ya = torch.as_tensor(a.planes[0]).to(torch.float32)[None]
        yb = torch.as_tensor(b.planes[0]).to(ya.device, torch.float32)[None]
        mv, _, _ = mesearch.full_search_mc(yb, ya, self.opts["search_range"],
                                           *yb.shape[1:])
        fa = float(np.float32(alpha))
        fb = float(np.float32(-(1 - alpha)))
        w0 = float(np.float32(1 - alpha))
        planes = []
        for i, (pa, pb) in enumerate(zip(a.planes, b.planes)):
            xa = torch.as_tensor(pa).to(torch.float32)[None]
            xb = torch.as_tensor(pb).to(xa.device, torch.float32)[None]
            mvp = mv // 2 if i else mv          # floor division, as jnp
            bs = 8 if i else 16
            fwd = motion.motion_compensate(
                xa, torch.round(mvp.to(torch.float32) * fa).to(mv.dtype),
                bs)[0]
            bwd = motion.motion_compensate(
                xb, torch.round(mvp.to(torch.float32) * fb).to(mv.dtype),
                bs)[0]
            planes.append(_u8(fwd * w0 + bwd * fa))
        return a.replace(planes=tuple(planes))

    def flush(self):
        if self._prev is not None:
            out = [(0, self._emit(self._prev, self._out_n))]
            self._out_n += 1
            self._prev = None
            return out
        return []


def _host_f32(frame) -> np.ndarray:
    d = frame.data
    if isinstance(d, torch.Tensor):
        d = d.cpu().numpy()
    return np.asarray(d, np.float32)


def _device_of(frame):
    return frame.data.device if isinstance(frame.data, torch.Tensor) \
        else torch.device("cpu")


class _AudioVis(Filter):
    INPUTS = (PadDesc("default", "audio"),)
    OUTPUTS = (PadDesc("default", "video"),)

    def _vprops(self, rate: Rational, w: int, h: int) -> StreamProps:
        return StreamProps(media="video", width=w, height=h,
                           pix_fmt="gray", frame_rate=rate,
                           time_base=Rational(rate.den, rate.num))

    def _picture(self, img: np.ndarray) -> VideoFrame:
        f = VideoFrame(planes=(torch.from_numpy(img).to(self._dev),),
                       format="gray", width=self._w, height=self._h,
                       pts=self._frame_n,
                       time_base=self.out_props[0].time_base)
        self._frame_n += 1
        return f


@register_filter
class ShowWavesFilter(_AudioVis):
    """Waveform video from audio (avf_showwaves.c, mode=line): one video
    frame per `n` samples, channels vertically stacked."""

    NAME = "showwaves"
    DESCRIPTION = "Convert input audio to a waveform video output."
    OPTIONS = OptionTable(
        Option("size", str, "600x240", alias="s"),
        Option("n", int, 0, min=0, max=1 << 20,
               help="samples per column (0 = auto for 25fps)"),
    )

    def configure(self, in_props):
        self.in_props = in_props
        w, h = map(int, self.opts["size"].split("x"))
        self._w, self._h = w, h
        sr = in_props[0].sample_rate or 44100
        n = self.opts["n"] or max(1, sr // (25 * w))
        self._spc = n                       # samples per column
        self._buf = None
        self._frame_n = 0
        self._dev = torch.device("cpu")
        rate = Rational(sr, n * w)
        self.out_props = [self._vprops(rate, w, h)]
        return self.out_props

    def filter_frame(self, frame, pad=0):
        self._dev = _device_of(frame)
        x = _host_f32(frame)
        if x.dtype != np.float32 or x.max(initial=0) > 4:   # int pcm
            x = x.astype(np.float32) / 32768.0
        self._buf = x if self._buf is None else \
            np.concatenate([self._buf, x], axis=1)
        outs = []
        need = self._spc * self._w
        while self._buf.shape[1] >= need:
            blk, self._buf = self._buf[:, :need], self._buf[:, need:]
            outs.append((0, self._render(blk)))
        return outs

    def _render(self, blk: np.ndarray) -> VideoFrame:
        ch = blk.shape[0]
        cols = blk.reshape(ch, self._w, self._spc).mean(axis=2)
        img = np.zeros((self._h, self._w), np.uint8)
        band = self._h // ch
        for c in range(ch):
            mid = c * band + band // 2
            y = np.clip(mid - (cols[c] * (band // 2 - 1)).astype(int),
                        c * band, (c + 1) * band - 1)
            img[y, np.arange(self._w)] = 255
            img[mid, :] = np.maximum(img[mid, :], 40)
        return self._picture(img)

    def flush(self):
        if self._buf is not None and self._buf.shape[1]:
            pad = self._spc * self._w - self._buf.shape[1]
            blk = np.pad(self._buf, ((0, 0), (0, pad)))
            self._buf = None
            return [(0, self._render(blk))]
        return []


@register_filter
class ShowSpectrumFilter(_AudioVis):
    """Scrolling STFT magnitude spectrogram (avf_showspectrum.c):
    log-magnitude of windowed FFT columns."""

    NAME = "showspectrum"
    DESCRIPTION = "Convert input audio to a spectrum video output."
    OPTIONS = OptionTable(
        Option("size", str, "512x256", alias="s"),
    )

    def configure(self, in_props):
        self.in_props = in_props
        w, h = map(int, self.opts["size"].split("x"))
        self._w, self._h = w, h
        self._nfft = 2 * h
        self._hop = self._nfft // 2
        self._buf = None
        self._img = np.zeros((h, w), np.uint8)
        self._frame_n = 0
        self._dev = torch.device("cpu")
        sr = in_props[0].sample_rate or 44100
        rate = Rational(sr, self._hop)       # one frame per column
        self.out_props = [self._vprops(rate, w, h)]
        self._win = np.hanning(self._nfft).astype(np.float32)
        return self.out_props

    def filter_frame(self, frame, pad=0):
        self._dev = _device_of(frame)
        x = _host_f32(frame)
        if x.max(initial=0) > 4:
            x = x / 32768.0
        mono = x.mean(axis=0)
        self._buf = mono if self._buf is None else \
            np.concatenate([self._buf, mono])
        outs = []
        while len(self._buf) >= self._nfft:
            seg = self._buf[:self._nfft] * self._win
            self._buf = self._buf[self._hop:]
            mag = np.abs(np.fft.rfft(seg))[:self._h]
            db = 20 * np.log10(np.maximum(mag, 1e-6))
            col = np.clip((db + 90) * (255 / 96), 0, 255).astype(np.uint8)
            self._img = np.roll(self._img, -1, axis=1)
            self._img[:, -1] = col[::-1]      # low freq at the bottom
            outs.append((0, self._picture(self._img.copy())))
        return outs


@register_filter
class AfirFilter(Filter):
    """FFT convolution with an impulse response from the second input
    (af_afir.c): the IR stream is buffered to EOF, then the main stream
    convolves by overlap-save (numpy's FFT on the host)."""

    NAME = "afir"
    DESCRIPTION = "Apply a finite impulse response from a second stream."
    INPUTS = (PadDesc("main", "audio"), PadDesc("ir", "audio"))
    OUTPUTS = (PadDesc("default", "audio"),)
    OPTIONS = OptionTable(
        Option("dry", float, 0.0, min=0.0, max=1.0),
        Option("wet", float, 1.0, min=0.0, max=1.0),
    )

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        self._ir_parts: list[np.ndarray] = []
        self._ir = None
        self._pend: list = []
        self._hist = None
        return self.out_props

    def filter_frame(self, frame, pad=0):
        if pad == 1:
            self._ir_parts.append(_host_f32(frame))
            return []
        if self._ir is None:
            self._pend.append(frame)
            return []
        return self._convolve(frame)

    def _finalize_ir(self):
        if not self._ir_parts:
            raise InvalidData("afir: no impulse response received")
        ir = np.concatenate(self._ir_parts, axis=1)
        if ir.max(initial=0) > 4:
            ir = ir / 32768.0
        self._ir = ir.mean(axis=0)           # mono IR applied per channel
        self._nfft = 1 << int(np.ceil(np.log2(
            max(256, 2 * len(self._ir)))))
        self._block = self._nfft - len(self._ir) + 1
        self._IR = np.fft.rfft(self._ir, self._nfft)

    def _convolve(self, frame):
        raw = frame.data.cpu().numpy() if isinstance(
            frame.data, torch.Tensor) else np.asarray(frame.data)
        x = np.asarray(raw, np.float32)
        scale = 32768.0 if x.max(initial=0) > 4 else 1.0
        x = x / scale
        ch, n = x.shape
        if self._hist is None:
            self._hist = np.zeros((ch, len(self._ir) - 1), np.float32)
        xin = np.concatenate([self._hist, x], axis=1)
        self._hist = xin[:, -(len(self._ir) - 1):] if len(self._ir) > 1 \
            else np.zeros((ch, 0), np.float32)
        out = np.zeros((ch, n), np.float32)
        pos = 0
        hl = len(self._ir) - 1
        while pos < n:
            blk = xin[:, pos:pos + hl + self._block]
            pad = self._nfft - blk.shape[1]
            seg = np.pad(blk, ((0, 0), (0, pad)))
            y = np.fft.irfft(np.fft.rfft(seg, axis=1) * self._IR[None],
                             axis=1)
            take = min(self._block, n - pos)
            out[:, pos:pos + take] = y[:, hl:hl + take]
            pos += take
        mixed = (self.opts["dry"] * x + self.opts["wet"] * out) * scale
        if raw.dtype == np.int16:
            data = np.clip(np.round(mixed), -32768, 32767).astype(np.int16)
        else:
            data = mixed.astype(np.float32)
        return [(0, frame.replace(
            data=torch.from_numpy(data).to(_device_of(frame))))]

    def flush(self):
        if self._ir is None and self._ir_parts:
            self._finalize_ir()
            outs = []
            for f in self._pend:
                outs += self._convolve(f)
            self._pend = []
            return outs
        return []


@register_filter
class TestSrcFilter(SourceFilter):
    """Classic test pattern (vsrc_testsrc.c testsrc): colour bars over a
    grey field with a moving block (host code)."""

    NAME = "testsrc"
    DESCRIPTION = "Generate a classic test pattern."
    OUTPUTS = (PadDesc("default", "video"),)
    OPTIONS = OptionTable(
        Option("size", str, "320x240", alias="s"),
        Option("rate", str, "25", alias="r"),
        Option("duration", float, float("inf"), alias="d"),
    )

    def configure(self, in_props):
        w, h = self.opts["size"].split("x")
        self._w, self._h = int(w), int(h)
        r = str(self.opts["rate"])
        self._rate = (Rational(*map(int, r.split("/"))) if "/" in r
                      else Rational(int(float(r)), 1))
        self._n = 0
        self.out_props = [StreamProps(
            media="video", width=self._w, height=self._h,
            pix_fmt="yuv420p", frame_rate=self._rate,
            time_base=Rational(self._rate.den, self._rate.num))]
        return self.out_props

    def request_frame(self) -> VideoFrame:
        t = self._n * self._rate.den / self._rate.num
        if t >= self.opts["duration"]:
            raise EndOfStream
        w, h = self._w, self._h
        xs = np.arange(w)
        bar = (xs * 8 // max(1, w)).astype(np.uint8)
        y = np.broadcast_to((bar * 32 + 16), (h, w)).copy()
        u = np.full((h // 2, w // 2), 128, np.uint8)
        v = np.full((h // 2, w // 2), 128, np.uint8)
        u[:, :] = np.broadcast_to((bar[::2] * 20 + 60)[: w // 2],
                                  (h // 2, w // 2))
        # moving block keyed to the frame index
        bx = (self._n * 7) % max(1, w - 32)
        by = (self._n * 3) % max(1, h - 32)
        y[by:by + 32, bx:bx + 32] = 235
        f = VideoFrame(planes=tuple(torch.from_numpy(p) for p in (
                           y.astype(np.uint8), u, v)),
                       format="yuv420p", width=w, height=h, pts=self._n,
                       time_base=self.out_props[0].time_base)
        self._n += 1
        return f
