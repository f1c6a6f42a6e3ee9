"""Dither and noise shaping for float -> integer PCM output.

Port of librempeg_tpu/resample/dither.py (libswresample dither.c
analog): additive dither in LSBs before requantisation, optionally
with an error-feedback noise shaper that pushes quantisation noise out
of the ear's sensitive band.

Methods:
- "rectangular": uniform in [-0.5, 0.5) LSB.
- "triangular":  TPDF, sum of two uniforms (the safe default).
- "triangular_hp": high-passed TPDF (first difference of uniform
  noise), concentrating dither power at high frequencies.
- "lipshitz": TPDF dither + 5-tap error-feedback noise shaper with the
  Lipshitz/Vanderkooy/Wannamaker minimally audible coefficients for
  44.1 kHz (JAES 39(11), 1991).
- "f_weighted": 3-tap Wannamaker f-weighted shaper, same family.

The noise is the JAX package's counter-based Philox draw on the host,
indexed by absolute sample position, so the two packages dither every
sample alike; it is uploaded to the samples' device. The error-feedback
loop is sequential per sample: on a CUDA tensor it is one launch of
csrc/shape_scan.cu (one thread per channel), on a CPU tensor its plain
version, a loop over samples.
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.codecs.pcm import _INT_FORMATS, clip_to_int
from librempeg_tpu_torch.kernels import shape_scan as K

__all__ = ["Ditherer", "DITHER_METHODS", "shape_scan", "shape_scan_plain"]

# error-feedback FIR coefficients (error history, most recent first)
_SHAPER_COEFS = {
    # Lipshitz et al. 1991, minimally audible 5-tap @44.1k
    "lipshitz": [2.033, -2.165, 1.959, -1.590, 0.6149],
    # Wannamaker f-weighted 3-tap
    "f_weighted": [1.623, -0.982, 0.109],
}

DITHER_METHODS = ("none", "rectangular", "triangular", "triangular_hp",
                  "lipshitz", "f_weighted")


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for float32 tensors with one rounding, as a fused
    multiply-add gives it. The product is exact in float64; the float64
    sum is made round-to-odd (an inexact sum whose last bit is even
    moves one ulp toward the exact sum, which TwoSum gives), and a
    round-to-odd value with 53 bits rounds to float32 as the exact sum
    does (Boldo and Melquiond, IEEE TC 57(4), 2008)."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    odd = torch.where((err != 0) & (bits & 1 == 0), bits + step, bits)
    return odd.view(torch.float64).float()


def shape_scan_plain(x: torch.Tensor, noise: torch.Tensor,
                     coefs: torch.Tensor, err0: torch.Tensor):
    """Plain version of the kernel: for each sample,
        fb = c0*e0 + c1*e1 + ... (left to right, e0 the newest error)
        y = round(x - fb + noise),  e = y - (x - fb).
    Each term of fb is a fused multiply-add (_fma32), the form XLA's
    CPU code takes (csrc/shape_scan.cu says where it differs); the rest
    is float32. x/noise [C, N] float32 in LSB units, coefs [K], err0
    [K, C] the carried history -> (y [C, N], final history [K, C])."""
    n = x.shape[1]
    cs = list(coefs.unbind(0))
    e = list(err0.unbind(0))
    xt, nt = x.t(), noise.t()
    y = torch.empty_like(x)
    zero = torch.zeros_like(err0[0])
    for i in range(n):
        fb = zero
        for ek, ck in zip(e, cs):
            fb = _fma32(ek, ck, fb)
        want = xt[i] - fb
        q = torch.round(want + nt[i])
        e = [q - want] + e[:-1]
        y[:, i] = q
    return y, torch.stack(e)


def shape_scan(x: torch.Tensor, noise: torch.Tensor, coefs: torch.Tensor,
               err0: torch.Tensor):
    """The error-feedback scan (same contract as shape_scan_plain). CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return shape_scan_plain(x, noise, coefs, err0)
    return K.launch(x.contiguous(), noise.contiguous(), coefs.contiguous(),
                    err0.contiguous())


class Ditherer:
    """Stateful per-stream ditherer (float [-1,1) -> integer tensors).

    State (noise position, the high-pass carry and the shaper's error
    history) persists across chunks, so streamed output equals
    one-shot output.
    """

    def __init__(self, method: str = "triangular", seed: int = 0):
        if method not in DITHER_METHODS:
            raise ValueError(f"unknown dither method {method!r}")
        self.method = method
        self._seed = seed
        self._pos = 0                      # absolute samples consumed
        self._hp_last = None               # per-channel carry for _hp
        self._err = None                   # shaper error-history carry
        self._coefs = None                 # shaper taps, on _err's device

    def _uniforms(self, C: int, N: int, per: int) -> np.ndarray:
        """[N, C, per] uniforms in [0,1), indexed by ABSOLUTE sample
        position (counter-based Philox), so chunked streaming draws the
        same values as one-shot."""
        skip = self._pos * C * per
        bg = np.random.Philox(key=self._seed)
        # Philox.advance counts 4-word COUNTER blocks (one block = 4
        # float64 draws), so advance whole blocks and burn the rest
        bg.advance(skip // 4)
        g = np.random.Generator(bg)
        if skip % 4:
            g.random(skip % 4)
        return g.random((N, C, per))

    def _noise(self, shape) -> np.ndarray:
        C, N = shape
        m = self.method
        if m == "rectangular":
            u = self._uniforms(C, N, 1)
            return (u[:, :, 0].T - 0.5).astype(np.float32)
        if m == "triangular_hp":
            # first difference of uniform noise: TPDF density, 6 dB/oct
            # high-pass spectrum (reference dither.c triangular_hp)
            u = self._uniforms(C, N, 1)[:, :, 0].T - 0.5
            prev = (self._hp_last if self._hp_last is not None
                    else np.zeros(C))
            self._hp_last = u[:, -1].copy() if N else prev
            shifted = np.concatenate([prev[:, None], u[:, :-1]], axis=1)
            return (u - shifted).astype(np.float32)
        # TPDF for triangular and both noise shapers
        u = self._uniforms(C, N, 2)
        return (u[:, :, 0] - u[:, :, 1]).T.astype(np.float32)

    def apply(self, x: torch.Tensor, out_fmt: str) -> torch.Tensor:
        """x: float32 [C, N] in [-1, 1) -> integer tensor in out_fmt, on
        x's device."""
        base = out_fmt.rstrip("p")
        scale, off, lo, hi, dt = _INT_FORMATS[base]
        xl = x.to(torch.float32) * scale + off    # LSB units
        if self.method == "none":
            y = torch.round(xl)
        else:
            noise = torch.from_numpy(self._noise(tuple(xl.shape))).to(
                xl.device)
            if self.method in _SHAPER_COEFS:
                cs = _SHAPER_COEFS[self.method]
                if self._err is None or self._err.shape[1] != xl.shape[0]:
                    self._err = torch.zeros((len(cs), xl.shape[0]),
                                            dtype=torch.float32,
                                            device=xl.device)
                if self._coefs is None or self._coefs.device != xl.device:
                    self._coefs = torch.tensor(cs, dtype=torch.float32,
                                               device=xl.device)
                y, self._err = shape_scan(xl, noise, self._coefs, self._err)
            else:
                y = torch.round(xl + noise)
        self._pos += xl.shape[1]
        return clip_to_int(y, lo, hi, dt)
