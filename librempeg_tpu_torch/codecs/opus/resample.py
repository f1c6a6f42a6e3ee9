"""Integer-factor streaming upsampler for the SILK internal rates
(8/12/16 kHz -> 48 kHz, L = 6/4/3).

Polyphase windowed-sinc interpolation with the group delay compensated
internally, so output sample n sits at input time n/L — the decoder
needs no extra latency bookkeeping (the reference routes SILK through
its ardftsrc FFT resampler and tracks the latency in delayed_samples;
see libavcodec/opus/dec.c opus_init_resample).

A copy of librempeg_tpu/codecs/opus/resample.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

import numpy as np

from librempeg_tpu_torch.ops.firdesign import kaiser_beta_window


class Upsampler:
    def __init__(self, factor: int, channels: int, half_taps: int = 12,
                 beta: float = 9.0):
        self.L = factor
        self.K = half_taps                 # input-sample half-length
        n = 2 * half_taps * factor + 1
        t = np.arange(n) - (n - 1) / 2
        cutoff = 0.92 / factor             # fraction of output Nyquist
        h = np.sinc(t * cutoff) * cutoff * factor
        h *= kaiser_beta_window(n, beta)
        # pad to a multiple of L and split into polyphase branches:
        # out[mL + p] = sum_k h[kL + p] x[m - k + K]
        pad = (-n) % factor
        h = np.concatenate([h, np.zeros(pad)])
        self.phases = h.reshape(-1, factor).T[:, ::-1] \
            .astype(np.float32).copy()     # [L, ntaps_per_phase]
        self.ntaps = self.phases.shape[1]
        self.channels = channels
        # prime with zeros; the first K*L outputs (pure delay) are cut
        self._hist = np.zeros((channels, self.ntaps - 1), np.float32)
        self._cut = half_taps * factor

    def process(self, x: np.ndarray) -> np.ndarray:
        """x [ch, n] at the internal rate -> [ch, ~n*L] at 48 kHz."""
        ch, n = x.shape
        buf = np.concatenate([self._hist, x.astype(np.float32)],
                             axis=1)
        self._hist = buf[:, -(self.ntaps - 1):].copy()
        # windows [ch, n, ntaps]
        idx = np.arange(n)[:, None] + np.arange(self.ntaps)[None, :]
        win = buf[:, idx]                          # [ch, n, ntaps]
        out = np.einsum("cnt,pt->cnp", win, self.phases,
                        optimize=True)             # [ch, n, L]
        out = out.reshape(ch, n * self.L)
        if self._cut:
            cut = min(self._cut, out.shape[1])
            out = out[:, cut:]
            self._cut -= cut
        return out

    def flush(self) -> np.ndarray:
        """Drain the remaining group delay."""
        pad = np.zeros((self.channels, self.K), np.float32)
        return self.process(pad)
