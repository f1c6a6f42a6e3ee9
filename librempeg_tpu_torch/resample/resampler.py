"""Polyphase audio resampler.

Port of librempeg_tpu/resample/resampler.py (libswresample resample.c
analog: a Kaiser-windowed sinc polyphase bank).

For a rational rate change out/in = p/q (reduced), outputs come in
periods of p samples consuming q input samples. Output j of a period
reads a T-tap window at offset s_j with phase-j taps, so a period is one
[L] x [L, p] product over a chunk of L = q + T input samples, and a
block of periods is one GEMM: the chunks are a strided view of the
input (Tensor.unfold) and the bank matrix M (M[s_j + k, j] =
taps[j, k]) is built once per rate pair in float32 on the host, cached,
and uploaded once per Resampler. The product is a float32 torch.matmul
with TF32 off (device.py), as the JAX package runs it at HIGHEST
precision outside any Pallas kernel.

Streaming: the object keeps the retained input history on the device
(`_buf`, whose first column is absolute input sample `_buf_start`), and
host integers for the stream position (`_next_origin`, `_out_count`,
`_total_in`), which fix every shape; arbitrary chunking gives the same
output as one call.

Soft compensation (swr_set_compensation analog): while active the
stream runs a second cached bank for the compensated ratio
p*D / (q*(D-delta)) (<= 1024 phases) and reverts to the ideal bank once
`compensation_distance` outputs have been produced (rounded up to a
whole period of the compensation bank).

One deviation from the JAX package: a final call (flush) under
compensation computes the remaining output length bank by bank, at the
ratio in force while each part of the input is consumed. The JAX
package computes it once at the compensated ratio, so a one-shot
48000-sample call with set_compensation(480, 24000) at 48 kHz gives
48980 samples where 48480 are right.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

import librempeg_tpu_torch.device  # noqa: F401  (TF32 off)
from librempeg_tpu_torch.core.options import Option, OptionTable, OptionedObject
from librempeg_tpu_torch.device import resolve
from librempeg_tpu_torch.ops.firdesign import resample_bank

_MAX_EXACT_PHASES = 1024


@functools.lru_cache(maxsize=32)
def _bank_matrix(p: int, q: int, taps: int, cutoff_x1e6: int, beta_x10: int,
                 window: str) -> tuple[np.ndarray, int, int]:
    """Dense banded bank matrix [L, p] for one period, plus (L, left_pad).

    left_pad is how many history samples the first window reaches back.
    """
    cutoff = cutoff_x1e6 / 1e6
    beta = beta_x10 / 10.0
    bank = resample_bank(taps, p, cutoff, beta, window)  # [p, taps]
    off = taps // 2 - 1 if taps > 1 else 0
    # window start for output j (relative to period origin): floor(j*q/p) - off
    starts = [(j * q) // p - off for j in range(p)]
    left_pad = -min(starts)
    L = max(starts) + taps + left_pad
    m = np.zeros((L, p), np.float32)
    for j in range(p):
        # phase: fractional part of j*q/p, taps index (j*q) % p
        phase = (j * q) % p
        s = starts[j] + left_pad
        m[s:s + taps, j] = bank[phase]
    return m, L, left_pad


def _resample_gemm(x: torch.Tensor, m: torch.Tensor, q: int,
                   n_periods: int) -> torch.Tensor:
    """x: [C, (n_periods - 1)*q + L] input from the first window's start;
    m: [L, p] bank matrix. Returns [C, n_periods * p]."""
    C = x.shape[0]
    L, p = m.shape
    chunks = x.unfold(-1, L, q)[:, :n_periods]     # [C, n_periods, L]
    return torch.matmul(chunks, m).reshape(C, n_periods * p)


class Resampler(OptionedObject):
    """Streaming rational resampler over [channels, samples] float32
    tensors on `device`."""

    OPTIONS = OptionTable(
        Option("filter_size", int, 32, min=4, max=512,
               help="taps per phase (swr filter_size analog)"),
        Option("cutoff", float, 0.0, min=0.0, max=1.0,
               help="anti-alias cutoff relative to min(in,out) Nyquist; 0=auto"),
        Option("kaiser_beta", float, 9.0, min=2.0, max=16.0),
        Option("window", str, "kaiser", choices=["kaiser", "blackman_nuttall"]),
    )

    def __init__(self, in_rate: int, out_rate: int, channels: int = 2,
                 device="cuda", **opts):
        super().__init__(**opts)
        if in_rate <= 0 or out_rate <= 0:
            raise ValueError("rates must be positive")
        self.device = resolve(device)
        self.in_rate = in_rate
        self.out_rate = out_rate
        self.channels = channels
        g = math.gcd(in_rate, out_rate)
        self.p = out_rate // g
        self.q = in_rate // g
        if self.p > _MAX_EXACT_PHASES:
            # quantize phases: the closest rational with a bounded
            # denominator (changes the ratio by < 1e-6; every standard
            # rate pair keeps p <= 1024)
            from fractions import Fraction

            f = Fraction(out_rate, in_rate).limit_denominator(_MAX_EXACT_PHASES)
            self.p, self.q = f.numerator, f.denominator
        cutoff = self.opts["cutoff"]
        if cutoff == 0.0:
            # auto: swr uses 0.97 of the output Nyquist when downsampling
            cutoff = 0.971 * min(1.0, self.p / self.q)
        taps = self.opts["filter_size"]
        if self.p < self.q:
            # keep absolute transition width when downsampling: more taps
            taps = int(math.ceil(taps * self.q / self.p / 2)) * 2
        self._cutoff = cutoff
        m_np, self.L, self.left_pad = _bank_matrix(
            self.p, self.q, taps, int(cutoff * 1e6),
            int(self.opts["kaiser_beta"] * 10), self.opts["window"])
        self.taps = taps
        self._m = torch.from_numpy(m_np).to(self.device)
        # streaming state, position-based: _buf[:, 0] sits at absolute
        # input index _buf_start; the next output period's windows start
        # reaching back from input position _next_origin.
        self._keep = self.left_pad + taps        # history retention
        self._buf = torch.zeros((channels, self._keep), dtype=torch.float32,
                                device=self.device)
        self._buf_start = -self._keep
        self._next_origin = 0
        self._out_count = 0   # total outputs produced
        self._total_in = 0
        self._comp = None     # active compensation bank, or None

    # -- compensation --------------------------------------------------
    def set_compensation(self, sample_delta: int,
                         compensation_distance: int) -> None:
        """swr_set_compensation semantics: over the next
        `compensation_distance` output samples the input advance per
        output is scaled by (1 - sample_delta/compensation_distance),
        i.e. positive sample_delta stretches output (produces
        `sample_delta` extra samples). distance 0 cancels."""
        if compensation_distance < 0:
            raise ValueError("compensation_distance must be >= 0")
        if compensation_distance == 0:
            if sample_delta:
                raise ValueError("sample_delta without distance")
            self._comp = None
            return
        if not (-compensation_distance < sample_delta
                < compensation_distance):
            raise ValueError("|sample_delta| must be < distance")
        from fractions import Fraction

        f = Fraction(self.p * compensation_distance,
                     self.q * (compensation_distance - sample_delta))
        f = f.limit_denominator(_MAX_EXACT_PHASES)
        p2, q2 = f.numerator, f.denominator
        m2, L2, lp2 = _bank_matrix(
            p2, q2, self.taps, int(self._cutoff * 1e6),
            int(self.opts["kaiser_beta"] * 10), self.opts["window"])
        have_hist = self._next_origin - self._buf_start
        if lp2 > have_hist:   # deeper bank than retained history:
            pad = lp2 - have_hist          # zero-extend (stream start)
            self._buf = torch.cat(
                [self._buf.new_zeros((self.channels, pad)), self._buf], 1)
            self._buf_start -= pad
        self._keep = max(self._keep, lp2)
        self._comp = {"m": torch.from_numpy(m2).to(self.device), "p": p2,
                      "q": q2, "L": L2, "lp": lp2,
                      "remaining": compensation_distance}

    def _bank(self):
        c = self._comp
        if c is not None:
            return c["m"], c["p"], c["q"], c["L"], c["lp"]
        return self._m, self.p, self.q, self.L, self.left_pad

    # -- core ---------------------------------------------------------
    def process(self, samples, final: bool = False) -> torch.Tensor:
        """Push [channels, n] samples; returns resampled [channels, m]
        on the device.

        With final=True, flushes the tail (zero-padded history drain):
        the output then covers the whole input timeline, each part at
        the ratio in force while it is consumed.
        """
        x = torch.as_tensor(samples).to(device=self.device,
                                        dtype=torch.float32)
        self._total_in += x.shape[1]
        self._buf = torch.cat([self._buf, x], dim=1)
        outs = []
        while True:
            m_, p_, q_, L_, lp_ = self._bank()
            keep = None
            if final:
                # outputs for the rest of the input at this bank's ratio
                want = max(0, -(-(self._total_in - self._next_origin)
                                * p_ // q_))
                n_per = -(-want // p_)
                keep = want
            else:
                # periods whose every window is fully inside real data:
                # need origin - lp + L <= avail_end
                avail_end = self._buf_start + self._buf.shape[1]
                n_per = max(0, (avail_end - (self._next_origin - lp_)
                                - L_) // q_ + 1)
            if self._comp is not None and n_per > 0:
                lim = -(-self._comp["remaining"] // p_)
                if lim < n_per:   # the bank changes inside this span
                    n_per, keep = lim, None
            if n_per <= 0:
                break
            s0 = self._next_origin - lp_ - self._buf_start
            need = s0 + (n_per - 1) * q_ + L_
            xb = self._buf
            if need > xb.shape[1]:        # flush: zero-pad the tail
                xb = torch.cat([xb, xb.new_zeros(
                    (self.channels, need - xb.shape[1]))], dim=1)
            out = _resample_gemm(xb[:, s0:need], m_, q_, n_per)
            if keep is not None:
                out = out[:, :keep]
            outs.append(out)
            self._out_count += out.shape[1]
            self._next_origin += n_per * q_
            if self._comp is not None:
                self._comp["remaining"] -= out.shape[1]
                if self._comp["remaining"] <= 0:
                    self._comp = None    # revert to the ideal bank
            # trim consumed input, retaining _keep history samples
            cut = self._next_origin - self._keep - self._buf_start
            if cut > 0:
                self._buf = self._buf[:, cut:]
                self._buf_start += cut
        if not outs:
            return torch.zeros((self.channels, 0), dtype=torch.float32,
                               device=self.device)
        return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]

    def flush(self) -> torch.Tensor:
        return self.process(torch.zeros((self.channels, 0)), final=True)

    @property
    def delay(self) -> int:
        """Pending input samples not yet represented in output."""
        return self._total_in - self._next_origin
