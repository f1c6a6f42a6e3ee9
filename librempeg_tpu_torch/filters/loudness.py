"""EBU R128 loudness: ebur128 metering + loudnorm normalization.

Analogs of libavfilter/f_ebur128.c and af_loudnorm.c
(SURVEY.md lists loudnorm/EBU R128 among the flagship audio filters).

Implements ITU-R BS.1770-4: K-weighting (shelf + high-pass biquads, the
published 48 kHz coefficients; other rates are resampled to 48 kHz
first via our resampler), 400 ms momentary / 3 s short-term windows at
75% overlap, absolute (-70 LUFS) and relative (-10 LU) gating for
integrated loudness, plus loudness range (LRA) and true-ish peak.

loudnorm here is the linear (two-pass) mode: measure integrated
loudness + peak, apply a constant gain to hit the target within the
true-peak ceiling (the reference's dynamic mode is round-2 scope).

Port of librempeg_tpu/filters/loudness.py. The measurement is the JAX
package's host numpy, with the K-weighting through the port's
native.biquad as there; a rate other than 48 kHz is first resampled by
the port's resample.Resampler on the frames' device. loudnorm's gain is
applied in numpy with the JAX package's dtypes and the result returns
to the frame's device.
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.codecs.pcm import from_float, to_float
from librempeg_tpu_torch.core.frame import AudioFrame
from librempeg_tpu_torch.core.options import Option, OptionTable
from librempeg_tpu_torch.filters.filter import Filter, PadDesc, register_filter
from librempeg_tpu_torch.native import build as native

# BS.1770-4 K-weighting biquads at 48 kHz
_SHELF_B = (1.53512485958697, -2.69169618940638, 1.19839281085285)
_SHELF_A = (-1.69065929318241, 0.73248077421585)
_HP_B = (1.0, -2.0, 1.0)
_HP_A = (-1.99004745483398, 0.99007225036621)


def k_weight(x: np.ndarray) -> np.ndarray:
    """Apply K-weighting to [channels, n] float samples (48 kHz)."""
    out = np.zeros_like(x, dtype=np.float32)
    for c in range(x.shape[0]):
        s1 = native.biquad(_SHELF_B, _SHELF_A, x[c].astype(np.float32))
        out[c] = native.biquad(_HP_B, _HP_A, s1)
    return out


def measure_r128(x: np.ndarray, rate: int, device="cuda") -> dict:
    """Integrated/momentary loudness + LRA + sample peak of [ch, n]
    (float32; a rate other than 48 kHz is resampled on `device`)."""
    if rate != 48000:
        from librempeg_tpu_torch.resample import Resampler

        r = Resampler(rate, 48000, channels=x.shape[0], device=device)
        x = torch.cat([r.process(torch.from_numpy(x)), r.flush()],
                      dim=1).cpu().numpy()
        rate = 48000
    peak = float(np.max(np.abs(x))) if x.size else 0.0
    kw = k_weight(x)
    win = int(0.400 * rate)
    hop = win // 4                       # 75% overlap
    n_blocks = max(0, (x.shape[1] - win) // hop + 1)
    if n_blocks == 0:
        return {"I": -70.0, "LRA": 0.0, "peak": peak, "momentary": []}
    # block powers, summed over channels (stereo weights are 1.0)
    powers = np.zeros(n_blocks)
    e = kw ** 2
    csum = np.concatenate([np.zeros((x.shape[0], 1)), np.cumsum(e, axis=1)],
                          axis=1)
    for b in range(n_blocks):
        s = b * hop
        powers[b] = float((csum[:, s + win] - csum[:, s]).sum()) / win
    loud = -0.691 + 10 * np.log10(np.maximum(powers, 1e-12))
    # gating (BS.1770-4 §4.2)
    abs_gate = loud > -70.0
    if not abs_gate.any():
        return {"I": -70.0, "LRA": 0.0, "peak": peak,
                "momentary": loud.tolist()}
    z = powers[abs_gate].mean()
    rel_thresh = -0.691 + 10 * np.log10(z) - 10.0
    gate = loud > rel_thresh
    if not gate.any():
        gate = abs_gate
    integrated = -0.691 + 10 * np.log10(powers[gate].mean())
    # LRA from short-term (3 s) blocks, 10th..95th percentile (EBU Tech
    # 3342) — fall back to momentary stats for short signals
    st_win = min(int(3.0 * rate), x.shape[1])
    st_hop = st_win // 3 or 1
    st_blocks = max(1, (x.shape[1] - st_win) // st_hop + 1)
    st = np.zeros(st_blocks)
    for b in range(st_blocks):
        s = b * st_hop
        st[b] = float((csum[:, s + st_win] - csum[:, s]).sum()) / st_win
    st_l = -0.691 + 10 * np.log10(np.maximum(st, 1e-12))
    st_l = st_l[st_l > -70]
    lra = (float(np.percentile(st_l, 95) - np.percentile(st_l, 10))
           if len(st_l) > 1 else 0.0)
    return {"I": float(integrated), "LRA": lra, "peak": peak,
            "momentary": loud.tolist()}


def _host_float(frame: AudioFrame) -> np.ndarray:
    """A frame's samples as host float32 [channels, n] (pcm.to_float)."""
    return to_float(torch.as_tensor(frame.data), frame.sample_fmt) \
        .cpu().numpy()


def _device_of(frame: AudioFrame):
    return frame.data.device if isinstance(frame.data, torch.Tensor) \
        else "cpu"


@register_filter
class Ebur128Filter(Filter):
    NAME = "ebur128"
    DESCRIPTION = "EBU R128 loudness metering."
    INPUTS = (PadDesc("default", "audio"),)
    OUTPUTS = (PadDesc("default", "audio"),)

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        self._buf = np.zeros((0, 0), np.float32)
        self._rate = in_props[0].sample_rate
        self._device = "cuda"
        self.stats: dict = {}
        return self.out_props

    def filter_frame(self, frame: AudioFrame, pad=0):
        x = _host_float(frame)
        self._rate = frame.sample_rate
        self._device = _device_of(frame)
        if self._buf.size == 0:
            self._buf = x
        else:
            self._buf = np.concatenate([self._buf, x], axis=1)
        return [(0, frame)]

    def flush(self):
        if self._buf.size:
            self.stats = measure_r128(self._buf, self._rate, self._device)
        return []


@register_filter
class LoudnormFilter(Filter):
    NAME = "loudnorm"
    DESCRIPTION = "EBU R128 loudness normalization (linear mode)."
    INPUTS = (PadDesc("default", "audio"),)
    OUTPUTS = (PadDesc("default", "audio"),)
    OPTIONS = OptionTable(
        Option("I", float, -24.0, alias="i", min=-70.0, max=-5.0,
               help="target integrated loudness (LUFS)"),
        Option("TP", float, -2.0, alias="tp", min=-9.0, max=0.0,
               help="true-peak ceiling (dBTP)"),
    )

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        self._frames: list[AudioFrame] = []
        self.measured: dict = {}
        return self.out_props

    def filter_frame(self, frame: AudioFrame, pad=0):
        # two-pass linear mode buffers the stream (like the reference's
        # linear=true behavior over a file)
        self._frames.append(frame)
        return []

    def flush(self):
        if not self._frames:
            return []
        xs = [_host_float(f) for f in self._frames]
        x = np.concatenate(xs, axis=1)
        rate = self._frames[0].sample_rate
        m = measure_r128(x, rate, _device_of(self._frames[0]))
        self.measured = m
        gain_db = self.opts["I"] - m["I"]
        # respect the true-peak ceiling
        if m["peak"] > 0:
            headroom_db = self.opts["TP"] - 20 * np.log10(m["peak"])
            gain_db = min(gain_db, headroom_db)
        g = 10 ** (gain_db / 20)
        outs = []
        for f, xf in zip(self._frames, xs):
            y = from_float(torch.from_numpy(np.clip(xf * g, -1.0, 1.0)),
                           f.sample_fmt)
            outs.append((0, f.replace(data=y.to(_device_of(f)))))
        self._frames = []
        return outs
