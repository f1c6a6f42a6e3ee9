"""Quality-metric filters: psnr, ssim.

Port of librempeg_tpu/filters/metrics.py (analogs of
libavfilter/vf_psnr.c, vf_ssim.c): two-input filters comparing main
against reference frames; results accumulate in `.stats`. Each plane's
reduction runs on the frame's device in float32, as in the JAX package,
with one `.item()` per plane (the JAX package's one float() per plane).

A float contract: the reduction order differs from XLA's (and between
the CPU and CUDA), so a plane's mean squared error or SSIM agrees with
the JAX package's to float32 rounding, not bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.core.frame import VideoFrame
from librempeg_tpu_torch.filters.filter import Filter, PadDesc, register_filter


def _f32(p) -> torch.Tensor:
    return torch.as_tensor(p).to(torch.float32)


def _mse_plane(a, b) -> float:
    return ((_f32(a) - _f32(b)) ** 2).mean().item()


def _ssim_plane(a, b) -> float:
    """Global SSIM over 8x8 non-overlapping windows (vf_ssim's blockwise
    scheme uses overlapping 8x8; non-overlap is the standard fast
    variant -- the JAX package's documented difference)."""
    a, b = _f32(a), _f32(b)
    h, w = a.shape[-2] // 8 * 8, a.shape[-1] // 8 * 8
    a = a[..., :h, :w].reshape(-1, h // 8, 8, w // 8, 8)
    b = b[..., :h, :w].reshape(-1, h // 8, 8, w // 8, 8)
    mu_a = a.mean(dim=(2, 4))
    mu_b = b.mean(dim=(2, 4))
    var_a = (a ** 2).mean(dim=(2, 4)) - mu_a ** 2
    var_b = (b ** 2).mean(dim=(2, 4)) - mu_b ** 2
    cov = (a * b).mean(dim=(2, 4)) - mu_a * mu_b
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return s.mean().item()


class _TwoInput(Filter):
    FRAMESYNC = True
    INPUTS = (PadDesc("main", "video"), PadDesc("reference", "video"))

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        self._pending = [None, None]
        self.stats: list[dict] = []
        return self.out_props

    def filter_frame(self, frame, pad=0):
        self._pending[pad] = frame
        if self._pending[0] is None or self._pending[1] is None:
            return []
        main, ref = self._pending
        self._pending = [None, None]
        self._compare(main, ref)
        return [(0, main)]

    def filter_frames(self, frames):
        main, ref = frames[0], frames[1]
        self._compare(main, ref)
        return [(0, main)]

    def _compare(self, main: VideoFrame, ref: VideoFrame):
        raise NotImplementedError


@register_filter
class PsnrFilter(_TwoInput):
    NAME = "psnr"
    DESCRIPTION = "Calculate the PSNR between two video streams."

    def _compare(self, main, ref):
        mses = [_mse_plane(a, b) for a, b in zip(main.planes, ref.planes)]
        names = "yuvar"
        st = {}
        for i, m in enumerate(mses):
            st[f"mse_{names[i]}"] = m
            st[f"psnr_{names[i]}"] = (99.0 if m == 0 else
                                      10 * np.log10(255 * 255 / m))
        # combined: weighted by plane size like the reference (4:1:1)
        d = main.desc
        weights = []
        for i in range(d.nb_planes):
            ph, pw = d.plane_shape(i, main.height, main.width)
            weights.append(ph * pw)
        mse_avg = sum(m * w for m, w in zip(mses, weights)) / sum(weights)
        st["mse_avg"] = mse_avg
        st["psnr_avg"] = (99.0 if mse_avg == 0 else
                          10 * np.log10(255 * 255 / mse_avg))
        self.stats.append(st)

    @property
    def average_psnr(self) -> float:
        if not self.stats:
            return 0.0
        mse = np.mean([s["mse_avg"] for s in self.stats])
        return 99.0 if mse == 0 else 10 * np.log10(255 * 255 / mse)


@register_filter
class SsimFilter(_TwoInput):
    NAME = "ssim"
    DESCRIPTION = "Calculate the SSIM between two video streams."

    def _compare(self, main, ref):
        vals = [_ssim_plane(a, b) for a, b in zip(main.planes, ref.planes)]
        names = "yuvar"
        st = {f"ssim_{names[i]}": v for i, v in enumerate(vals)}
        st["ssim_all"] = float(np.mean(vals))
        self.stats.append(st)

    @property
    def average_ssim(self) -> float:
        return (float(np.mean([s["ssim_all"] for s in self.stats]))
                if self.stats else 0.0)
