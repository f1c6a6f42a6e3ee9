"""FIR filter design: windowed-sinc polyphase banks and scaler kernels.

Host-side (numpy/float64) construction of the filter *coefficients*; the
*application* of these filters is the device kernels in
librempeg_tpu_torch.ops.fir / scale. Behavioral analog of:

* libswresample/resample.c:41 (build_filter): Kaiser /
  Blackman-Nuttall windowed sinc, `phase_count` polyphases, per-phase
  normalization — the audio resampler bank.
* libswscale/utils.c (initFilter): bilinear / bicubic /
  lanczos / gaussian / spline taps for image scaling.

The construction is pure tables; caching keys on the full parameter set.
"""
from __future__ import annotations

import functools
import math

import numpy as np


def i0(x: float) -> float:
    """Zeroth-order modified Bessel function (power series)."""
    t = x * x / 4.0
    term = 1.0
    s = 1.0
    for k in range(1, 50):
        term *= t / (k * k)
        s += term
        if term < 1e-21 * s:
            break
    return s


def kaiser_beta_window(n: int, beta: float) -> np.ndarray:
    """Length-n Kaiser window with shape parameter beta."""
    ii = np.arange(n)
    r = 2.0 * ii / (n - 1) - 1.0
    return np.array([i0(beta * math.sqrt(max(0.0, 1 - v * v))) for v in r]) / i0(beta)


def blackman_nuttall_window(n: int) -> np.ndarray:
    ii = np.arange(n)
    t = 2 * np.pi * ii / (n - 1)
    return (0.3635819 - 0.4891775 * np.cos(t) + 0.1365995 * np.cos(2 * t)
            - 0.0106411 * np.cos(3 * t))


@functools.lru_cache(maxsize=64)
def resample_bank(
    filter_size: int,
    phase_count: int,
    cutoff: float,
    kaiser_beta: float = 9.0,
    window: str = "kaiser",
) -> np.ndarray:
    """Build a polyphase windowed-sinc bank: [phase_count, filter_size] float64.

    Semantics follow swresample's build_filter (resample.c:41): for phase p
    the taps sample sinc(cutoff * (i - center + p/phase_count)) * w(...),
    then each phase is normalized to unit DC gain so resampling preserves
    level exactly.
    """
    taps = np.zeros((phase_count, filter_size))
    # integer center so tap k of phase frac sits at distance k-center-frac
    # from the output position; the consumer's window offset must match.
    center = filter_size // 2 - 1 if filter_size > 1 else 0
    for p in range(phase_count):
        frac = p / phase_count
        x = (np.arange(filter_size) - center - frac) * cutoff
        h = np.sinc(x)
        if window == "kaiser":
            # windowed over the tap span including the fractional shift
            span = (np.arange(filter_size) - center - frac) / (filter_size / 2)
            span = np.clip(span, -1.0, 1.0)
            w = np.array([i0(kaiser_beta * math.sqrt(max(0.0, 1 - v * v)))
                          for v in span]) / i0(kaiser_beta)
        elif window == "blackman_nuttall":
            t = np.pi * ((np.arange(filter_size) - center - frac) / (filter_size / 2) + 1)
            w = 0.3635819 - 0.4891775 * np.cos(t) + 0.1365995 * np.cos(2 * t) \
                - 0.0106411 * np.cos(3 * t)
        else:
            raise ValueError(f"unknown window {window!r}")
        taps[p] = h * cutoff * w
        s = taps[p].sum()
        if s != 0:
            taps[p] /= s  # unit DC gain per phase
    return taps


# ---------------------------------------------------------------------------
# Image scaler kernels (swscale flags analog)
# ---------------------------------------------------------------------------


def _bicubic(x: np.ndarray, a: float = -0.6) -> np.ndarray:
    """Keys cubic with parameter a (swscale's default bicubic uses -0.60)."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w = np.where(
        ax <= 1,
        (a + 2) * ax3 - (a + 3) * ax2 + 1,
        np.where(ax < 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0),
    )
    return w


def _lanczos(x: np.ndarray, a: int = 3) -> np.ndarray:
    return np.where(np.abs(x) < a, np.sinc(x) * np.sinc(x / a), 0.0)


def _gaussian(x: np.ndarray, p: float = 3.0) -> np.ndarray:
    return 2.0 ** (-p * x * x)


def _spline(x: np.ndarray) -> np.ndarray:
    """Cubic B-spline."""
    ax = np.abs(x)
    return np.where(
        ax < 1,
        2 / 3 - ax * ax + ax ** 3 / 2,
        np.where(ax < 2, ((2 - ax) ** 3) / 6, 0.0),
    )


_KERNELS = {
    "bilinear": (lambda x: np.maximum(0.0, 1.0 - np.abs(x)), 1.0),
    "bicubic": (_bicubic, 2.0),
    "lanczos": (_lanczos, 3.0),
    "gauss": (_gaussian, 2.0),
    "spline": (_spline, 2.0),
    "area": (lambda x: np.maximum(0.0, 1.0 - np.abs(x)), 1.0),  # box via scaled tri
    "neighbor": (lambda x: (np.abs(x) <= 0.5).astype(np.float64), 0.5),
}

SCALER_KERNEL_NAMES = tuple(_KERNELS)


@functools.lru_cache(maxsize=256)
def scale_filter(
    src_size: int,
    dst_size: int,
    kernel: str = "bicubic",
) -> tuple[np.ndarray, np.ndarray]:
    """Polyphase resize filter for one axis.

    Returns (taps, index): taps [dst_size, n_taps] float64 rows summing to
    1, index [dst_size] int32 of the first source sample of each row.
    Downscales widen the kernel support by the scale ratio (anti-aliasing),
    as swscale does.
    """
    if kernel == "neighbor":
        idx = np.clip(
            ((np.arange(dst_size) + 0.5) * src_size / dst_size).astype(np.int64),
            0, src_size - 1)
        return np.ones((dst_size, 1)), idx.astype(np.int32)
    fn, support = _KERNELS[kernel]
    scale = src_size / dst_size
    stretch = max(1.0, scale)  # widen when downscaling
    n_taps = max(1, int(math.ceil(support * stretch * 2)))
    taps = np.zeros((dst_size, n_taps))
    index = np.zeros(dst_size, np.int32)
    for d in range(dst_size):
        center = (d + 0.5) * scale - 0.5
        left = int(math.floor(center - support * stretch)) + 1
        index[d] = left
        x = (left + np.arange(n_taps) - center) / stretch
        w = fn(x)
        s = w.sum()
        taps[d] = w / s if s != 0 else w
    return taps, index


def clamp_filter_edges(taps: np.ndarray, index: np.ndarray, src_size: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Fold out-of-range taps onto the edge samples (replicate padding),
    keeping index within [0, src_size - n_taps] so device gathers are
    in-bounds with static shapes."""
    taps = taps.copy()
    index = index.copy()
    n_taps = taps.shape[1]
    for d in range(taps.shape[0]):
        lo = index[d]
        hi = lo + n_taps - 1
        if lo < 0:
            # accumulate all taps below 0 into the first in-range tap
            shift = -lo
            row = np.zeros(n_taps)
            row[0] = taps[d, :shift].sum()
            row[: n_taps - shift] += taps[d, shift:]
            # re-derive: row[j] corresponds to src sample j
            taps[d] = row
            index[d] = 0
        elif hi >= src_size:
            over = hi - (src_size - 1)
            row = np.zeros(n_taps)
            row[n_taps - 1] = taps[d, n_taps - over:].sum()
            row[over:] += taps[d, : n_taps - over]
            taps[d] = row
            index[d] = src_size - n_taps
    np.clip(index, 0, max(0, src_size - n_taps), out=index)
    return taps, index
