"""AAC psychoacoustic model (3GPP TS 26.403-style, simplified).

Copy of librempeg_tpu/codecs/aac/psy.py (host numpy).

Role analog of libavcodec/aacpsy.c: per-scalefactor-band
masking thresholds from band energies spread along the Bark scale with
asymmetric slopes, an SMR offset, and an absolute-threshold floor. The
encoder's two-loop quantizer (aaccoder.c twoloop role) distributes
noise under these thresholds and scales them uniformly to meet the bit
budget.
"""
from __future__ import annotations

import numpy as np


def _bark(f):
    return 13.0 * np.arctan(0.00076 * f) \
        + 3.5 * np.arctan((f / 7500.0) ** 2)


class PsyModel:
    # spreading slopes, dB per Bark (toward lower / higher bands)
    SLOPE_LO = 30.0
    SLOPE_HI = 15.0
    SMR_DB = 29.0                  # signal-to-mask offset (tonal-safe)

    def __init__(self, swb_offsets, sample_rate: int, frame: int = 1024):
        self.offsets = np.asarray(swb_offsets)
        centers = (self.offsets[:-1] + self.offsets[1:]) / 2.0
        freqs = centers * sample_rate / (2.0 * frame)
        self.bark = _bark(freqs)
        dbark = np.diff(self.bark)
        self.k_up = 10.0 ** (-self.SLOPE_HI * dbark / 10.0)
        self.k_dn = 10.0 ** (-self.SLOPE_LO * dbark / 10.0)
        # absolute threshold of hearing per band (quiet floor), mapped
        # into the encoder's spectral domain (x 32768 pcm scaling)
        ath_db = (3.64 * (freqs / 1000.0 + 1e-3) ** -0.8
                  - 6.5 * np.exp(-0.6 * (freqs / 1000.0 - 3.3) ** 2)
                  + 1e-3 * (freqs / 1000.0) ** 4)
        ath_db = np.clip(ath_db, -20.0, 60.0)
        widths = np.diff(self.offsets)
        self.ath = 10.0 ** (ath_db / 10.0) * widths * 1e-2

    def thresholds(self, spec: np.ndarray) -> np.ndarray:
        """spec [1024] -> per-band masking threshold (energy)."""
        nb = len(self.offsets) - 1
        en = np.zeros(nb)
        for b in range(nb):
            seg = spec[self.offsets[b]:self.offsets[b + 1]]
            en[b] = float(np.dot(seg, seg))
        spread = en.copy()
        for b in range(1, nb):                 # upward spreading
            spread[b] = max(spread[b], spread[b - 1] * self.k_up[b - 1])
        for b in range(nb - 2, -1, -1):        # downward spreading
            spread[b] = max(spread[b], spread[b + 1] * self.k_dn[b])
        thr = spread * 10.0 ** (-self.SMR_DB / 10.0)
        return np.maximum(thr, self.ath)
