"""Deterministic test-signal generators.

Analog of the reference's synthetic fixtures (tests/
audiogen.c, videogen.c, rotozoom.c — SURVEY.md §4 tier 2): reproducible
audio/video content for tests and benchmarks without sample downloads.
"""
from __future__ import annotations

import numpy as np

from librempeg_tpu_torch.core.frame import VideoFrame
from librempeg_tpu_torch.core.rational import Rational


def sine(freq: float, rate: int, n: int, channels: int = 2,
         amp: float = 0.5) -> np.ndarray:
    """[channels, n] float32 sine, per-channel phase offset."""
    t = np.arange(n) / rate
    out = np.stack([
        amp * np.sin(2 * np.pi * freq * t + c * np.pi / 4)
        for c in range(channels)
    ])
    return out.astype(np.float32)


def audio_mix(rate: int, n: int, channels: int = 2) -> np.ndarray:
    """Deterministic broadband audio: sum of incommensurate sines +
    exponentially decaying envelope wobble (audiogen-style content)."""
    t = np.arange(n) / rate
    freqs = [440.0, 1237.0, 3313.0, 7919.0]
    amps = [0.3, 0.2, 0.1, 0.05]
    out = np.zeros((channels, n))
    for c in range(channels):
        sig = np.zeros(n)
        for i, (f, a) in enumerate(zip(freqs, amps)):
            sig += a * np.sin(2 * np.pi * (f * (1 + 0.01 * c)) * t + i)
        env = 0.8 + 0.2 * np.sin(2 * np.pi * 0.5 * t + c)
        out[c] = sig * env
    return out.astype(np.float32)


def s16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16)


def video_rgb(width: int, height: int, frame_idx: int) -> np.ndarray:
    """[H, W, 3] uint8 moving-gradient + circle test pattern."""
    y, x = np.mgrid[0:height, 0:width]
    r = ((x * 255 // max(1, width - 1)) + 2 * frame_idx) % 256
    g = ((y * 255 // max(1, height - 1)) + 3 * frame_idx) % 256
    cx = width / 2 + width / 4 * np.sin(frame_idx / 7)
    cy = height / 2 + height / 4 * np.cos(frame_idx / 5)
    d2 = (x - cx) ** 2 + (y - cy) ** 2
    b = np.where(d2 < (min(width, height) / 6) ** 2, 255, (x + y + frame_idx) % 256)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def video_yuv420(width: int, height: int, frame_idx: int) -> tuple[np.ndarray, ...]:
    """(y, u, v) uint8 planes of a deterministic pattern (even dims)."""
    yy, xx = np.mgrid[0:height, 0:width]
    y = ((xx + yy + 4 * frame_idx) % 220 + 16).astype(np.uint8)
    cu, cv = np.mgrid[0:height // 2, 0:width // 2]
    u = ((cu + 2 * frame_idx) % 200 + 28).astype(np.uint8)
    v = ((cv * 2 - frame_idx) % 200 + 28).astype(np.uint8)
    return y, u, v


def video_frame_yuv420(width: int, height: int, frame_idx: int,
                       fps: Rational = Rational(25, 1)) -> VideoFrame:
    planes = video_yuv420(width, height, frame_idx)
    return VideoFrame(
        planes=planes, format="yuv420p", width=width, height=height,
        pts=frame_idx, time_base=Rational(fps.den, fps.num),
    )
