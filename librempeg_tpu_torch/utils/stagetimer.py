"""Env-gated per-stage wall-clock accounting.

Set LIBREMPEG_TIMING=1 and the hot paths accumulate seconds per named
stage into a process-global table (the `-benchmark_all` analog,
reference fftools/ffmpeg.c:940).  Zero overhead when disabled: `stage`
resolves to a no-op context manager at import time.

Usage:
    from librempeg_tpu_torch.utils.stagetimer import stage
    with stage("h264.entropy"):
        ...
    report() -> {"h264.entropy": {"s": 1.23, "n": 48}, ...}
"""
from __future__ import annotations

import os
import time
from collections import defaultdict

ENABLED = bool(int(os.environ.get("LIBREMPEG_TIMING", "0") or "0"))

_acc: dict = defaultdict(lambda: [0.0, 0])


class _Stage:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        a = _acc[self.name]
        a[0] += time.perf_counter() - self.t0
        a[1] += 1
        return False


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def stage(name: str):
    """Context manager accumulating wall time under `name`."""
    return _Stage(name) if ENABLED else _NOOP


def reset() -> None:
    _acc.clear()


def report() -> dict:
    """{name: {"s": total_seconds, "n": enter_count}} sorted by cost."""
    return {k: {"s": round(v[0], 4), "n": v[1]}
            for k, v in sorted(_acc.items(), key=lambda kv: -kv[1][0])}
