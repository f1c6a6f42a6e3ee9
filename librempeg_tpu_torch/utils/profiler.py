"""Profiling and tracing utilities.

Port of librempeg_tpu/utils/profiler.py (the reference's timer layer,
libavutil/timer.h:118 START_TIMER/STOP_TIMER with outlier rejection,
checkasm --bench). Device work is asynchronous, so a timed value is
forced by synchronising the device of its first tensor (nothing on the
CPU); kernels are benchmarked with warm-up and the slowest quarter
trimmed. `device_trace` records a torch.profiler trace of the CPU and
the card and writes it as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import statistics
import time
from collections import defaultdict
from typing import Any, Callable

import numpy as np
import torch

_records: dict[str, list[float]] = defaultdict(list)


def _first_tensor(value: Any) -> torch.Tensor | None:
    if isinstance(value, torch.Tensor):
        return value
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        for v in value:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def _force(value: Any) -> None:
    """Wait for the device of the first tensor in `value` (a tensor or
    a nest of lists, tuples and dicts) to finish its work."""
    t = _first_tensor(value)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def scoped(name: str, result_holder: list | None = None):
    """START_TIMER/STOP_TIMER analog:

        with profiler.scoped("idct", out := []):
            out.append(idct(x))

    forces completion when the block appends its outputs to
    result_holder; otherwise it times the dispatch only."""
    t0 = time.perf_counter()
    yield
    if result_holder:
        _force(result_holder[-1])
    _records[name].append(time.perf_counter() - t0)


def bench_kernel(fn: Callable, *args, iters: int = 10, warmup: int = 2,
                 name: str | None = None) -> dict:
    """checkasm --bench analog: timed runs with outlier trimming.

    Returns {"mean_ms", "min_ms", "p50_ms", "iters"}."""
    for _ in range(warmup):
        _force(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _force(fn(*args))
        times.append((time.perf_counter() - t0) * 1000)
    times.sort()
    trimmed = times[: max(1, len(times) * 3 // 4)]  # drop slowest quarter
    stats = {
        "mean_ms": statistics.fmean(trimmed),
        "min_ms": times[0],
        "p50_ms": times[len(times) // 2],
        "iters": iters,
    }
    if name:
        _records[name].extend(t / 1000 for t in trimmed)
    return stats


def report() -> dict[str, dict]:
    """Aggregate scoped-timer stats (print_report analog)."""
    out = {}
    for name, ts in _records.items():
        arr = np.asarray(ts)
        out[name] = {
            "calls": len(arr),
            "total_s": float(arr.sum()),
            "mean_ms": float(arr.mean() * 1000),
            "p50_ms": float(np.percentile(arr, 50) * 1000),
            "p95_ms": float(np.percentile(arr, 95) * 1000),
        }
    return out


def reset() -> None:
    _records.clear()


@contextlib.contextmanager
def device_trace(path: str):
    """Record the block with torch.profiler over the CPU and, where
    there is one, the card, and write a Chrome trace (viewable in
    chrome://tracing or Perfetto) to `path`. Yields the profiler, whose
    events are read after the block."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
