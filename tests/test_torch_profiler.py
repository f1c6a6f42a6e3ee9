"""utils/profiler in the port against the JAX package's: fed the same
timings (time.perf_counter patched with one fixed sequence), report()
and bench_kernel() give equal dicts; _force synchronises nothing on the
CPU; device_trace writes a Chrome trace of the block."""
import itertools
import json

import numpy as np
import pytest
import torch

from librempeg_tpu.utils import profiler as JPR
from librempeg_tpu_torch.utils import profiler as TPR


def _clock(seed: int):
    """A perf_counter that steps by seeded amounts (0.1-30 ms)."""
    rng = np.random.default_rng(seed)
    steps = rng.uniform(1e-4, 3e-2, 10_000)
    t = itertools.accumulate(steps, initial=100.0)
    return lambda: next(t)


@pytest.mark.parametrize("iters", [1, 4, 10, 17])
def test_bench_kernel_and_report_agree(monkeypatch, iters):
    out = []
    for mod, x in ((JPR, np.ones(4, np.float32)), (TPR, torch.ones(4))):
        mod.reset()
        monkeypatch.setattr(mod.time, "perf_counter", _clock(iters))
        stats = mod.bench_kernel(lambda a: a * 2, x, iters=iters, warmup=2,
                                 name="k")
        for i in range(5):
            holder = []
            with mod.scoped("block", holder):
                holder.append([x, {"y": x}])
        with mod.scoped("dispatch"):
            pass
        out.append((stats, mod.report()))
        mod.reset()
        assert mod.report() == {}
    assert out[0] == out[1]
    assert set(out[1][1]) == {"k", "block", "dispatch"}


def test_force_finds_the_first_tensor():
    assert TPR._first_tensor([1, {"a": (None, torch.zeros(2))}]) is not None
    assert TPR._first_tensor({"a": 1}) is None
    TPR._force([torch.zeros(2)])          # a CPU tensor: nothing to wait for


def test_device_trace_writes_a_chrome_trace(tmp_path):
    path = str(tmp_path / "trace.json")
    with TPR.device_trace(path) as prof:
        torch.ones(64).cumsum(0)
    events = json.load(open(path))["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    assert any("cumsum" in e.key for e in prof.key_averages())
