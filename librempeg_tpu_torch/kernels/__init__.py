"""CUDA kernels of the port: one binding module per kernel (ctypes over
an nvcc-built library from csrc/), each with a launch counter."""
from __future__ import annotations

from librempeg_tpu_torch.kernels import deblock, hpel, intra, mc

MODULES = (mc, deblock, intra, hpel)


def reset_counts() -> None:
    for m in MODULES:
        m.LAUNCHES = 0


def counts() -> dict:
    return {m.NAME: m.LAUNCHES for m in MODULES}
