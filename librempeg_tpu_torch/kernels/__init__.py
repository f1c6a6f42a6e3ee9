"""CUDA kernels of the port: one binding module per kernel (ctypes over
an nvcc-built library from csrc/<SOURCE>.cu), each with a launch
counter."""
from __future__ import annotations

from librempeg_tpu_torch.kernels import (
    biquad,
    deblock,
    fsearch,
    hpel,
    hpel_chroma,
    hpel_luma,
    intra,
    mc,
    residual,
    shape_scan,
)

MODULES = (mc, deblock, intra, hpel, hpel_luma, hpel_chroma, fsearch,
           residual, shape_scan, biquad)


def sources() -> list[str]:
    """The csrc/*.cu sources the kernels are built from."""
    return sorted({m.SOURCE for m in MODULES})


def reset_counts() -> None:
    for m in MODULES:
        m.LAUNCHES = 0


def counts() -> dict:
    return {m.NAME: m.LAUNCHES for m in MODULES}
