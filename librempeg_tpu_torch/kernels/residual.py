"""Binding of csrc/residual.cu (H.264 residual expansion, one thread per
output pixel of a compact row)."""
from __future__ import annotations

import ctypes

import torch

from librempeg_tpu_torch.kernels import _build as B

NAME = "residual"
SOURCE = "residual"
#: kernel launches since the last reset (one per call)
LAUNCHES = 0


def _lib():
    lib = B.load(SOURCE)
    fn = lib.expand_residual
    if fn.restype is not ctypes.c_int:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p] * 2
    return lib


def launch(packed, nmb: int, rows: int):
    """packed [K,24] i16 compact rows -> [rows, 384] f32 spatial
    residual (rows >= nmb; zero where no row lands)."""
    global LAUNCHES
    k = packed.shape[0]
    if rows < nmb:
        raise ValueError(f"expand_residual: {rows} output rows < {nmb} MBs")
    B.require(packed, "packed", torch.int16, (k, 24))
    out = torch.zeros((rows, 384), dtype=torch.float32, device=packed.device)
    err = _lib().expand_residual(B.ptr(packed), k, int(nmb), B.ptr(out),
                                 B.stream_ptr(packed))
    B.check(NAME, err)
    LAUNCHES += 1
    return out
