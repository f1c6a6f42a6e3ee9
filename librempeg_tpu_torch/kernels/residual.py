"""Binding of csrc/residual.cu (H.264 residual expansion: a block per 8
output rows writes each of their floats once from a shared tile)."""
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
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p] * 2
    return lib


def launch(packed, nmb: int, rows: int):
    """packed [K,24] i16 compact rows, ids ascending with the pad rows at
    the tail, 16-byte aligned -> [rows, 384] f32 spatial residual (rows
    >= nmb and a multiple of 8; zero where no row lands)."""
    global LAUNCHES
    k = packed.shape[0]
    if rows < nmb or rows % 8:
        raise ValueError(f"expand_residual: {rows} output rows for {nmb} "
                         f"MBs (at least nmb, a multiple of 8)")
    B.require(packed, "packed", torch.int16, (k, 24))
    if packed.data_ptr() % 16:
        raise ValueError("packed: expected a 16-byte aligned tensor")
    out = torch.empty((rows, 384), dtype=torch.float32, device=packed.device)
    err = _lib().expand_residual(B.ptr(packed), k, int(nmb), rows,
                                 B.ptr(out), B.stream_ptr(packed))
    B.check(NAME, err)
    LAUNCHES += 1
    return out
