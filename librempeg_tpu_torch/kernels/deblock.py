"""Binding of csrc/deblock.cu (H.264 loop filter, one launch per MB
diagonal t = mx + 2*my)."""
from __future__ import annotations

import ctypes

import torch

from librempeg_tpu_torch.kernels import _build as B

NAME = "deblock"
SOURCE = "deblock"
#: deblock_frame calls since the last reset (each call launches the
#: kernel once per diagonal)
LAUNCHES = 0


def _lib():
    lib = B.load(SOURCE)
    fn = lib.deblock_frame
    if fn.restype is not ctypes.c_int:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
    return lib


def launch(y, u, v, params, mb_w: int, mb_h: int) -> None:
    """Filter y [16*mb_h, 16*mb_w], u/v [8*mb_h, 8*mb_w] u8 IN PLACE;
    params [nmb, 8, 16] i32 packed per-edge decisions."""
    global LAUNCHES
    H, W = mb_h * 16, mb_w * 16
    B.require(y, "y", torch.uint8, (H, W))
    B.require(u, "u", torch.uint8, (H // 2, W // 2))
    B.require(v, "v", torch.uint8, (H // 2, W // 2))
    B.require(params, "params", torch.int32, (mb_w * mb_h, 8, 16))
    err = _lib().deblock_frame(B.ptr(y), B.ptr(u), B.ptr(v), B.ptr(params),
                               mb_w, mb_h, B.stream_ptr(y))
    B.check(NAME, err)
    LAUNCHES += 1
