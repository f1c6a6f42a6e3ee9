"""Binding of csrc/intra.cu (H.264 scattered intra MBs, one block
walking the raster-ordered list)."""
from __future__ import annotations

import ctypes

import torch

from librempeg_tpu_torch.kernels import _build as B

NAME = "intra"
#: kernel launches since the last reset (one per call)
LAUNCHES = 0


def _lib():
    lib = B.load(NAME)
    fn = lib.intra_scan
    if fn.restype is not ctypes.c_int:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                       + [ctypes.c_void_p, ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
    return lib


def launch(y, u, v, scal, t4, t16, tc, lres_t, cres_t, mb_w: int,
               mb_h: int) -> None:
    """Rebuild the MBs listed in scal [n, 32] i32 IN PLACE in y/u/v u8.
    t4/t16/tc: i32 coefficient tables; lres_t [nmb,16,16] and cres_t
    [nmb,2,8,8] i32 MB-tile residuals."""
    global LAUNCHES
    nmb = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    B.require(y, "y", torch.uint8, (H, W))
    B.require(u, "u", torch.uint8, (H // 2, W // 2))
    B.require(v, "v", torch.uint8, (H // 2, W // 2))
    B.require(scal, "scal", torch.int32, (scal.shape[0], 32))
    for name, t in (("t4", t4), ("t16", t16), ("tc", tc)):
        B.require(t, name, torch.int32)
    B.require(lres_t, "lres_t", torch.int32, (nmb, 16, 16))
    B.require(cres_t, "cres_t", torch.int32, (nmb, 2, 8, 8))
    err = _lib().intra_scan(
        B.ptr(y), B.ptr(u), B.ptr(v), B.ptr(scal), scal.shape[0],
        B.ptr(t4), t4.shape[1], B.ptr(t16), t16.shape[1], B.ptr(tc),
        tc.shape[1], B.ptr(lres_t), B.ptr(cres_t), mb_w, mb_h,
        B.stream_ptr(y))
    B.check(NAME, err)
    LAUNCHES += 1
