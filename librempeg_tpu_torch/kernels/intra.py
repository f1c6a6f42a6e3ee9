"""Binding of csrc/intra.cu (H.264 scattered intra MBs: one block, one
warp per listed MB, each waiting only for its intra neighbours)."""
from __future__ import annotations

import ctypes

import torch

from librempeg_tpu_torch.kernels import _build as B

NAME = "intra"
SOURCE = "intra"
#: kernel launches since the last reset (one per call)
LAUNCHES = 0


def _lib():
    lib = B.load(SOURCE)
    fn = lib.intra_scan
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        lib.intra_smem.restype = ctypes.c_long
        lib.intra_smem.argtypes = [ctypes.c_int] * 2
        lib.intra_smem_limit.restype = ctypes.c_long
        lib.intra_smem_limit.argtypes = []
    return lib


def launch(y, u, v, scal, lres_t, cres_t, mb_w: int, mb_h: int) -> None:
    """Rebuild the MBs listed in scal [n, 32] i32 IN PLACE in y/u/v u8.
    lres_t [nmb,16,16] and cres_t [nmb,2,8,8] i32 MB-tile residuals.

    The kernel's shared memory holds 4 bytes per MB of the frame, 64 per
    slot of its ring (a power of two >= mb_w + 2) and 21 KB of per-warp
    tiles, so it takes frames up to about 48,000 MBs (a 1080p frame has
    8,160, a 2160p one 32,400; n itself is not limited); a larger frame
    raises."""
    global LAUNCHES
    nmb = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    B.require(y, "y", torch.uint8, (H, W))
    B.require(u, "u", torch.uint8, (H // 2, W // 2))
    B.require(v, "v", torch.uint8, (H // 2, W // 2))
    B.require(scal, "scal", torch.int32, (scal.shape[0], 32))
    B.require(lres_t, "lres_t", torch.int32, (nmb, 16, 16))
    B.require(cres_t, "cres_t", torch.int32, (nmb, 2, 8, 8))
    # the kernel stores 8 luma / 4 chroma bytes and loads 16-byte residuals
    for name, t, a in (("y", y, 8), ("u", u, 4), ("v", v, 4),
                       ("lres_t", lres_t, 16), ("cres_t", cres_t, 16)):
        if t.data_ptr() % a:
            raise ValueError(f"{name}: expected a {a}-byte aligned tensor")
    lib = _lib()
    need, limit = lib.intra_smem(mb_w, mb_h), lib.intra_smem_limit()
    if need > limit:
        raise ValueError(f"intra kernel: a frame of {mb_w}x{mb_h} MBs needs "
                         f"{need} bytes of shared memory; the kernel takes "
                         f"at most {limit}")
    err = lib.intra_scan(
        B.ptr(y), B.ptr(u), B.ptr(v), B.ptr(scal), scal.shape[0],
        B.ptr(lres_t), B.ptr(cres_t), mb_w, mb_h, B.stream_ptr(y))
    B.check(NAME, err)
    LAUNCHES += 1
