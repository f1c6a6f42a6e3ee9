"""Binding of csrc/fsearch.cu (fused integer full search + MC, one
block per frame and 16x16 MB)."""
from __future__ import annotations

import ctypes

import torch

from librempeg_tpu_torch.kernels import _build as B

NAME = "fsearch"
SOURCE = "fsearch"
MAX_RANGE = 16         # MAX_R of the kernel's template instances
#: kernel launches since the last reset (one per call)
LAUNCHES = 0


def _lib():
    lib = B.load(SOURCE)
    fn = lib.full_search_mc
    if fn.restype is not ctypes.c_int:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p] * 4
    return lib


def launch(cur, ref, search_range: int):
    """cur/ref [N,H,W] f32 -> (mv [N,H/16,W/16,2] i32, cost
    [N,H/16,W/16] f32, pred [N,H,W] f32)."""
    global LAUNCHES
    n, h, w = cur.shape
    if h % 16 or w % 16:
        raise ValueError("full_search_mc: plane dims must be multiples of 16")
    if not 0 <= search_range <= MAX_RANGE:
        raise ValueError(f"full_search_mc: search_range {search_range} "
                         f"outside 0..{MAX_RANGE}")
    B.require(cur, "cur", torch.float32, (n, h, w))
    B.require(ref, "ref", torch.float32, (n, h, w))
    dev = cur.device
    mv = torch.empty((n, h // 16, w // 16, 2), dtype=torch.int32, device=dev)
    cost = torch.empty((n, h // 16, w // 16), dtype=torch.float32, device=dev)
    pred = torch.empty((n, h, w), dtype=torch.float32, device=dev)
    err = _lib().full_search_mc(B.ptr(cur), B.ptr(ref), n, h, w,
                                int(search_range), B.ptr(mv), B.ptr(cost),
                                B.ptr(pred), B.stream_ptr(cur))
    B.check(NAME, err)
    LAUNCHES += 1
    return mv, cost, pred
