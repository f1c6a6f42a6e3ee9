"""Binding of csrc/hpel.cu's luma kernel (MPEG-4 half-pel refinement +
luma MC, one warp per 16x16 MB, 4 MBs of one MB row per block): the
per-MB luma form."""
from __future__ import annotations

import ctypes

import torch

from librempeg_tpu_torch.kernels import _build as B

NAME = "hpel_luma"
SOURCE = "hpel"
#: kernel launches since the last reset (one per call)
LAUNCHES = 0


def _lib():
    lib = B.load(SOURCE)
    fn = lib.refine_mc_luma
    if fn.restype is not ctypes.c_int:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p] * 3
    return lib


def launch(cur_y, ref_y, mv_i, rnd: int = 0):
    """cur_y/ref_y [H,W] f32, mv_i [H/16,W/16,2] i32 -> (mv_h i32
    [H/16,W/16,2] half-pel, pred_y [H,W] f32)."""
    global LAUNCHES
    h, w = cur_y.shape
    if h % 16 or w % 16:
        raise ValueError("refine_mc_luma: plane dims must be multiples of 16")
    B.require(cur_y, "cur_y", torch.float32, (h, w))
    B.require(ref_y, "ref_y", torch.float32, (h, w))
    B.require(mv_i, "mv_i", torch.int32, (h // 16, w // 16, 2))
    for name, t in (("cur_y", cur_y), ("ref_y", ref_y)):
        if t.data_ptr() % 16:       # the kernel's float4 loads
            raise ValueError(f"{name}: expected a 16-byte aligned tensor")
    dev = cur_y.device
    mv_h = torch.empty((h // 16, w // 16, 2), dtype=torch.int32, device=dev)
    pred_y = torch.empty((h, w), dtype=torch.float32, device=dev)
    err = _lib().refine_mc_luma(B.ptr(cur_y), B.ptr(ref_y), B.ptr(mv_i), h,
                                w, int(rnd), B.ptr(mv_h), B.ptr(pred_y),
                                B.stream_ptr(cur_y))
    B.check(NAME, err)
    LAUNCHES += 1
    return mv_h, pred_y
