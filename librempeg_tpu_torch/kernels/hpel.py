"""Binding of csrc/hpel.cu (MPEG-4 half-pel refinement + MC, one block
per 16x16 MB)."""
from __future__ import annotations

import ctypes

import torch

from librempeg_tpu_torch.kernels import _build as B

NAME = "hpel"
#: kernel launches since the last reset (one per call)
LAUNCHES = 0


def _lib():
    lib = B.load(NAME)
    fn = lib.hpel_refine_mc
    if fn.restype is not ctypes.c_int:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p] * 5
    return lib


def launch(cur_y, ref_y, ref_u, ref_v, mv_i, rnd: int = 0):
    """cur_y/ref_y [H,W] f32, ref_u/v [H/2,W/2] f32, mv_i [H/16,W/16,2]
    i32 -> (mv_h i32 [H/16,W/16,2], pred_y, pred_u, pred_v f32)."""
    global LAUNCHES
    h, w = cur_y.shape
    if h % 16 or w % 16:
        raise ValueError("hpel_refine_mc: plane dims must be multiples of 16")
    B.require(cur_y, "cur_y", torch.float32, (h, w))
    B.require(ref_y, "ref_y", torch.float32, (h, w))
    B.require(ref_u, "ref_u", torch.float32, (h // 2, w // 2))
    B.require(ref_v, "ref_v", torch.float32, (h // 2, w // 2))
    B.require(mv_i, "mv_i", torch.int32, (h // 16, w // 16, 2))
    dev = cur_y.device
    mv_h = torch.empty((h // 16, w // 16, 2), dtype=torch.int32, device=dev)
    pred_y = torch.empty((h, w), dtype=torch.float32, device=dev)
    pred_u = torch.empty((h // 2, w // 2), dtype=torch.float32, device=dev)
    pred_v = torch.empty((h // 2, w // 2), dtype=torch.float32, device=dev)
    err = _lib().hpel_refine_mc(
        B.ptr(cur_y), B.ptr(ref_y), B.ptr(ref_u), B.ptr(ref_v), B.ptr(mv_i),
        h, w, int(rnd), B.ptr(mv_h), B.ptr(pred_y), B.ptr(pred_u),
        B.ptr(pred_v), B.stream_ptr(cur_y))
    B.check(NAME, err)
    LAUNCHES += 1
    return mv_h, pred_y, pred_u, pred_v
