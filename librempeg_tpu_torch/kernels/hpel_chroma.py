"""Binding of csrc/hpel.cu's chroma kernel (MPEG-4 half-pel chroma MC at
the chroma MV derived from the luma half-pel MV, one warp per MB, 4 MBs
of one MB row per block): the per-MB chroma form."""
from __future__ import annotations

import ctypes

import torch

from librempeg_tpu_torch.kernels import _build as B

NAME = "hpel_chroma"
SOURCE = "hpel"
#: kernel launches since the last reset (one per call)
LAUNCHES = 0


def _lib():
    lib = B.load(SOURCE)
    fn = lib.mc_chroma
    if fn.restype is not ctypes.c_int:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p] * 3
    return lib


def launch(ref_u, ref_v, mv_h, rnd: int = 0):
    """ref_u/v [H/2,W/2] f32, mv_h [H/16,W/16,2] i32 luma half-pel ->
    (pred_u, pred_v) [H/2,W/2] f32."""
    global LAUNCHES
    hc, wc = ref_u.shape
    h, w = 2 * hc, 2 * wc
    if h % 16 or w % 16:
        raise ValueError("mc_chroma: plane dims must be multiples of 8")
    B.require(ref_u, "ref_u", torch.float32, (hc, wc))
    B.require(ref_v, "ref_v", torch.float32, (hc, wc))
    B.require(mv_h, "mv_h", torch.int32, (h // 16, w // 16, 2))
    if mv_h.data_ptr() % 8:         # the kernel's (dy, dx) pair loads
        raise ValueError("mv_h: expected an 8-byte aligned tensor")
    dev = ref_u.device
    pred_u = torch.empty((hc, wc), dtype=torch.float32, device=dev)
    pred_v = torch.empty((hc, wc), dtype=torch.float32, device=dev)
    err = _lib().mc_chroma(B.ptr(ref_u), B.ptr(ref_v), B.ptr(mv_h), h, w,
                           int(rnd), B.ptr(pred_u), B.ptr(pred_v),
                           B.stream_ptr(ref_u))
    B.check(NAME, err)
    LAUNCHES += 1
    return pred_u, pred_v
