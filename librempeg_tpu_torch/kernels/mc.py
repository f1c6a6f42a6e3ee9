"""Binding of csrc/mc.cu (H.264 quarter-pel MC, one thread per luma 4x4
block)."""
from __future__ import annotations

import ctypes

import torch

from librempeg_tpu_torch.kernels import _build as B

NAME = "mc"
SOURCE = "mc"
#: kernel launches since the last reset (one per call)
LAUNCHES = 0


def _lib():
    lib = B.load(SOURCE)
    fn = lib.mc_predict
    if fn.restype is not ctypes.c_int:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p] * 4
    return lib


def launch(luma4, upad, vpad, mv, ref, mb_w: int, mb_h: int):
    """luma4 [R,4,hp,wp] u8, upad/vpad [R,hc,wc] u8, mv [nmb,16,2] i16
    (x, y quarter-pel), ref [nmb,4] i8 -> (pred_y [nmb,16,16],
    pred_u/v [nmb,8,8]) u8, on the tensors' CUDA device: contiguous
    slices of one buffer of nmb * 384 bytes."""
    global LAUNCHES
    nmb = mb_w * mb_h
    nref, _, hp, wp = luma4.shape
    hc, wc = upad.shape[1], upad.shape[2]
    B.require(luma4, "luma4", torch.uint8, (nref, 4, hp, wp))
    B.require(upad, "upad", torch.uint8, (nref, hc, wc))
    B.require(vpad, "vpad", torch.uint8, (nref, hc, wc))
    B.require(mv, "mv", torch.int16, (nmb, 16, 2))
    B.require(ref, "ref", torch.int8, (nmb, 4))
    if wp % 4 or wc % 4:
        raise ValueError("mc: padded plane widths must be multiples of 4")
    for name, t in (("luma4", luma4), ("upad", upad), ("vpad", vpad),
                    ("mv", mv), ("ref", ref)):
        if t.data_ptr() % 4:        # the kernel's 32-bit loads
            raise ValueError(f"{name}: expected a 4-byte aligned tensor")
    buf = torch.empty(nmb * 384, dtype=torch.uint8, device=luma4.device)
    py = buf[:nmb * 256].view(nmb, 16, 16)
    pu = buf[nmb * 256:nmb * 320].view(nmb, 8, 8)
    pv = buf[nmb * 320:].view(nmb, 8, 8)
    err = _lib().mc_predict(
        B.ptr(luma4), B.ptr(upad), B.ptr(vpad), B.ptr(mv), B.ptr(ref),
        nref, mb_w, mb_h, hp, wp, hc, wc, B.ptr(py), B.ptr(pu), B.ptr(pv),
        B.stream_ptr(luma4))
    B.check(NAME, err)
    LAUNCHES += 1
    return py, pu, pv
