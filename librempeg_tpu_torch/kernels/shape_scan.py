"""Binding of csrc/shape_scan.cu (the noise shaper's error-feedback
scan, one thread per channel)."""
from __future__ import annotations

import ctypes

import torch

from librempeg_tpu_torch.kernels import _build as B

NAME = "shape_scan"
SOURCE = "shape_scan"
#: kernel launches since the last reset (one per call)
LAUNCHES = 0
#: history lengths the kernel is built for
TAPS = (3, 5)


def _lib():
    lib = B.load(SOURCE)
    fn = lib.shape_scan
    if fn.restype is not ctypes.c_int:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
    return lib


def launch(x, noise, coefs, err0):
    """x, noise [C, N] f32 (LSB units), coefs [K] f32, err0 [K, C] f32
    -> (y [C, N] f32 integers, hist [K, C] f32)."""
    global LAUNCHES
    c, n = x.shape
    k = coefs.shape[0]
    if k not in TAPS:
        raise ValueError(f"shape_scan: {k} taps (built for {TAPS})")
    B.require(x, "x", torch.float32, (c, n))
    B.require(noise, "noise", torch.float32, (c, n))
    B.require(coefs, "coefs", torch.float32, (k,))
    B.require(err0, "err0", torch.float32, (k, c))
    y = torch.empty_like(x)
    hist = torch.empty_like(err0)
    err = _lib().shape_scan(B.ptr(x), B.ptr(noise), B.ptr(coefs),
                            B.ptr(err0), B.ptr(y), B.ptr(hist), k, c, n,
                            B.stream_ptr(x))
    B.check(NAME, err)
    LAUNCHES += 1
    return y, hist
