"""Binding of csrc/biquad.cu (the direct-form-II-transposed biquad, one
thread per channel) and its plain version."""
from __future__ import annotations

import ctypes

import torch

from librempeg_tpu_torch.kernels import _build as B

NAME = "biquad"
SOURCE = "biquad"
#: kernel launches since the last reset (one per call)
LAUNCHES = 0


def _lib():
    lib = B.load(SOURCE)
    fn = lib.biquad
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
            + [ctypes.c_float] * 5 + [ctypes.c_void_p]
    return lib


def launch(x, b, a, z):
    """x [C, N] f32, b (b0, b1, b2) and a (a1, a2) float32 values, z
    [C, 2] f32 (z1, z2) -> (y [C, N] f32, z' [C, 2] f32)."""
    global LAUNCHES
    c, n = x.shape
    B.require(x, "x", torch.float32, (c, n))
    B.require(z, "z", torch.float32, (c, 2))
    y = torch.empty_like(x)
    zo = torch.empty_like(z)
    err = _lib().biquad(B.ptr(x), B.ptr(z), B.ptr(y), B.ptr(zo), c, n,
                        *(float(v) for v in (*b, *a)), B.stream_ptr(x))
    B.check(NAME, err)
    LAUNCHES += 1
    return y, zo


def biquad_plain(x, b, a, z):
    """Plain version of the kernel (same contract as launch), on any
    device: a loop over samples, vectorised over channels, in the float
    form of csrc/biquad.cu. Each fused multiply-add is the float64 sum
    of the exact float64 product and the addend, rounded once to
    float32; that rounds twice and can differ from fmaf where the float64
    sum is itself rounded onto a float32 tie (no such sample was found in
    1.4 million: four filter kinds, 44,100 samples at 2 and 6 channels)."""
    b0, b1, b2 = (float(v) for v in b)
    a1, a2 = (float(v) for v in a)

    def f32(t):
        return t.to(torch.float32).to(torch.float64)

    xd = x.to(torch.float64)
    z1 = z[:, 0].to(torch.float64)
    z2 = z[:, 1].to(torch.float64)
    y = torch.empty_like(x)
    for i in range(x.shape[1]):
        xi = xd[:, i]
        out = f32(b0 * xi + z1)
        z1 = f32(f32(b1 * xi - f32(a1 * out)) + z2)
        z2 = f32(b2 * xi - f32(a2 * out))
        y[:, i] = out
    return y, torch.stack([z1, z2], 1).to(torch.float32)
