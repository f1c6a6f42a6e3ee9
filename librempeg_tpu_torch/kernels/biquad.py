"""Binding of csrc/biquad.cu (a run of direct-form-II-transposed biquads,
all stages and channels in one launch) and its plain versions."""
from __future__ import annotations

import ctypes

import torch

from librempeg_tpu_torch.codecs.pcm import from_float, to_float
from librempeg_tpu_torch.kernels import _build as B

NAME = "biquad"
SOURCE = "biquad"
#: kernel launches since the last reset (one per call of at most SMAX
#: stages)
LAUNCHES = 0
#: stages one launch runs (csrc/biquad.cu SMAX); a longer run is split
SMAX = 32
#: the kernel's round trip between stages for each base sample format
FORMATS = {"flt": 0, "dbl": 0, "s16": 1, "s32": 2, "u8": 3}


def _lib():
    lib = B.load(SOURCE)
    fn = lib.biquad
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return lib


def launch(x, coefs, z, fmt: str):
    """x [C, N] f32; coefs the run's stages, each (b0, b1, b2, a1, a2)
    float32 values; z [S, C, 2] f32 each stage's (z1, z2); fmt the run's
    sample format -> (y [C, N] f32, z' [S, C, 2] f32), as
    biquad_cascade_plain (a run longer than SMAX takes one launch for
    each SMAX stages, the output of one the input of the next)."""
    global LAUNCHES
    c, n = x.shape
    s = len(coefs)
    if s == 0:
        raise ValueError("biquad: a run has at least one stage")
    B.require(x, "x", torch.float32, (c, n))
    B.require(z, "z", torch.float32, (s, c, 2))
    code = FORMATS[fmt.rstrip("p")]
    zo = torch.empty_like(z)
    for s0 in range(0, s, SMAX):
        s1 = min(s, s0 + SMAX)
        if s0:
            x = y
        y = torch.empty_like(x)
        flat = (ctypes.c_float * (5 * (s1 - s0)))(
            *(float(v) for st in coefs[s0:s1] for v in st))
        err = _lib().biquad(B.ptr(x), B.ptr(z[s0:s1]), B.ptr(y),
                            B.ptr(zo[s0:s1]), c, n, s1 - s0, flat, code,
                            B.stream_ptr(x))
        B.check(NAME, err)
        LAUNCHES += 1
    return y, zo


def biquad_plain(x, b, a, z):
    """Plain version of one stage (x [C, N] f32, b (b0, b1, b2) and a
    (a1, a2) float32 values, z [C, 2] f32 -> (y, z')), on any device: a
    loop over samples, vectorised over channels, in the float form of
    csrc/biquad.cu. Each fused multiply-add is the float64 sum of the
    exact float64 product and the addend, rounded once to float32; that
    rounds twice and can differ from fmaf where the float64 sum is itself
    rounded onto a float32 tie (no such sample was found in 1.4 million:
    four filter kinds, 44,100 samples at 2 and 6 channels)."""
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


def biquad_cascade_plain(x, coefs, z, fmt: str):
    """Plain version of the kernel (same contract as launch), on any
    device: each stage's biquad_plain, and after each stage the sample
    format's round trip of codecs/pcm.py, as the filter graph hands one
    biquad filter's output frame to the next. y is the last stage's
    output round-tripped: its from_float is the last filter's frame."""
    zs = []
    for b0, b1, b2, a1, a2 in coefs:
        y, zn = biquad_plain(x, (b0, b1, b2), (a1, a2), z[len(zs)])
        x = to_float(from_float(y, fmt), fmt)
        zs.append(zn)
    return x, torch.stack(zs)
