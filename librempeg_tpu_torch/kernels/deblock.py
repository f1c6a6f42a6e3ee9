"""Binding of csrc/deblock.cu (H.264 loop filter: one persistent launch
per frame, MB rows handed out in order, each row's bottom pixels handed
to the row below through flagged words)."""
from __future__ import annotations

import ctypes

import torch

from librempeg_tpu_torch.kernels import _build as B

NAME = "deblock"
SOURCE = "deblock"
#: words (int64) each MB hands the row below (csrc/deblock.cu MBOX)
MBOX = 24
#: kernel launches since the last reset (one per call)
LAUNCHES = 0
_coresident: dict[int, int] = {}
# (device index, stream) -> [scratch, last epoch, ticket]: the kernel's
# scratch stays with its stream, so calls on it run in order, and is
# zeroed only when made (or when the epoch wraps)
_scratch: dict[tuple[int, int], list] = {}


def _lib():
    lib = B.load(SOURCE)
    fn = lib.deblock_frame
    if fn.restype is not ctypes.c_int:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p] + [ctypes.c_uint] * 2 + [ctypes.c_void_p]
        lib.deblock_coresident.restype = ctypes.c_int
        lib.deblock_coresident.argtypes = [ctypes.c_void_p]
    return lib


def coresident(device) -> int:
    """Blocks of the kernel that fit on `device` at once."""
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    if idx not in _coresident:
        out = ctypes.c_int(0)
        with torch.cuda.device(idx):
            B.check(NAME, _lib().deblock_coresident(ctypes.byref(out)))
        _coresident[idx] = out.value
    return _coresident[idx]


def scratch_words(mb_w: int, mb_h: int) -> int:
    """int64 words of the kernel's scratch: the row ticket, then MBOX
    per MB."""
    return 1 + MBOX * mb_w * mb_h


def _next_scratch(device, stream, words: int):
    """The stream's scratch of at least `words` words, this call's
    epoch and ticket base; counts the call against them."""
    key = (device.index, stream.cuda_stream)
    s = _scratch.get(key)
    if s is None or s[0].numel() < words:
        s = _scratch[key] = [torch.zeros(words, dtype=torch.int64,
                                         device=device), 0, 0]
    if s[1] == 2 ** 32 - 1:
        s[0].zero_()
        s[1] = 0
    s[1] += 1
    return s


def launch(y, u, v, params, mb_w: int, mb_h: int,
           grid: int | None = None) -> None:
    """Filter y [16*mb_h, 16*mb_w], u/v [8*mb_h, 8*mb_w] u8 IN PLACE;
    params [nmb, 8, 16] i32 packed per-edge decisions. grid: thread
    blocks, by default min(mb_h, the blocks that fit on the card)."""
    global LAUNCHES
    H, W = mb_h * 16, mb_w * 16
    B.require(y, "y", torch.uint8, (H, W))
    B.require(u, "u", torch.uint8, (H // 2, W // 2))
    B.require(v, "v", torch.uint8, (H // 2, W // 2))
    B.require(params, "params", torch.int32, (mb_w * mb_h, 8, 16))
    if grid is None:
        grid = min(mb_h, coresident(y.device))
    stream = torch.cuda.current_stream(y.device)
    s = _next_scratch(y.device, stream, scratch_words(mb_w, mb_h))
    err = _lib().deblock_frame(B.ptr(y), B.ptr(u), B.ptr(v), B.ptr(params),
                               mb_w, mb_h, int(grid), B.ptr(s[0]), s[2],
                               s[1], ctypes.c_void_p(stream.cuda_stream))
    B.check(NAME, err)
    s[2] = (s[2] + mb_h + int(grid)) % 2 ** 32
    LAUNCHES += 1
