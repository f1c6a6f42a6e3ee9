"""GIF codec: LZW decode/encode + palette handling.

Analog of libavcodec/gifdec.c / gifenc.c (+lzw.c).
Host-side: LZW is inherently serial; palette mapping is vectorized
numpy (ordered-dither quantization to a uniform 6x7x6 cube on encode).

A copy of librempeg_tpu/codecs/gif.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

import numpy as np

from librempeg_tpu_torch.core.errors import InvalidData

# ---------------------------------------------------------------------------
# LZW (GIF variable-code-size variant, LSB-first)
# ---------------------------------------------------------------------------


def lzw_decode(data: bytes, min_code_size: int, max_pixels: int) -> np.ndarray:
    clear = 1 << min_code_size
    end = clear + 1
    out = np.zeros(max_pixels, np.uint8)
    n_out = 0

    bitpos = 0
    total_bits = len(data) * 8

    def read_code(size):
        nonlocal bitpos
        if bitpos + size > total_bits:
            return end
        byte = bitpos >> 3
        shift = bitpos & 7
        v = data[byte] | (data[byte + 1] << 8 if byte + 1 < len(data) else 0) \
            | (data[byte + 2] << 16 if byte + 2 < len(data) else 0)
        bitpos += size
        return (v >> shift) & ((1 << size) - 1)

    # dictionary: prefix/last-char arrays
    maxdict = 4096
    prefix = np.full(maxdict, -1, np.int32)
    suffix = np.zeros(maxdict, np.uint8)
    for i in range(clear):
        suffix[i] = i

    code_size = min_code_size + 1
    next_code = end + 1
    prev = -1
    stack = bytearray()
    while n_out < max_pixels:
        code = read_code(code_size)
        if code == clear:
            code_size = min_code_size + 1
            next_code = end + 1
            prev = -1
            continue
        if code == end:
            break
        if prev < 0:
            out[n_out] = suffix[code]
            n_out += 1
            prev = code
            continue
        incode = code
        stack.clear()
        if code >= next_code:        # KwKwK case
            stack.append(0)          # placeholder, filled below
            code = prev
        while prefix[code] >= 0:
            stack.append(suffix[code])
            code = prefix[code]
        first = suffix[code]
        stack.append(first)
        if incode >= next_code:
            stack[0] = first
        # emit reversed
        seq = bytes(reversed(stack))
        k = min(len(seq), max_pixels - n_out)
        out[n_out:n_out + k] = np.frombuffer(seq[:k], np.uint8)
        n_out += k
        if next_code < maxdict:
            prefix[next_code] = prev
            suffix[next_code] = first
            next_code += 1
            if next_code == (1 << code_size) and code_size < 12:
                code_size += 1
        prev = incode
    return out[:n_out]


def lzw_encode(indices: np.ndarray, min_code_size: int) -> bytes:
    clear = 1 << min_code_size
    end = clear + 1
    out = bytearray()
    acc = 0
    nbits = 0

    def put(code, size):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    code_size = min_code_size + 1
    table: dict[bytes, int] = {bytes([i]): i for i in range(clear)}
    next_code = end + 1
    put(clear, code_size)
    w = b""
    for px in indices.tobytes():
        wk = w + bytes([px])
        if wk in table:
            w = wk
            continue
        put(table[w], code_size)
        if next_code < 4096:
            table[wk] = next_code
            next_code += 1
            if next_code - 1 == (1 << code_size) and code_size < 12:
                code_size += 1
        else:
            put(clear, code_size)
            table = {bytes([i]): i for i in range(clear)}
            next_code = end + 1
            code_size = min_code_size + 1
        w = bytes([px])
    if w:
        put(table[w], code_size)
    put(end, code_size)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


# ---------------------------------------------------------------------------
# Palette quantization (uniform 6x7x6 cube + ordered dither)
# ---------------------------------------------------------------------------

_BAYER8 = (np.array([
    [0, 32, 8, 40, 2, 34, 10, 42],
    [48, 16, 56, 24, 50, 18, 58, 26],
    [12, 44, 4, 36, 14, 46, 6, 38],
    [60, 28, 52, 20, 62, 30, 54, 22],
    [3, 35, 11, 43, 1, 33, 9, 41],
    [51, 19, 59, 27, 49, 17, 57, 25],
    [15, 47, 7, 39, 13, 45, 5, 37],
    [63, 31, 55, 23, 61, 29, 53, 21]], np.float32) + 0.5) / 64 - 0.5


def make_palette() -> np.ndarray:
    """252-entry uniform 6x7x6 RGB cube palette."""
    r = np.linspace(0, 255, 6)
    g = np.linspace(0, 255, 7)
    b = np.linspace(0, 255, 6)
    pal = np.zeros((256, 3), np.uint8)
    i = 0
    for rv in r:
        for gv in g:
            for bv in b:
                pal[i] = (round(rv), round(gv), round(bv))
                i += 1
    return pal


def quantize(rgb: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 -> palette indices (ordered dither)."""
    h, w, _ = rgb.shape
    d = np.tile(_BAYER8, (h // 8 + 1, w // 8 + 1))[:h, :w]
    x = rgb.astype(np.float32)
    ri = np.clip(np.floor(x[..., 0] / 255 * 5 + d + 0.5), 0, 5)
    gi = np.clip(np.floor(x[..., 1] / 255 * 6 + d + 0.5), 0, 6)
    bi = np.clip(np.floor(x[..., 2] / 255 * 5 + d + 0.5), 0, 5)
    return (ri * 42 + gi * 6 + bi).astype(np.uint8)
