"""Bit-level I/O + CRCs for FLAC.

Analog of the reference's get_bits/put_bits use in flacdec.c/flacenc.c.
CRC-8 (poly 0x07) and CRC-16 (poly 0x8005) are the FLAC spec ones.
"""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def _crc8_table() -> np.ndarray:
    t = np.zeros(256, np.uint8)
    for i in range(256):
        c = i
        for _ in range(8):
            c = ((c << 1) ^ 0x07 if c & 0x80 else c << 1) & 0xFF
        t[i] = c
    return t


@functools.lru_cache(maxsize=None)
def _crc16_table() -> np.ndarray:
    t = np.zeros(256, np.uint16)
    for i in range(256):
        c = i << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005 if c & 0x8000 else c << 1) & 0xFFFF
        t[i] = c
    return t


def crc8(data: bytes) -> int:
    t = _crc8_table()
    c = 0
    for b in data:
        c = t[c ^ b]
    return int(c)


def crc16(data: bytes) -> int:
    t = _crc16_table()
    c = 0
    for b in data:
        c = int(t[(c >> 8) ^ b]) ^ ((c << 8) & 0xFFFF)
    return c


class BitReaderMSB:
    """MSB-first bit reader over bytes."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, bit_pos: int = 0):
        self.data = data
        self.pos = bit_pos

    def read(self, n: int) -> int:
        v = 0
        pos = self.pos
        data = self.data
        # byte-at-a-time
        while n > 0:
            byte = data[pos >> 3]
            avail = 8 - (pos & 7)
            take = min(avail, n)
            shift = avail - take
            v = (v << take) | ((byte >> shift) & ((1 << take) - 1))
            pos += take
            n -= take
        self.pos = pos
        return v

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >> (n - 1) else v

    def read_unary(self) -> int:
        """Count 0 bits until a 1 (FLAC rice unary part)."""
        n = 0
        while self.read(1) == 0:
            n += 1
            if self.pos >= len(self.data) * 8:
                raise EOFError("unary overrun")
        return n

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    @property
    def bytes_consumed(self) -> int:
        return (self.pos + 7) >> 3


class BitWriterMSB:
    __slots__ = ("_buf", "_acc", "_n")

    def __init__(self):
        self._buf = bytearray()
        self._acc = 0
        self._n = 0

    def write(self, v: int, n: int) -> None:
        if n == 0:
            return
        self._acc = (self._acc << n) | (v & ((1 << n) - 1))
        self._n += n
        while self._n >= 8:
            self._n -= 8
            self._buf.append((self._acc >> self._n) & 0xFF)
        self._acc &= (1 << self._n) - 1

    def write_signed(self, v: int, n: int) -> None:
        self.write(v & ((1 << n) - 1), n)

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self) -> None:
        if self._n:
            self.write(0, 8 - self._n)

    def bytes(self) -> bytes:
        assert self._n == 0
        return bytes(self._buf)


def utf8_code(n: int) -> bytes:
    """FLAC's extended UTF-8 coding of frame numbers."""
    if n < 0x80:
        return bytes([n])
    out = []
    if n < 0x800:
        lead, nbytes = 0xC0, 2
    elif n < 0x10000:
        lead, nbytes = 0xE0, 3
    elif n < 0x200000:
        lead, nbytes = 0xF0, 4
    elif n < 0x4000000:
        lead, nbytes = 0xF8, 5
    else:
        lead, nbytes = 0xFC, 6
    for i in range(nbytes - 1):
        out.append(0x80 | (n & 0x3F))
        n >>= 6
    out.append(lead | n)
    return bytes(reversed(out))


def utf8_decode(br: BitReaderMSB) -> int:
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    nbytes = 0
    mask = 0x80
    while b0 & mask:
        nbytes += 1
        mask >>= 1
    v = b0 & (mask - 1)
    for _ in range(nbytes - 1):
        v = (v << 6) | (br.read(8) & 0x3F)
    return v
