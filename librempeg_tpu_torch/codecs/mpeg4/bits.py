"""Bit writer for host-side VLC packing.

Analog of the reference's put_bits.h. Accumulates into a Python int in
word-sized chunks — adequate for header+MB assembly; bulk coefficient
packing migrates to the C++ layer when profiling demands.
"""
from __future__ import annotations


class BitWriter:
    __slots__ = ("_buf", "_acc", "_nbits")

    def __init__(self):
        self._buf = bytearray()
        self._acc = 0
        self._nbits = 0

    def put(self, value: int, bits: int) -> None:
        if bits == 0:
            return
        self._acc = (self._acc << bits) | (value & ((1 << bits) - 1))
        self._nbits += bits
        while self._nbits >= 8:
            self._nbits -= 8
            self._buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def put_signed(self, value: int, bits: int) -> None:
        self.put(value & ((1 << bits) - 1), bits)

    def align(self, pad_bit: int = 0) -> None:
        """Byte-align; MPEG-4 stuffing is '0111...1' but plain zero/one
        padding is selectable."""
        if self._nbits:
            n = 8 - self._nbits
            self.put((1 << n) - 1 if pad_bit else 0, n)

    def align_stuffing(self) -> None:
        """MPEG-4 next_start_code() stuffing: one 0 then 1s to alignment;
        if already aligned, a full '01111111' byte."""
        n = 8 - self._nbits if self._nbits else 8
        self.put(0, 1)
        if n > 1:
            self.put((1 << (n - 1)) - 1, n - 1)

    @property
    def bit_count(self) -> int:
        return len(self._buf) * 8 + self._nbits

    def bytes(self) -> bytes:
        assert self._nbits == 0, "unaligned bitstream"
        return bytes(self._buf)
