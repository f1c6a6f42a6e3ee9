"""Opus range decoder (RFC 6716 §4.1).

Entropy-coded symbols read forward through the range coder; CELT "raw
bits" read backwards from the end of the frame (§4.1.4) -- both sides
share the total-bits budget. Semantics mirror the reference's
libavcodec/opus/rc.c (ff_opus_rc_*) exactly, including the ^0xFF byte
convention and the zero-extension past the end of the buffer.

A copy of librempeg_tpu/codecs/opus/rc.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

TOP = 1 << 31
BOT = TOP >> 8
M31 = TOP - 1


def _ilog(v: int) -> int:
    return v.bit_length()


class RangeDecoder:
    __slots__ = ("data", "size", "bitpos", "range", "value",
                 "total_bits", "rb_pos", "rb_bytes", "rb_cachelen",
                 "rb_cacheval", "_rawbuf")

    def __init__(self, data: bytes):
        self.data = data
        self.size = len(data)
        self.bitpos = 0
        self.range = 128
        self.value = 127 - self._gb(7)
        self.total_bits = 9
        # raw bits, read backwards from the end
        self.rb_pos = self.size
        self.rb_bytes = self.size
        self.rb_cachelen = 0
        self.rb_cacheval = 0
        self._normalize()

    # -- forward bit source (MSB-first; zeros past the end) ----------
    def _gb(self, n: int) -> int:
        v = 0
        data, size = self.data, self.size
        pos = self.bitpos
        for _ in range(n):
            byte = data[pos >> 3] if (pos >> 3) < size else 0
            v = (v << 1) | ((byte >> (7 - (pos & 7))) & 1)
            pos += 1
        self.bitpos = pos
        return v

    def _normalize(self) -> None:
        while self.range <= BOT:
            self.value = ((self.value << 8)
                          | (self._gb(8) ^ 0xFF)) & M31
            self.range = (self.range << 8) & 0xFFFFFFFF
            self.total_bits += 8

    def _update(self, scale: int, low: int, high: int,
                total: int) -> None:
        self.value -= scale * (total - high)
        self.range = (scale * (high - low) if low
                      else self.range - scale * (total - high))
        self._normalize()

    # -- telling -----------------------------------------------------
    def tell(self) -> int:
        return self.total_bits - _ilog(self.range)

    def tell_frac(self) -> int:
        total_bits = self.total_bits << 3
        rcbuffer = _ilog(self.range)
        rng = self.range >> (rcbuffer - 16)
        for _ in range(3):
            rng = (rng * rng) >> 15
            bit = rng >> 16
            rcbuffer = rcbuffer << 1 | bit
            rng >>= bit
        return total_bits - rcbuffer

    # -- symbol decoders ---------------------------------------------
    def dec_cdf(self, cdf) -> int:
        total = cdf[0]
        scale = self.range // total
        symbol = self.value // scale + 1
        symbol = total - min(symbol, total)
        k = 0
        while cdf[1 + k] <= symbol:
            k += 1
        high = cdf[1 + k]
        low = cdf[k] if k else 0
        self._update(scale, low, high, total)
        return k

    def dec_log(self, bits: int) -> int:
        scale = self.range >> bits
        if self.value >= scale:
            self.value -= scale
            self.range -= scale
            k = 0
        else:
            self.range = scale
            k = 1
        self._normalize()
        return k

    def raw_init(self, buf: bytes) -> None:
        """Re-point the backwards raw-bit reader at a different buffer
        (ff_opus_rc_dec_raw_init role — hybrid frames re-init it over
        the non-redundancy portion)."""
        self._rawbuf = buf
        self.rb_pos = len(buf)
        self.rb_bytes = len(buf)
        self.rb_cachelen = 0
        self.rb_cacheval = 0

    def get_raw(self, count: int) -> int:
        src = getattr(self, "_rawbuf", self.data)
        while self.rb_bytes and self.rb_cachelen < count:
            self.rb_pos -= 1
            self.rb_cacheval |= src[self.rb_pos] << self.rb_cachelen
            self.rb_cachelen += 8
            self.rb_bytes -= 1
        value = self.rb_cacheval & ((1 << count) - 1)
        self.rb_cacheval >>= count
        self.rb_cachelen = max(self.rb_cachelen - count, 0)
        self.total_bits += count
        return value

    def dec_uint(self, size: int) -> int:
        bits = _ilog(size - 1)
        total = ((size - 1) >> (bits - 8)) + 1 if bits > 8 else size
        scale = self.range // total
        k = self.value // scale + 1
        k = total - min(k, total)
        self._update(scale, k, k + 1, total)
        if bits > 8:
            k = k << (bits - 8) | self.get_raw(bits - 8)
            return min(k, size - 1)
        return k

    def dec_uint_step(self, k0: int) -> int:
        total = (k0 + 1) * 3 + k0
        scale = self.range // total
        symbol = self.value // scale + 1
        symbol = total - min(symbol, total)
        k = symbol // 3 if symbol < (k0 + 1) * 3 else symbol - (k0 + 1) * 2
        if k <= k0:
            self._update(scale, 3 * k, 3 * (k + 1), total)
        else:
            self._update(scale, (k - 1 - k0) + 3 * (k0 + 1),
                         (k - k0) + 3 * (k0 + 1), total)
        return k

    def dec_uint_tri(self, qn: int) -> int:
        total = ((qn >> 1) + 1) * ((qn >> 1) + 1)
        scale = self.range // total
        center = self.value // scale + 1
        center = total - min(center, total)
        if center < total >> 1:
            k = (_isqrt(8 * center + 1) - 1) >> 1
            low = k * (k + 1) >> 1
            symbol = k + 1
        else:
            k = (2 * (qn + 1) - _isqrt(8 * (total - center - 1) + 1)) >> 1
            low = total - ((qn + 1 - k) * (qn + 2 - k) >> 1)
            symbol = qn + 1 - k
        self._update(scale, low, low + symbol, total)
        return k

    def dec_laplace(self, symbol: int, decay: int) -> int:
        value = 0
        scale = self.range >> 15
        center = self.value // scale + 1
        center = (1 << 15) - min(center, 1 << 15)
        low = 0
        if center >= symbol:
            value += 1
            low = symbol
            symbol = 1 + (((32768 - 32 - symbol) * (16384 - decay)) >> 15)
            while symbol > 1 and center >= low + 2 * symbol:
                value += 1
                symbol *= 2
                low += symbol
                symbol = (((symbol - 2) * decay) >> 15) + 1
            if symbol <= 1:
                distance = (center - low) >> 1
                value += distance
                low += 2 * distance
            if center < low + symbol:
                value *= -1
            else:
                low += symbol
        self._update(scale, low, min(low + symbol, 32768), 32768)
        return value


def _isqrt(v: int) -> int:
    """Integer sqrt matching the reference's ff_sqrt (floor)."""
    import math

    r = int(math.isqrt(v))
    return r
