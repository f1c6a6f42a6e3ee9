"""HEVC CABAC: arithmetic engine (decode + encode) and context state.

The binary arithmetic coder is the H.264 engine (ITU-T H.265 §9.3.4.3
uses the identical range-update tables); context initialization uses
the HEVC initValue formula (§9.3.2.2). The encoder is the exact
inverse of the decoder and powers the conformance stream generator —
the same bootstrap the H.264 CABAC layer used (our encode, reference
decode, our decode, all three bit-equal).

Behavioral reference: libavcodec/hevc/cabac.c (context
layout), libavcodec/cabac.c (engine).

A copy of librempeg_tpu/codecs/hevc/cabac.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

from librempeg_tpu_torch.codecs.hevc import tables as T


def init_states(init_type: int, qp: int) -> tuple[bytearray, bytearray]:
    """(pStateIdx[], valMps[]) per §9.3.2.2."""
    states = bytearray(T.N_CTX)
    mps = bytearray(T.N_CTX)
    qp = max(0, min(51, qp))
    for i, iv in enumerate(T.INIT_VALUES[init_type]):
        slope = (iv >> 4) * 5 - 45
        offset = ((iv & 15) << 3) - 16
        pre = min(126, max(1, ((slope * qp) >> 4) + offset))
        if pre <= 63:
            states[i] = 63 - pre
            mps[i] = 0
        else:
            states[i] = pre - 64
            mps[i] = 1
    return states, mps


class CabacDecoder:
    """§9.3.4.3 arithmetic decoder over a byte string."""

    def __init__(self, data: bytes, pos_bits: int, init_type: int,
                 qp: int):
        self.d = data
        self.pos = pos_bits
        self.n = len(data) * 8
        self.states, self.mps = init_states(init_type, qp)
        # initialization: 9 bits value
        self.range = 510
        self.value = self._bits(9)
        self.error = False

    def _bit(self) -> int:
        if self.pos >= self.n:
            self.error = True
            return 0
        b = (self.d[self.pos >> 3] >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return b

    def _bits(self, k: int) -> int:
        v = 0
        for _ in range(k):
            v = (v << 1) | self._bit()
        return v

    def decision(self, ctx: int) -> int:
        st = self.states[ctx]
        lps = T.LPS_RANGE[4 * st + ((self.range >> 6) & 3)]
        self.range -= lps
        if self.value < self.range:
            bit = self.mps[ctx]
            if st < 62:
                self.states[ctx] = st + 1
        else:
            self.value -= self.range
            self.range = lps
            bit = 1 - self.mps[ctx]
            if st == 0:
                self.mps[ctx] ^= 1
            self.states[ctx] = T.TRANS_LPS[st]
        while self.range < 256:
            self.range <<= 1
            self.value = (self.value << 1) | self._bit()
        return bit

    def bypass(self) -> int:
        self.value = (self.value << 1) | self._bit()
        if self.value >= self.range:
            self.value -= self.range
            return 1
        return 0

    def bypass_bits(self, k: int) -> int:
        v = 0
        for _ in range(k):
            v = (v << 1) | self.bypass()
        return v

    def terminate(self) -> int:
        self.range -= 2
        if self.value < self.range:
            while self.range < 256:
                self.range <<= 1
                self.value = (self.value << 1) | self._bit()
            return 0
        return 1


class CabacEncoder:
    """Exact inverse of CabacDecoder (mirrors the proven native
    CabEnc: low/outstanding putbit renormalization, §9.3.4.4-9.3.4.6).
    """

    def __init__(self, init_type: int, qp: int):
        self.states, self.mps = init_states(init_type, qp)
        self.low = 0
        self.range = 510
        self.outstanding = 0
        self.first = True
        self._acc = 0
        self._nbits = 0
        self.out = bytearray()

    def _rawbit(self, b: int) -> None:
        self._acc = (self._acc << 1) | b
        self._nbits += 1
        if self._nbits == 8:
            self.out.append(self._acc & 0xFF)
            self._acc = 0
            self._nbits = 0

    def _putbit(self, b: int) -> None:
        if self.first:
            self.first = False
        else:
            self._rawbit(b)
        while self.outstanding > 0:
            self._rawbit(1 - b)
            self.outstanding -= 1

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low < 256:
                self._putbit(0)
            elif self.low >= 512:
                self.low -= 512
                self._putbit(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.low <<= 1
            self.range <<= 1

    def encode_decision(self, ctx: int, bit: int) -> None:
        st = self.states[ctx]
        lps = T.LPS_RANGE[4 * st + ((self.range >> 6) & 3)]
        self.range -= lps
        if bit != self.mps[ctx]:
            self.low += self.range
            self.range = lps
            if st == 0:
                self.mps[ctx] ^= 1
            self.states[ctx] = T.TRANS_LPS[st]
        else:
            if st < 62:
                self.states[ctx] = st + 1
        self._renorm()

    def encode_bypass(self, bit: int) -> None:
        self.low <<= 1
        if bit:
            self.low += self.range
        if self.low >= 1024:
            self._putbit(1)
            self.low -= 1024
        elif self.low < 512:
            self._putbit(0)
        else:
            self.outstanding += 1
            self.low -= 512

    def encode_bypass_bits(self, v: int, k: int) -> None:
        for i in range(k - 1, -1, -1):
            self.encode_bypass((v >> i) & 1)

    def encode_terminate(self, bit: int) -> None:
        self.range -= 2
        if bit:
            self.low += self.range
            self.range = 2
            self._renorm()
            # EncodeFlush (§9.3.4.6) + rbsp stop + byte align
            self._putbit((self.low >> 9) & 1)
            self._rawbit((self.low >> 8) & 1)
            self._rawbit(1)
            while self._nbits:
                self._rawbit(0)
        else:
            self._renorm()

    def bytes(self) -> bytes:
        return bytes(self.out)
