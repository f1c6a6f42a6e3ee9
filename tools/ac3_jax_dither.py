"""Run-time repair of the JAX package's AC-3 / E-AC-3 decoder: the dither.

The JAX decoder (librempeg_tpu/codecs/ac3/decoder.py) gives every bap-0
mantissa the value 0. libavcodec's ac3dec.c gives each bap-0 mantissa of
the coupling channel, and of a channel whose dithflag is set (never the
LFE channel), ((av_lfg_get() >> 8) * 181 >> 8) - 5931008 in Q23, from one
generator a decoder (av_lfg_init(&dith_state, 0) when it is made), in
bitstream read order. The port's decoder does the same
(librempeg_tpu_torch/codecs/ac3/decoder.py `LaggedFibonacci`).

`dithered()` fills the noise into the JAX decoder for the duration of a
`with` block, without editing the JAX package: after its own mantissa
pass, each bap-0 bin of a dithered segment is overwritten with the next
draw of `LavuLFG`, a plain transcription of libavutil's lfg.c, scaled
by 2^-23 and the bin's exponent (the decoder's mantissa scale). With it,
the JAX decoder's samples equal the port's float for float.

Used by tests/test_torch_eac3.py and by tools/torch_port_goldens.py
--acodecs (the K8 and K9 goldens).
"""
from __future__ import annotations

import contextlib
import hashlib
import struct

from librempeg_tpu.codecs.ac3 import decoder as JAC3


class LavuLFG:
    """libavutil's av_lfg_init(seed) / av_lfg_get, one value a call."""

    def __init__(self, seed=0):
        self.state, tmp = [0] * 64, bytearray(16)
        for i in range(8, 64, 4):
            tmp[0:4] = struct.pack("<I", seed)
            tmp[4] = i
            tmp = bytearray(hashlib.md5(bytes(tmp)).digest())
            self.state[i:i + 4] = struct.unpack("<4I", bytes(tmp))
        self.index = 0

    def get(self):
        s, i = self.state, self.index
        s[i & 63] = (s[(i - 24) & 63] + s[(i - 55) & 63]) & 0xFFFFFFFF
        self.index += 1
        return s[i & 63]


@contextlib.contextmanager
def dithered():
    plain = JAC3.Ac3FrameDecoder._decode_mantissas_block

    def with_dither(self, br, order):
        plain(self, br, order)
        lfg = self.__dict__.setdefault("_lfg", LavuLFG(0))
        st = self.st
        for ch, out in order:
            if ch == self.lfe_ch or not (ch == 0 or self.dither_flag[ch]):
                continue
            for f in range(st.start_freq[ch], st.end_freq[ch]):
                if st.bap[ch][f] == 0:
                    m = (((lfg.get() >> 8) * 181) >> 8) - 5931008
                    out[f] = m / 2.0 ** 23 * 2.0 ** -float(st.dexps[ch][f])

    JAC3.Ac3FrameDecoder._decode_mantissas_block = with_dither
    try:
        yield
    finally:
        JAC3.Ac3FrameDecoder._decode_mantissas_block = plain
