"""Hash/CRC facade (libavutil/hash.c + crc.c analog).

One entry point over every digest the framework uses: the codec CRCs
(FLAC's CRC-8/16, MPEG-2 TS's CRC-32), the FATE digests (av_adler32 =
adler32 with init 0, md5), and the standard library's SHA family. The
reference reimplements these in C tables; here the table-driven ones
live next to their codecs and this module is the registry.

A copy of librempeg_tpu/core/hash.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

import hashlib
import zlib


def adler32(data: bytes, value: int = 0) -> int:
    """av_adler32_update semantics: init 0 (NOT zlib's standard 1)."""
    return zlib.adler32(bytes(data), value) & 0xFFFFFFFF


def crc32(data: bytes, value: int = 0) -> int:
    """IEEE CRC-32 (zlib polynomial, reflected)."""
    return zlib.crc32(bytes(data), value) & 0xFFFFFFFF


def crc32_mpeg2(data: bytes) -> int:
    """CRC-32/MPEG-2 (poly 0x04C11DB7, no reflection, init all-ones)."""
    from librempeg_tpu_torch.formats.mpegts import _crc32_mpeg

    return _crc32_mpeg(bytes(data))


def crc8_flac(data: bytes) -> int:
    """CRC-8 poly 0x07 (FLAC frame headers)."""
    from librempeg_tpu_torch.codecs.flac.bitio import crc8

    return crc8(bytes(data))


def crc16_flac(data: bytes) -> int:
    """CRC-16 poly 0x8005 (FLAC frames)."""
    from librempeg_tpu_torch.codecs.flac.bitio import crc16

    return crc16(bytes(data))


_HASHES = {"md5": hashlib.md5, "sha1": hashlib.sha1,
           "sha224": hashlib.sha224, "sha256": hashlib.sha256,
           "sha384": hashlib.sha384, "sha512": hashlib.sha512}


class Hasher:
    """av_hash API shape: create by name, update, hexdigest."""

    NAMES = tuple(_HASHES) + ("adler32", "crc32", "crc32_mpeg2")

    def __init__(self, name: str):
        name = name.lower()
        if name in _HASHES:
            self._h = _HASHES[name]()
            self._crc = None
        elif name == "adler32":
            self._h = None
            self._crc, self._fn = 0, adler32
        elif name == "crc32":
            self._h = None
            self._crc, self._fn = 0, crc32
        elif name == "crc32_mpeg2":
            self._h = None
            self._buf = bytearray()
            self._crc, self._fn = None, None
        else:
            raise ValueError(f"unknown hash {name!r}")
        self.name = name

    def update(self, data: bytes) -> "Hasher":
        if self._h is not None:
            self._h.update(bytes(data))
        elif self.name == "crc32_mpeg2":
            self._buf += bytes(data)
        else:
            self._crc = self._fn(data, self._crc)
        return self

    def hexdigest(self) -> str:
        if self._h is not None:
            return self._h.hexdigest()
        if self.name == "crc32_mpeg2":
            return f"{crc32_mpeg2(bytes(self._buf)):08x}"
        return f"{self._crc:08x}"
