"""A TrueType reader: the tables the drawtext rasteriser reads.

The JAX package's drawtext reads fonts through fontTools; the port
reads them with `struct` alone, so drawtext and subtitles run where
fontTools is absent. It reads exactly what the rasteriser needs:

- `head`: unitsPerEm and the `loca` offset format;
- `hhea`: ascent, descent and the number of long metrics;
- `hmtx`: each glyph's advance width (a glyph past the long metrics
  takes the last one's);
- `cmap`: the best Unicode subtable, in fontTools' `getBestCmap` order
  ((3, 10), (0, 6), (0, 4), (3, 1), (0, 3), (0, 2), (0, 1), (0, 0)),
  formats 4 and 12;
- `glyf`/`loca`: simple glyphs (absolute coordinates, flags and contour
  ends, as fontTools' `getCoordinates` gives them) and composites (the
  component glyph ids and their x/y offsets; scales are read past, as
  the rasteriser uses the offsets only).

Glyphs are addressed by id (0 is .notdef) where fontTools uses names.
"""
from __future__ import annotations

import functools
import struct

# composite glyph component flags (the TrueType glyf table)
_ARG_1_AND_2_ARE_WORDS = 0x0001
_ARGS_ARE_XY_VALUES = 0x0002
_WE_HAVE_A_SCALE = 0x0008
_MORE_COMPONENTS = 0x0020
_WE_HAVE_AN_X_AND_Y_SCALE = 0x0040
_WE_HAVE_A_TWO_BY_TWO = 0x0080

# simple glyph point flags
_ON_CURVE = 0x01
_X_SHORT = 0x02
_Y_SHORT = 0x04
_REPEAT = 0x08
_X_SAME_OR_POSITIVE = 0x10
_Y_SAME_OR_POSITIVE = 0x20

_CMAP_ORDER = ((3, 10), (0, 6), (0, 4), (3, 1), (0, 3), (0, 2), (0, 1),
               (0, 0))


class Glyph:
    """One glyph of the glyf table.

    number_of_contours > 0: a simple glyph with `coords` [(x, y)],
    `flags` (bit 0 on-curve) and `end_pts`; -1: a composite with
    `components` [(glyph id, dx, dy)]; 0: empty."""

    def __init__(self, number_of_contours: int, coords=(), flags=(),
                 end_pts=(), components=()):
        self.number_of_contours = number_of_contours
        self.coords = list(coords)
        self.flags = list(flags)
        self.end_pts = list(end_pts)
        self.components = list(components)

    def is_composite(self) -> bool:
        return self.number_of_contours == -1


class TrueTypeFont:
    """The tables of one .ttf file that drawtext reads."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self._data = data = f.read()
        if len(data) < 12:
            raise ValueError(f"{path}: not a TrueType font")
        tag = data[:4]
        if tag not in (b"\x00\x01\x00\x00", b"true"):
            raise ValueError(f"{path}: not a TrueType font ({tag!r})")
        (num_tables,) = struct.unpack_from(">H", data, 4)
        self._tables = {}
        for i in range(num_tables):
            t, _csum, off, length = struct.unpack_from(">4sIII", data,
                                                       12 + 16 * i)
            self._tables[t.decode("latin-1")] = (off, length)
        for t in ("head", "hhea", "hmtx", "maxp", "cmap", "loca", "glyf"):
            if t not in self._tables:
                raise ValueError(f"{path}: no {t} table")
        head = self._table("head")
        self.units_per_em = struct.unpack_from(">H", head, 18)[0]
        loc_format = struct.unpack_from(">h", head, 50)[0]
        hhea = self._table("hhea")
        self.ascent, self.descent = struct.unpack_from(">hh", hhea, 4)
        n_hmetrics = struct.unpack_from(">H", hhea, 34)[0]
        self.num_glyphs = struct.unpack_from(">H", self._table("maxp"), 4)[0]
        hmtx = self._table("hmtx")
        adv = [struct.unpack_from(">H", hmtx, 4 * i)[0]
               for i in range(n_hmetrics)]
        self.advances = adv + [adv[-1]] * (self.num_glyphs - n_hmetrics)
        loca = self._table("loca")
        n = self.num_glyphs + 1
        if loc_format == 0:
            self._loca = [2 * v for v in struct.unpack_from(f">{n}H", loca)]
        else:
            self._loca = list(struct.unpack_from(f">{n}I", loca))
        self.cmap = self._best_cmap()

    def _table(self, tag: str) -> bytes:
        off, length = self._tables[tag]
        return self._data[off:off + length]

    # -- cmap -----------------------------------------------------------
    def _best_cmap(self) -> dict[int, int]:
        cmap = self._table("cmap")
        n = struct.unpack_from(">H", cmap, 2)[0]
        subs = {}
        for i in range(n):
            pid, eid, off = struct.unpack_from(">HHI", cmap, 4 + 8 * i)
            subs.setdefault((pid, eid), off)
        for key in _CMAP_ORDER:
            off = subs.get(key)
            if off is None:
                continue
            fmt = struct.unpack_from(">H", cmap, off)[0]
            if fmt == 4:
                return _cmap_format4(cmap, off)
            if fmt == 12:
                return _cmap_format12(cmap, off)
        return {}

    def glyph_id(self, ch: str) -> int:
        """The glyph of a character; 0 (.notdef) where the cmap has
        none."""
        return self.cmap.get(ord(ch), 0)

    # -- glyf -----------------------------------------------------------
    @functools.lru_cache(maxsize=None)
    def glyph(self, gid: int) -> Glyph:
        start, end = self._loca[gid], self._loca[gid + 1]
        if end <= start:
            return Glyph(0)
        off, _ = self._tables["glyf"]
        d = self._data
        pos = off + start
        (nc,) = struct.unpack_from(">h", d, pos)
        pos += 10                                   # contours + bbox
        if nc < 0:
            return Glyph(-1, components=_components(d, pos))
        end_pts = list(struct.unpack_from(f">{nc}H", d, pos))
        pos += 2 * nc
        (ilen,) = struct.unpack_from(">H", d, pos)
        pos += 2 + ilen
        npts = end_pts[-1] + 1 if nc else 0
        flags = []
        while len(flags) < npts:
            f = d[pos]
            pos += 1
            flags.append(f)
            if f & _REPEAT:
                flags.extend([f] * d[pos])
                pos += 1
        flags = flags[:npts]
        xs, pos = _deltas(d, pos, flags, _X_SHORT, _X_SAME_OR_POSITIVE)
        ys, pos = _deltas(d, pos, flags, _Y_SHORT, _Y_SAME_OR_POSITIVE)
        return Glyph(nc, coords=list(zip(xs, ys)),
                     flags=[f & _ON_CURVE for f in flags], end_pts=end_pts)


def _deltas(d: bytes, pos: int, flags, short: int, same_or_pos: int):
    """One axis of a simple glyph's points: delta-coded, returned as
    absolute coordinates."""
    out, v = [], 0
    for f in flags:
        if f & short:
            dv = d[pos]
            pos += 1
            v += dv if f & same_or_pos else -dv
        elif not f & same_or_pos:
            (dv,) = struct.unpack_from(">h", d, pos)
            pos += 2
            v += dv
        out.append(v)
    return out, pos


def _components(d: bytes, pos: int) -> list[tuple[int, int, int]]:
    """A composite glyph's (glyph id, dx, dy) components; point-matched
    components (no x/y offsets) are kept with offsets 0."""
    comps = []
    while True:
        flags, gid = struct.unpack_from(">HH", d, pos)
        pos += 4
        if flags & _ARG_1_AND_2_ARE_WORDS:
            fmt = ">hh" if flags & _ARGS_ARE_XY_VALUES else ">HH"
            a1, a2 = struct.unpack_from(fmt, d, pos)
            pos += 4
        else:
            fmt = ">bb" if flags & _ARGS_ARE_XY_VALUES else ">BB"
            a1, a2 = struct.unpack_from(fmt, d, pos)
            pos += 2
        if not flags & _ARGS_ARE_XY_VALUES:
            a1 = a2 = 0
        if flags & _WE_HAVE_A_SCALE:
            pos += 2
        elif flags & _WE_HAVE_AN_X_AND_Y_SCALE:
            pos += 4
        elif flags & _WE_HAVE_A_TWO_BY_TWO:
            pos += 8
        comps.append((gid, a1, a2))
        if not flags & _MORE_COMPONENTS:
            return comps


def _cmap_format4(cmap: bytes, off: int) -> dict[int, int]:
    seg2 = struct.unpack_from(">H", cmap, off + 6)[0]
    n = seg2 // 2
    ends = struct.unpack_from(f">{n}H", cmap, off + 14)
    starts = struct.unpack_from(f">{n}H", cmap, off + 16 + seg2)
    deltas = struct.unpack_from(f">{n}h", cmap, off + 16 + 2 * seg2)
    ro_pos = off + 16 + 3 * seg2
    ranges = struct.unpack_from(f">{n}H", cmap, ro_pos)
    out = {}
    for i in range(n):
        for c in range(starts[i], ends[i] + 1):
            if c == 0xFFFF:
                continue
            if ranges[i] == 0:
                g = (c + deltas[i]) & 0xFFFF
            else:
                at = ro_pos + 2 * i + ranges[i] + 2 * (c - starts[i])
                g = struct.unpack_from(">H", cmap, at)[0]
                if g:
                    g = (g + deltas[i]) & 0xFFFF
            if g:
                out[c] = g
    return out


def _cmap_format12(cmap: bytes, off: int) -> dict[int, int]:
    n = struct.unpack_from(">I", cmap, off + 12)[0]
    out = {}
    for i in range(n):
        s, e, g = struct.unpack_from(">III", cmap, off + 16 + 12 * i)
        for c in range(s, e + 1):
            out[c] = g + c - s
    return out


@functools.lru_cache(maxsize=4)
def load(path: str) -> TrueTypeFont:
    return TrueTypeFont(path)
