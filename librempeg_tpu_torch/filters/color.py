"""Colour-management filters: lut3d, lut1d, colorspace.

Port of librempeg_tpu/filters/color.py (vf_lut3d.c, vf_colorspace.c,
libswscale/csputils.c roles): the .cube parser and the matrix, transfer
and primaries tables are host code carried over; the per-pixel work is
plain tensor code on the frame's device. The JAX package runs these
filters as eager jnp calls, each rounding its result, and the port does
the same operations in the same order in float32.

The K = 3 colour products ([..., 3] x [3, 3]) take the order of the JAX
package's eager matmul on the CPU (tests/test_torch_filters2.py reads it
off the JAX package): output columns 0 and 1 sum the three rounded
products left to right, column 2 is a chain of fused multiply-adds,
fma(a2, m2, fma(a1, m1, a0 * m0)), each computed as a float64 sum
rounded once to float32. Nothing here goes through a GEMM, so TF32
cannot enter. Divisions by a constant go through ops.fdiv (a
correctly rounded division on the card too).

The transfer functions' powers are the one inexact part: XLA's CPU
code computes x ** y with its own approximation, which matches neither
libm's powf nor PyTorch's. The port raises in float64 and rounds once
to float32 (_pow), so the card and the CPU give the same samples; that
is the correctly rounded power, which XLA's differs from by one ulp on
about 0.07% of inputs (tests/test_torch_filters2.py holds colorspace to
the scaler's float contract: at most 0.1% of samples differ, by 1).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from librempeg_tpu_torch.core.errors import InvalidData
from librempeg_tpu_torch.core.options import Option, OptionTable
from librempeg_tpu_torch.filters.filter import Filter, register_filter
from librempeg_tpu_torch.filters.video2 import _fma
from librempeg_tpu_torch.ops.fdiv import fdiv

# ---------------------------------------------------------------------------
# .cube parsing (Adobe/Resolve format, vf_lut3d.c parse_cube role)
# ---------------------------------------------------------------------------


def parse_cube(path: str):
    """Returns (table, domain_min, domain_max). 3D tables come back as
    [N, N, N, 3] float32 indexed [b][g][r] (fastest-varying r, per the
    cube spec), 1D as [N, 3]."""
    size3 = size1 = None
    dmin = np.zeros(3, np.float32)
    dmax = np.ones(3, np.float32)
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            key = tok[0].upper()
            if key == "LUT_3D_SIZE":
                size3 = int(tok[1])
            elif key == "LUT_1D_SIZE":
                size1 = int(tok[1])
            elif key == "DOMAIN_MIN":
                dmin = np.array(tok[1:4], np.float32)
            elif key == "DOMAIN_MAX":
                dmax = np.array(tok[1:4], np.float32)
            elif key == "TITLE":
                continue
            else:
                try:
                    rows.append([float(t) for t in tok[:3]])
                except ValueError:
                    continue
    if size3 is not None:
        if len(rows) < size3 ** 3:
            raise InvalidData(f"cube: expected {size3 ** 3} entries, "
                              f"got {len(rows)}")
        t = np.array(rows[:size3 ** 3], np.float32)
        return t.reshape(size3, size3, size3, 3), dmin, dmax
    if size1 is not None:
        if len(rows) < size1:
            raise InvalidData("cube: short 1D table")
        return np.array(rows[:size1], np.float32), dmin, dmax
    raise InvalidData("cube: no LUT_3D_SIZE/LUT_1D_SIZE")


def _domain(x: torch.Tensor, dmin, dmax, n: int) -> torch.Tensor:
    """(x - dmin) / max(dmax - dmin, 1e-9) * (n - 1), clipped to
    [0, n - 1], in float32 with the domain vectors on x's device."""
    lo = torch.from_numpy(np.asarray(dmin, np.float32)).to(x.device)
    span = torch.from_numpy(np.maximum(
        np.asarray(dmax, np.float32) - np.asarray(dmin, np.float32),
        np.float32(1e-9)).astype(np.float32)).to(x.device)
    return ((x - lo) / span * float(n - 1)).clamp(0.0, float(n - 1))


def apply_lut3d(rgb: torch.Tensor, table, dmin, dmax,
                interp: str = "tetrahedral") -> torch.Tensor:
    """rgb [..., 3] float32 in [0, 1] -> mapped [..., 3]; table
    [N, N, N, 3] indexed [b][g][r]."""
    n = table.shape[0]
    t = torch.as_tensor(np.asarray(table, np.float32)).to(rgb.device)
    x = _domain(rgb, dmin, dmax, n)
    if interp == "nearest":
        i = torch.round(x).long()
        return t[i[..., 2], i[..., 1], i[..., 0]]
    i0 = torch.clamp(torch.floor(x).long(), max=n - 2)
    f = x - i0.to(torch.float32)
    r0, g0, b0 = i0[..., 0], i0[..., 1], i0[..., 2]
    fr, fg, fb = f[..., 0:1], f[..., 1:2], f[..., 2:3]

    def at(dr, dg, db):
        return t[b0 + db, g0 + dg, r0 + dr]

    if interp == "trilinear":
        c00 = at(0, 0, 0) * (1 - fr) + at(1, 0, 0) * fr
        c10 = at(0, 1, 0) * (1 - fr) + at(1, 1, 0) * fr
        c01 = at(0, 0, 1) * (1 - fr) + at(1, 0, 1) * fr
        c11 = at(0, 1, 1) * (1 - fr) + at(1, 1, 1) * fr
        c0 = c00 * (1 - fg) + c10 * fg
        c1 = c01 * (1 - fg) + c11 * fg
        return c0 * (1 - fb) + c1 * fb
    # tetrahedral (vf_lut3d.c interp_tetrahedral): the tetrahedron of the
    # unit cube holding (fr, fg, fb), picked by ordering the fractions
    c000, c111 = at(0, 0, 0), at(1, 1, 1)
    c100, c010, c001 = at(1, 0, 0), at(0, 1, 0), at(0, 0, 1)
    c110, c101, c011 = at(1, 1, 0), at(1, 0, 1), at(0, 1, 1)

    def lerp3(w0, wa, wb, ca, cb):
        return c000 * (1 - w0) + ca * (w0 - wa) + cb * (wa - wb) \
            + c111 * wb

    rg = fr >= fg
    gb = fg >= fb
    rb = fr >= fb
    return torch.where(
        rg & gb, lerp3(fr, fg, fb, c100, c110),
        torch.where(
            rg & rb, lerp3(fr, fb, fg, c100, c101),
            torch.where(
                rg, lerp3(fb, fr, fg, c001, c101),
                torch.where(
                    (~rg) & (~gb), lerp3(fb, fg, fr, c001, c011),
                    torch.where(
                        rb, lerp3(fg, fr, fb, c010, c110),
                        lerp3(fg, fb, fr, c010, c011))))))


def _to_rgb_unit(frame) -> torch.Tensor:
    return fdiv(torch.as_tensor(frame.planes[0]).to(torch.float32), 255.0)


def _quant(a: torch.Tensor) -> torch.Tensor:
    return torch.floor(a + 0.5).clamp(0, 255).to(torch.uint8)


@register_filter
class Lut3dFilter(Filter):
    NAME = "lut3d"
    DESCRIPTION = "Apply a 3D LUT (.cube) to an RGB stream."
    OPT_ORDER = ("file", "interp")
    OPTIONS = OptionTable(
        Option("file", str, "", alias="f"),
        Option("interp", str, "tetrahedral",
               choices=("nearest", "trilinear", "tetrahedral")),
    )
    _FORMATS = ("rgb24",)

    def in_formats(self, pad: int = 0):
        return self._FORMATS

    def configure(self, in_props):
        if not self.opts["file"]:
            raise InvalidData("lut3d: 'file' option required")
        table, dmin, dmax = parse_cube(self.opts["file"])
        if table.ndim != 4:
            raise InvalidData("lut3d: file holds a 1D LUT (use lut1d)")
        self._table, self._dmin, self._dmax = table, dmin, dmax
        return super().configure(in_props)

    def filter_frame(self, frame, pad=0):
        out = apply_lut3d(_to_rgb_unit(frame), self._table, self._dmin,
                          self._dmax, self.opts["interp"])
        return [(0, frame.replace(planes=(_quant(out * 255.0),)))]


@register_filter
class Lut1dFilter(Filter):
    NAME = "lut1d"
    DESCRIPTION = "Apply a 1D LUT (.cube) per RGB channel."
    OPT_ORDER = ("file", "interp")
    OPTIONS = OptionTable(
        Option("file", str, "", alias="f"),
        Option("interp", str, "linear", choices=("nearest", "linear")),
    )
    _FORMATS = ("rgb24",)

    def in_formats(self, pad: int = 0):
        return self._FORMATS

    def configure(self, in_props):
        if not self.opts["file"]:
            raise InvalidData("lut1d: 'file' option required")
        table, dmin, dmax = parse_cube(self.opts["file"])
        if table.ndim != 2:
            raise InvalidData("lut1d: file holds a 3D LUT (use lut3d)")
        self._table, self._dmin, self._dmax = table, dmin, dmax
        return super().configure(in_props)

    def filter_frame(self, frame, pad=0):
        rgb = _to_rgb_unit(frame)
        t = torch.from_numpy(self._table).to(rgb.device)          # [N, 3]
        n = t.shape[0]
        x = _domain(rgb, self._dmin, self._dmax, n)
        ch = torch.arange(3, device=rgb.device)[None, None, :]
        if self.opts["interp"] == "nearest":
            out = t[torch.round(x).long(), ch]
        else:
            i0 = torch.clamp(torch.floor(x).long(), max=n - 2)
            f = x - i0.to(torch.float32)
            out = t[i0, ch] * (1 - f) + t[i0 + 1, ch] * f
        return [(0, frame.replace(planes=(_quant(out * 255.0),)))]


# ---------------------------------------------------------------------------
# colorspace conversion (vf_colorspace.c / libswscale csputils.c roles)
# ---------------------------------------------------------------------------

# CIE xy chromaticities (R, G, B) -- csputils.c primaries tables
_PRIMARIES = {
    "bt709": ((0.640, 0.330), (0.300, 0.600), (0.150, 0.060)),
    "smpte170m": ((0.630, 0.340), (0.310, 0.595), (0.155, 0.070)),
    "bt470bg": ((0.640, 0.330), (0.290, 0.600), (0.150, 0.060)),
    "bt2020": ((0.708, 0.292), (0.170, 0.797), (0.131, 0.046)),
}
_WHITE_D65 = (0.3127, 0.3290)

# luma coefficients (kr, kb) per matrix
_MATRIX_KRKB = {
    "bt709": (0.2126, 0.0722),
    "smpte170m": (0.299, 0.114),
    "bt470bg": (0.299, 0.114),
    "bt601": (0.299, 0.114),
    "bt2020": (0.2627, 0.0593),
    "bt2020nc": (0.2627, 0.0593),
}

_ALIAS = {"bt601-6-525": "smpte170m", "bt601-6-625": "bt470bg",
          "bt2020-10": "bt2020", "bt2020-12": "bt2020",
          "iec61966-2-1": "srgb", "601": "smpte170m", "709": "bt709",
          "2020": "bt2020"}


def _norm(name: str) -> str:
    return _ALIAS.get(name, name)


def _xy_to_xyz(x, y):
    return np.array([x / y, 1.0, (1 - x - y) / y])


@functools.lru_cache(maxsize=None)
def rgb_to_xyz_matrix(primaries: str) -> np.ndarray:
    """[3,3] linear-RGB -> XYZ for the primary set (white = D65)."""
    prims = _PRIMARIES[_norm(primaries)]
    m = np.stack([_xy_to_xyz(*p) for p in prims], axis=1)
    w = _xy_to_xyz(*_WHITE_D65)
    s = np.linalg.solve(m, w)
    return m * s[None, :]


@functools.lru_cache(maxsize=None)
def primaries_matrix(src: str, dst: str) -> np.ndarray:
    """Linear-RGB src-primaries -> dst-primaries (both D65, so no
    chromatic adaptation needed)."""
    a = rgb_to_xyz_matrix(src)
    b = rgb_to_xyz_matrix(dst)
    return np.linalg.solve(b, a)


# transfer characteristics: (to_linear, from_linear)
_BT709_ALPHA = 1.099296826809442
_BT709_BETA = 0.018053968510807


def _pow(x: torch.Tensor, e: float) -> torch.Tensor:
    """x ** e for float32 x and the float32 exponent e, raised in
    float64 and rounded once (see the module docstring)."""
    return (x.to(torch.float64) ** float(np.float32(e))).to(torch.float32)


def _bt709_to_lin(v):
    return torch.where(v < 4.5 * _BT709_BETA, fdiv(v, 4.5),
                       _pow(fdiv(v + (_BT709_ALPHA - 1), _BT709_ALPHA),
                            1 / 0.45))


def _bt709_from_lin(lin):
    return torch.where(lin < _BT709_BETA, 4.5 * lin,
                       _BT709_ALPHA * _pow(torch.clamp(lin, min=1e-9), 0.45)
                       - (_BT709_ALPHA - 1))


def _srgb_to_lin(v):
    return torch.where(v <= 0.04045, fdiv(v, 12.92),
                       _pow(fdiv(v + 0.055, 1.055), 2.4))


def _srgb_from_lin(lin):
    return torch.where(lin <= 0.0031308, 12.92 * lin,
                       1.055 * _pow(torch.clamp(lin, min=1e-9), 1 / 2.4)
                       - 0.055)


_TRC = {
    "bt709": (_bt709_to_lin, _bt709_from_lin),
    "smpte170m": (_bt709_to_lin, _bt709_from_lin),
    "bt470bg": (_bt709_to_lin, _bt709_from_lin),
    "bt2020": (_bt709_to_lin, _bt709_from_lin),
    "srgb": (_srgb_to_lin, _srgb_from_lin),
    "linear": (lambda v: v, lambda v: v),
}


def _yuv_matrices(matrix: str):
    kr, kb = _MATRIX_KRKB[_norm(matrix)]
    kg = 1.0 - kr - kb
    enc = np.array([
        [kr, kg, kb],
        [-kr / (2 * (1 - kb)), -kg / (2 * (1 - kb)), 0.5],
        [0.5, -kg / (2 * (1 - kr)), -kb / (2 * (1 - kr))],
    ])
    return np.linalg.inv(enc), enc            # (decode, encode)


def mat3(a: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """a [..., 3] @ m [3, 3] in float32, in the JAX package's order (see
    the module docstring)."""
    m = np.asarray(m, np.float32)
    t = [[a[..., k] * float(m[k, j]) for k in range(3)] for j in range(2)]
    c2 = _fma(a[..., 2], float(m[2, 2]), _fma(
        a[..., 1], float(m[1, 2]), a[..., 0] * float(m[0, 2])))
    return torch.stack([t[0][0] + t[0][1] + t[0][2],
                        t[1][0] + t[1][1] + t[1][2], c2], -1)


@register_filter
class ColorspaceFilter(Filter):
    NAME = "colorspace"
    DESCRIPTION = "Convert between colorspaces (matrix/transfer/" \
        "primaries)."
    OPT_ORDER = ("all",)
    OPTIONS = OptionTable(
        Option("all", str, ""),
        Option("space", str, ""),
        Option("trc", str, ""),
        Option("primaries", str, ""),
        Option("range", str, "tv", choices=("tv", "pc", "mpeg",
                                            "jpeg")),
        Option("ispace", str, "bt709"),
        Option("itrc", str, "bt709"),
        Option("iprimaries", str, "bt709"),
        Option("irange", str, "tv", choices=("tv", "pc", "mpeg",
                                             "jpeg")),
    )
    _FORMATS = ("yuv444p", "yuv420p")

    # presets for all= (vf_colorspace.c all option)
    _ALL = {
        "bt709": ("bt709", "bt709", "bt709"),
        "bt601-6-525": ("smpte170m", "smpte170m", "smpte170m"),
        "bt601-6-625": ("bt470bg", "smpte170m", "bt470bg"),
        "smpte170m": ("smpte170m", "smpte170m", "smpte170m"),
        "bt2020": ("bt2020", "bt2020", "bt2020"),
    }

    def in_formats(self, pad: int = 0):
        return self._FORMATS

    def configure(self, in_props):
        o = self.opts
        space, trc, prim = o["space"], o["trc"], o["primaries"]
        if o["all"]:
            d = self._ALL.get(o["all"])
            if d is None:
                raise InvalidData(f"colorspace: unknown all={o['all']}")
            space, trc, prim = (space or d[0], trc or d[1],
                                prim or d[2])
        if not (space and trc and prim):
            raise InvalidData("colorspace: need all= or "
                              "space/trc/primaries")
        for nm in (space, o["ispace"]):
            if _norm(nm) not in _MATRIX_KRKB:
                raise InvalidData(f"colorspace: unknown space {nm}")
        for nm in (trc, o["itrc"]):
            if _norm(nm) not in _TRC:
                raise InvalidData(f"colorspace: unknown trc {nm}")
        for nm in (prim, o["iprimaries"]):
            if _norm(nm) not in _PRIMARIES:
                raise InvalidData(f"colorspace: unknown primaries "
                                  f"{nm}")
        # the matrices as the JAX package applies them: transposed,
        # rounded to float32
        self._dec = _yuv_matrices(o["ispace"])[0].T
        self._enc = _yuv_matrices(space)[1].T
        self._to_lin = _TRC[_norm(o["itrc"])][0]
        self._from_lin = _TRC[_norm(trc)][1]
        self._prim = primaries_matrix(o["iprimaries"], prim).T
        self._same_prim = _norm(o["iprimaries"]) == _norm(prim)
        self._ifull = o["irange"] in ("pc", "jpeg")
        self._ofull = o["range"] in ("pc", "jpeg")
        return super().configure(in_props)

    def filter_frame(self, frame, pad=0):
        y, u, v = (torch.as_tensor(p).to(torch.float32)
                   for p in frame.planes[:3])
        sub = frame.format == "yuv420p"
        if sub:
            u = u.repeat_interleave(2, 0).repeat_interleave(2, 1)[
                :y.shape[0], :y.shape[1]]
            v = v.repeat_interleave(2, 0).repeat_interleave(2, 1)[
                :y.shape[0], :y.shape[1]]
        if self._ifull:
            yn = fdiv(y, 255.0)
            c = 255.0
        else:
            yn = fdiv(y - 16.0, 219.0)
            c = 224.0
        un = fdiv(u - 128.0, c)
        vn = fdiv(v - 128.0, c)
        rgb = mat3(torch.stack([yn, un, vn], -1), self._dec).clamp(0.0, 1.0)
        lin = self._to_lin(rgb)
        if not self._same_prim:
            lin = mat3(lin, self._prim).clamp(0.0, 1.0)
        rgb2 = self._from_lin(lin).clamp(0.0, 1.0)
        yuv2 = mat3(rgb2, self._enc)
        if self._ofull:
            yo = yuv2[..., 0] * 255.0
            co = 255.0
        else:
            yo = yuv2[..., 0] * 219.0 + 16.0
            co = 224.0
        uo = yuv2[..., 1] * co + 128.0
        vo = yuv2[..., 2] * co + 128.0
        if sub:
            uo = (uo[0::2, 0::2] + uo[0::2, 1::2] + uo[1::2, 0::2]
                  + uo[1::2, 1::2]) * 0.25
            vo = (vo[0::2, 0::2] + vo[0::2, 1::2] + vo[1::2, 0::2]
                  + vo[1::2, 1::2]) * 0.25
        return [(0, frame.replace(planes=(_quant(yo), _quant(uo),
                                          _quant(vo))))]
