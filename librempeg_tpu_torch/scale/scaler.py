"""Video scaling and pixel-format conversion.

Port of librempeg_tpu/scale/scaler.py (Scaler._plan and its helpers).
The plan:

  unpack: uint/float planes -> float32 working tensors (0..255 domain)
  direct planar path (YUV -> YUV with the same range, planar or
    semi-planar): resize Y, U, V (and alpha) in their own domains
  general path: upsample chroma to 4:4:4 (bilinear), convert to RGB
    (ops/colorspace), resize the RGB planes, convert back / pack RGB,
    re-subsample chroma (bilinear)
  repack: floor(x + 0.5), clamp, cast (uint8, uint16 or float32)

Resizes are separable float32 GEMMs (ops/fir). All functions accept
leading batch dimensions ([N, H, W] planes).

One deliberate difference from the JAX package: its general path resizes
the RGB planes with resize_plane's default bicubic kernel whatever
`kernel` says (scaler.py:173-174); here the RGB resize uses `kernel`.
The two agree where kernel is bicubic, the default.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from librempeg_tpu_torch.core import pixfmt as pf
from librempeg_tpu_torch.core.errors import Unsupported
from librempeg_tpu_torch.core.frame import VideoFrame
from librempeg_tpu_torch.ops import colorspace as cs
from librempeg_tpu_torch.ops.fir import resize_plane
from librempeg_tpu_torch.ops.firdesign import SCALER_KERNEL_NAMES

# The colour matrix of the general path; each format's default range
# decides full or limited range. No filter option sets either yet.
_CSP = "bt601"


def _is_yuv(d: pf.PixFmtDesc) -> bool:
    return not d.is_rgb


def _max_val(d: pf.PixFmtDesc) -> float:
    return float((1 << d.bit_depth) - 1)


def _round_store(x: torch.Tensor, d: pf.PixFmtDesc) -> torch.Tensor:
    """floor(x + 0.5), clamped to the format's range, in its storage
    type."""
    x = torch.floor(x + 0.5).clamp(0.0, _max_val(d))
    if d.bit_depth <= 8:
        return x.to(torch.uint8)
    if d.is_float:
        return x.to(torch.float32)
    return x.to(torch.uint16)


def _load_scaled(x, d: pf.PixFmtDesc, device) -> torch.Tensor:
    """A plane as float32 on `device`, in the 0..255 working domain
    whatever its bit depth."""
    x = torch.as_tensor(x, device=device).to(torch.float32)
    if d.bit_depth != 8 and not d.is_float:
        x = x * (255.0 / _max_val(d))
    return x


def _store_domain(x: torch.Tensor, d: pf.PixFmtDesc) -> torch.Tensor:
    if d.bit_depth != 8 and not d.is_float:
        x = x * (_max_val(d) / 255.0)
    return x


@dataclass(frozen=True)
class ScalerSpec:
    src_fmt: str
    src_w: int
    src_h: int
    dst_fmt: str
    dst_w: int
    dst_h: int
    kernel: str = "bicubic"


class Scaler:
    """Scaling/conversion plan for one (src, dst) signature."""

    def __init__(self, src_fmt: str, src_w: int, src_h: int,
                 dst_fmt: str, dst_w: int, dst_h: int,
                 kernel: str = "bicubic"):
        if kernel not in SCALER_KERNEL_NAMES:
            raise Unsupported(f"unknown scaler kernel {kernel!r}")
        for name in (src_fmt, dst_fmt):
            if not pf.exists(name):
                raise Unsupported(f"scale: unknown pixel format {name!r}")
        self.spec = ScalerSpec(src_fmt, src_w, src_h, dst_fmt, dst_w,
                               dst_h, kernel)
        sd = self.src_desc = pf.get(src_fmt)
        dd = self.dst_desc = pf.get(dst_fmt)
        self._src_full = sd.default_range == pf.ColorRange.JPEG
        self._dst_full = dd.default_range == pf.ColorRange.JPEG

    # -- plan ---------------------------------------------------------
    def _to_rgb444(self, planes, dev) -> torch.Tensor:
        """Input planes -> [..., H, W, 3] float RGB (0..255)."""
        d = self.src_desc
        if d.is_rgb:
            return self._unpack_rgb(planes, d, dev)
        y, u, v = self._yuv_planes_444(planes, dev)
        return cs.yuv_to_rgb(y, u, v, _CSP, self._src_full)

    @staticmethod
    def _unpack_rgb(planes, d: pf.PixFmtDesc, dev) -> torch.Tensor:
        if d.nb_planes == 1:
            x = _load_scaled(planes[0], d, dev)   # [..., H, W, C]
            comps = d.planes[0].components
            order = [comps.index(c) for c in ("r", "g", "b")]
            return x[..., order]
        # planar RGB (gbrp): planes in g, b, r order
        names = [p.components[0] for p in d.planes]
        return torch.stack([_load_scaled(planes[names.index(c)], d, dev)
                            for c in ("r", "g", "b")], dim=-1)

    def _yuv_planes_444(self, planes, dev):
        """Upsample chroma to luma resolution (float, bilinear)."""
        d = self.src_desc
        y = _load_scaled(planes[0], d, dev)
        if d.nb_planes == 1:  # gray
            zeros = torch.full_like(y, 128.0)
            return y, zeros, zeros
        h, w = self.spec.src_h, self.spec.src_w
        _, u, v = self._extract_yuv(planes, d, dev)
        if u.shape != y.shape:
            u = resize_plane(u, h, w, "bilinear")
            v = resize_plane(v, h, w, "bilinear")
        return y, u, v

    def _plan(self, planes, dev):
        s = self.spec
        sd, dd = self.src_desc, self.dst_desc
        same_colorimetry = (_is_yuv(sd) == _is_yuv(dd)
                            and self._src_full == self._dst_full)
        if _is_yuv(sd) and _is_yuv(dd) and same_colorimetry \
                and sd.nb_planes >= 2 and dd.nb_planes >= 2:
            # direct planar path: resize y/u/v in their own domains
            # (planar and semi-planar nv12/nv21 layouts)
            resized = []
            for i, x in enumerate(self._extract_yuv(planes, sd, dev)):
                ph_d, pw_d = self._comp_shape(dd, i, s.dst_h, s.dst_w)
                resized.append(resize_plane(x, ph_d, pw_d, s.kernel))
            alpha = None
            if dd.has_alpha:
                ph_d, pw_d = dd.plane_shape(3, s.dst_h, s.dst_w)
                if sd.has_alpha and sd.nb_planes > 3:
                    alpha = resize_plane(_load_scaled(planes[3], sd, dev),
                                         ph_d, pw_d, s.kernel)
                else:
                    alpha = torch.full(resized[0].shape[:-2] + (ph_d, pw_d),
                                       255.0, device=dev)
            return self._emit_yuv(resized, alpha, dd)

        # general path through RGB 4:4:4
        rgb = self._to_rgb444(planes, dev)
        rgb = resize_plane(rgb.movedim(-1, -3), s.dst_h, s.dst_w, s.kernel)
        rgb = rgb.movedim(-3, -1)
        if dd.is_rgb:
            return self._pack_rgb(rgb, dd, dev)
        y, u, v = cs.rgb_to_yuv(rgb, _CSP, self._dst_full)
        outs = []
        for i, p in enumerate((y, u, v)[:dd.nb_planes]):
            ph_d, pw_d = dd.plane_shape(i, s.dst_h, s.dst_w)
            if p.shape[-2:] != (ph_d, pw_d):
                p = resize_plane(p, ph_d, pw_d, "bilinear")
            outs.append(_round_store(_store_domain(p, dd), dd))
        if dd.has_alpha:
            ph_d, pw_d = dd.plane_shape(3, s.dst_h, s.dst_w)
            outs.append(_round_store(torch.full(
                y.shape[:-2] + (ph_d, pw_d), 255.0, device=dev), dd))
        return tuple(outs)

    @staticmethod
    def _extract_yuv(planes, d: pf.PixFmtDesc, dev):
        """Y/U/V float components at their stored resolutions, from
        planar or semi-planar (nv12/nv21) layouts."""
        y = _load_scaled(planes[0], d, dev)
        if d.nb_planes >= 3:
            return [y, _load_scaled(planes[1], d, dev),
                    _load_scaled(planes[2], d, dev)]
        comps = d.planes[1].components     # ("u", "v") or ("v", "u")
        c = _load_scaled(planes[1], d, dev)
        return [y, c[..., comps.index("u")], c[..., comps.index("v")]]

    @staticmethod
    def _comp_shape(d: pf.PixFmtDesc, comp: int, h: int, w: int):
        plane_i = comp if d.nb_planes >= 3 else min(comp, 1)
        return d.plane_shape(plane_i, h, w)

    @staticmethod
    def _emit_yuv(comps, alpha, d: pf.PixFmtDesc):
        stored = [_round_store(_store_domain(x, d), d) for x in comps]
        if d.nb_planes >= 3:
            out = stored[:3]
            if alpha is not None:
                out.append(_round_store(_store_domain(alpha, d), d))
            return tuple(out)
        order = d.planes[1].components
        uv = torch.stack([stored[1] if c == "u" else stored[2]
                          for c in order], dim=-1)
        return (stored[0], uv)

    @staticmethod
    def _pack_rgb(rgb: torch.Tensor, d: pf.PixFmtDesc, dev):
        """Packed RGB as one [..., H, W, C] plane, or planar RGB (gbrp)
        as one plane per component in the format's order."""
        chans = {"r": rgb[..., 0], "g": rgb[..., 1], "b": rgb[..., 2],
                 "a": torch.full_like(rgb[..., 0], 255.0)}
        if d.nb_planes == 1:
            packed = torch.stack([chans[c] for c in d.planes[0].components],
                                 dim=-1)
            return (_round_store(_store_domain(packed, d), d),)
        return tuple(_round_store(_store_domain(chans[p.components[0]], d), d)
                     for p in d.planes)

    # -- public -------------------------------------------------------
    def scale_planes(self, planes, device=None):
        """Tuple of planes (tensors or arrays, optional leading batch
        dims) -> the converted planes on `device` (default: the first
        plane's device)."""
        if device is None:
            device = planes[0].device if isinstance(
                planes[0], torch.Tensor) else "cpu"
        return self._plan(planes, device)

    def scale_frame(self, frame: VideoFrame) -> VideoFrame:
        return frame.replace(
            planes=self.scale_planes(frame.planes),
            format=self.spec.dst_fmt, width=self.spec.dst_w,
            height=self.spec.dst_h,
            color_range="jpeg" if self._dst_full else "mpeg")


@functools.lru_cache(maxsize=64)
def get_scaler(src_fmt: str, src_w: int, src_h: int,
               dst_fmt: str, dst_w: int, dst_h: int,
               kernel: str = "bicubic") -> Scaler:
    """Cached scaler lookup (sws_getCachedContext analog)."""
    return Scaler(src_fmt, src_w, src_h, dst_fmt, dst_w, dst_h, kernel)
