"""Pixel format descriptors.

Analog of the reference's pixdesc layer (libavutil/pixdesc.c,
pixfmt.h — 311 formats). We implement the working subset needed by the
supported codec/filter set and define descriptors richly enough that generic
code (plane sizing, conversion planning, image fill/copy) is table-driven,
so growing toward the full 311 is adding rows, not code.

TPU-first representation note: on device, video planes are dense jnp arrays
(one per plane), typically batched [N, H, W] or [N, H, W, C]; packed host
formats (rgb24 in a file) are unpacked to planar/channel-last device layout
at ingest. These descriptors describe the *logical* format and its host
byte layout; `librempeg_tpu_torch.scale` compiles conversions between them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum


class ColorRange(Enum):
    UNSPECIFIED = 0
    MPEG = 1  # limited, Y in [16..235]
    JPEG = 2  # full range


@dataclass(frozen=True)
class PlaneDesc:
    """One plane of a pixel format."""

    components: tuple[str, ...]  # component names stored in this plane, in order
    log2_chroma_w: int = 0       # horizontal subsampling of this plane
    log2_chroma_h: int = 0


@dataclass(frozen=True)
class PixFmtDesc:
    """Descriptor for a pixel format (analog of AVPixFmtDescriptor)."""

    name: str
    bit_depth: int                       # bits per component
    planes: tuple[PlaneDesc, ...]
    is_rgb: bool = False
    has_alpha: bool = False
    is_float: bool = False
    default_range: ColorRange = ColorRange.UNSPECIFIED
    # log2 chroma subsampling of the format as a whole (max over planes)
    log2_chroma_w: int = field(init=False)
    log2_chroma_h: int = field(init=False)

    def __post_init__(self):
        object.__setattr__(
            self, "log2_chroma_w", max((p.log2_chroma_w for p in self.planes), default=0)
        )
        object.__setattr__(
            self, "log2_chroma_h", max((p.log2_chroma_h for p in self.planes), default=0)
        )

    @property
    def nb_planes(self) -> int:
        return len(self.planes)

    @property
    def nb_components(self) -> int:
        return sum(len(p.components) for p in self.planes)

    @property
    def bytes_per_component(self) -> int:
        return (self.bit_depth + 7) // 8

    def plane_shape(self, plane: int, height: int, width: int) -> tuple[int, int]:
        """(h, w) of `plane` for a `height` x `width` image (rows/cols of pixels;
        packed planes carry len(components) values per pixel)."""
        p = self.planes[plane]
        ph = -(-height >> p.log2_chroma_h) if p.log2_chroma_h else height
        pw = -(-width >> p.log2_chroma_w) if p.log2_chroma_w else width
        # ceil for odd sizes, matching AV_CEIL_RSHIFT
        ph = (height + (1 << p.log2_chroma_h) - 1) >> p.log2_chroma_h
        pw = (width + (1 << p.log2_chroma_w) - 1) >> p.log2_chroma_w
        return ph, pw

    def buffer_size(self, height: int, width: int) -> int:
        """Total bytes of a tightly packed image (av_image_get_buffer_size)."""
        total = 0
        for i, p in enumerate(self.planes):
            ph, pw = self.plane_shape(i, height, width)
            total += ph * pw * len(p.components) * self.bytes_per_component
        return total


def _planar_yuv(name: str, cw: int, ch: int, depth: int = 8,
                rng: ColorRange = ColorRange.UNSPECIFIED, alpha: bool = False) -> PixFmtDesc:
    planes = [
        PlaneDesc(("y",)),
        PlaneDesc(("u",), cw, ch),
        PlaneDesc(("v",), cw, ch),
    ]
    if alpha:
        planes.append(PlaneDesc(("a",)))
    return PixFmtDesc(name, depth, tuple(planes), has_alpha=alpha, default_range=rng)


FORMATS: dict[str, PixFmtDesc] = {}


def _reg(d: PixFmtDesc) -> PixFmtDesc:
    FORMATS[d.name] = d
    return d


YUV420P = _reg(_planar_yuv("yuv420p", 1, 1))
YUVJ420P = _reg(_planar_yuv("yuvj420p", 1, 1, rng=ColorRange.JPEG))
YUV422P = _reg(_planar_yuv("yuv422p", 1, 0))
YUVJ422P = _reg(_planar_yuv("yuvj422p", 1, 0, rng=ColorRange.JPEG))
YUV444P = _reg(_planar_yuv("yuv444p", 0, 0))
YUVJ444P = _reg(_planar_yuv("yuvj444p", 0, 0, rng=ColorRange.JPEG))
YUV410P = _reg(_planar_yuv("yuv410p", 2, 2))
YUV411P = _reg(_planar_yuv("yuv411p", 2, 0))
YUV440P = _reg(_planar_yuv("yuv440p", 0, 1))
YUVA420P = _reg(_planar_yuv("yuva420p", 1, 1, alpha=True))
YUVA444P = _reg(_planar_yuv("yuva444p", 0, 0, alpha=True))
YUV420P10 = _reg(_planar_yuv("yuv420p10le", 1, 1, depth=10))
YUV422P10 = _reg(_planar_yuv("yuv422p10le", 1, 0, depth=10))
YUV444P10 = _reg(_planar_yuv("yuv444p10le", 0, 0, depth=10))
YUV420P12 = _reg(_planar_yuv("yuv420p12le", 1, 1, depth=12))
YUV444P16 = _reg(_planar_yuv("yuv444p16le", 0, 0, depth=16))
YUV420P9 = _reg(_planar_yuv("yuv420p9le", 1, 1, depth=9))
YUV422P9 = _reg(_planar_yuv("yuv422p9le", 1, 0, depth=9))
YUV444P9 = _reg(_planar_yuv("yuv444p9le", 0, 0, depth=9))
YUV422P12 = _reg(_planar_yuv("yuv422p12le", 1, 0, depth=12))
YUV444P12 = _reg(_planar_yuv("yuv444p12le", 0, 0, depth=12))
YUV420P14 = _reg(_planar_yuv("yuv420p14le", 1, 1, depth=14))
YUV420P16 = _reg(_planar_yuv("yuv420p16le", 1, 1, depth=16))
YUV422P16 = _reg(_planar_yuv("yuv422p16le", 1, 0, depth=16))
YUV440P10 = _reg(_planar_yuv("yuv440p10le", 0, 1, depth=10))
YUV440P12 = _reg(_planar_yuv("yuv440p12le", 0, 1, depth=12))
YUVA422P = _reg(_planar_yuv("yuva422p", 1, 0, alpha=True))
YUVA444P10 = _reg(_planar_yuv("yuva444p10le", 0, 0, depth=10, alpha=True))

NV12 = _reg(PixFmtDesc("nv12", 8, (PlaneDesc(("y",)), PlaneDesc(("u", "v"), 1, 1))))
NV21 = _reg(PixFmtDesc("nv21", 8, (PlaneDesc(("y",)), PlaneDesc(("v", "u"), 1, 1))))

GRAY8 = _reg(PixFmtDesc("gray", 8, (PlaneDesc(("y",)),)))
GRAY9 = _reg(PixFmtDesc("gray9le", 9, (PlaneDesc(("y",)),)))
GRAY10 = _reg(PixFmtDesc("gray10le", 10, (PlaneDesc(("y",)),)))
GRAY12 = _reg(PixFmtDesc("gray12le", 12, (PlaneDesc(("y",)),)))
GRAY14 = _reg(PixFmtDesc("gray14le", 14, (PlaneDesc(("y",)),)))
GRAY16 = _reg(PixFmtDesc("gray16le", 16, (PlaneDesc(("y",)),)))
GRAYF32 = _reg(PixFmtDesc("grayf32le", 32, (PlaneDesc(("y",)),), is_float=True))

RGB24 = _reg(PixFmtDesc("rgb24", 8, (PlaneDesc(("r", "g", "b")),), is_rgb=True,
                        default_range=ColorRange.JPEG))
BGR24 = _reg(PixFmtDesc("bgr24", 8, (PlaneDesc(("b", "g", "r")),), is_rgb=True,
                        default_range=ColorRange.JPEG))
RGBA = _reg(PixFmtDesc("rgba", 8, (PlaneDesc(("r", "g", "b", "a")),), is_rgb=True,
                       has_alpha=True, default_range=ColorRange.JPEG))
BGRA = _reg(PixFmtDesc("bgra", 8, (PlaneDesc(("b", "g", "r", "a")),), is_rgb=True,
                       has_alpha=True, default_range=ColorRange.JPEG))
ARGB = _reg(PixFmtDesc("argb", 8, (PlaneDesc(("a", "r", "g", "b")),), is_rgb=True,
                       has_alpha=True, default_range=ColorRange.JPEG))
GBRP10 = _reg(PixFmtDesc("gbrp10le", 10,
                         (PlaneDesc(("g",)), PlaneDesc(("b",)),
                          PlaneDesc(("r",))), is_rgb=True))
GBRP12 = _reg(PixFmtDesc("gbrp12le", 12,
                         (PlaneDesc(("g",)), PlaneDesc(("b",)),
                          PlaneDesc(("r",))), is_rgb=True))
GBRAP = _reg(PixFmtDesc("gbrap", 8,
                        (PlaneDesc(("g",)), PlaneDesc(("b",)),
                         PlaneDesc(("r",)), PlaneDesc(("a",))),
                        is_rgb=True, has_alpha=True))
GBRP = _reg(PixFmtDesc("gbrp", 8, (PlaneDesc(("g",)), PlaneDesc(("b",)), PlaneDesc(("r",))),
                       is_rgb=True, default_range=ColorRange.JPEG))
GBRP16 = _reg(PixFmtDesc("gbrp16le", 16,
                         (PlaneDesc(("g",)), PlaneDesc(("b",)), PlaneDesc(("r",))),
                         is_rgb=True, default_range=ColorRange.JPEG))
RGB48 = _reg(PixFmtDesc("rgb48le", 16, (PlaneDesc(("r", "g", "b")),), is_rgb=True,
                        default_range=ColorRange.JPEG))
RGBAF32 = _reg(PixFmtDesc("rgbaf32le", 32, (PlaneDesc(("r", "g", "b", "a")),),
                          is_rgb=True, has_alpha=True, is_float=True,
                          default_range=ColorRange.JPEG))


def get(name: str) -> PixFmtDesc:
    """Look up a pixel format descriptor by name (av_pix_fmt_desc_get)."""
    try:
        return FORMATS[name]
    except KeyError:
        raise ValueError(f"unknown pixel format {name!r}") from None


def exists(name: str) -> bool:
    return name in FORMATS
