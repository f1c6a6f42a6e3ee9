"""subtitles filter: burn a subtitle FILE into video frames.

The vf_subtitles.c role (there backed by libass): cues are loaded from
the file through the demuxer+subtitle-decoder stack, rendered with the
drawtext TrueType rasterizer, and alpha-blended bottom-center with a
thin dilated outline for contrast. Multi-line cues stack upward.

Behavioral reference: libavfilter/vf_subtitles.c:563
(role; rendering is our own rasterizer, not libass).

Port of librempeg_tpu/filters/subtitles.py: the coverage and its
outline are rendered on the host; the blend runs on the frame's device
over the touched rectangle (drawtext.blend), bit-exact with the JAX
package's host blend.
"""
from __future__ import annotations

import os

import numpy as np

from librempeg_tpu_torch.core.options import Option, OptionTable
from librempeg_tpu_torch.filters.drawtext import (
    _DEFAULT_FONT,
    blend,
    font_path,
    render_text,
)
from librempeg_tpu_torch.filters.filter import Filter, register_filter


@register_filter
class SubtitlesFilter(Filter):
    NAME = "subtitles"
    DESCRIPTION = "Burn a subtitle file (srt/ass) into the video."
    OPT_ORDER = ("filename",)
    OPTIONS = OptionTable(
        Option("filename", str, ""),
        Option("fontsize", int, 0, min=0, max=512,
               help="0 = auto (frame height / 18)"),
        Option("fontfile", str, _DEFAULT_FONT),
        Option("alpha", float, 1.0, min=0.0, max=1.0),
    )

    def configure(self, in_props):
        from librempeg_tpu_torch.codecs.subtitles import load_cues

        fn = self.opts["filename"]
        if not fn or not os.path.exists(fn):
            raise ValueError(f"subtitles: file not found: {fn!r}")
        # the cues are host text; the decoder follows the device policy
        # of the run's frames, which configure() does not know yet
        cues = load_cues(fn, device="cpu")
        # [(start_s, end_s, text)]
        self._cues = []
        for c in cues:
            if c.pts is None or not c.time_base.valid:
                continue
            t0 = c.pts * c.time_base.num / c.time_base.den
            t1 = t0 + (c.duration or 0) * c.time_base.num \
                / c.time_base.den
            if t1 <= t0:
                t1 = t0 + 5.0          # undurationed cue: 5 s default
            if c.text:
                self._cues.append((t0, t1, c.text))
        self._render_cache: dict[str, np.ndarray] = {}
        return super().configure(in_props)

    def _coverage(self, text: str, fontsize: int) -> np.ndarray:
        key = f"{fontsize}:{text}"
        cov = self._render_cache.get(key)
        if cov is None:
            ff = font_path(self.opts["fontfile"])
            lines = [render_text(ln, ff, fontsize)
                     for ln in text.split("\n") if ln.strip()]
            if not lines:
                cov = np.zeros((1, 1), np.float32)
            else:
                w = max(l.shape[1] for l in lines)
                gap = fontsize // 4
                h = sum(l.shape[0] for l in lines) \
                    + gap * (len(lines) - 1)
                cov = np.zeros((h, w), np.float32)
                y = 0
                for l in lines:
                    x = (w - l.shape[1]) // 2       # center each line
                    cov[y:y + l.shape[0], x:x + l.shape[1]] = l
                    y += l.shape[0] + gap
            self._render_cache[key] = cov
        return cov

    def filter_frame(self, frame, pad=0):
        if frame.pts is None or not frame.time_base.valid \
                or not frame.time_base.num:
            return [(0, frame)]
        t = frame.pts * frame.time_base.num / frame.time_base.den
        text = None
        for t0, t1, tx in self._cues:
            if t0 <= t < t1:
                text = tx
                break
        if text is None:
            return [(0, frame)]
        fontsize = self.opts["fontsize"] or max(12, frame.height // 18)
        cov = self._coverage(text, fontsize)
        # outline: dilate the coverage for a dark rim behind the glyphs
        pad_c = np.pad(cov, 1)
        outline = np.maximum.reduce([
            pad_c[0:-2, 0:-2], pad_c[0:-2, 1:-1], pad_c[0:-2, 2:],
            pad_c[1:-1, 0:-2], pad_c[1:-1, 2:],
            pad_c[2:, 0:-2], pad_c[2:, 1:-1], pad_c[2:, 2:], cov])
        alpha = self.opts["alpha"]
        x0 = (frame.width - cov.shape[1]) // 2
        y0 = frame.height - cov.shape[0] - max(8, frame.height // 24)
        d = frame.desc
        planes = []
        white = (235, 128, 128) if frame.format.startswith("yuv") \
            else (255, 255, 255)
        black = (16, 128, 128) if frame.format.startswith("yuv") \
            else (0, 0, 0)
        for i, p in enumerate(frame.planes):
            sx = d.planes[i].log2_chroma_w
            sy = d.planes[i].log2_chroma_h
            g = cov[::1 << sy, ::1 << sx]
            o = outline[::1 << sy, ::1 << sx]
            px, py = x0 >> sx, y0 >> sy
            ph, pw = p.shape[:2]
            ch, cw = g.shape
            cx0, cy0 = max(px, 0), max(py, 0)
            cx1, cy1 = min(px + cw, pw), min(py + ch, ph)
            if cx1 <= cx0 or cy1 <= cy0:
                planes.append(p)
                continue
            gs = g[cy0 - py:cy1 - py, cx0 - px:cx1 - px] * alpha
            os_ = o[cy0 - py:cy1 - py, cx0 - px:cx1 - px] * alpha
            planes.append(blend(p, (cy0, cy1, cx0, cx1), [
                (1 - os_, float(black[min(i, 2)]), os_),
                (1 - gs, float(white[min(i, 2)]), gs)]))
        return [(0, frame.replace(planes=tuple(planes)))]
