"""The port's TrueType reader (librempeg_tpu_torch/filters/_ttf.py)
against fontTools, which the JAX package's drawtext reads fonts with.

On the committed DejaVu Sans Mono, for every printable ASCII and
Latin-1 character: the cmap's glyph, the advance width, and the glyph
itself (a simple glyph's coordinates, on-curve flags and contour ends;
a composite's component glyphs and x/y offsets), exactly; the whole
best cmap and the head/hhea metrics exactly. Then the rasteriser:
render_text of the port and of the JAX package give the identical
float32 coverage.
"""
import os

import numpy as np
import pytest

from librempeg_tpu.filters import drawtext as JD
from librempeg_tpu_torch.filters import _ttf
from librempeg_tpu_torch.filters import drawtext as TD

FONT = os.path.join(os.path.dirname(__file__), "data", "torch_port",
                    "fonts", "DejaVuSansMono.ttf")
CHARS = [chr(c) for c in list(range(0x20, 0x7f)) + list(range(0xa0, 0x100))]

TTFont = pytest.importorskip("fontTools.ttLib").TTFont


@pytest.fixture(scope="module")
def fonts():
    return TTFont(FONT), _ttf.load(FONT)


def test_metrics_and_cmap(fonts):
    ft, mine = fonts
    assert os.path.getsize(FONT) == 343140
    assert (mine.units_per_em, mine.ascent, mine.descent, mine.num_glyphs) \
        == (ft["head"].unitsPerEm, ft["hhea"].ascent, ft["hhea"].descent,
            ft["maxp"].numGlyphs)
    order = ft.getGlyphOrder()
    assert {c: order[g] for c, g in mine.cmap.items()} == ft.getBestCmap()


@pytest.mark.parametrize("ch", CHARS, ids=[f"U{ord(c):04X}" for c in CHARS])
def test_glyph_matches_fonttools(fonts, ch):
    ft, mine = fonts
    gname = ft.getBestCmap().get(ord(ch), ".notdef")
    gid = mine.glyph_id(ch)
    assert ft.getGlyphName(gid) == gname
    assert mine.advances[gid] == ft["hmtx"][gname][0]
    glyf = ft["glyf"]
    g, m = glyf[gname], mine.glyph(gid)
    assert max(g.numberOfContours, -1) == m.number_of_contours
    if g.numberOfContours > 0:
        coords, ends, flags = g.getCoordinates(glyf)
        assert [tuple(p) for p in coords] == m.coords
        assert list(ends) == m.end_pts
        assert [f & 1 for f in flags] == m.flags
    elif g.isComposite():
        assert [(ft.getGlyphID(c.glyphName), c.x, c.y)
                for c in g.components] == m.components


@pytest.mark.parametrize("text,size", [
    ("Hello, world!", 16), ("0123456789 %{}", 24),
    ("àéîõü ÄÖÜ ß ñ ç ÿ", 20), ("MW|gjpqy_", 11)])
def test_render_text_coverage_is_identical(text, size):
    a = JD.render_text(text, FONT, size)
    b = TD.render_text(text, FONT, size)
    assert a.dtype == b.dtype == np.float32
    assert a.shape == b.shape
    assert np.array_equal(a, b)
