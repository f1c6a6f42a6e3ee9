"""The port's drawtext (librempeg_tpu_torch/filters/drawtext.py)
against the JAX package's, on the CPU.

Every graph runs through both packages' GraphRunner on the same seeded
64x48 yuv420p frames with the committed DejaVu Sans Mono. The planes are
equal bit for bit (tolerance 0): the coverage is the JAX package's
rasteriser over the port's TrueType reader (test_torch_ttf.py), and the
blend on the frame's device takes the JAX package's float32 operations
one at a time in its order. The cases cover plain text, a box, alpha, the
%{n} and %{pts} expansions, x/y expressions and text clipped at every
edge of the frame. Without the given and the default font, drawtext
raises.
"""
import os

import numpy as np
import pytest
import torch

from librempeg_tpu_torch.filters import drawtext as TD
from test_torch_filters2 import _pair, assert_same, run_both

FONT = os.path.join(os.path.dirname(__file__), "data", "torch_port",
                    "fonts", "DejaVuSansMono.ttf")

CASES = [
    f"drawtext=fontfile={FONT}:text=Hi:x=4:y=4",
    f"drawtext=fontfile={FONT}:text='%{{n}}':x=16:y=16:box=1",
    f"drawtext=fontfile={FONT}:text='%{{pts}}':fontsize=9:x=0:y=30"
    ":fontcolor=red",
    f"drawtext=fontfile={FONT}:text='%{{pts\\:hms}} 100%%':fontsize=8"
    ":x=(w-text_w)/2:y=h-th",
    f"drawtext=fontfile={FONT}:text=Edge:x=-7:y=-5:fontsize=20:alpha=0.5"
    ":fontcolor=0x20C0F0",
    f"drawtext=fontfile={FONT}:text=Box:x=40:y=38:box=1:boxcolor=blue"
    ":alpha=0.75:fontsize=18",
    f"drawtext=fontfile={FONT}:text='Ünïcödé':x=2:y=10:fontcolor=green",
]


@pytest.mark.parametrize("desc", CASES, ids=range(len(CASES)))
def test_drawtext_matches_jax(desc):
    jo, to = run_both(desc, n=4)
    assert_same(jo, to)
    # the text was drawn: some sample differs from the input
    _, tf = _pair("yuv420p", 0)
    assert not torch.equal(to[0].planes[0], tf.planes[0])


def test_blend_touches_only_the_rectangle():
    plane = torch.arange(48 * 64, dtype=torch.int64).remainder(251) \
        .to(torch.uint8).reshape(48, 64)
    w = np.full((3, 5), 0.5, np.float32)
    out = TD.blend(plane, (10, 13, 20, 25), [(1 - w, 200.0, w)])
    mask = torch.zeros_like(plane, dtype=torch.bool)
    mask[10:13, 20:25] = True
    assert torch.equal(out[~mask], plane[~mask])
    ref = np.clip(plane[10:13, 20:25].numpy().astype(np.float32) * (1 - w)
                  + 200.0 * w + 0.5, 0, 255).astype(np.uint8)
    assert np.array_equal(out[10:13, 20:25].numpy(), ref)
    assert plane.data_ptr() != out.data_ptr()


def test_missing_fonts_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(TD, "_DEFAULT_FONT", str(tmp_path / "none.ttf"))
    with pytest.raises(FileNotFoundError, match="no font"):
        TD.font_path(str(tmp_path / "absent.ttf"))
    assert TD.font_path(FONT) == FONT
