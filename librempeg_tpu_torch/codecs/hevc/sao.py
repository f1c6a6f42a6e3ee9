"""HEVC sample-adaptive offset filter (§8.7.3), 8-bit 4:2:0.

Applied after deblocking on whole-picture arrays: SAO classification
for every sample reads the PRE-SAO (post-deblock) picture, so the
whole filter is one vectorized pass per component — no CTB loop.
Per-CTB parameters (type, four offsets, band position / EO class) come
from the CTU walk (ctu.py saog grid).

Band offset: band index = sample >> 3 (8-bit); the four coded offsets
apply to bands band_pos..band_pos+3 (mod 32). Edge offset: category
from the two directional neighbors, edgeIdx map (1, 2, 0, 3, 4) —
samples whose neighbors fall outside the picture are left unfiltered.

Behavioral reference: libavcodec/hevc/filter.c:269
(sao_filter_CTB) — reimplemented from the spec, validated bit-exactly
against the reference decoder (tests/test_hevc.py sao tier).

A copy of librempeg_tpu/codecs/hevc/sao.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

import numpy as np

# raw edgeIdx (0..4) -> category (§8.7.3: 2 + sign sums, remapped)
_EO_CAT = np.array([1, 2, 0, 3, 4], np.int32)
# EO class -> the two neighbor offsets ((dy, dx) pairs)
_EO_NB = {0: ((0, -1), (0, 1)), 1: ((-1, 0), (1, 0)),
          2: ((-1, -1), (1, 1)), 3: ((1, -1), (-1, 1))}


def _sao_plane(plane: np.ndarray, prm: np.ndarray, ctb: int,
               across_slice_ok: np.ndarray | None = None) -> np.ndarray:
    """Filter one component plane in place.

    prm [hctb, wctb, 6]: (type, off1..off4, pos_or_class) per CTB of
    this component; ctb: CTB size in THIS plane's samples."""
    H, W = plane.shape
    src = plane.astype(np.int32)
    cy = np.arange(H)[:, None] // ctb       # CTB row per sample row
    cx = np.arange(W)[None, :] // ctb
    typ = prm[cy, cx, 0]                    # [H, W]
    if not np.any(typ):
        return plane
    offv = prm[:, :, 1:5]                   # [hctb, wctb, 4]
    out = src.copy()

    # ---- band offset (type 1) ----
    if np.any(typ == 1):
        k = ((src >> 3) - prm[cy, cx, 5]) & 31
        boff = np.where(k < 4,
                        offv[cy, cx, np.minimum(k, 3)], 0)
        out = np.where(typ == 1, src + boff, out)

    # ---- edge offset (type 2) ----
    if np.any(typ == 2):
        eo = prm[cy, cx, 5]
        pad = np.pad(src, 1, mode="edge")
        eo_off = np.zeros_like(src)
        valid = np.zeros((H, W), bool)
        for cls, ((dy0, dx0), (dy1, dx1)) in _EO_NB.items():
            sel = (typ == 2) & (eo == cls)
            if not np.any(sel):
                continue
            n0 = pad[1 + dy0:1 + dy0 + H, 1 + dx0:1 + dx0 + W]
            n1 = pad[1 + dy1:1 + dy1 + H, 1 + dx1:1 + dx1 + W]
            cat = _EO_CAT[2 + np.sign(src - n0) + np.sign(src - n1)]
            off = np.where(cat > 0,
                           offv[cy, cx, np.maximum(cat - 1, 0)], 0)
            eo_off = np.where(sel, off, eo_off)
            v = np.ones((H, W), bool)
            if dx0 or dx1:                  # horizontal neighbors
                v[:, 0] = False
                v[:, -1] = False
            if dy0 or dy1:                  # vertical neighbors
                v[0, :] = False
                v[-1, :] = False
            valid |= sel & v
        out = np.where((typ == 2) & valid, src + eo_off, out)

    plane[:] = np.clip(out, 0, 255).astype(plane.dtype)
    return plane


def sao_filter_picture(pic, sps, sh) -> None:
    """Apply SAO to pic.y/u/v in place from pic.sao (the walker's saog
    grid). Runs after deblocking (§8.7 filter order)."""
    saog = pic.sao
    ctb = sps.ctb_size
    if sh.sao_luma:
        _sao_plane(pic.y, saog[:, :, 0], ctb)
    if sh.sao_chroma:
        _sao_plane(pic.u, saog[:, :, 1], ctb // 2)
        _sao_plane(pic.v, saog[:, :, 2], ctb // 2)
