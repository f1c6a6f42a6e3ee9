"""MPEG-4 part 2 / H.263 VLC tables.

Spec constants from ISO/IEC 14496-2 (Tables B-6..B-17) and ITU-T H.263
Annex — the same numeric tables the reference carries in
libavcodec/h263data.c and mpeg4data.h (table values are standard facts;
cross-checked against the reference's copies).

Layout notes:
* RL (run/level) VLC tables list (code, bits) for (last,run,level)
  triples; entries [0:last_split) have last=0, the rest last=1. The sign
  bit is appended after the code. Index 102 is ESCAPE.
* MV VLC indexes |value| 0..32 (half-pel units, f_code=1); sign appended
  unless value==0.
"""
from __future__ import annotations

import numpy as np

# intra MCBPC (Table B-6): index = (mb_type==intra_q)*4 + cbpc; we use
# mb_type=intra (first 4)
INTRA_MCBPC = [(1, 1), (1, 3), (2, 3), (3, 3),     # intra, cbpc 0..3
               (1, 4), (1, 6), (2, 6), (3, 6),     # intra+q
               (1, 9)]                             # stuffing

# inter MCBPC (Table B-7): index = mb_type*4 + cbpc
# mb_type: 0=inter(1mv) 1=intra 2=inter+q 3=intra+q 4=inter4v (+stuffing)
INTER_MCBPC = [
    (1, 1), (3, 4), (2, 4), (5, 6),      # inter
    (3, 5), (4, 8), (3, 8), (3, 7),      # intra
    (3, 3), (7, 7), (6, 7), (5, 9),      # inter+q
    (4, 6), (4, 9), (3, 9), (2, 9),      # intra+q
    (2, 3), (5, 7), (4, 7), (5, 8),      # inter4v
    (1, 9),                              # stuffing
]

# CBPY (Table B-9): index = cbpy for intra, 15-cbpy for inter
CBPY = [(3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4),
        (2, 5), (3, 6), (5, 4), (10, 4), (4, 4), (8, 4), (6, 4), (3, 2)]

# motion vector VLC (Table B-12), index |val| in half-pel units 0..32
MVTAB = [(1, 1), (1, 2), (1, 3), (1, 4), (3, 6), (5, 7), (4, 7), (3, 7),
         (11, 9), (10, 9), (9, 9), (17, 10), (16, 10), (15, 10), (14, 10),
         (13, 10), (12, 10), (11, 10), (10, 10), (9, 10), (8, 10), (7, 10),
         (6, 10), (5, 10), (4, 10), (7, 11), (6, 11), (5, 11), (4, 11),
         (3, 11), (2, 11), (3, 12), (2, 12)]

# intra DC size VLCs (Tables B-13/B-14): (code, bits) per size 0..12
DC_LUM = [(3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6),
          (1, 7), (1, 8), (1, 9), (1, 10), (1, 11)]
DC_CHROM = [(3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7),
            (1, 8), (1, 9), (1, 10), (1, 11), (1, 12)]

# intra coefficient RL VLC (Table B-16): 102 coded pairs + ESCAPE
INTRA_VLC = [
    (0x2, 2), (0x6, 3), (0xf, 4), (0xd, 5), (0xc, 5), (0x15, 6), (0x13, 6),
    (0x12, 6), (0x17, 7), (0x1f, 8), (0x1e, 8), (0x1d, 8), (0x25, 9),
    (0x24, 9), (0x23, 9), (0x21, 9), (0x21, 10), (0x20, 10), (0xf, 10),
    (0xe, 10), (0x7, 11), (0x6, 11), (0x20, 11), (0x21, 11), (0x50, 12),
    (0x51, 12), (0x52, 12), (0xe, 4), (0x14, 6), (0x16, 7), (0x1c, 8),
    (0x20, 9), (0x1f, 9), (0xd, 10), (0x22, 11), (0x53, 12), (0x55, 12),
    (0xb, 5), (0x15, 7), (0x1e, 9), (0xc, 10), (0x56, 12), (0x11, 6),
    (0x1b, 8), (0x1d, 9), (0xb, 10), (0x10, 6), (0x22, 9), (0xa, 10),
    (0xd, 6), (0x1c, 9), (0x8, 10), (0x12, 7), (0x1b, 9), (0x54, 12),
    (0x14, 7), (0x1a, 9), (0x57, 12), (0x19, 8), (0x9, 10), (0x18, 8),
    (0x23, 11), (0x17, 8), (0x19, 9), (0x18, 9), (0x7, 10), (0x58, 12),
    (0x7, 4), (0xc, 6), (0x16, 8), (0x17, 9), (0x6, 10), (0x5, 11),
    (0x4, 11), (0x59, 12), (0xf, 6), (0x16, 9), (0x5, 10), (0xe, 6),
    (0x4, 10), (0x11, 7), (0x24, 11), (0x10, 7), (0x25, 11), (0x13, 7),
    (0x5a, 12), (0x15, 8), (0x5b, 12), (0x14, 8), (0x13, 8), (0x1a, 8),
    (0x15, 9), (0x14, 9), (0x13, 9), (0x12, 9), (0x11, 9), (0x26, 11),
    (0x27, 11), (0x5c, 12), (0x5d, 12), (0x5e, 12), (0x5f, 12), (0x3, 7),
]
INTRA_LEVEL = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3,
    4, 5, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2,
    1, 2, 1, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 1, 2,
    1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1,
]
INTRA_RUN = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3,
    4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7, 7, 8, 8, 9, 9, 10, 11, 12, 13, 14,
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 8,
    9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
]
INTRA_LAST_SPLIT = 67  # entries [67:] have last=1

# inter coefficient RL VLC (Table B-17 / H.263): 102 pairs + ESCAPE
INTER_VLC = [
    (0x2, 2), (0xf, 4), (0x15, 6), (0x17, 7), (0x1f, 8), (0x25, 9),
    (0x24, 9), (0x21, 10), (0x20, 10), (0x7, 11), (0x6, 11), (0x20, 11),
    (0x6, 3), (0x14, 6), (0x1e, 8), (0xf, 10), (0x21, 11), (0x50, 12),
    (0xe, 4), (0x1d, 8), (0xe, 10), (0x51, 12), (0xd, 5), (0x23, 9),
    (0xd, 10), (0xc, 5), (0x22, 9), (0x52, 12), (0xb, 5), (0xc, 10),
    (0x53, 12), (0x13, 6), (0xb, 10), (0x54, 12), (0x12, 6), (0xa, 10),
    (0x11, 6), (0x9, 10), (0x10, 6), (0x8, 10), (0x16, 7), (0x55, 12),
    (0x15, 7), (0x14, 7), (0x1c, 8), (0x1b, 8), (0x21, 9), (0x20, 9),
    (0x1f, 9), (0x1e, 9), (0x1d, 9), (0x1c, 9), (0x1b, 9), (0x1a, 9),
    (0x22, 11), (0x23, 11), (0x56, 12), (0x57, 12), (0x7, 4), (0x19, 9),
    (0x5, 11), (0xf, 6), (0x4, 11), (0xe, 6), (0xd, 6), (0xc, 6),
    (0x13, 7), (0x12, 7), (0x11, 7), (0x10, 7), (0x1a, 8), (0x19, 8),
    (0x18, 8), (0x17, 8), (0x16, 8), (0x15, 8), (0x14, 8), (0x13, 8),
    (0x18, 9), (0x17, 9), (0x16, 9), (0x15, 9), (0x14, 9), (0x13, 9),
    (0x12, 9), (0x11, 9), (0x7, 10), (0x6, 10), (0x5, 10), (0x4, 10),
    (0x24, 11), (0x25, 11), (0x26, 11), (0x27, 11), (0x58, 12), (0x59, 12),
    (0x5a, 12), (0x5b, 12), (0x5c, 12), (0x5d, 12), (0x5e, 12), (0x5f, 12),
    (0x3, 7),
]
INTER_LEVEL = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4,
    1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 3, 1, 2, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
]
INTER_RUN = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3,
    3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 12,
    13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 0, 0, 0, 1,
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36,
    37, 38, 39, 40,
]
INTER_LAST_SPLIT = 58

ESCAPE_CODE, ESCAPE_BITS = 0x3, 7


def _build_rl_index(vlc, levels, runs, last_split):
    """(last, run, level) -> (code, bits) dict for the coded pairs."""
    idx = {}
    for i in range(len(levels)):
        last = 1 if i >= last_split else 0
        idx[(last, runs[i], levels[i])] = vlc[i]
    return idx


INTRA_RL_INDEX = _build_rl_index(INTRA_VLC, INTRA_LEVEL, INTRA_RUN,
                                 INTRA_LAST_SPLIT)
INTER_RL_INDEX = _build_rl_index(INTER_VLC, INTER_LEVEL, INTER_RUN,
                                 INTER_LAST_SPLIT)


def dc_scaler(qscale: int, chroma: bool) -> int:
    """Intra DC quantizer step (ISO 14496-2 §7.4.1 Table 7-1)."""
    if chroma:
        if qscale < 5:
            return 8
        if qscale < 25:
            return (qscale + 13) // 2
        return qscale - 6
    if qscale < 5:
        return 8
    if qscale < 9:
        return 2 * qscale
    if qscale < 25:
        return qscale + 8
    return 2 * qscale - 16


# zigzag scan (same spec constant as JPEG's)
from librempeg_tpu_torch.codecs.jpeg.tables import ZIGZAG  # noqa: E402,F401
