"""H.264 CAVLC residual coding (ISO/IEC 14496-10 §9.2): encode+decode.

Analog of libavcodec/h264_cavlc.c's residual layer.
Blocks are coefficient lists in zigzag order; context nC selects the
coeff_token table (chroma DC uses its dedicated table via nC=-1).
"""
from __future__ import annotations

import numpy as np

from librempeg_tpu_torch.codecs.flac.bitio import BitReaderMSB, BitWriterMSB
from librempeg_tpu_torch.codecs.h264 import cavlc_tables as T
from librempeg_tpu_torch.core.errors import InvalidData

ZIGZAG4 = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15],
                   np.int32)


def _token_table(nc: int) -> int:
    if nc < 2:
        return 0
    if nc < 4:
        return 1
    if nc < 8:
        return 2
    return 3


def write_residual(bw: BitWriterMSB, coeffs: np.ndarray, nc: int) -> int:
    """Encode one block (zigzag-ordered ints, chroma DC len 4, luma 15/16).

    Returns total_coeff (for nC context propagation)."""
    n = len(coeffs)
    nz = [int(c) for c in coeffs if c]
    positions = [i for i, c in enumerate(coeffs) if c]
    total = len(nz)
    # trailing ones: up to 3 |1| values at the end of the scan
    t1 = 0
    while t1 < min(3, total) and abs(nz[total - 1 - t1]) == 1:
        t1 += 1
    if nc >= 0:
        tab = _token_table(nc)
        if tab == 3:  # 6-bit FLC: 4*(total-1)+t1 with total>=1; 3 for 0
            if total == 0:
                bw.write(3, 6)
            else:
                bw.write(((total - 1) << 2) | t1, 6)
        else:
            ln = T.COEFF_TOKEN_LEN[tab][total * 4 + t1]
            code = T.COEFF_TOKEN_BITS[tab][total * 4 + t1]
            if ln == 0:
                raise InvalidData("cavlc: no coeff_token code")
            bw.write(code, ln)
    else:
        ln = T.CHROMA_DC_COEFF_TOKEN_LEN[total * 4 + t1]
        code = T.CHROMA_DC_COEFF_TOKEN_BITS[total * 4 + t1]
        if ln == 0:
            raise InvalidData("cavlc: no chroma-dc coeff_token")
        bw.write(code, ln)
    if total == 0:
        return 0
    # trailing-one signs (reverse scan order)
    for k in range(t1):
        bw.write(1 if nz[total - 1 - k] < 0 else 0, 1)
    # remaining levels, reverse order
    suffix_len = 1 if (total > 10 and t1 < 3) else 0
    first = True
    for k in range(t1, total):
        level = nz[total - 1 - k]
        code = 2 * abs(level) - 2 if level > 0 else 2 * abs(level) - 1
        if first and t1 < 3:
            code -= 2
        first = False
        # level_prefix / suffix
        if suffix_len == 0:
            if code < 14:
                bw.write(1, code + 1)          # prefix zeros + terminating 1
            elif code < 30:
                bw.write(1, 15)                # prefix 14
                bw.write(code - 14, 4)
            else:
                bw.write(1, 16)                # prefix 15 escape
                bw.write(code - 30, 12)
        else:
            prefix = code >> suffix_len
            if prefix < 15:
                bw.write(1, prefix + 1)
                bw.write(code & ((1 << suffix_len) - 1), suffix_len)
            else:
                bw.write(1, 16)
                bw.write(code - (15 << suffix_len), 12)
        if suffix_len == 0:
            suffix_len = 1
        if abs(level) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1
    # total_zeros
    max_coeff = n
    if total < max_coeff:
        tz = positions[-1] + 1 - total
        if nc >= 0:
            bw.write(T.TOTAL_ZEROS_BITS[total - 1][tz],
                     T.TOTAL_ZEROS_LEN[total - 1][tz])
        else:
            bw.write(T.CHROMA_DC_TOTAL_ZEROS_BITS[total - 1][tz],
                     T.CHROMA_DC_TOTAL_ZEROS_LEN[total - 1][tz])
    else:
        tz = 0
    # run_before for each coefficient except the last (reverse order)
    zeros_left = tz
    for k in range(total - 1):
        if zeros_left <= 0:
            break
        pos = positions[total - 1 - k]
        prev_pos = positions[total - 2 - k]
        run = pos - prev_pos - 1
        tabrow = min(zeros_left, 7) - 1
        bw.write(T.RUN_BITS[tabrow][run], T.RUN_LEN[tabrow][run])
        zeros_left -= run
    return total


def read_residual(br: BitReaderMSB, n: int, nc: int) -> tuple[np.ndarray, int]:
    """Decode one block -> (zigzag coeffs [n], total_coeff)."""
    out = np.zeros(n, np.int32)
    if nc >= 0:
        tab = _token_table(nc)
        if tab == 3:
            v = br.read(6)
            if v == 3:
                return out, 0
            total = (v >> 2) + 1
            t1 = v & 3
        else:
            total, t1 = _read_token(br, T.COEFF_TOKEN_LEN[tab],
                                    T.COEFF_TOKEN_BITS[tab], 17)
    else:
        total, t1 = _read_token(br, T.CHROMA_DC_COEFF_TOKEN_LEN,
                                T.CHROMA_DC_COEFF_TOKEN_BITS, 5)
    if total == 0:
        return out, 0
    levels = []
    for _ in range(t1):
        levels.append(-1 if br.read(1) else 1)
    suffix_len = 1 if (total > 10 and t1 < 3) else 0
    first = True
    for k in range(t1, total):
        prefix = 0
        while br.read(1) == 0:
            prefix += 1
            if prefix > 32:
                raise InvalidData("cavlc: bad level prefix")
        if suffix_len == 0:
            if prefix < 14:
                code = prefix
            elif prefix == 14:
                code = 14 + br.read(4)
            else:
                code = 30 + br.read(12)
        else:
            if prefix < 15:
                code = (prefix << suffix_len) | br.read(suffix_len)
            else:
                code = (15 << suffix_len) + br.read(12)
        if first and t1 < 3:
            code += 2
        first = False
        level = (code + 2) >> 1 if code % 2 == 0 else -((code + 1) >> 1)
        levels.append(level)
        if suffix_len == 0:
            suffix_len = 1
        if abs(level) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1
    # total_zeros
    if total < n:
        if nc >= 0:
            tz = _read_vlc_row(br, T.TOTAL_ZEROS_LEN[total - 1],
                               T.TOTAL_ZEROS_BITS[total - 1])
        else:
            tz = _read_vlc_row(br, T.CHROMA_DC_TOTAL_ZEROS_LEN[total - 1],
                               T.CHROMA_DC_TOTAL_ZEROS_BITS[total - 1])
    else:
        tz = 0
    # runs
    runs = []
    zeros_left = tz
    for k in range(total - 1):
        if zeros_left <= 0:
            runs.append(0)
            continue
        tabrow = min(zeros_left, 7) - 1
        run = _read_vlc_row(br, T.RUN_LEN[tabrow], T.RUN_BITS[tabrow])
        runs.append(run)
        zeros_left -= run
    runs.append(zeros_left)
    # place coefficients: levels[k] is the k-th from the END of the scan;
    # its position steps back by run_before[k] + 1 each time
    pos = total + tz - 1
    for k in range(total):
        out[pos] = levels[k]
        if k < total - 1:
            pos -= runs[k] + 1
    return out, total


def _read_token(br, len_tab, bits_tab, ntotals):
    """Match a (total,t1) coeff_token against a [ntotals*4] table."""
    code = 0
    for ln in range(1, 17):
        code = (code << 1) | br.read(1)
        for total in range(ntotals):
            for t1 in range(4):
                if len_tab[total * 4 + t1] == ln and \
                        bits_tab[total * 4 + t1] == code:
                    return total, t1
    raise InvalidData("cavlc: bad coeff_token")


def _read_vlc_row(br, len_row, bits_row):
    code = 0
    for ln in range(1, 16):
        code = (code << 1) | br.read(1)
        for v in range(len(len_row)):
            if len_row[v] == ln and bits_row[v] == code:
                return v
    raise InvalidData("cavlc: bad vlc")
