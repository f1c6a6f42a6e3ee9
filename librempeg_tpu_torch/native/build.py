"""Build & load the native host extension (ctypes).

Compiles the C++ sources beside this file (bitstream.cpp, h264.cpp,
mpeg4.cpp and their table headers) to a shared library on first use
(cached by source mtime) and exposes typed wrappers. Callers check
`available()`; the port's codecs raise where it is missing.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

# The C++ sources are the port's own copies, in this directory; the
# library is built under the checkout's build/ directory.
_DIR = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_DIR))
_SRCS = [os.path.join(_DIR, f)
         for f in ("bitstream.cpp", "h264.cpp", "mpeg4.cpp")]
_HDRS = [os.path.join(_DIR, f)
         for f in ("h264_tables.h", "mpeg4_tables.h", "cabac_tables.h")]
_LIB = os.path.join(_ROOT, "build", "native", "_bitstream.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build() -> bool:
    try:
        os.makedirs(os.path.dirname(_LIB), exist_ok=True)
        # build beside the target and rename: concurrent test workers
        # never load a half-written library
        tmp = f"{_LIB}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-march=native",
             "-o", tmp] + _SRCS,
            check=True, capture_output=True)
        os.replace(tmp, _LIB)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        import sys

        print(f"native build failed: {e}", file=sys.stderr)
        return False


def get() -> ctypes.CDLL | None:
    """The loaded library, building if needed; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None:
            return _lib
        if _tried:
            return None
        _tried = True
        srcs = [s for s in _SRCS + _HDRS if os.path.exists(s)]
        need_build = (not os.path.exists(_LIB)
                      or any(os.path.getmtime(_LIB) < os.path.getmtime(s)
                             for s in srcs))
        if need_build and not _build():
            return None
        lib = ctypes.CDLL(_LIB)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i16p = ctypes.POINTER(ctypes.c_int16)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.jpeg_decode_scan.restype = ctypes.c_int
        lib.jpeg_decode_scan.argtypes = [
            u8p, ctypes.c_int,
            ctypes.c_int, i32p, i32p, i32p, i32p,
            u8p, u8p, i32p, u8p, u8p, i32p,
            ctypes.c_int, ctypes.c_int, i16p]
        lib.jpeg_encode_scan.restype = ctypes.c_int
        lib.jpeg_encode_scan.argtypes = [
            i16p, ctypes.c_int,
            ctypes.c_int, i32p, i32p, i32p, i32p,
            u8p, u8p, i32p, u8p, u8p, i32p,
            u8p, ctypes.c_int]
        lib.png_unfilter.restype = ctypes.c_int
        lib.png_unfilter.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, u8p]
        lib.png_filter.restype = ctypes.c_int
        lib.png_filter.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, u8p]
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.biquad.restype = ctypes.c_int
        lib.biquad.argtypes = [f64p, f64p, f32p, f32p, ctypes.c_long]
        i8p = ctypes.POINTER(ctypes.c_int8)
        lib.h264_decode_slice_cavlc.restype = ctypes.c_int
        lib.h264_decode_slice_cavlc.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int,             # rbsp, nbytes, bit
            ctypes.c_int, ctypes.c_int, ctypes.c_int,    # mb_w, mb_h, first
            ctypes.c_int, ctypes.c_int, ctypes.c_int,    # type, qp, nref
            i32p, i32p, i8p, i16p, i8p, i32p, i16p, i16p, i32p,
            ctypes.c_int, i16p, i8p,                     # nref1, mv1, ref1
            ctypes.c_int]                                # transform_8x8
        lib.h264_qpel_planes.restype = None
        lib.h264_qpel_planes.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, u8p, u8p, u8p]
        lib.mpeg4_pack_frame.restype = ctypes.c_long
        lib.mpeg4_pack_frame.argtypes = [
            u8p, ctypes.c_int, ctypes.c_uint32, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i32p, i32p, i32p, i16p, i16p, i16p, i32p,
            u8p, ctypes.c_long]
        u8pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
        lib.h264_recon_frame.restype = ctypes.c_int
        lib.h264_recon_frame.argtypes = [
            u8p, u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i32p, i32p, i8p, i16p, i8p, i32p, i16p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            u8pp, u8pp, u8pp, u8pp, u8pp, u8pp,
            i16p, i8p, ctypes.c_int,                 # mv1, ref1, n_ref1
            u8pp, u8pp, u8pp, u8pp, u8pp, u8pp,
            i32p, i32p, ctypes.c_int,                # qmul4/8, cqp_off2
            i32p, i32p, i32p, i16p,                  # wmode/wld/wpx/impw
            i32p]                                    # slice_id
        lib.h264_cabac_slice.restype = ctypes.c_int
        lib.h264_cabac_slice.argtypes = [
            ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int,
            u8p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i32p, i32p, i8p, i16p, i8p, i32p, i16p, i16p, i32p,
            ctypes.c_int, i16p, i8p,
            ctypes.c_int]                            # transform_8x8
        lib.h264_intra_recon.restype = None
        lib.h264_intra_recon.argtypes = [
            u8p, u8p, u8p, ctypes.c_int, ctypes.c_int,
            i32p, i32p, i8p, i16p, i16p, ctypes.c_int, ctypes.c_int,
            i32p]                                    # slice_id
        lib.h264_sparse_coeffs.restype = ctypes.c_int
        lib.h264_sparse_coeffs.argtypes = [
            i16p, i16p, ctypes.c_int, i32p, i16p, ctypes.c_int]
        lib.h264_deblock_frame.restype = None
        lib.h264_deblock_frame.argtypes = [
            u8p, u8p, u8p, ctypes.c_int, ctypes.c_int,
            i32p, i32p, i16p, i8p, i16p,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i16p, i8p, i32p, i32p,       # list-1 mv/ref + pic-id maps
            i32p, ctypes.c_int]          # mb_info, cqp_off2
        _lib = lib
        return _lib


def available() -> bool:
    return get() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i16(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def jpeg_decode_scan(data: bytes, comps: list[dict],
                     dc_tables: list[tuple[np.ndarray, np.ndarray]],
                     ac_tables: list[tuple[np.ndarray, np.ndarray]],
                     mcu_count: int, restart_interval: int) -> np.ndarray:
    """Decode a baseline scan -> [total_blocks, 64] int16 (zigzag order).

    comps: [{"h":, "v":, "dc":, "ac":}]; tables: (bits[16], vals[<=256]).
    """
    lib = get()
    assert lib is not None
    ncomp = len(comps)
    ch = np.array([c["h"] for c in comps], np.int32)
    cv = np.array([c["v"] for c in comps], np.int32)
    cd = np.array([c["dc"] for c in comps], np.int32)
    ca = np.array([c["ac"] for c in comps], np.int32)
    dc_bits = np.zeros((4, 16), np.uint8)
    dc_vals = np.zeros((4, 256), np.uint8)
    dc_n = np.zeros(4, np.int32)
    ac_bits = np.zeros((4, 16), np.uint8)
    ac_vals = np.zeros((4, 256), np.uint8)
    ac_n = np.zeros(4, np.int32)
    for i, (b, v) in enumerate(dc_tables):
        dc_bits[i, :len(b)] = b
        dc_vals[i, :len(v)] = v
        dc_n[i] = len(v)
    for i, (b, v) in enumerate(ac_tables):
        ac_bits[i, :len(b)] = b
        ac_vals[i, :len(v)] = v
        ac_n[i] = len(v)
    blocks_per_mcu = int(sum(c["h"] * c["v"] for c in comps))
    out = np.zeros((mcu_count * blocks_per_mcu, 64), np.int16)
    buf = np.frombuffer(data, np.uint8)
    r = lib.jpeg_decode_scan(
        _u8(buf), len(data), ncomp, _i32(ch), _i32(cv), _i32(cd), _i32(ca),
        _u8(dc_bits), _u8(dc_vals), _i32(dc_n),
        _u8(ac_bits), _u8(ac_vals), _i32(ac_n),
        mcu_count, restart_interval, _i16(out))
    if r < 0:
        from librempeg_tpu_torch.core.errors import InvalidData

        raise InvalidData("JPEG scan decode failed")
    return out


def jpeg_encode_scan(coeffs: np.ndarray, comps: list[dict],
                     dc_tables, ac_tables, mcu_count: int) -> bytes:
    """[total_blocks, 64] int16 zigzag -> entropy-coded bytes."""
    lib = get()
    assert lib is not None
    ncomp = len(comps)
    ch = np.array([c["h"] for c in comps], np.int32)
    cv = np.array([c["v"] for c in comps], np.int32)
    cd = np.array([c["dc"] for c in comps], np.int32)
    ca = np.array([c["ac"] for c in comps], np.int32)
    dc_bits = np.zeros((4, 16), np.uint8)
    dc_vals = np.zeros((4, 256), np.uint8)
    dc_n = np.zeros(4, np.int32)
    ac_bits = np.zeros((4, 16), np.uint8)
    ac_vals = np.zeros((4, 256), np.uint8)
    ac_n = np.zeros(4, np.int32)
    for i, (b, v) in enumerate(dc_tables):
        dc_bits[i, :len(b)] = b
        dc_vals[i, :len(v)] = v
        dc_n[i] = len(v)
    for i, (b, v) in enumerate(ac_tables):
        ac_bits[i, :len(b)] = b
        ac_vals[i, :len(v)] = v
        ac_n[i] = len(v)
    coeffs = np.ascontiguousarray(coeffs, np.int16)
    cap = coeffs.size * 4 + 65536
    out = np.zeros(cap, np.uint8)
    n = lib.jpeg_encode_scan(
        _i16(coeffs), mcu_count, ncomp, _i32(ch), _i32(cv), _i32(cd),
        _i32(ca),
        _u8(dc_bits), _u8(dc_vals), _i32(dc_n),
        _u8(ac_bits), _u8(ac_vals), _i32(ac_n),
        _u8(out), cap)
    if n < 0:
        raise RuntimeError("JPEG scan encode overflow")
    return out[:n].tobytes()


def png_unfilter(rows: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    lib = get()
    assert lib is not None
    rows_a = np.frombuffer(rows, np.uint8)
    out = np.zeros(h * stride, np.uint8)
    r = lib.png_unfilter(_u8(rows_a), h, stride, bpp, _u8(out))
    if r < 0:
        from librempeg_tpu_torch.core.errors import InvalidData

        raise InvalidData("bad PNG filter type")
    return out


def png_filter(img: np.ndarray, h: int, stride: int, bpp: int) -> bytes:
    lib = get()
    assert lib is not None
    img = np.ascontiguousarray(img.reshape(-1), dtype=np.uint8)
    out = np.zeros(h * (stride + 1), np.uint8)
    lib.png_filter(_u8(img), h, stride, bpp, _u8(out))
    return out.tobytes()


def biquad(b, a, x: np.ndarray) -> np.ndarray:
    """Direct-form-II-transposed biquad over float32 samples."""
    lib = get()
    if lib is None:
        # pure-python fallback
        z1 = z2 = 0.0
        y = np.zeros_like(x)
        for i in range(len(x)):
            out = b[0] * x[i] + z1
            z1 = b[1] * x[i] - a[0] * out + z2
            z2 = b[2] * x[i] - a[1] * out
            y[i] = out
        return y
    x = np.ascontiguousarray(x, np.float32)
    y = np.zeros_like(x)
    bb = np.asarray(b, np.float64)
    aa = np.asarray(a, np.float64)
    lib.biquad(bb.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
               aa.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
               x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
               y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
               len(x))
    return y


def _i8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def h264_decode_slice_cavlc(rbsp: bytes, start_bit: int, mb_w: int,
                            mb_h: int, first_mb: int, slice_type: int,
                            slice_qp: int, num_ref_idx_l0: int,
                            num_ref_idx_l1: int = 1,
                            transform_8x8_mode: bool = False,
                            partial: bool = False) -> dict:
    """Decode one CAVLC slice (I or P) to per-MB tensors.

    partial=True returns whatever decoded before a bitstream error
    (res["error"] set) instead of raising -- the error-concealment
    path (error_resilience.c role).

    Returns dict of arrays: kind[nMB], info[nMB], i4modes[nMB,16],
    mv[nMB,16,2], ref[nMB,4], qp[nMB], coeffs[nMB,27,16] (zigzag),
    ncoef[nMB,27], end_bit, last_mb. See native/h264.cpp for layout.
    """
    lib = get()
    assert lib is not None
    nmb = mb_w * mb_h
    kind = np.full(nmb, -1, np.int32)
    info = np.zeros(nmb, np.int32)
    i4m = np.zeros((nmb, 16), np.int8)
    mv = np.zeros((nmb, 16, 2), np.int16)
    ref = np.full((nmb, 4), -1, np.int8)
    qp = np.zeros(nmb, np.int32)
    coeffs = np.zeros((nmb, 27, 16), np.int16)
    ncoef = np.zeros((nmb, 27), np.int16)
    mv1 = np.zeros((nmb, 16, 2), np.int16)
    ref1 = np.full((nmb, 4), -1, np.int8)
    end = np.zeros(2, np.int32)
    buf = np.frombuffer(rbsp, np.uint8)
    r = lib.h264_decode_slice_cavlc(
        _u8(buf), len(rbsp), start_bit, mb_w, mb_h, first_mb,
        slice_type, slice_qp, num_ref_idx_l0,
        _i32(kind), _i32(info), _i8(i4m), _i16(mv), _i8(ref), _i32(qp),
        _i16(coeffs), _i16(ncoef), _i32(end),
        num_ref_idx_l1, _i16(mv1), _i8(ref1), int(transform_8x8_mode))
    if r < 0:
        from librempeg_tpu_torch.core.errors import InvalidData, Unsupported

        if r == -5:
            raise Unsupported("h264: I_PCM macroblocks")
        if r == -8:
            raise Unsupported("h264: B direct/partition macroblocks")
        if not partial:
            raise InvalidData(f"h264: slice entropy decode failed ({r})")
        return {"kind": kind, "info": info, "i4modes": i4m, "mv": mv,
                "ref": ref, "qp": qp, "coeffs": coeffs, "ncoef": ncoef,
                "mv1": mv1, "ref1": ref1, "error": int(r),
                "end_bit": 0, "last_mb": int((kind >= 0).sum())}
    return {"kind": kind, "info": info, "i4modes": i4m, "mv": mv,
            "ref": ref, "qp": qp, "coeffs": coeffs, "ncoef": ncoef,
            "mv1": mv1, "ref1": ref1,
            "end_bit": int(end[0]), "last_mb": int(end[1])}


def h264_sparse_coeffs(coeffs: np.ndarray, ncoef: np.ndarray,
                       idx_out: np.ndarray, val_out: np.ndarray) -> int:
    """Compact (flat zigzag index, level) extraction from the dense
    [nMB,27,16] tensor, pruned by ncoef. Returns the entry count, or
    -1 when idx_out/val_out (same length) would overflow."""
    lib = get()
    assert lib is not None
    nmb = coeffs.shape[0]
    return lib.h264_sparse_coeffs(
        _i16(coeffs), _i16(ncoef), nmb,
        _i32(idx_out), _i16(val_out), len(idx_out))


def h264_deblock_frame(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                       kind: np.ndarray, qp: np.ndarray, mv: np.ndarray,
                       ref: np.ndarray, ncoef: np.ndarray,
                       mb_w: int, mb_h: int, alpha_off: int = 0,
                       beta_off: int = 0, chroma_qp_off: int = 0,
                       mv1=None, ref1=None, l0pic=None,
                       l1pic=None, info=None, cqp_off2=None) -> None:
    """In-place H.264 in-loop deblock over uint8 yuv420 planes.
    mv1/ref1 (+ refIdx->picture-id maps) carry list 1 for B frames."""
    lib = get()
    assert lib is not None
    assert y.dtype == np.uint8 and y.flags.c_contiguous
    h, w = y.shape
    null16 = ctypes.POINTER(ctypes.c_int16)()
    null8 = ctypes.POINTER(ctypes.c_int8)()
    null32 = ctypes.POINTER(ctypes.c_int32)()
    a_mv1 = np.ascontiguousarray(mv1, np.int16) if mv1 is not None \
        else None
    a_ref1 = np.ascontiguousarray(ref1, np.int8) if ref1 is not None \
        else None
    a_l0 = np.ascontiguousarray(l0pic, np.int32) if l0pic is not None \
        else None
    a_l1 = np.ascontiguousarray(l1pic, np.int32) if l1pic is not None \
        else None
    lib.h264_deblock_frame(
        _u8(y), _u8(u), _u8(v), w, h,
        _i32(np.ascontiguousarray(kind, np.int32)),
        _i32(np.ascontiguousarray(qp, np.int32)),
        _i16(np.ascontiguousarray(mv, np.int16)),
        _i8(np.ascontiguousarray(ref, np.int8)),
        _i16(np.ascontiguousarray(ncoef, np.int16)),
        mb_w, mb_h, alpha_off, beta_off, chroma_qp_off,
        _i16(a_mv1) if a_mv1 is not None else null16,
        _i8(a_ref1) if a_ref1 is not None else null8,
        _i32(a_l0) if a_l0 is not None else null32,
        _i32(a_l1) if a_l1 is not None else null32,
        _i32(np.ascontiguousarray(info, np.int32))
        if info is not None else null32,
        chroma_qp_off if cqp_off2 is None else cqp_off2)


def h264_intra_recon(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                     kind: np.ndarray, info: np.ndarray,
                     i4modes: np.ndarray, resid_y: np.ndarray,
                     resid_c: np.ndarray, mb_w: int, mb_h: int,
                     slice_id=None) -> None:
    """In-place intra MB reconstruction over uint8 planes; resid_y
    [nMB,256] int16 MB-raster, resid_c [nMB,2,64]."""
    lib = get()
    assert lib is not None
    assert y.dtype == np.uint8 and y.flags.c_contiguous
    h, w = y.shape
    lib.h264_intra_recon(
        _u8(y), _u8(u), _u8(v), w, h,
        _i32(np.ascontiguousarray(kind, np.int32)),
        _i32(np.ascontiguousarray(info, np.int32)),
        _i8(np.ascontiguousarray(i4modes, np.int8)),
        _i16(np.ascontiguousarray(resid_y, np.int16)),
        _i16(np.ascontiguousarray(resid_c, np.int16)),
        mb_w, mb_h,
        _i32(np.ascontiguousarray(slice_id, np.int32))
        if slice_id is not None else ctypes.POINTER(ctypes.c_int32)())


def h264_qpel_planes(epad: np.ndarray):
    """(b, h, j) half-pel planes (uint8) for a padded ref plane."""
    lib = get()
    assert lib is not None
    hp, wp = epad.shape
    epad = np.ascontiguousarray(epad, np.uint8)
    b = np.zeros((hp, wp), np.uint8)
    h = np.zeros((hp, wp), np.uint8)
    j = np.zeros((hp, wp), np.uint8)
    lib.h264_qpel_planes(_u8(epad), hp, wp, _u8(b), _u8(h), _u8(j))
    return b, h, j


def mpeg4_pack_frame(hdr_bw, is_i: bool, mb_w: int, mb_h: int,
                     dc_diff_y, dc_diff_u, dc_diff_v,
                     zz_y: np.ndarray, zz_u: np.ndarray, zz_v: np.ndarray,
                     mvh) -> bytes:
    """Pack one VOP: header bits from `hdr_bw` (a mpeg4.bits.BitWriter,
    consumed) + the MB layer + stuffing alignment. Returns full bytes."""
    lib = get()
    assert lib is not None
    hdr_bytes = np.frombuffer(bytes(hdr_bw._buf), np.uint8)
    zz_y = np.ascontiguousarray(zz_y, np.int16)
    zz_u = np.ascontiguousarray(zz_u, np.int16)
    zz_v = np.ascontiguousarray(zz_v, np.int16)
    zero32 = np.zeros(1, np.int32)
    if is_i:
        d_y = np.ascontiguousarray(dc_diff_y, np.int32)
        d_u = np.ascontiguousarray(dc_diff_u, np.int32)
        d_v = np.ascontiguousarray(dc_diff_v, np.int32)
        mv_a = zero32
    else:
        d_y = d_u = d_v = zero32
        mv_a = np.ascontiguousarray(mvh, np.int32)
    cap = int(zz_y.size + zz_u.size + zz_v.size) * 4 + len(hdr_bytes) + 4096
    out = np.zeros(cap, np.uint8)
    n = lib.mpeg4_pack_frame(
        _u8(hdr_bytes), len(hdr_bytes),
        ctypes.c_uint32(hdr_bw._acc & 0xFFFFFFFF), hdr_bw._nbits,
        1 if is_i else 0, mb_w, mb_h,
        _i32(d_y), _i32(d_u), _i32(d_v),
        _i16(zz_y), _i16(zz_u), _i16(zz_v), _i32(mv_a),
        _u8(out), cap)
    if n < 0:
        raise RuntimeError("mpeg4_pack_frame overflow")
    return out[:n].tobytes()


def h264_recon_frame(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                     res: dict, mb_w: int, mb_h: int,
                     chroma_qp_off: int, ref_packs,
                     ref_packs_l1=None, qmul4=None, qmul8=None,
                     cqp_off2=None, weights=None, impw=None,
                     slice_id=None) -> None:
    """Full in-place frame reconstruction (residuals + inter MC + intra)
    from per-MB entropy tensors; ref_packs are recon.RefPack objects."""
    lib = get()
    assert lib is not None
    n = len(ref_packs)
    PP = ctypes.POINTER(ctypes.c_uint8) * max(1, n)
    pE, pB, pH, pJ, pU, pV = (PP() for _ in range(6))
    if n:
        hp, wp = ref_packs[0].E.shape
        hc, wc = ref_packs[0].U.shape
        for i, rp in enumerate(ref_packs):
            pE[i] = _u8(rp.E)
            pB[i] = _u8(rp.B)
            pH[i] = _u8(rp.Hm)
            pJ[i] = _u8(rp.J)
            pU[i] = _u8(rp.U)
            pV[i] = _u8(rp.V)
    else:
        hp = wp = hc = wc = 0
    n1 = len(ref_packs_l1) if ref_packs_l1 else 0
    PP1 = ctypes.POINTER(ctypes.c_uint8) * max(1, n1)
    p1E, p1B, p1H, p1J, p1U, p1V = (PP1() for _ in range(6))
    for i, rp in enumerate(ref_packs_l1 or ()):
        p1E[i] = _u8(rp.E)
        p1B[i] = _u8(rp.B)
        p1H[i] = _u8(rp.Hm)
        p1J[i] = _u8(rp.J)
        p1U[i] = _u8(rp.U)
        p1V[i] = _u8(rp.V)
    null16 = ctypes.POINTER(ctypes.c_int16)()
    null8 = ctypes.POINTER(ctypes.c_int8)()
    has_l1 = ref_packs_l1 is not None and "mv1" in res
    a_mv1 = np.ascontiguousarray(res["mv1"], np.int16) if has_l1 else None
    a_ref1 = np.ascontiguousarray(res["ref1"], np.int8) if has_l1 else None
    null32 = ctypes.POINTER(ctypes.c_int32)()
    a_q4 = np.ascontiguousarray(qmul4, np.int32) \
        if qmul4 is not None else None
    a_q8 = np.ascontiguousarray(qmul8, np.int32) \
        if qmul8 is not None else None
    # weights: per-slice (wmode[nsl], wld[nsl,2], wpx[nsl,2,32,6])
    # tabulated by the codec from each slice's pred_weight_table
    a_wm = a_wld = a_wpx = None
    if weights is not None:
        a_wm, a_wld, a_wpx = (np.ascontiguousarray(w, np.int32)
                              for w in weights)
    a_imp = np.ascontiguousarray(impw, np.int16) \
        if impw is not None else None
    r = lib.h264_recon_frame(
        _u8(y), _u8(u), _u8(v), mb_w, mb_h, chroma_qp_off,
        _i32(np.ascontiguousarray(res["kind"], np.int32)),
        _i32(np.ascontiguousarray(res["info"], np.int32)),
        _i8(np.ascontiguousarray(res["i4modes"], np.int8)),
        _i16(np.ascontiguousarray(res["mv"], np.int16)),
        _i8(np.ascontiguousarray(res["ref"], np.int8)),
        _i32(np.ascontiguousarray(res["qp"], np.int32)),
        _i16(np.ascontiguousarray(res["coeffs"], np.int16)),
        n, hp, wp, hc, wc, pE, pB, pH, pJ, pU, pV,
        _i16(a_mv1) if a_mv1 is not None else null16,
        _i8(a_ref1) if a_ref1 is not None else null8,
        n1, p1E, p1B, p1H, p1J, p1U, p1V,
        _i32(a_q4) if a_q4 is not None else null32,
        _i32(a_q8) if a_q8 is not None else null32,
        chroma_qp_off if cqp_off2 is None else cqp_off2,
        _i32(a_wm) if a_wm is not None else null32,
        _i32(a_wld) if a_wld is not None else null32,
        _i32(a_wpx) if a_wpx is not None else null32,
        _i16(a_imp) if a_imp is not None else null16,
        _i32(np.ascontiguousarray(slice_id, np.int32))
        if slice_id is not None else null32)
    if r < 0:
        from librempeg_tpu_torch.core.errors import InvalidData

        raise InvalidData("h264: ref idx out of range")


def h264_decode_slice_cabac(rbsp: bytes, start_bit: int, mb_w: int,
                            mb_h: int, first_mb: int, slice_type: int,
                            slice_qp: int, num_ref_idx_l0: int,
                            cabac_init_idc: int,
                            num_ref_idx_l1: int = 1,
                            transform_8x8_mode: bool = False,
                            partial: bool = False) -> dict:
    """CABAC twin of h264_decode_slice_cavlc (same tensor layout)."""
    lib = get()
    assert lib is not None
    nmb = mb_w * mb_h
    kind = np.full(nmb, -1, np.int32)
    info = np.zeros(nmb, np.int32)
    i4m = np.zeros((nmb, 16), np.int8)
    mv = np.zeros((nmb, 16, 2), np.int16)
    ref = np.full((nmb, 4), -1, np.int8)
    qp = np.zeros(nmb, np.int32)
    coeffs = np.zeros((nmb, 27, 16), np.int16)
    ncoef = np.zeros((nmb, 27), np.int16)
    mv1 = np.zeros((nmb, 16, 2), np.int16)
    ref1 = np.full((nmb, 4), -1, np.int8)
    end = np.zeros(2, np.int32)
    buf = np.frombuffer(rbsp, np.uint8)
    r = lib.h264_cabac_slice(
        0, _u8(buf), len(rbsp), start_bit, _u8(np.zeros(1, np.uint8)), 0,
        mb_w, mb_h, first_mb, slice_type, slice_qp, num_ref_idx_l0,
        cabac_init_idc,
        _i32(kind), _i32(info), _i8(i4m), _i16(mv), _i8(ref), _i32(qp),
        _i16(coeffs), _i16(ncoef), _i32(end),
        num_ref_idx_l1, _i16(mv1), _i8(ref1), int(transform_8x8_mode))
    if r < 0:
        from librempeg_tpu_torch.core.errors import InvalidData, Unsupported

        if r == -5:
            raise Unsupported("h264: I_PCM macroblocks")
        if r == -8:
            raise Unsupported("h264: B direct/partition macroblocks")
        if partial:
            return {"kind": kind, "info": info, "i4modes": i4m,
                    "mv": mv, "ref": ref, "qp": qp, "coeffs": coeffs,
                    "ncoef": ncoef, "mv1": mv1, "ref1": ref1,
                    "error": int(r), "end_bit": 0,
                    "last_mb": int((kind >= 0).sum())}
        raise InvalidData(f"h264: CABAC slice decode failed ({r})")
    return {"kind": kind, "info": info, "i4modes": i4m, "mv": mv,
            "ref": ref, "qp": qp, "coeffs": coeffs, "ncoef": ncoef,
            "mv1": mv1, "ref1": ref1,
            "end_bit": int(end[0]), "last_mb": int(end[1])}


def h264_encode_slice_cabac(res: dict, mb_w: int, mb_h: int,
                            slice_type: int, slice_qp: int,
                            num_ref_idx_l0: int,
                            cabac_init_idc: int = 0,
                            num_ref_idx_l1: int = 1,
                            transform_8x8_mode: bool = False) -> bytes:
    """Encode per-MB tensors as CABAC slice data (alignment handled by
    caller; returned bytes start at the first arithmetic byte)."""
    lib = get()
    assert lib is not None
    nmb = mb_w * mb_h
    cap = int(res["coeffs"].size) * 4 + nmb * 16 + 65536
    out = np.zeros(cap, np.uint8)
    end = np.zeros(2, np.int32)
    r = lib.h264_cabac_slice(
        1, _u8(np.zeros(1, np.uint8)), 0, 0, _u8(out), cap,
        mb_w, mb_h, 0, slice_type, slice_qp, num_ref_idx_l0,
        cabac_init_idc,
        _i32(np.ascontiguousarray(res["kind"], np.int32)),
        _i32(np.ascontiguousarray(res["info"], np.int32)),
        _i8(np.ascontiguousarray(res["i4modes"], np.int8)),
        _i16(np.ascontiguousarray(res["mv"], np.int16)),
        _i8(np.ascontiguousarray(res["ref"], np.int8)),
        _i32(np.ascontiguousarray(res["qp"], np.int32)),
        _i16(np.ascontiguousarray(res["coeffs"], np.int16)),
        _i16(np.ascontiguousarray(res["ncoef"], np.int16)), _i32(end),
        num_ref_idx_l1,
        _i16(np.ascontiguousarray(
            res.get("mv1", np.zeros((nmb, 16, 2), np.int16)), np.int16)),
        _i8(np.ascontiguousarray(
            res.get("ref1", np.full((nmb, 4), -1, np.int8)), np.int8)),
        int(transform_8x8_mode))
    if r < 0:
        raise RuntimeError(f"h264: CABAC slice encode failed ({r})")
    return out[:int(end[0])].tobytes()
