"""MPEG-4 part 2 (Simple Profile) video encoder.

Port of librempeg_tpu/codecs/mpeg4/encoder.py. The device half runs on
tensors on the encoder's device: integer full search
(ops.motion.full_search_mc_xla), half-pel refinement + MC (the half-pel
kernel, codecs/mpeg4/me_pallas.py), the spec DCT and H.263 quantiser or
the trellis (RD) quantiser (codecs/mpeg4/trellis.py), in-loop
reconstruction, and the compaction of the coded levels for the host
fetch (_sparsify_slim / _sparsify_fat). The in-loop reference is the
picture the decoder (codecs/mpeg4/_decoder.py) rebuilds from the
written bits: its dequantiser with int16 storage and its simple_idct
(_idct_int) on the integer prediction, so a decode does not drift
along the GOP. (The JAX package keeps a float recon from the spec
IDCT, which its decoder never has.) B-VOPs (-bf) take a plain-torch
pass (_encode_b_device: the searches against both anchors and the
residuals of the four prediction modes). The host half (DC and MV
prediction, VLC packing in native/mpeg4.cpp, B-VOP mode decision and
packing, anchor-group scheduling, rate control) is the JAX package's,
copied unchanged.

Simple-profile choices: quant_type=0 (H.263 quantizer), I/P GOP
structure (Advanced Simple VOL with B-VOPs), half-pel MVs with
vop_rounding_type 0, ac_pred off, resync markers off. The multi-device
(-mesh) path is not ported yet.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from librempeg_tpu_torch.codecs.api import CodecInfo, Encoder, register_encoder
from librempeg_tpu_torch.codecs.mpeg4 import me_pallas as MEP
from librempeg_tpu_torch.codecs.mpeg4 import tables as T
from librempeg_tpu_torch.codecs.mpeg4 import trellis as rdq
from librempeg_tpu_torch.codecs.mpeg4._decoder import _int_idct_matrix
from librempeg_tpu_torch.codecs.mpeg4.bits import BitWriter
from librempeg_tpu_torch.core.errors import InvalidData, Unsupported
from librempeg_tpu_torch.core.frame import VideoFrame
from librempeg_tpu_torch.core.options import Option, OptionTable
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import NOPTS, Rational
from librempeg_tpu_torch.device import resolve
from librempeg_tpu_torch.ops import dct8x8, motion
from librempeg_tpu_torch.ops.fdiv import fdiv

# ---------------------------------------------------------------------------
# Device passes
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _spec_dct_scale() -> np.ndarray:
    """Orthonormal-DCT -> ISO 8x8 DCT coefficient scaling, derived
    numerically exactly as the JAX package's JPEG encoder derives it
    (jpeg/encoder._verify_scale), so both packages use the same float32
    table."""
    rng = np.random.default_rng(0)
    # JPEG reference DCT: S(k,l)=1/4 C(k)C(l) sum x cos cos
    j = np.arange(8)
    cos = np.cos((2 * j[None, :] + 1) * j[:, None] * np.pi / 16)
    cmat = np.ones(8)
    cmat[0] = 1 / np.sqrt(2)
    x = rng.standard_normal((8, 8))
    jpeg = 0.25 * np.outer(cmat, cmat) * (cos @ x @ cos.T)
    B = dct8x8._ortho_basis()
    ortho = B @ x @ B.T
    with np.errstate(divide="ignore", invalid="ignore"):
        s = jpeg / ortho
    s[~np.isfinite(s)] = 1.0
    return s.astype(np.float32)


_SCALES: dict = {}


def _scale_basis(like: torch.Tensor) -> tuple:
    """The spec scale table and the orthonormal DCT basis, float64 on
    `like`'s device, uploaded once."""
    key = str(like.device)
    s = _SCALES.get(key)
    if s is None:
        s = _SCALES[key] = (
            torch.as_tensor(_spec_dct_scale(), dtype=torch.float64,
                            device=like.device),
            torch.as_tensor(dct8x8._ortho_basis(), dtype=torch.float64,
                            device=like.device))
    return s


def _fdct_spec(x: torch.Tensor) -> torch.Tensor:
    """[B, 8, 8] pixels or residuals -> spec DCT coefficients (float32),
    computed in float64 and rounded once. With the integer reference
    the residuals are integers, and their DCT often lands exactly on a
    quantiser's threshold; a float32 GEMM settles such a tie by its
    summation order, which differs between the card and the CPU, where
    the float64 value rounds to the same float32 on every device."""
    scale, c = _scale_basis(x)
    return ((c @ x.to(torch.float64) @ c.T) * scale).to(torch.float32)


_IDCT_M: dict = {}


def _idct_matrix(like: torch.Tensor) -> torch.Tensor:
    """The decoder's simple_idct pass matrix (_decoder._int_idct_matrix)
    as float64 on `like`'s device, uploaded once."""
    key = str(like.device)
    m = _IDCT_M.get(key)
    if m is None:
        m = _IDCT_M[key] = torch.as_tensor(
            _int_idct_matrix(), dtype=torch.float64, device=like.device)
    return m


def _wrap16(x: torch.Tensor) -> torch.Tensor:
    """int16 storage wrap of the decoder's coefficient blocks."""
    return torch.remainder(x + 32768, 65536) - 32768


def _idct_int(deq: torch.Tensor) -> torch.Tensor:
    """[..., 8, 8] dequantised coefficients -> the residual the decoder
    reconstructs (_decoder.idct_simple: the row pass's DC-only shortcut,
    int16 row storage, the column pass), as float32 integers.

    Two float64 matrix products: every input is an int16, every entry of
    the matrix under 2^15, so each partial sum of a pass stays under
    8 * 2^15 * 2^15 = 2^33 < 2^53 and float64 is exact in any summation
    order (float32 would not be: its sums pass 2^24)."""
    m = _idct_matrix(deq)
    x = deq.to(torch.float64)
    rows = torch.floor((x @ m.T + 1024.0) * (1.0 / 2048.0))
    dconly = (x[..., 1:] == 0).all(dim=-1, keepdim=True)
    rows = _wrap16(torch.where(dconly, x[..., :1] * 8.0, rows))
    rows[..., 0, :] += float((1 << 19) // 16383)
    return torch.floor((m @ rows) * (1.0 / (1 << 20))).to(torch.float32)


def _dequant(level: torch.Tensor, qscale: int) -> torch.Tensor:
    """H.263 dequantisation (what the decoder reconstructs, in its int16
    storage)."""
    even = 1 - (qscale & 1)
    lv = level.to(torch.int64)
    deq = torch.sign(lv) * (qscale * (2 * lv.abs() + 1) - even)
    return _wrap16(torch.where(lv != 0, deq, 0)).to(torch.float32)


def _intra_dc(dc_level: torch.Tensor, dc_scale: int) -> torch.Tensor:
    """The intra DC coefficient the decoder reconstructs."""
    return _wrap16(dc_level.to(torch.int64) * dc_scale).to(torch.float32)


def _quant_intra(coeffs, qscale: int, dc_scale: int):
    """H.263-style intra quant. Returns (dc_level, ac_levels, recon): the
    recon is the decoder's (_idct_int), unclamped."""
    dc_level = torch.round(fdiv(coeffs[..., 0, 0], dc_scale)).to(torch.int32)
    ac_level = torch.trunc(fdiv(coeffs, 2.0 * qscale)).to(torch.int32) \
        .clamp(-2047, 2047)
    ac_level[..., 0, 0] = 0
    deq = _dequant(ac_level, qscale)
    deq[..., 0, 0] = _intra_dc(dc_level, dc_scale)
    return dc_level, ac_level, _idct_int(deq)


def _inter_levels(coeffs, qscale: int) -> torch.Tensor:
    """H.263-style inter quant with dead zone: the levels."""
    mag = torch.trunc(fdiv(coeffs.abs() - qscale / 2.0, 2.0 * qscale))
    return (torch.sign(coeffs) * mag.clamp(min=0.0)).to(torch.int32) \
        .clamp(-2047, 2047)


def _quant_inter(coeffs, qscale: int):
    """H.263-style inter quant with dead zone. Returns (levels, the
    decoder's residual)."""
    level = _inter_levels(coeffs, qscale)
    return level, _idct_int(_dequant(level, qscale))


_ZZ: dict = {}


def _zz_index(dev) -> torch.Tensor:
    """The zigzag scan as an index tensor on `dev`, uploaded once."""
    key = str(dev)
    zz = _ZZ.get(key)
    if zz is None:
        zz = _ZZ[key] = torch.as_tensor(np.asarray(T.ZIGZAG, np.int64),
                                        device=dev)
    return zz


def _zigzag(level: torch.Tensor) -> torch.Tensor:
    """[..., 8, 8] levels -> [nblk, 64] int16 in zigzag order."""
    return level.reshape(-1, 64)[:, _zz_index(level.device)] \
        .to(torch.int16)


def _dequant_recon(zz_levels: torch.Tensor, qscale: int) -> torch.Tensor:
    """Inverse-zigzag + H.263 AC dequant -> [nblk, 8, 8] ISO coeffs (the
    DC slot holds whatever zz_levels[:, 0] dequantizes to; intra callers
    overwrite it)."""
    lev = torch.zeros_like(zz_levels)
    lev[:, _zz_index(zz_levels.device)] = zz_levels
    return _dequant(lev, qscale).reshape(-1, 8, 8)


def _quant_rd(coeffs: list, qscale: int, intra: bool) -> list:
    """Trellis (RD) levels [nblk, 64] (zigzag order) of each plane's
    [..., 8, 8] coefficients. The planes share the quantiser and the RL
    table, so one lattice (trellis.quantize_rd) serves all three; its
    blocks are independent, so the levels are those of one call per
    plane."""
    dev = coeffs[0].device
    zzc = torch.cat([c.reshape(-1, 64)[:, _zz_index(dev)] for c in coeffs])
    zz = rdq.quantize_rd(zzc, qscale, intra, 1 if intra else 0)
    return list(zz.split([c.numel() // 64 for c in coeffs]))


def _encode_i_device(y, u, v, qscale: int, dcs_luma: int, dcs_chroma: int,
                     trellis: bool = False):
    """I-VOP pass over one frame's planes. Returns per plane
    (dc_levels [bh, bw], ac_zz [nblk, 64] int16, recon plane f32)."""
    names = ("y", "u", "v")
    planes = [x.to(torch.float32) for x in (y, u, v)]
    coeffs = [_fdct_spec(dct8x8.to_blocks(p)) for p in planes]
    rd = _quant_rd(coeffs, qscale, True) if trellis else None
    out = {}
    for i, (name, p, c) in enumerate(zip(names, planes, coeffs)):
        h, w = p.shape
        dcs = dcs_chroma if i else dcs_luma
        if trellis:
            # DC as in _quant_intra, AC levels from the lattice
            dc = torch.round(fdiv(c[..., 0, 0], dcs)).to(torch.int32)
            deq = _dequant_recon(rd[i], qscale)
            deq[:, 0, 0] = _intra_dc(dc.reshape(-1), dcs)
            recon = _idct_int(deq).reshape(c.shape)
            zz = rd[i].to(torch.int16)
        else:
            dc, ac, recon = _quant_intra(c, qscale, dcs)
            zz = _zigzag(ac)
        out[name] = (dc.reshape(h // 8, w // 8), zz,
                     dct8x8.from_blocks(recon, h, w).clamp(0, 255))
    return out


def _encode_p_device(y, u, v, ref_y, ref_u, ref_v, qscale: int,
                     search_range: int = 8, trellis: bool = False):
    """P-VOP pass: even-pel integer full search, half-pel refinement +
    MC of all planes (the half-pel kernel), residual transform coding
    and in-loop recon. MVs are in HALF-PEL units."""
    yf = y.to(torch.float32)[None]
    mv_i, _, _ = motion.full_search_mc_xla(
        yf, ref_y.to(torch.float32)[None], search_range, 16, 2)
    mvh, pred_y, pred_u, pred_v = MEP.hpel_refine_mc(
        yf[0], ref_y, ref_u, ref_v, mv_i[0], rnd=0)
    out = {"mv": mvh}
    planes = (yf[0], u.to(torch.float32), v.to(torch.float32))
    preds = (pred_y, pred_u, pred_v)
    coeffs = [_fdct_spec(dct8x8.to_blocks(p - pred))
              for p, pred in zip(planes, preds)]
    rd = _quant_rd(coeffs, qscale, False) if trellis else None
    for i, (name, p, pred, c) in enumerate(zip("yuv", planes, preds,
                                               coeffs)):
        h, w = p.shape
        if trellis:
            rec_res = _idct_int(_dequant_recon(rd[i], qscale)) \
                .reshape(c.shape)
            zz = rd[i].to(torch.int16)
        else:
            level, rec_res = _quant_inter(c, qscale)
            zz = _zigzag(level)
        recon = (pred + dct8x8.from_blocks(rec_res, h, w)).clamp(0, 255)
        out[name] = (zz, recon)
    return out


def _encode_b_device(y, u, v, fy, fu, fv, by_, bu, bv_, qscale: int,
                     dmvf, dmvb, search_range: int = 8):
    """B-VOP pass: even-pel ME with half-pel refinement against BOTH
    anchors, and the residual levels of the forward, backward,
    bidirectional and direct candidates; the host picks the per-MB mode
    from the returned SAD costs. Plain tensor code (the JAX package runs
    it in XLA, outside any Pallas kernel)."""
    f32 = torch.float32
    yf = y.to(f32)[None]
    mvf, cost_f, pred_fy = motion.full_search_mc_hpel(
        yf, fy.to(f32)[None], search_range, 16, 0, 2)
    mvb, cost_b, pred_by = motion.full_search_mc_hpel(
        yf, by_.to(f32)[None], search_range, 16, 0, 2)
    pred_biy = torch.floor((pred_fy + pred_by + 1.0) * 0.5)
    h, w = y.shape
    # bidir luma SAD per MB
    cost_bi = (yf - pred_biy).abs()[0].reshape(h // 16, 16, w // 16, 16) \
        .sum(dim=(1, 3))
    # direct-mode candidate: prediction at the TRB/TRD-scaled colocated
    # MVs (zero delta), averaged like the decoder
    dpad = search_range + 2
    pred_dfy = motion.mc_hpel(fy.to(f32)[None], dmvf, 16, dpad, 0)
    pred_dby = motion.mc_hpel(by_.to(f32)[None], dmvb, 16, dpad, 0)
    pred_dy = torch.floor((pred_dfy + pred_dby + 1.0) * 0.5)
    cost_d = (yf - pred_dy).abs()[0].reshape(h // 16, 16, w // 16, 16) \
        .sum(dim=(1, 3))
    out = {"mvf": mvf[0], "mvb": mvb[0], "cost_f": cost_f[0],
           "cost_b": cost_b[0], "cost_bi": cost_bi, "cost_d": cost_d}
    mvf_c, mvb_c = MEP._chroma_mv(mvf), MEP._chroma_mv(mvb)
    dmvf_c, dmvb_c = MEP._chroma_mv(dmvf), MEP._chroma_mv(dmvb)
    cpad = search_range // 2 + 2
    preds = {"f": {"y": pred_fy[0]}, "b": {"y": pred_by[0]},
             "bi": {"y": pred_biy[0]}, "d": {"y": pred_dy[0]}}
    for cname, (rf, rb) in (("u", (fu, bu)), ("v", (fv, bv_))):
        rf, rb = rf.to(f32)[None], rb.to(f32)[None]
        pf = motion.mc_hpel(rf, mvf_c, 8, cpad, 0)[0]
        pb = motion.mc_hpel(rb, mvb_c, 8, cpad, 0)[0]
        pdf = motion.mc_hpel(rf, dmvf_c, 8, search_range + 2, 0)[0]
        pdb = motion.mc_hpel(rb, dmvb_c, 8, search_range + 2, 0)[0]
        preds["f"][cname] = pf
        preds["b"][cname] = pb
        preds["bi"][cname] = torch.floor((pf + pb + 1.0) * 0.5)
        preds["d"][cname] = torch.floor((pdf + pdb + 1.0) * 0.5)
    for mode in ("f", "b", "bi", "d"):
        for name, plane in (("y", y), ("u", u), ("v", v)):
            resid = plane.to(f32) - preds[mode][name]
            level = _inter_levels(_fdct_spec(dct8x8.to_blocks(resid)),
                                  qscale)
            out[f"{mode}_{name}"] = _zigzag(level)
    return out


#: the order of _encode_b_device's outputs in the one host fetch
_B_LEVELS = tuple(f"{m}_{p}" for m in ("f", "b", "bi", "d") for p in "yuv")
_B_MAPS = ("mvf", "mvb", "cost_f", "cost_b", "cost_bi", "cost_d")


def _pack_b_outputs(out: dict) -> torch.Tensor:
    """_encode_b_device's 12 level arrays, 2 MV fields and 4 cost maps
    as one int16 tensor (MVs and the integer-valued costs as int32
    halves), so the host fetch is one copy."""
    parts = [out[k].reshape(-1) for k in _B_LEVELS]
    parts += [_as_i16(out[k].reshape(-1)) for k in _B_MAPS]
    return torch.cat(parts)


def _unpack_b_outputs(flat: np.ndarray, mb_h: int, mb_w: int) -> dict:
    """The host side of _pack_b_outputs."""
    nby, nbc = 4 * mb_h * mb_w, mb_h * mb_w
    out, o = {}, 0
    for k in _B_LEVELS:
        n = nby if k.endswith("y") else nbc
        out[k] = flat[o:o + n * 64].reshape(n, 64)
        o += n * 64
    for k in _B_MAPS:
        n = 2 * mb_h * mb_w * (2 if k.startswith("mv") else 1)
        v = flat[o:o + n].view(np.int32)
        o += n
        out[k] = v.reshape(mb_h, mb_w, 2) if k.startswith("mv") \
            else v.reshape(mb_h, mb_w).astype(np.float32)
    return out


def _as_i16(x: torch.Tensor) -> torch.Tensor:
    """int32 values -> their little-endian int16 halves (bit cast)."""
    return x.to(torch.int32).contiguous().view(torch.int16)


def _pack_i8_pairs(x8: torch.Tensor) -> torch.Tensor:
    """[n] int32 byte values -> [n/2] int16 (little-endian pair pack);
    the host recovers them with ndarray.view(int8)."""
    lo = x8[0::2] & 0xFF
    hi = x8[1::2] & 0xFF
    return _as_i16(lo | (hi << 8))[0::2]


def _nonzero_fixed(mask: torch.Tensor, size: int) -> torch.Tensor:
    """jnp.flatnonzero(mask, size=size, fill_value=0) as int32."""
    nz = torch.nonzero(mask.reshape(-1)).reshape(-1)[:size]
    return F.pad(nz, (0, size - nz.numel())).to(torch.int32)


def _sparsify_fat(zz, cap: int, ecap: int):
    """Worst-case compaction of coded coefficients for the fetch (always
    correct; I frames and slim-overflow retries): coded blocks first,
    then the nonzero elements of those blocks, mapped back to
    dense-tensor positions.

    zz [nblk, 64] int16. Returns int16 parts
    [pos_as_2xi16 (2*ecap), vals (ecap), counts (4xi16)]."""
    dev = zz.device
    coded = (zz != 0).any(dim=1)
    cnt_b = coded.sum()
    bids = _nonzero_fixed(coded, cap)
    rows = zz[bids.long()]
    # padding slots re-read block 0: zero them so the element stage
    # doesn't count replicated coefficients
    rows = torch.where((torch.arange(cap, device=dev) < cnt_b)[:, None],
                       rows, 0)
    flat = rows.reshape(-1)
    cnt_e = (flat != 0).sum()
    pos = _nonzero_fixed(flat != 0, ecap)
    vals = flat[pos.long()].to(torch.int16)
    gpos = bids[(pos // 64).long()] * 64 + pos % 64    # dense positions
    counts = _as_i16(torch.stack([cnt_b, cnt_e]))
    return [_as_i16(gpos), vals, counts]


# slim-path tail capacity: blocks with any coefficient beyond zigzag 31
_SLIM_TCAP = 768


def _sparsify_slim(zz):
    """Dense-band fetch layout sized for typical P frames: the zigzag
    band 0..31 ships dense as two packed int8 planes (low/high bytes)
    and the host's C loops find the nonzeros; only the rare tail past
    zigzag 31 moves as compacted whole rows.

    zz [nblk, 64] int16, nblk even multiple of 16. Returns int16 parts
    [lo (nblk*16), hi (nblk*16), tslot (T), trows (T*32), counts
    (2xi16)]."""
    dev = zz.device
    band = zz[:, :32].to(torch.int32).reshape(-1)
    lo = _pack_i8_pairs(band)
    hi = _pack_i8_pairs(band >> 8)
    tail = (zz[:, 32:] != 0).any(dim=1)
    cnt_t = tail.sum()
    tslot = _nonzero_fixed(tail, _SLIM_TCAP)
    trows = zz[tslot.long(), 32:]
    trows = torch.where(
        (torch.arange(_SLIM_TCAP, device=dev) < cnt_t)[:, None], trows, 0)
    return [lo, hi, tslot.to(torch.int16), trows.reshape(-1),
            _as_i16(cnt_t.reshape(1))]


def _packed(zz_blocks, tail, slim: bool, cap: int = 0, ecap: int = 0):
    """The one host fetch of a pass: the coded levels zz_blocks [nblk,
    64] in the slim or the fat layout (caps cap, ecap), then `tail`
    (an I-VOP's DC levels, a P-VOP's MVs) as int16."""
    parts = _sparsify_slim(zz_blocks) if slim else \
        _sparsify_fat(zz_blocks, cap, ecap)
    return torch.cat(parts + [tail])


def _encode_i_packed(y, u, v, qscale, dcs_luma, dcs_chroma, cap, ecap,
                     trellis=False):
    """I-VOP pass returning (packed int16, recon planes, levels): all
    host-side data (sparse zz coefficients + dc levels) in ONE array, so
    the host fetch is one small copy per frame; `levels` (the dense
    levels and the DC tail) re-packs the same pass in another layout."""
    out = _encode_i_device(y, u, v, qscale, dcs_luma, dcs_chroma, trellis)
    levels = (torch.cat([out[k][1] for k in ("y", "u", "v")]),
              torch.cat([out[k][0].reshape(-1).to(torch.int16)
                         for k in ("y", "u", "v")]))
    return (_packed(*levels, False, cap, ecap),
            (out["y"][2], out["u"][2], out["v"][2]), levels)


def _encode_p_packed(y, u, v, ry, ru, rv, qscale, search_range, slim,
                     cap=0, ecap=0, trellis=False):
    out = _encode_p_device(y, u, v, ry, ru, rv, qscale, search_range,
                           trellis)
    levels = (torch.cat([out["y"][0], out["u"][0], out["v"][0]]),
              out["mv"].reshape(-1).to(torch.int16))
    return (_packed(*levels, slim, cap, ecap),
            (out["y"][1], out["u"][1], out["v"][1]), levels)


def _dc_predict(dc_levels: np.ndarray, scaler: int,
                intra_mask: np.ndarray | None = None) -> np.ndarray:
    """Spec DC prediction (ISO 14496-2 §7.4.3): gradient rule over
    dequantized DCs; non-intra/outside neighbors read as 1024.
    Fully vectorized (prediction is causal but reads only stored
    neighbor values, not running state). Returns diff levels."""
    deq = dc_levels.astype(np.int64) * scaler
    if intra_mask is not None:
        deq = np.where(intra_mask, deq, 1024)
    pad = np.full((deq.shape[0] + 1, deq.shape[1] + 2), 1024, np.int64)
    pad[1:, 1:-1] = deq
    A = pad[1:, :-2]      # left
    B = pad[:-1, :-2]     # top-left
    C = pad[:-1, 1:-1]    # top
    pred_val = np.where(np.abs(A - B) < np.abs(B - C), C, A)
    pred_level = (pred_val + scaler // 2) // scaler
    return (dc_levels.astype(np.int64) - pred_level).astype(np.int32)


def _put_dc(bw: BitWriter, diff: int, chroma: bool) -> None:
    size = int(abs(int(diff))).bit_length()
    code, bits = (T.DC_CHROM if chroma else T.DC_LUM)[size]
    bw.put(code, bits)
    if size:
        v = diff if diff > 0 else diff + (1 << size) - 1
        bw.put(v, size)
        if size > 8:
            bw.put(1, 1)


def _put_coeffs(bw: BitWriter, zz: np.ndarray, first: int, intra: bool
                ) -> None:
    """Encode one block's zigzag coefficients from index `first`."""
    idx = T.INTRA_RL_INDEX if intra else T.INTER_RL_INDEX
    nz = np.nonzero(zz[first:])[0]
    if len(nz) == 0:
        return
    run = 0
    positions = nz + first
    for k, pos in enumerate(positions):
        level = int(zz[pos])
        run = int(pos - (positions[k - 1] if k else first - 1) - 1)
        last = 1 if k == len(positions) - 1 else 0
        key = (last, run, abs(level))
        ent = idx.get(key)
        if ent is not None:
            code, bits = ent
            bw.put(code, bits)
            bw.put(1 if level < 0 else 0, 1)
        else:
            bw.put(T.ESCAPE_CODE, T.ESCAPE_BITS)
            bw.put(0b11, 2)                  # escape type 3
            bw.put(last, 1)
            bw.put(run, 6)
            bw.put(1, 1)                     # marker
            bw.put_signed(level, 12)
            bw.put(1, 1)                     # marker


def _put_mv(bw: BitWriter, d: int) -> None:
    """One MV component difference, half-pel units, f_code=1."""
    if d < -32:
        d += 64
    elif d > 31:
        d -= 64
    code, bits = T.MVTAB[abs(d)]
    bw.put(code, bits)
    if d:
        bw.put(1 if d < 0 else 0, 1)


class _Mpeg4Packer:
    """Assembles headers + macroblock layer."""

    def __init__(self, width, height, fps: Rational, qscale: int,
                 bframes: bool = False):
        self.w, self.h = width, height
        self.fps = fps
        self.bframes = bframes
        self.qscale = qscale
        self.last_sec = 0
        self.prev_sec = 0
        # time resolution = fps numerator (ticks of fps.den per frame)
        self.time_res = max(1, fps.num)
        self.inc_bits = max(1, int(self.time_res - 1).bit_length())

    def sequence_headers(self) -> bytes:
        bw = BitWriter()
        bw.put(0x000001B0, 32)     # visual_object_sequence
        bw.put(0x01, 8)            # profile/level: simple L1
        bw.put(0x000001B5, 32)     # visual_object
        bw.put(0, 1)               # is_visual_object_identifier
        bw.put(1, 4)               # visual_object_type: video
        bw.put(0, 1)               # video_signal_type
        bw.align_stuffing()
        bw.put(0x00000100, 32)     # video_object
        bw.put(0x00000120, 32)     # video_object_layer
        bw.put(0, 1)               # random_accessible_vol
        # ASP object type when B-VOPs are in use (like the reference)
        bw.put(17 if self.bframes else 1, 8)
        bw.put(0, 1)               # is_object_layer_identifier
        bw.put(1, 4)               # aspect_ratio_info: square
        if self.bframes:
            bw.put(1, 1)           # vol_control_parameters
            bw.put(1, 2)           # chroma_format 4:2:0
            bw.put(0, 1)           # low_delay: B-VOPs reorder
            bw.put(0, 1)           # vbv_parameters
        else:
            bw.put(0, 1)           # vol_control_parameters
        bw.put(0, 2)               # shape: rectangular
        bw.put(1, 1)               # marker
        bw.put(self.time_res, 16)
        bw.put(1, 1)               # marker
        bw.put(0, 1)               # fixed_vop_rate
        bw.put(1, 1)               # marker
        bw.put(self.w, 13)
        bw.put(1, 1)
        bw.put(self.h, 13)
        bw.put(1, 1)
        bw.put(0, 1)               # interlaced
        bw.put(1, 1)               # obmc_disable
        bw.put(0, 1)               # sprite_enable
        bw.put(0, 1)               # not_8_bit
        bw.put(0, 1)               # quant_type: H.263
        bw.put(1, 1)               # complexity_estimation_disable
        bw.put(1, 1)               # resync_marker_disable
        bw.put(0, 1)               # data_partitioned
        bw.put(0, 1)               # scalability
        bw.align_stuffing()
        return bw.bytes()

    def vop(self, bw: BitWriter, coding_type: int, frame_idx: int,
            qscale: int | None = None) -> None:
        bw.put(0x000001B6, 32)
        bw.put(coding_type, 2)     # 0 = I, 1 = P, 2 = B
        # time: seconds elapsed as modulo_time_base '1's. B-VOPs code
        # their modulo relative to the PREVIOUS non-B time base (the
        # decoder's last_time_base), non-B ones advance the base.
        total_ticks = frame_idx * self.fps.den
        sec = total_ticks // self.time_res
        if coding_type == 2:
            for _ in range(max(0, sec - self.prev_sec)):
                bw.put(1, 1)
        else:
            for _ in range(sec - self.last_sec):
                bw.put(1, 1)
            self.prev_sec = self.last_sec
            self.last_sec = sec
        bw.put(0, 1)
        bw.put(1, 1)               # marker
        bw.put(total_ticks % self.time_res, self.inc_bits)
        bw.put(1, 1)               # marker
        bw.put(1, 1)               # vop_coded
        if coding_type == 1:
            bw.put(0, 1)           # vop_rounding_type
        bw.put(0, 3)               # intra_dc_vlc_thr: always DC VLC
        bw.put(qscale if qscale is not None else self.qscale, 5)
        if coding_type == 1:
            bw.put(1, 3)           # vop_fcode_forward
        elif coding_type == 2:
            bw.put(1, 3)           # vop_fcode_forward
            bw.put(1, 3)           # vop_fcode_backward


class RateController:
    """Single-pass rate control (the role of the reference's
    ratecontrol.c in one-pass CBR mode): a bits*q complexity model per
    frame type predicts the quantizer that hits the per-frame budget; a
    leaky virtual buffer adds integral correction. I frames spend a
    fixed multiple of the per-frame budget."""

    I_COST = 3.0          # relative I-frame budget at equal quality

    def __init__(self, bit_rate: int, fps: Rational, gop: int):
        self.fps = max(1.0, fps.num / max(1, fps.den))
        self.gop = max(1, gop)
        per_gop = bit_rate / self.fps * self.gop
        unit = per_gop / (self.I_COST + (self.gop - 1))
        self.p_budget = max(1.0, unit)
        self.i_budget = max(1.0, unit * self.I_COST)
        # complexity = bits * q (approximately constant per frame type)
        self.c_i = self.i_budget * 8.0
        self.c_p = self.p_budget * 8.0
        self.buffer = 0.0             # bits over (+) / under (-) target
        self._last_q = 8

    def pick_qscale(self, is_i: bool) -> int:
        budget = self.i_budget if is_i else self.p_budget
        # drain the buffer over roughly one GOP
        eff = budget - self.buffer / self.gop
        eff = max(budget * 0.3, min(budget * 3.0, eff))
        c = self.c_i if is_i else self.c_p
        q = c / eff
        self._last_q = int(max(2, min(31, round(q))))
        return self._last_q

    def update(self, bits: float, is_i: bool) -> None:
        budget = self.i_budget if is_i else self.p_budget
        self.buffer += bits - budget
        c = bits * self._last_q
        if is_i:
            self.c_i = 0.5 * self.c_i + 0.5 * c
        else:
            self.c_p = 0.7 * self.c_p + 0.3 * c


@register_encoder
class Mpeg4Encoder(Encoder):
    INFO = CodecInfo(name="mpeg4", long_name="MPEG-4 part 2 (Simple Profile)",
                     codec_type="video")
    OPTIONS = OptionTable(
        Option("qscale", int, 4, min=1, max=31),
        Option("gop_size", int, 12, alias="g", min=1, max=600),
        Option("search_range", int, 8, min=2, max=16),
        Option("bit_rate", int, 0, alias="b", min=0, max=1 << 30,
               help="target bitrate (bits/s); 0 = constant qscale"),
        Option("max_b_frames", int, 0, alias="bf", min=0, max=4,
               help="B-frames between anchors (fwd/bwd/bidir modes)"),
        Option("trellis", int, 0, min=0, max=2,
               help="RD (trellis) coefficient quantization on I/P"),
    )

    def __init__(self, width=0, height=0, pix_fmt="yuv420p",
                 framerate: Rational = Rational(25, 1), device="cuda",
                 **opts):
        super().__init__(**opts)
        self.device = resolve(device)
        self._pad_w = (16 - width % 16) % 16
        self._pad_h = (16 - height % 16) % 16
        self.width, self.height = width, height
        self.cw, self.ch = width + self._pad_w, height + self._pad_h
        self.pix_fmt = pix_fmt
        self.framerate = framerate
        self.time_base = Rational(framerate.den, framerate.num)
        self._packer = None
        self._rc = None
        self._frame_idx = 0
        self._ref = None  # (y, u, v) recon planes on the device
        self._next_pts = 0
        # B-frame state
        self._pending: list = []        # buffered (frame, display index)
        self._prev_anchor = None        # older anchor recon
        self._disp_idx = 0
        self._decode_idx = 0
        self._anchor_skip = None        # future-anchor MB skip mask
        self._anchor_mvs = None         # future-anchor half-pel MVs
        self._prev_anchor_disp = 0
        self._cur_anchor_disp = 0
        #: set to a list to collect each frame's in-loop recon PSNR (dB,
        #: all three planes) against its input, computed at fetch time
        self.recon_psnr = None

    def codec_parameters(self):
        from librempeg_tpu_torch.formats.api import CodecParameters

        return CodecParameters(
            codec_type="video", codec_id="mpeg4",
            width=self.width, height=self.height, pix_fmt="yuv420p",
            framerate=self.framerate)

    def encode(self, frame: VideoFrame):
        if self.opts["max_b_frames"]:
            return self._encode_with_b(frame)
        return self.encode_finish(self.encode_async(frame))

    # ---- B-frame scheduling (display buffering + decode-order emit)
    def _encode_with_b(self, frame: VideoFrame):
        bf = self.opts["max_b_frames"]
        d = self._disp_idx
        self._disp_idx += 1
        is_i = d % self.opts["gop_size"] == 0 or self._ref is None
        if is_i or len(self._pending) >= bf:
            return self._emit_anchor_group(frame, d, is_i)
        self._pending.append((frame, d))
        return []

    def _emit_anchor_group(self, frame, d, is_i):
        prev_anchor = self._ref
        self._prev_anchor_disp = self._cur_anchor_disp
        self._cur_anchor_disp = d
        h = self.encode_async(frame, force_type="I" if is_i else "P",
                              display_idx=d)
        pkts = self.encode_finish(h)
        pkts[0] = pkts[0].replace(dts=self._decode_idx)
        self._decode_idx += 1
        for bframe, bd in self._pending:
            pkt = self._encode_bvop(bframe, bd, prev_anchor, self._ref)
            pkts.append(pkt.replace(dts=self._decode_idx))
            self._decode_idx += 1
        self._pending = []
        self._prev_anchor = prev_anchor
        return pkts

    def _encode_bvop(self, frame, d, fwd_refs, bwd_refs) -> Packet:
        y, u, v = self._planes(frame)
        q = self._packer.qscale if self._rc is None else \
            self._rc.pick_qscale(False)
        dmvf, dmvb = self._direct_mvs(d)
        dev = self.device
        out = _encode_b_device(
            y, u, v, *fwd_refs, *bwd_refs, q,
            torch.from_numpy(dmvf).to(dev)[None],
            torch.from_numpy(dmvb).to(dev)[None], self.opts["search_range"])
        mb_w, mb_h = self.cw // 16, self.ch // 16
        out = _unpack_b_outputs(_pack_b_outputs(out).cpu().numpy(), mb_h,
                                mb_w)
        bw = BitWriter()
        self._packer.vop(bw, 2, d, q)
        body = self._pack_b(bw, out, q)
        pkt = Packet(data=body, pts=d, dts=d, duration=1,
                     time_base=self.time_base)
        if self._rc is not None:
            self._rc.update(len(body) * 8, False)
        return pkt

    def _direct_mvs(self, d):
        """TRB/TRD-scaled colocated MVs (zero delta) for direct mode;
        matches the decoder's C-truncating scaling (np.fix)."""
        mb_w, mb_h = self.cw // 16, self.ch // 16
        pmv = self._anchor_mvs
        if pmv is None:
            pmv = np.zeros((mb_h, mb_w, 2), np.int32)
        trb = d - self._prev_anchor_disp
        trd = self._cur_anchor_disp - self._prev_anchor_disp
        p = pmv.astype(np.int64)
        fwd = np.fix(p * trb / trd).astype(np.int32)
        bwd = np.fix(p * (trb - trd) / trd).astype(np.int32)
        return fwd, bwd

    def _pack_b(self, bw: BitWriter, out, q: int) -> bytes:
        """B-VOP macroblock layer: per-MB mode decision between direct,
        forward, backward and bidirectional 16x16 prediction;
        colocated-skipped MBs (in the future anchor) are not coded."""
        mb_w, mb_h = self.cw // 16, self.ch // 16
        nbx = mb_w * 2
        mvf, mvb = out["mvf"], out["mvb"]                  # half-pel
        cost_f, cost_b = out["cost_f"], out["cost_b"]
        cost_bi, cost_d = out["cost_bi"], out["cost_d"]
        zz = {m: {p: out[f"{m}_{p}"] for p in ("y", "u", "v")}
              for m in ("f", "b", "bi", "d")}
        co_skip = self._anchor_skip
        if co_skip is None:
            co_skip = np.zeros((mb_h, mb_w), bool)
        # bidir pays two MV fields; bias roughly the extra bits
        lam = 16.0 * q
        for my in range(mb_h):
            last_f = np.zeros(2, np.int32)
            last_b = np.zeros(2, np.int32)
            for mx in range(mb_w):
                if co_skip[my, mx]:
                    continue
                costs = (float(cost_d[my, mx]),
                         float(cost_f[my, mx]) + lam,
                         float(cost_b[my, mx]) + lam,
                         float(cost_bi[my, mx]) + 2 * lam)
                mode = ("d", "f", "b", "bi")[int(np.argmin(costs))]
                lblk = [(2 * my, 2 * mx), (2 * my, 2 * mx + 1),
                        (2 * my + 1, 2 * mx), (2 * my + 1, 2 * mx + 1)]
                acs_y = [zz[mode]["y"][by * nbx + bx] for by, bx in lblk]
                ac_u = zz[mode]["u"][my * mb_w + mx]
                ac_v = zz[mode]["v"][my * mb_w + mx]
                cbp = 0
                for i, a in enumerate(acs_y):
                    if np.any(a):
                        cbp |= 32 >> i
                if np.any(ac_u):
                    cbp |= 2
                if np.any(ac_v):
                    cbp |= 1
                if mode == "d" and cbp == 0:
                    bw.put(1, 1)        # modb1: direct, nothing else
                    continue
                bw.put(0, 1)            # modb1: mb_type/vectors coded
                bw.put(0 if cbp else 1, 1)   # modb2: cbp present?
                # mb_type: '1' direct, '01' bidir, '001' backward,
                # '0001' forward
                code = {"d": (1, 1), "bi": (1, 2), "b": (1, 3),
                        "f": (1, 4)}[mode]
                bw.put(*code)
                if cbp:
                    bw.put(cbp, 6)
                    if mode != "d":
                        bw.put(0, 1)    # dbquant flag: keep qp
                if mode == "d":
                    _put_mv(bw, 0)      # zero direct delta
                    _put_mv(bw, 0)
                if mode in ("f", "bi"):
                    mvh = mvf[my, mx]
                    _put_mv(bw, int(mvh[1]) - int(last_f[1]))
                    _put_mv(bw, int(mvh[0]) - int(last_f[0]))
                    last_f[:] = mvh
                if mode in ("b", "bi"):
                    mvh = mvb[my, mx]
                    _put_mv(bw, int(mvh[1]) - int(last_b[1]))
                    _put_mv(bw, int(mvh[0]) - int(last_b[0]))
                    last_b[:] = mvh
                for i in range(4):
                    if cbp & (32 >> i):
                        _put_coeffs(bw, acs_y[i], 0, intra=False)
                if cbp & 2:
                    _put_coeffs(bw, ac_u, 0, intra=False)
                if cbp & 1:
                    _put_coeffs(bw, ac_v, 0, intra=False)
        bw.align_stuffing()
        return bw.bytes()

    def _stash_anchor_skip(self, is_i, flat, tail):
        """Record the anchor's MB skip mask: colocated-skipped MBs in the
        future anchor force B MBs to be skipped too (§7.6.7)."""
        mb_w, mb_h = self.cw // 16, self.ch // 16
        if is_i:
            self._anchor_skip = np.zeros((mb_h, mb_w), bool)
            self._anchor_mvs = None
            return
        H, W = self.ch, self.cw
        nby = (H // 8) * (W // 8)
        nbc = (H // 16) * (W // 16)
        zz_y = flat[:nby * 64].reshape(nby, 64)
        zz_u = flat[nby * 64:(nby + nbc) * 64].reshape(nbc, 64)
        zz_v = flat[(nby + nbc) * 64:].reshape(nbc, 64)
        mv = tail[:mb_h * mb_w * 2].reshape(mb_h, mb_w, 2)
        yany = (zz_y.reshape(mb_h * 2, mb_w * 2, 64) != 0).any(-1)
        yany = yany.reshape(mb_h, 2, mb_w, 2).any(1).any(-1)
        uany = (zz_u != 0).any(-1).reshape(mb_h, mb_w)
        vany = (zz_v != 0).any(-1).reshape(mb_h, mb_w)
        self._anchor_skip = (~yany & ~uany & ~vany
                             & (mv == 0).all(-1))
        self._anchor_mvs = np.asarray(mv, np.int32).copy()

    def flush(self):
        if not self._pending:
            return []
        # trailing frames: the last buffered one becomes the final
        # anchor; earlier ones encode as B between the two anchors
        frame, d = self._pending.pop()
        return self._emit_anchor_group(frame, d, is_i=False)

    def _planes(self, frame: VideoFrame):
        """The frame's planes on the encoder's device, edge-padded to
        whole MBs."""
        out = []
        for i, p in enumerate(frame.planes):
            t = torch.as_tensor(p, device=self.device)
            if self._pad_w or self._pad_h:
                s = 1 if i == 0 else 2
                t = F.pad(t.to(torch.float32)[None, None],
                          (0, self._pad_w // s, 0, self._pad_h // s),
                          mode="replicate")[0, 0].to(torch.uint8)
            out.append(t)
        return tuple(out)

    def encode_async(self, frame: VideoFrame, *, force_type=None,
                     display_idx=None) -> dict:
        """Run the device pass for one frame and return a handle for
        encode_finish (which fetches the compacted levels and packs the
        bitstream, so a pipeline can overlap it with the next frame).
        The B-frame scheduler passes the anchor's type and display
        index."""
        if frame.format not in ("yuv420p", "yuvj420p"):
            raise Unsupported(f"mpeg4: input must be yuv420p, got "
                              f"{frame.format}")
        if force_type is not None:
            is_i = force_type == "I"
        else:
            is_i = self._frame_idx % self.opts["gop_size"] == 0 \
                or self._ref is None
        if self.opts["bit_rate"] > 0:
            if self._rc is None:
                self._rc = RateController(self.opts["bit_rate"],
                                          self.framerate,
                                          self.opts["gop_size"])
            q = self._rc.pick_qscale(is_i)
        else:
            q = self.opts["qscale"]
        if self._packer is None:
            self._packer = _Mpeg4Packer(
                self.width, self.height, self.framerate, q,
                bframes=bool(self.opts["max_b_frames"]))
        y, u, v = self._planes(frame)
        bw = BitWriter()
        data0 = self._packer.sequence_headers() if self._frame_idx == 0 \
            else b""
        refs = self._ref
        self._sp_init()
        slim = not is_i and self._sp_slim_ok
        rd = bool(self.opts["trellis"])
        if is_i:
            packed, recon, levels = _encode_i_packed(
                y, u, v, q, T.dc_scaler(q, False), T.dc_scaler(q, True),
                *self._fat_caps(), trellis=rd)
        else:
            packed, recon, levels = _encode_p_packed(
                y, u, v, *refs, q, self.opts["search_range"], slim,
                *(() if slim else self._fat_caps()), trellis=rd)
        self._ref = recon
        hdr_idx = display_idx if display_idx is not None \
            else self._frame_idx
        self._packer.vop(bw, 0 if is_i else 1, hdr_idx, q)
        pts = display_idx if display_idx is not None else (
            frame.pts if frame.pts != NOPTS else self._next_pts)
        self._next_pts = pts + 1
        handle = {"bw": bw, "data0": data0, "q": q, "is_i": is_i,
                  "packed": packed, "levels": levels, "planes": (y, u, v),
                  "pts": pts, "slim": slim}
        if self.recon_psnr is not None:
            handle["recon"] = recon
        self._frame_idx += 1
        return handle

    def encode_finish(self, h: dict):
        """Fetch the device results for a dispatched frame and pack the
        bitstream."""
        q, is_i = h["q"], h["is_i"]
        while True:
            # a batching pipeline may have pre-fetched the packed array;
            # the overflow retry below re-dispatches, so consume it once
            pre = h.pop("packed_np", None)
            raw = pre if pre is not None else h["packed"].cpu().numpy()
            if h["slim"]:
                flat, tail = self._unsparsify_slim(raw)
            else:
                flat, tail = self._unsparsify_fat(
                    raw, h.get("caps", self._fat_caps()))
            if flat is not None:
                break
            # capacity overflow: re-pack this pass's levels in the next
            # larger always-correct layout (slim -> fat -> full): the
            # written levels are by construction the ones the reference
            # was rebuilt from, and the pass is not run again
            if h["slim"]:
                h["slim"] = False
                # content that blows the slim caps once keeps doing it:
                # downgrade the stream to the fat layout from here on
                self._sp_slim_ok = False
                caps = self._fat_caps()
            else:
                caps = (self._sp_nblk, self._sp_total)
                if h.get("full"):
                    raise InvalidData("mpeg4: sparse fetch overflow")
                h["full"] = True
            h["packed"] = _packed(*h["levels"], False, *caps)
            h["caps"] = caps
        if "recon" in h:
            self.recon_psnr.append(_psnr(h["planes"], h["recon"]))
        bw = h["bw"]
        if self.opts["max_b_frames"]:
            self._stash_anchor_skip(is_i, flat, tail)
        if is_i:
            body = self._pack_i(bw, flat, tail, q)
        else:
            body = self._pack_p(bw, flat, tail)
        payload = h["data0"] + body
        pkt = Packet(data=payload, pts=h["pts"], dts=h["pts"], duration=1,
                     flags=PktFlags.KEY if is_i else 0,
                     time_base=self.time_base)
        if self._rc is not None:
            self._rc.update(len(payload) * 8, is_i)
        return [pkt]

    def _sp_init(self) -> None:
        if not hasattr(self, "_sp_nblk"):
            nblk = ((self.ch // 8) * (self.cw // 8)
                    + 2 * (self.ch // 16) * (self.cw // 16))
            self._sp_nblk = nblk
            self._sp_total = nblk * 64
            # the slim layout requires nblk % 16 == 0 (byte-pair packed
            # maps), block indices that fit its 16-bit slots, and only
            # pays off on large frames
            self._sp_slim_ok = nblk % 16 == 0 and 4096 <= nblk <= 1 << 16

    def _fat_caps(self) -> tuple[int, int]:
        """Worst-typical caps for the fat program (always-correct
        fallback + I frames); static, so exactly one compile."""
        self._sp_init()
        return self._sp_nblk, min(self._sp_total, self._sp_nblk * 8)

    def _unsparsify_fat(self, packed: np.ndarray, caps):
        """Parse the fat layout [pos16(2*ecap), vals(ecap), cnt(4),
        tail...] -> dense flat zz int16 [total]; (None, None) when the
        event cap overflowed (scene-change outlier: caller re-runs with
        full-size caps)."""
        self._sp_init()
        cap, ecap = caps
        pos = packed[:2 * ecap].view(np.int32)
        o = 2 * ecap
        vals = packed[o:o + ecap]
        o += ecap
        cnt_b, cnt_e = packed[o:o + 4].view(np.int32)
        o += 4
        if cnt_b > cap or cnt_e > ecap:
            return None, None
        flat = np.zeros(self._sp_total, np.int16)
        flat[pos[:cnt_e]] = vals[:cnt_e]
        return flat, packed[o:]

    def _unsparsify_slim(self, packed: np.ndarray):
        """Parse the slim layout (see _sparsify_slim) -> dense flat zz
        int16 [total]; (None, None) on tail-capacity overflow (caller
        re-dispatches the fat program)."""
        self._sp_init()
        nblk = self._sp_nblk
        T = _SLIM_TCAP
        o = 0
        lo = packed[o:o + nblk * 16].view(np.int8); o += nblk * 16
        hi = packed[o:o + nblk * 16].view(np.int8); o += nblk * 16
        # the slots travel as int16; a block index past 32767 (a 1080p
        # frame has 48960 blocks) reads back unsigned (the JAX package
        # reads it signed and files the tail under another block)
        tslot = packed[o:o + T].view(np.uint16); o += T
        trows = packed[o:o + T * 32].reshape(T, 32); o += T * 32
        (cnt_t,) = packed[o:o + 2].view(np.int32)
        o += 2
        if cnt_t > T:
            return None, None
        blocks = np.zeros((nblk, 64), np.int16)
        band = (hi.astype(np.int16) << 8) | (lo.astype(np.int16) & 255)
        blocks[:, :32] = band.reshape(nblk, 32)
        if cnt_t:
            blocks[tslot[:cnt_t], 32:] = trows[:cnt_t]
        return blocks.ravel(), packed[o:]

    def _pack_i(self, bw: BitWriter, flat, tail, q: int) -> bytes:
        H, W = self.ch, self.cw
        nby = (H // 8) * (W // 8)
        nbc = (H // 16) * (W // 16)
        zz_y = flat[:nby * 64].reshape(nby, 64)
        zz_u = flat[nby * 64:(nby + nbc) * 64].reshape(nbc, 64)
        zz_v = flat[(nby + nbc) * 64:].reshape(nbc, 64)
        o = 0
        dc_y = tail[o:o + nby].reshape(H // 8, W // 8); o += nby
        dc_u = tail[o:o + nbc].reshape(H // 16, W // 16); o += nbc
        dc_v = tail[o:o + nbc].reshape(H // 16, W // 16)

        diff_y = _dc_predict(dc_y, T.dc_scaler(q, False))
        diff_u = _dc_predict(dc_u, T.dc_scaler(q, True))
        diff_v = _dc_predict(dc_v, T.dc_scaler(q, True))

        mb_w, mb_h = self.cw // 16, self.ch // 16
        from librempeg_tpu_torch.native import build as native

        if native.available():
            return native.mpeg4_pack_frame(
                bw, True, mb_w, mb_h, diff_y, diff_u, diff_v,
                zz_y, zz_u, zz_v, None)
        nbx = mb_w * 2
        for my in range(mb_h):
            for mx in range(mb_w):
                # luma blocks of this MB in raster order
                lblk = [(2 * my, 2 * mx), (2 * my, 2 * mx + 1),
                        (2 * my + 1, 2 * mx), (2 * my + 1, 2 * mx + 1)]
                acs_y = [zz_y[by * nbx + bx] for by, bx in lblk]
                ac_u = zz_u[my * mb_w + mx]
                ac_v = zz_v[my * mb_w + mx]
                cbpy = 0
                for i, a in enumerate(acs_y):
                    if np.any(a[1:]):
                        cbpy |= 8 >> i
                cbpc = ((2 if np.any(ac_u[1:]) else 0)
                        | (1 if np.any(ac_v[1:]) else 0))
                code, bits = T.INTRA_MCBPC[cbpc]
                bw.put(code, bits)
                bw.put(0, 1)                       # ac_pred_flag
                code, bits = T.CBPY[cbpy]
                bw.put(code, bits)
                for i, (by, bx) in enumerate(lblk):
                    _put_dc(bw, int(diff_y[by, bx]), chroma=False)
                    if cbpy & (8 >> i):
                        _put_coeffs(bw, acs_y[i], 1, intra=True)
                _put_dc(bw, int(diff_u[my, mx]), chroma=True)
                if cbpc & 2:
                    _put_coeffs(bw, ac_u, 1, intra=True)
                _put_dc(bw, int(diff_v[my, mx]), chroma=True)
                if cbpc & 1:
                    _put_coeffs(bw, ac_v, 1, intra=True)
        bw.align_stuffing()
        return bw.bytes()

    def _pack_p(self, bw: BitWriter, flat, tail) -> bytes:
        H, W = self.ch, self.cw
        nby = (H // 8) * (W // 8)
        nbc = (H // 16) * (W // 16)
        bh, bwd = H // 16, W // 16
        zz_y = flat[:nby * 64].reshape(nby, 64)
        zz_u = flat[nby * 64:(nby + nbc) * 64].reshape(nbc, 64)
        zz_v = flat[(nby + nbc) * 64:].reshape(nbc, 64)
        mv = tail[:bh * bwd * 2].reshape(bh, bwd, 2).astype(np.int32)

        mb_w, mb_h = self.cw // 16, self.ch // 16
        # MVs arrive in half-pel units from the device pass
        mvh = mv
        from librempeg_tpu_torch.native import build as native

        if native.available():
            return native.mpeg4_pack_frame(
                bw, False, mb_w, mb_h, None, None, None,
                zz_y, zz_u, zz_v, mvh)
        nbx = mb_w * 2
        for my in range(mb_h):
            for mx in range(mb_w):
                lblk = [(2 * my, 2 * mx), (2 * my, 2 * mx + 1),
                        (2 * my + 1, 2 * mx), (2 * my + 1, 2 * mx + 1)]
                acs_y = [zz_y[by * nbx + bx] for by, bx in lblk]
                ac_u = zz_u[my * mb_w + mx]
                ac_v = zz_v[my * mb_w + mx]
                cbpy = 0
                for i, a in enumerate(acs_y):
                    if np.any(a):
                        cbpy |= 8 >> i
                cbpc = ((2 if np.any(ac_u) else 0)
                        | (1 if np.any(ac_v) else 0))
                this = mvh[my, mx]
                if cbpy == 0 and cbpc == 0 and this[0] == 0 and this[1] == 0:
                    bw.put(1, 1)                   # not_coded (skip)
                    continue
                bw.put(0, 1)                       # coded
                code, bits = T.INTER_MCBPC[0 * 4 + cbpc]  # mb_type inter
                bw.put(code, bits)
                code, bits = T.CBPY[15 - cbpy]
                bw.put(code, bits)
                # MV pred (x and y component-wise median)
                px, py = self._mv_pred(mvh, my, mx, mb_w)
                _put_mv(bw, int(this[1]) - px)     # horizontal first
                _put_mv(bw, int(this[0]) - py)
                for i in range(4):
                    if cbpy & (8 >> i):
                        _put_coeffs(bw, acs_y[i], 0, intra=False)
                if cbpc & 2:
                    _put_coeffs(bw, ac_u, 0, intra=False)
                if cbpc & 1:
                    _put_coeffs(bw, ac_v, 0, intra=False)
        bw.align_stuffing()
        return bw.bytes()

    @staticmethod
    def _mv_pred(mvh: np.ndarray, my: int, mx: int, mb_w: int):
        """Median MV predictor (spec §7.5.5 candidate rules)."""

        def cand(yy, xx):
            if yy < 0 or xx < 0 or xx >= mb_w:
                return None
            return (int(mvh[yy, xx, 1]), int(mvh[yy, xx, 0]))

        A = cand(my, mx - 1)
        B = cand(my - 1, mx)
        C = cand(my - 1, mx + 1)
        if B is None and C is None:
            # first MB row: predictor is A (or 0)
            return A if A is not None else (0, 0)
        A = A or (0, 0)
        B = B or (0, 0)
        C = C or (0, 0)
        px = A[0] + B[0] + C[0] - max(A[0], B[0], C[0]) \
            - min(A[0], B[0], C[0])
        py = A[1] + B[1] + C[1] - max(A[1], B[1], C[1]) \
            - min(A[1], B[1], C[1])
        return px, py


def _psnr(planes, recon) -> float:
    """PSNR (dB) of the recon planes against the input planes, over all
    samples of the three planes."""
    se, n = 0.0, 0
    for p, r in zip(planes, recon):
        d = p.to(torch.float64) - r.to(torch.float64)
        se += float((d * d).sum())
        n += d.numel()
    return float("inf") if se == 0 else \
        10.0 * float(np.log10(255.0 ** 2 * n / se))
