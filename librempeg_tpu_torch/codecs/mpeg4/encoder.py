"""MPEG-4 part 2 (Simple Profile) video encoder.

Port of librempeg_tpu/codecs/mpeg4/encoder.py. The device half runs on
tensors on the encoder's device: integer full search
(ops.motion.full_search_mc_xla), half-pel refinement + MC (the half-pel
kernel, codecs/mpeg4/me_pallas.py), the spec DCT and H.263 quantiser,
in-loop reconstruction, and the compaction of the coded levels for the
host fetch (_sparsify_slim / _sparsify_fat). The host half (DC and MV
prediction, VLC packing in native/mpeg4.cpp, rate control) is the JAX
package's, copied unchanged.

Simple-profile choices: quant_type=0 (H.263 quantizer), I/P GOP
structure, half-pel MVs with vop_rounding_type 0, ac_pred off, resync
markers off. Trellis quantisation, B-VOPs and the multi-device path are
not ported yet.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from librempeg_tpu_torch.codecs.api import CodecInfo, Encoder
from librempeg_tpu_torch.codecs.mpeg4 import me_pallas as MEP
from librempeg_tpu_torch.codecs.mpeg4 import tables as T
from librempeg_tpu_torch.codecs.mpeg4.bits import BitWriter
from librempeg_tpu_torch.core.errors import InvalidData, Unsupported
from librempeg_tpu_torch.core.frame import VideoFrame
from librempeg_tpu_torch.core.options import Option, OptionTable
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import NOPTS, Rational
from librempeg_tpu_torch.device import resolve
from librempeg_tpu_torch.ops import dct8x8, motion

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


def _scale(like: torch.Tensor) -> torch.Tensor:
    key = str(like.device)
    s = _SCALES.get(key)
    if s is None:
        s = _SCALES[key] = torch.as_tensor(_spec_dct_scale(),
                                           device=like.device)
    return s


def _fdct_spec(x: torch.Tensor) -> torch.Tensor:
    """[B, 8, 8] float pixels -> spec DCT coefficients."""
    return dct8x8.fdct(x) * _scale(x)


def _idct_spec(c: torch.Tensor) -> torch.Tensor:
    return dct8x8.idct(c / _scale(c))


def _dequant(level: torch.Tensor, qscale: int) -> torch.Tensor:
    """H.263 dequantisation (what the decoder reconstructs)."""
    even = 1 - (qscale & 1)
    deq = torch.sign(level) * (qscale * (2 * level.abs() + 1) - even)
    return torch.where(level != 0, deq, 0).to(torch.float32)


def _quant_intra(coeffs, qscale: int, dc_scale: int):
    """H.263-style intra quant. Returns (dc_level, ac_levels, recon)."""
    dc_level = torch.round(coeffs[..., 0, 0] / dc_scale).to(torch.int32)
    ac_level = torch.trunc(coeffs / (2.0 * qscale)).to(torch.int32) \
        .clamp(-2047, 2047)
    ac_level[..., 0, 0] = 0
    deq = _dequant(ac_level, qscale)
    deq[..., 0, 0] = dc_level.to(torch.float32) * dc_scale
    return dc_level, ac_level, _idct_spec(deq)


def _quant_inter(coeffs, qscale: int):
    """H.263-style inter quant with dead zone."""
    mag = torch.trunc((coeffs.abs() - qscale / 2.0) / (2.0 * qscale))
    level = (torch.sign(coeffs) * mag.clamp(min=0.0)).to(torch.int32) \
        .clamp(-2047, 2047)
    return level, _idct_spec(_dequant(level, qscale))


_ZZ: dict = {}


def _zigzag(level: torch.Tensor) -> torch.Tensor:
    """[..., 8, 8] levels -> [nblk, 64] int16 in zigzag order."""
    key = str(level.device)
    zz = _ZZ.get(key)
    if zz is None:
        zz = _ZZ[key] = torch.as_tensor(np.asarray(T.ZIGZAG, np.int64),
                                        device=level.device)
    return level.reshape(-1, 64)[:, zz].to(torch.int16)


def _encode_i_device(y, u, v, qscale: int, dcs_luma: int, dcs_chroma: int):
    """I-VOP pass over one frame's planes. Returns per plane
    (dc_levels [bh, bw], ac_zz [nblk, 64] int16, recon plane f32)."""
    out = {}
    for name, plane, chroma in (("y", y, False), ("u", u, True),
                                ("v", v, True)):
        p = plane.to(torch.float32)
        h, w = p.shape
        coeffs = _fdct_spec(dct8x8.to_blocks(p))
        dc, ac, recon = _quant_intra(coeffs, qscale,
                                     dcs_chroma if chroma else dcs_luma)
        out[name] = (dc.reshape(h // 8, w // 8), _zigzag(ac),
                     dct8x8.from_blocks(recon, h, w).clamp(0, 255))
    return out


def _encode_p_device(y, u, v, ref_y, ref_u, ref_v, qscale: int,
                     search_range: int = 8):
    """P-VOP pass: even-pel integer full search, half-pel refinement +
    MC of all planes (the half-pel kernel), residual transform coding
    and in-loop recon. MVs are in HALF-PEL units."""
    yf = y.to(torch.float32)[None]
    mv_i, _, _ = motion.full_search_mc_xla(
        yf, ref_y.to(torch.float32)[None], search_range, 16, 2)
    mvh, pred_y, pred_u, pred_v = MEP.hpel_refine_mc(
        yf[0], ref_y, ref_u, ref_v, mv_i[0], rnd=0)
    out = {"mv": mvh}
    for name, plane, pred in (("y", yf[0], pred_y), ("u", u, pred_u),
                              ("v", v, pred_v)):
        p = plane.to(torch.float32)
        h, w = p.shape
        coeffs = _fdct_spec(dct8x8.to_blocks(p - pred))
        level, rec_res = _quant_inter(coeffs, qscale)
        recon = (pred + dct8x8.from_blocks(rec_res, h, w)).clamp(0, 255)
        out[name] = (_zigzag(level), recon)
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


def _encode_i_packed(y, u, v, qscale, dcs_luma, dcs_chroma, cap, ecap):
    """I-VOP pass returning (packed int16, recon planes): all host-side
    data (sparse zz coefficients + dc levels) in ONE array, so the host
    fetch is one small copy per frame."""
    out = _encode_i_device(y, u, v, qscale, dcs_luma, dcs_chroma)
    zz_blocks = torch.cat([out[k][1] for k in ("y", "u", "v")])
    parts = _sparsify_fat(zz_blocks, cap, ecap)
    parts += [out[k][0].reshape(-1).to(torch.int16) for k in ("y", "u", "v")]
    return torch.cat(parts), (out["y"][2], out["u"][2], out["v"][2])


def _encode_p_packed(y, u, v, ry, ru, rv, qscale, search_range, slim,
                     cap=0, ecap=0):
    out = _encode_p_device(y, u, v, ry, ru, rv, qscale, search_range)
    zz_blocks = torch.cat([out["y"][0], out["u"][0], out["v"][0]])
    if slim:
        parts = _sparsify_slim(zz_blocks)
    else:
        parts = _sparsify_fat(zz_blocks, cap, ecap)
    parts += [out["mv"].reshape(-1).to(torch.int16)]
    return torch.cat(parts), (out["y"][1], out["u"][1], out["v"][1])


# ---------------------------------------------------------------------------
# Host: prediction + VLC packing
# ---------------------------------------------------------------------------


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

    def __init__(self, width, height, fps: Rational, qscale: int):
        self.w, self.h = width, height
        self.fps = fps
        self.qscale = qscale
        self.last_sec = 0
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
        bw.put(1, 8)               # video_object_type: simple
        bw.put(0, 1)               # is_object_layer_identifier
        bw.put(1, 4)               # aspect_ratio_info: square
        bw.put(0, 1)               # vol_control_parameters
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
        bw.put(coding_type, 2)     # 0 = I, 1 = P
        # time: seconds elapsed as modulo_time_base '1's
        total_ticks = frame_idx * self.fps.den
        sec = total_ticks // self.time_res
        for _ in range(sec - self.last_sec):
            bw.put(1, 1)
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
               help="B-frames between anchors (not ported: must be 0)"),
        Option("trellis", int, 0, min=0, max=2,
               help="RD (trellis) quantisation (not ported: must be 0)"),
    )

    def __init__(self, width=0, height=0, pix_fmt="yuv420p",
                 framerate: Rational = Rational(25, 1), device="cuda",
                 **opts):
        super().__init__(**opts)
        if self.opts["trellis"]:
            raise Unsupported("mpeg4: trellis quantisation is not ported")
        if self.opts["max_b_frames"]:
            raise Unsupported("mpeg4: B-VOPs are not ported")
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
        return self.encode_finish(self.encode_async(frame))

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

    def encode_async(self, frame: VideoFrame) -> dict:
        """Run the device pass for one frame and return a handle for
        encode_finish (which fetches the compacted levels and packs the
        bitstream, so a pipeline can overlap it with the next frame)."""
        if frame.format not in ("yuv420p", "yuvj420p"):
            raise Unsupported(f"mpeg4: input must be yuv420p, got "
                              f"{frame.format}")
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
            self._packer = _Mpeg4Packer(self.width, self.height,
                                        self.framerate, q)
        y, u, v = self._planes(frame)
        bw = BitWriter()
        data0 = self._packer.sequence_headers() if self._frame_idx == 0 \
            else b""
        refs = self._ref
        self._sp_init()
        slim = not is_i and self._sp_slim_ok
        if is_i:
            packed, recon = _encode_i_packed(
                y, u, v, q, T.dc_scaler(q, False), T.dc_scaler(q, True),
                *self._fat_caps())
        else:
            packed, recon = _encode_p_packed(
                y, u, v, *refs, q, self.opts["search_range"], slim,
                *(() if slim else self._fat_caps()))
        self._ref = recon
        self._packer.vop(bw, 0 if is_i else 1, self._frame_idx, q)
        pts = frame.pts if frame.pts != NOPTS else self._next_pts
        self._next_pts = pts + 1
        handle = {"bw": bw, "data0": data0, "q": q, "is_i": is_i,
                  "packed": packed, "planes": (y, u, v), "refs": refs,
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
            # capacity overflow: re-run this frame through the next
            # larger always-correct layout (slim -> fat -> full)
            y, u, v = h["planes"]
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
            # recon is identical to the original dispatch (same inputs,
            # only the fetch layout differs): self._ref is left alone
            if is_i:
                h["packed"], _ = _encode_i_packed(
                    y, u, v, q, T.dc_scaler(q, False),
                    T.dc_scaler(q, True), *caps)
            else:
                h["packed"], _ = _encode_p_packed(
                    y, u, v, *h["refs"], q, self.opts["search_range"],
                    False, *caps)
            h["caps"] = caps
        if "recon" in h:
            self.recon_psnr.append(_psnr(h["planes"], h["recon"]))
        bw = h["bw"]
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
            # maps) and only pays off on large frames
            self._sp_slim_ok = nblk % 16 == 0 and nblk >= 4096

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
        tslot = packed[o:o + T]; o += T
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
