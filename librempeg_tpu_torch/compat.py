"""Codec state carried in from numpy.

For this system the "weights" are the codec state: the decoder's
reference pictures and parameter sets, the encoder's reference recon
planes and rate-control fields, and on the audio path the resampler's
history and stream position, the AAC encoder's overlap and rate
control, and the ditherer's noise position and error history. These
functions build the port's objects from plain numpy arrays and values,
so a run (or a test) can start the port mid-stream from state another
implementation reached, e.g. the JAX package's objects.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from librempeg_tpu_torch.codecs.aac.codec import AacEncoder
from librempeg_tpu_torch.codecs.h264 import device_recon as DR
from librempeg_tpu_torch.codecs.h264 import parse as P
from librempeg_tpu_torch.codecs.h264.codec import H264Decoder
from librempeg_tpu_torch.codecs.mpeg4.encoder import (
    Mpeg4Encoder,
    RateController,
    _Mpeg4Packer,
)
from librempeg_tpu_torch.core.frame import VideoFrame
from librempeg_tpu_torch.core.rational import Rational
from librempeg_tpu_torch.device import resolve
from librempeg_tpu_torch.resample.dither import Ditherer
from librempeg_tpu_torch.resample.resampler import Resampler, _bank_matrix


def _as(cls, obj):
    """A parameter-set dataclass of any origin as the port's class."""
    return cls(**{f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(cls)})


def decoder_state_from_numpy(sps, pps, dpb, poc_state=(0, 0),
                             frame_count: int = 0, device="cuda",
                             **opts) -> H264Decoder:
    """An H264Decoder positioned after the pictures in `dpb`.

    sps/pps: parsed parameter sets (any dataclass with the fields of
    codecs/h264/parse.SPS / PPS). dpb: reference pictures newest first,
    each a dict with y/u/v uint8 arrays (cropped-to-MB planes, i.e.
    [16*mb_h, 16*mb_w] luma), frame_num, poc and long_term (None or the
    LongTermFrameIdx). poc_state: (msb, lsb) of the previous reference
    picture (§8.2.1.1). The reference planes go to `device` with their
    refpacks, as if the decoder had reconstructed them there."""
    dec = H264Decoder(None, device=device, **opts)
    dec.sps = _as(P.SPS, sps)
    dec.pps = _as(P.PPS, pps)
    dec._poc_state = tuple(poc_state)
    dec._dec_count = frame_count
    for ent in dpb:
        planes = tuple(torch.from_numpy(np.array(ent[k], dtype=np.uint8))
                       .to(dec.device) for k in "yuv")
        dec._dpb.append([ent["frame_num"], None, None, planes,
                         DR.make_refpack(*planes), ent["poc"],
                         ent.get("long_term")])
    return dec


def _planes_on(planes, dtype, device):
    return tuple(torch.from_numpy(np.array(p, dtype=dtype)).to(device)
                 for p in planes)


def encoder_state_from_numpy(width: int, height: int, ref, frame_idx: int,
                             rc: dict | None = None,
                             slim_ok: bool | None = None,
                             packer: dict | None = None,
                             framerate: Rational = Rational(25, 1),
                             device="cuda", bframes: dict | None = None,
                             **opts) -> Mpeg4Encoder:
    """An Mpeg4Encoder positioned after `frame_idx` coded frames.

    ref: the (y, u, v) float32 in-loop recon planes of the last coded
    frame (unrounded, as the encoder keeps them). rc: rate-controller
    fields (buffer, c_i, c_p, last_q) when bit_rate is set. slim_ok:
    the sparse-fetch layout flag (None: derive from the frame size).
    packer: header-state fields (last_sec, prev_sec) of the VOP time
    code. bframes (with max_b_frames > 0): the B-frame scheduler's
    state -- prev_anchor (the older anchor's recon planes, or None),
    anchor_skip ([mb_h, mb_w] bool) and anchor_mvs ([mb_h, mb_w, 2]
    half-pel, or None) of the newest anchor, pending (the buffered
    frames as (y, u, v) uint8 planes and display index), disp_idx,
    decode_idx, prev_anchor_disp and cur_anchor_disp."""
    enc = Mpeg4Encoder(width=width, height=height, framerate=framerate,
                       device=device, **opts)
    enc._ref = _planes_on(ref, np.float32, enc.device)
    enc._frame_idx = frame_idx
    enc._next_pts = frame_idx
    if rc is not None:
        enc._rc = RateController(enc.opts["bit_rate"], framerate,
                                 enc.opts["gop_size"])
        enc._rc.buffer = float(rc["buffer"])
        enc._rc.c_i = float(rc["c_i"])
        enc._rc.c_p = float(rc["c_p"])
        enc._rc._last_q = int(rc["last_q"])
    enc._sp_init()
    if slim_ok is not None:
        enc._sp_slim_ok = bool(slim_ok)
    if packer is not None:
        enc._packer = _Mpeg4Packer(width, height, framerate,
                                   enc.opts["qscale"],
                                   bframes=bool(enc.opts["max_b_frames"]))
        enc._packer.last_sec = int(packer["last_sec"])
        enc._packer.prev_sec = int(packer.get("prev_sec", 0))
    if bframes is not None:
        b = bframes
        pa = b.get("prev_anchor")
        enc._prev_anchor = None if pa is None else _planes_on(
            pa, np.float32, enc.device)
        skip, mvs = b.get("anchor_skip"), b.get("anchor_mvs")
        enc._anchor_skip = None if skip is None else np.array(skip, bool)
        enc._anchor_mvs = None if mvs is None else np.array(mvs, np.int32)
        enc._pending = [
            (VideoFrame(planes=_planes_on(planes, np.uint8, enc.device),
                        format="yuv420p", width=width, height=height,
                        pts=d), d)
            for planes, d in b.get("pending", ())]
        for k in ("disp_idx", "decode_idx", "prev_anchor_disp",
                  "cur_anchor_disp"):
            setattr(enc, "_" + k, int(b[k]))
    return enc


def _f32_on(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def resampler_state_from_numpy(in_rate: int, out_rate: int, channels: int,
                               buf, buf_start: int, next_origin: int,
                               out_count: int, total_in: int, keep: int,
                               comp: dict | None = None, device="cuda",
                               **opts) -> Resampler:
    """A Resampler positioned mid-stream.

    buf: the retained input [channels, n] float32, whose first column
    is absolute input sample buf_start; next_origin, out_count,
    total_in and keep (the history retained, which a compensation bank
    can deepen) as the JAX package's fields of those names. comp: the
    active compensation, {"p", "q", "remaining"} (its bank is rebuilt
    from p and q), or None."""
    r = Resampler(in_rate, out_rate, channels, device=device, **opts)
    r._buf = _f32_on(buf, r.device)
    r._buf_start = int(buf_start)
    r._next_origin = int(next_origin)
    r._out_count = int(out_count)
    r._total_in = int(total_in)
    r._keep = int(keep)
    if comp is not None:
        p2, q2 = int(comp["p"]), int(comp["q"])
        m2, L2, lp2 = _bank_matrix(
            p2, q2, r.taps, int(r._cutoff * 1e6),
            int(r.opts["kaiser_beta"] * 10), r.opts["window"])
        r._comp = {"m": torch.from_numpy(m2).to(r.device), "p": p2, "q": q2,
                   "L": L2, "lp": lp2, "remaining": int(comp["remaining"])}
    return r


def aac_encoder_state_from_numpy(sample_rate: int, channels: int, hist,
                                 pend, frame_no: int, rc_q: float,
                                 rc_buffer: float, device="cuda",
                                 **opts) -> AacEncoder:
    """An AacEncoder positioned after `frame_no` coded frames: hist the
    last coded block [channels, 1024] (the MDCT overlap), pend the
    samples not yet coded [channels, n] (float32 in [-1, 1)), rc_q and
    rc_buffer the rate control's quality knob and bit balance."""
    enc = AacEncoder(sample_rate=sample_rate, channels=channels,
                     device=device, **opts)
    enc._hist = _f32_on(hist, enc.device)
    enc._pend = _f32_on(pend, enc.device).reshape(channels, -1)
    enc._frame_no = int(frame_no)
    enc._rc_q = float(rc_q)
    enc._rc_buffer = float(rc_buffer)
    return enc


def ditherer_state_from_numpy(method: str, pos: int, hp_last=None,
                              err=None, seed: int = 0,
                              device="cuda") -> Ditherer:
    """A Ditherer positioned after `pos` samples: hp_last the high-pass
    noise carry [channels] (triangular_hp), err the shaper's error
    history [K, channels], newest first (lipshitz, f_weighted); None
    where the method has none yet."""
    d = Ditherer(method, seed=seed)
    d._pos = int(pos)
    d._hp_last = None if hp_last is None else np.array(hp_last, np.float64)
    d._err = None if err is None else _f32_on(err, resolve(device))
    return d
