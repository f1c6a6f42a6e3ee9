"""Codec state carried in from numpy.

For this system the "weights" are the codec state: the decoder's
reference pictures and parameter sets, the encoder's reference recon
planes and rate-control fields. These functions build the port's
objects from plain numpy arrays and values, so a run (or a test) can
start the port mid-GOP from state another implementation reached,
e.g. the JAX package's decoder and encoder.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from librempeg_tpu_torch.codecs.h264 import device_recon as DR
from librempeg_tpu_torch.codecs.h264 import parse as P
from librempeg_tpu_torch.codecs.h264.codec import H264Decoder
from librempeg_tpu_torch.codecs.mpeg4.encoder import (
    Mpeg4Encoder,
    RateController,
    _Mpeg4Packer,
)
from librempeg_tpu_torch.core.rational import Rational


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


def encoder_state_from_numpy(width: int, height: int, ref, frame_idx: int,
                             rc: dict | None = None,
                             slim_ok: bool | None = None,
                             packer: dict | None = None,
                             framerate: Rational = Rational(25, 1),
                             device="cuda", **opts) -> Mpeg4Encoder:
    """An Mpeg4Encoder positioned after `frame_idx` coded frames.

    ref: the (y, u, v) float32 in-loop recon planes of the last coded
    frame (unrounded, as the encoder keeps them). rc: rate-controller
    fields (buffer, c_i, c_p, last_q) when bit_rate is set. slim_ok:
    the sparse-fetch layout flag (None: derive from the frame size).
    packer: header-state field (last_sec) of the VOP time code."""
    enc = Mpeg4Encoder(width=width, height=height, framerate=framerate,
                       device=device, **opts)
    enc._ref = tuple(torch.from_numpy(np.array(p, dtype=np.float32))
                     .to(enc.device) for p in ref)
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
                                   enc.opts["qscale"])
        enc._packer.last_sec = int(packer["last_sec"])
    return enc
