"""The port's H.264 encoder (a copy of the JAX package's H264Encoder,
inter_enc.py and entropy_transcode.py) against the JAX package's, and
against the port's own decoder.

The same seeded numpy frames go through both encoders; every packet's
bytes, pts, dts and flags must be equal (H.264 is integer throughout,
so there is no tolerance). The encoder's deblocked recon (`_ref`) after
each reference frame must equal the port decoder's output for that
frame, on the CPU's plain kernels, at decode-ahead depth 0 (the CPU's)
and 2 (the card's). syngen (the High-profile stream generator) must
write the same bytes in both packages.
"""
import numpy as np
import pytest
import torch

from librempeg_tpu.codecs.h264.codec import H264Encoder as JEnc
from librempeg_tpu.codecs.h264.syngen import HighStreamGen as JGen
from librempeg_tpu.core.frame import VideoFrame as JFrame
from librempeg_tpu_torch.codecs.h264.codec import H264Decoder as TDec
from librempeg_tpu_torch.codecs.h264.codec import H264Encoder as TEnc
from librempeg_tpu_torch.codecs.h264.syngen import HighStreamGen as TGen
from librempeg_tpu_torch.core.frame import VideoFrame as TFrame
from librempeg_tpu_torch.core.packet import Packet as TPacket


def frames(w, h, n, seed=7):
    """A drifting texture with noise: motion for the search, flat and
    busy MBs for the mode decisions."""
    rng = np.random.default_rng(seed)
    gy, gx = np.mgrid[0:h + 2 * n, 0:w + 2 * n]
    base = np.clip(128 + 70 * np.sin(gx / 9.0) * np.cos(gy / 7.0)
                   + rng.normal(0, 8, gx.shape), 0, 255).astype(np.uint8)
    out = []
    for i in range(n):
        y = base[i:i + h, 2 * i:2 * i + w].copy()
        u = base[i // 2 + 3:i // 2 + 3 + h // 2, i:i + w // 2].copy()
        v = (255 - base[i:i + h // 2, i + 5:i + 5 + w // 2]).copy()
        out.append((y, u, v))
    return out


def encode(enc_cls, frame_cls, planes, w, h, as_tensor=False, refs=None,
           **opts):
    enc = enc_cls(width=w, height=h, **opts)
    if refs is not None:
        code_ref = enc._code_ref

        def step(y, u, v, disp, pts, is_idr):
            pkt = code_ref(y, u, v, disp, pts, is_idr)
            refs[disp] = [p.copy() for p in enc._ref]
            return pkt

        enc._code_ref = step
    pkts = []
    for i, (y, u, v) in enumerate(planes):
        pl = tuple(torch.from_numpy(p) for p in (y, u, v)) if as_tensor \
            else (y, u, v)
        pkts += enc.encode(frame_cls(planes=pl, format="yuv420p", width=w,
                                     height=h, pts=i))
    pkts += enc.flush()
    return enc, [(bytes(p.data), p.pts, p.dts, int(p.flags)) for p in pkts]


CASES = [
    # (width, height, frames, options)
    (64, 48, 5, {"qp": 26}),
    (80, 48, 5, {"qp": 26, "g": 3}),
    (74, 42, 5, {"qp": 26, "bf": 1}),          # cropped: 80x48 coded
    (176, 144, 4, {"qp": 26, "sr": 8}),
    (64, 48, 4, {"qp": 16, "g": 1}),
    (64, 48, 6, {"qp": 40, "g": 3, "bf": 2}),
    (80, 48, 6, {"qp": 30, "bf": 2, "sr": 1}),
    (64, 48, 4, {"qp": 28, "variety": 1, "pcm": 1}),
    (64, 48, 4, {"qp": 28, "variety": 1, "pcm": 0}),
    (64, 48, 5, {"qp": 26, "cabac": 1}),
    (80, 48, 5, {"qp": 26, "cabac": 1, "bf": 1, "g": 3}),
]


@pytest.mark.parametrize("w,h,n,opts", CASES)
def test_bytes_equal_jax(w, h, n, opts):
    planes = frames(w, h, n)
    j_enc, j_pk = encode(JEnc, JFrame, planes, w, h, **opts)
    t_enc, t_pk = encode(TEnc, TFrame, planes, w, h, **opts)
    assert len(t_pk) == n
    assert t_pk == j_pk
    assert bytes(t_enc.codec_parameters().extradata) == \
        bytes(j_enc.codec_parameters().extradata)


def test_flush_at_eof_codes_the_pending_frames():
    """Frames held for B prediction at EOF leave as a trailing P chain:
    five frames at bf 2 give I0 P3 B1 B2 then P4 from flush()."""
    w, h = 64, 48
    planes = frames(w, h, 5)
    enc = TEnc(width=w, height=h, qp=26, bf=2)
    pk = []
    for i, p in enumerate(planes):
        pk += enc.encode(TFrame(planes=p, format="yuv420p", width=w,
                                height=h, pts=i))
    assert [p.pts for p in pk] == [0, 3, 1, 2]
    tail = enc.flush()
    assert [p.pts for p in tail] == [4] and enc.flush() == []
    _, j_pk = encode(JEnc, JFrame, planes, w, h, qp=26, bf=2)
    assert [(bytes(p.data), p.pts, p.dts) for p in pk + tail] == \
        [(d, pts, dts) for d, pts, dts, _ in j_pk]


@pytest.mark.parametrize("bf", [0, 1])
def test_tensor_planes_equal_numpy_planes(bf):
    """Planes given as CPU tensors (as a decoder on the CPU hands them
    over; cropped views included) code to the same bytes as numpy."""
    w, h = 74, 42
    planes = frames(w, h, 4)
    _, a = encode(TEnc, TFrame, planes, w, h, qp=26, bf=bf)
    _, b = encode(TEnc, TFrame, planes, w, h, as_tensor=True, qp=26, bf=bf)
    big = [tuple(np.pad(p, ((0, 6), (0, 6))) for p in pl) for pl in planes]
    views = [(torch.from_numpy(y)[:h, :w], torch.from_numpy(u)[:h // 2,
              :w // 2], torch.from_numpy(v)[:h // 2, :w // 2])
             for y, u, v in big]
    enc = TEnc(width=w, height=h, qp=26, bf=bf)
    c = []
    for i, pl in enumerate(views):
        c += enc.encode(TFrame(planes=pl, format="yuv420p", width=w,
                               height=h, pts=i))
    c += enc.flush()
    assert a == b == [(bytes(p.data), p.pts, p.dts, int(p.flags))
                      for p in c]


def decode(pk, extradata, prefetch):
    dec = TDec(device="cpu", prefetch=prefetch)
    out = []
    first = True
    for d, pts, dts, flags in pk:
        if first and extradata and not d.startswith(extradata):
            d = extradata + d
        first = False
        out += dec.decode(TPacket(data=d, pts=pts, dts=dts, flags=flags))
    out += dec.flush()
    if hasattr(dec, "close"):
        dec.close()
    return out


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("opts", [
    {"qp": 26, "g": 3},
    {"qp": 26, "bf": 1, "g": 4},
    {"qp": 20, "variety": 1, "pcm": 0},
    {"qp": 26, "cabac": 1},
])
def test_recon_equals_port_decode(opts, prefetch):
    """The encoder's contract: each reference frame the port decodes
    equals the encoder's deblocked recon after that frame."""
    w, h = 80, 48
    planes = frames(w, h, 6)
    refs = {}
    enc, pk = encode(TEnc, TFrame, planes, w, h, refs=refs, **opts)
    out = decode(pk, bytes(enc.codec_parameters().extradata), prefetch)
    assert len(out) == len(planes)
    assert [f.pts for f in out] == list(range(len(planes)))
    assert refs and set(refs) <= set(range(len(planes)))
    for i, ref in refs.items():
        for a, b in zip(out[i].planes, ref):
            assert np.array_equal(a.numpy(), b)


def test_cropped_recon_equals_decode():
    """At 74x42 the decoder crops the coded 80x48 frame; the crop of the
    recon is what it gives."""
    w, h = 74, 42
    planes = frames(w, h, 4)
    refs = {}
    enc, pk = encode(TEnc, TFrame, planes, w, h, refs=refs, qp=26)
    out = decode(pk, b"", 2)
    for i, ref in refs.items():
        assert out[i].planes[0].shape == (h, w)
        for a, b in zip(out[i].planes, ref):
            assert np.array_equal(a.numpy(), b[:a.shape[0], :a.shape[1]])


def _syngen(gen_cls, kw, script):
    g = gen_cls(4, 3, **kw)
    g.headers()
    for step, args in script:
        getattr(g, step)(**args)
    return g.bytes()


# the generator's scripts of the JAX package's tests/test_h264_high.py,
# at 4x3 MBs
SYNGEN = {
    "i8x8": ({"seed": 1}, [("i_frame", {"mix": ("i8",)})]),
    "qp46": ({"seed": 49, "qp": 46}, [("i_frame", {"mix": ("i8", "i4")})]),
    "sps_matrices": ({"seed": 4, "scaling": "sps"},
                     [("i_frame", {}), ("p_frame", {})]),
    "pps_matrices": ({"seed": 5, "scaling": "pps"},
                     [("i_frame", {}), ("p_frame", {})]),
    "cqp2": ({"seed": 6, "cqp_off": 3, "cqp_off2": -4},
             [("i_frame", {}), ("p_frame", {})]),
    "weights_multi_ref": (
        {"seed": 10, "weighted": 1, "num_ref": 3, "transform_8x8": False},
        [("i_frame", {"mix": ("i16",)})]
        + [("p_frame", {"intra_prob": 0.05})] * 4),
    "reorder_mmco": (
        {"seed": 13, "num_ref": 3, "transform_8x8": False},
        [("i_frame", {"mix": ("i16",)}), ("p_frame", {}),
         ("p_frame", {"reorder": ((0, 1), (1, 0))}),
         ("p_frame", {"mmco": ((4, 1), (3, 0, 0))}), ("p_frame", {})]),
    "slices": ({"seed": 14, "scaling": "sps", "weighted": 1, "num_ref": 2},
               [("i_frame", {"slices": 3}), ("p_frame", {"slices": 2})]),
}


@pytest.mark.parametrize("name", list(SYNGEN))
def test_syngen_streams_equal(name):
    """The High-profile generator (inter_enc's MotionCtx inside) writes
    the same stream in both packages, and the CABAC recode of it too."""
    from librempeg_tpu.codecs.h264.entropy_transcode import (
        cavlc_to_cabac as j_cabac,
    )
    from librempeg_tpu_torch.codecs.h264.entropy_transcode import (
        cavlc_to_cabac as t_cabac,
    )

    kw, script = SYNGEN[name]
    j = _syngen(JGen, kw, script)
    t = _syngen(TGen, kw, script)
    assert j == t
    if name in ("i8x8", "sps_matrices"):
        assert j_cabac(j) == t_cabac(t)
