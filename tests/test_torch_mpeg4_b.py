"""The port's MPEG-4 B-VOPs (-bf) against the JAX package's on the CPU.

Integer paths are bit-exact (tolerance 0): the B-VOP search
(full_search_mc_hpel) and _encode_b_device's MVs and SAD costs on
integer-valued references, the direct-mode MV scaling, and the Advanced
Simple VOL and B-VOP headers. Residual levels come from the float32 DCT
and quantiser: at most 0.1% may differ (test_torch_mpeg4._levels_close).
Streams at constant qscale (g 12, bf 2, trellis 0 and 1): packet types,
pts and dts equal the JAX encoder's; the JAX package's decoder decodes
the port's stream to within 0.5 dB per frame of the JAX stream (PSNR
against the encoder's input); the port's vendored decoder gives the JAX
decoder's planes exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from librempeg_tpu.codecs.mpeg4 import decoder as JD
from librempeg_tpu.codecs.mpeg4 import encoder as JE
from librempeg_tpu.core.frame import VideoFrame as JFrame
from librempeg_tpu.core.rational import Rational as JRational
from librempeg_tpu.ops import motion as JM
from librempeg_tpu_torch import compat
from librempeg_tpu_torch.codecs.mpeg4 import _decoder as TD
from librempeg_tpu_torch.codecs.mpeg4 import encoder as TE
from librempeg_tpu_torch.core.frame import VideoFrame as TFrame
from librempeg_tpu_torch.core.rational import Rational as TRational
from librempeg_tpu_torch.ops import motion as TM
from test_torch_mpeg4 import _eq, _frames, _levels_close, _psnr, _t
from tools.mpeg4_jax_repair import repaired


@pytest.fixture(autouse=True, scope="module")
def _jax_mpeg4_reference():
    """The JAX encoder with its decoder's reference, as the port's
    encoder has it (tools/mpeg4_jax_repair.py): its float recon is the
    fault the port repairs, so byte and level comparisons hold the port
    to the repaired JAX encoder."""
    with repaired():
        yield


W, H = 96, 64
N = 15


def _clip(n=N):
    """Smooth texture panning at 2 px/frame (luma) with drifting chroma,
    as the JAX package's own B-frame test makes it."""
    from numpy.lib.stride_tricks import sliding_window_view

    rng = np.random.default_rng(7)
    big = rng.integers(0, 256, (H + 60, W + 60)).astype(np.float32)
    sm = np.clip(sliding_window_view(big, (7, 7)).mean(axis=(2, 3)), 0,
                 255).astype(np.uint8)
    return [(sm[10 + i:10 + i + H, 10 + 2 * i:10 + 2 * i + W].copy(),
             sm[5:5 + H // 2, 6 + i:6 + i + W // 2].copy(),
             sm[2:2 + H // 2, 15 + i:15 + i + W // 2].copy())
            for i in range(n)]


def _jax_enc(**opts):
    return JE.Mpeg4Encoder(width=W, height=H, framerate=JRational(25, 1),
                           **opts)


def _port_enc(**opts):
    return TE.Mpeg4Encoder(width=W, height=H, framerate=TRational(25, 1),
                           device="cpu", **opts)


def _feed(enc, frames, port, start=0, flush=True):
    Frame, Rat = (TFrame, TRational) if port else (JFrame, JRational)
    pkts = []
    for i, planes in enumerate(frames, start):
        if port:
            planes = tuple(_t(p) for p in planes)
        pkts += enc.encode(Frame(planes=planes, format="yuv420p", width=W,
                                 height=H, pts=i, time_base=Rat(1, 25)))
    return pkts + (enc.flush() if flush else [])


def _types(pkts):
    out = ""
    for p in pkts:
        d = bytes(p.data)
        out += "IPBS"[d[d.index(b"\x00\x00\x01\xb6") + 4] >> 6]
    return out


def _decode(dec_cls, pkts):
    dec = dec_cls()
    out = []
    for p in pkts:
        out += dec.decode(p)
    return [tuple(np.asarray(x) for x in f.planes) for f in out + dec.flush()]


def _frame_psnr(frames, decoded):
    return [min(_psnr(a, b) for a, b in zip(f, d))
            for f, d in zip(frames, decoded)]


@pytest.fixture(scope="module")
def streams():
    """{trellis: (jax packets, port packets)} for the N-frame clip at
    qscale 5, g 12, bf 2."""
    frames = _clip()
    out = {}
    for rd in (0, 1):
        opts = dict(qscale=5, gop_size=12, max_b_frames=2, trellis=rd)
        out[rd] = (_feed(_jax_enc(**opts), frames, False),
                   _feed(_port_enc(**opts), frames, True))
    return frames, out


@pytest.mark.parametrize("seed", [0, 1])
def test_full_search_mc_hpel_bit_exact(seed):
    (cy, _, _), (ry, _, _) = _frames(seed, h=H, w=W)
    cur, ref = cy.astype(np.float32)[None], ry.astype(np.float32)[None]
    jo = JM.full_search_mc_hpel(jnp.asarray(cur), jnp.asarray(ref), 8, 16,
                                0, 2)
    to = TM.full_search_mc_hpel(_t(cur), _t(ref), 8, 16, 0, 2)
    assert to[0].dtype == torch.int32
    for a, b, name in zip(jo, to, ("mv", "cost", "pred")):
        _eq(a, b, name)


def test_encode_b_device_matches_on_integer_refs():
    # the clip's size, so the JAX package's B pass compiles once for this
    # test and the streams below
    (fy, fu, fv), (y, u, v), (by, bu, bv) = _frames(4, h=H, w=W, n=3)
    refs = [a.astype(np.float32) for a in (fy, fu, fv, by, bu, bv)]
    rng = np.random.default_rng(4)
    dmvf = rng.integers(-6, 7, (1, H // 16, W // 16, 2)).astype(np.int32)
    dmvb = -dmvf
    q = 5
    jo = JE._encode_b_device(*(jnp.asarray(a) for a in (y, u, v, *refs)),
                             jnp.int32(q), jnp.asarray(dmvf),
                             jnp.asarray(dmvb), 8)
    to = TE._encode_b_device(*(_t(a) for a in (y, u, v, *refs)), q,
                             _t(dmvf), _t(dmvb), 8)
    for k in ("mvf", "mvb", "cost_f", "cost_b", "cost_bi", "cost_d"):
        _eq(jo[k], to[k], k)
    for k in TE._B_LEVELS:
        assert to[k].dtype == torch.int16
        _levels_close(jo[k], to[k], f"B levels {k}")
    # the one host fetch carries every output unchanged
    back = TE._unpack_b_outputs(TE._pack_b_outputs(to).numpy(),
                                H // 16, W // 16)
    for k in TE._B_LEVELS + TE._B_MAPS:
        _eq(to[k], back[k], f"fetch {k}")


def test_direct_mvs_exact():
    rng = np.random.default_rng(2)
    mvs = rng.integers(-30, 31, (H // 16, W // 16, 2)).astype(np.int32)
    for pad, cad, d in ((0, 3, 1), (0, 3, 2), (3, 6, 5), (9, 12, 10),
                        (12, 13, 12)):
        out = []
        for enc in (_jax_enc(max_b_frames=2), _port_enc(max_b_frames=2)):
            enc._anchor_mvs = mvs
            enc._prev_anchor_disp, enc._cur_anchor_disp = pad, cad
            out.append(enc._direct_mvs(d))
        for a, b in zip(*out):
            _eq(a, b, f"direct MVs trb={d - pad} trd={cad - pad}")


def test_bframe_headers_byte_equal():
    jp = JE._Mpeg4Packer(W, H, JRational(25, 1), 5, bframes=True)
    tp = TE._Mpeg4Packer(W, H, TRational(25, 1), 5, bframes=True)
    assert jp.sequence_headers() == tp.sequence_headers()
    # display order I0 P3 B1 B2 ... across a second boundary
    for ctype, idx, q in ((0, 0, 5), (1, 3, 6), (2, 1, 7), (2, 2, 7),
                          (1, 24, 5), (2, 23, 9), (1, 27, 4), (2, 25, 8),
                          (2, 26, 8), (0, 50, 3), (2, 49, 3)):
        bj, bt = JE.BitWriter(), TE.BitWriter()
        jp.vop(bj, ctype, idx, q)
        tp.vop(bt, ctype, idx, q)
        bj.align_stuffing()
        bt.align_stuffing()
        assert bj.bytes() == bt.bytes(), (ctype, idx)


@pytest.mark.parametrize("rd", [0, 1], ids=["trellis0", "trellis1"])
def test_stream_types_and_timestamps_match(streams, rd):
    _, out = streams
    jp, tp = out[rd]
    assert len(jp) == len(tp) == N
    assert _types(jp) == _types(tp) == "IPBBPBBPBBIBBPB"
    assert [p.pts for p in jp] == [p.pts for p in tp]
    assert [p.dts for p in jp] == [p.dts for p in tp] == list(range(N))
    assert sorted(p.pts for p in tp) == list(range(N))
    assert [bool(p.flags) for p in jp] == [bool(p.flags) for p in tp]
    js, ts = (sum(len(p.data) for p in x) for x in (jp, tp))
    print(f"trellis {rd}: {js} vs {ts} bytes (JAX vs port)")


@pytest.mark.parametrize("rd", [0, 1], ids=["trellis0", "trellis1"])
def test_jax_decoder_reads_port_stream(streams, rd):
    frames, out = streams
    jp, tp = out[rd]
    dj = _decode(JD.Mpeg4Decoder, jp)
    dt = _decode(JD.Mpeg4Decoder, tp)
    assert len(dj) == len(dt) == N
    pj, pt = _frame_psnr(frames, dj), _frame_psnr(frames, dt)
    print("decoded PSNR JAX stream:", " ".join(f"{p:.2f}" for p in pj))
    print("decoded PSNR port stream:", " ".join(f"{p:.2f}" for p in pt))
    assert all(abs(a - b) <= 0.5 for a, b in zip(pj, pt)), (pj, pt)
    assert min(pt) > 30


def test_vendored_decoder_equals_jax_decoder(streams):
    _, out = streams
    tp = out[1][1]
    dj = _decode(JD.Mpeg4Decoder, tp)
    dt = _decode(lambda: TD.Mpeg4Decoder(device="cpu"), tp)
    assert len(dj) == len(dt) == N
    for i, (a, b) in enumerate(zip(dj, dt)):
        for pa, pb in zip(a, b):
            _eq(pa, pb, f"decoded frame {i}")


def test_b_coding_not_larger_than_p_only(streams):
    """The JAX package's own gate (tests/test_mpeg4_b.py
    test_encoder_b_frames): at equal qscale the B stream stays within
    1.15x of the P-only stream's size, in both packages."""
    frames, out = streams
    for port, name in ((False, "JAX"), (True, "port")):
        enc = (_port_enc if port else _jax_enc)(qscale=5, gop_size=12)
        p_only = sum(len(p.data) for p in _feed(enc, frames, port))
        bf2 = sum(len(p.data) for p in out[0][int(port)])
        print(f"{name} bytes: bf 0 {p_only}, bf 2 {bf2} "
              f"(ratio {bf2 / p_only:.4f})")
        assert bf2 <= p_only * 1.15, (name, bf2, p_only)


def test_mid_gop_start_from_jax_state():
    """The JAX encoder codes 7 frames (I0 P3 B1 B2 P6 B4 B5, frame 7
    pending); the port continues from its state via
    compat.encoder_state_from_numpy; the remaining packets match the
    JAX encoder's in type, pts and dts, and their sizes."""
    frames = _clip()
    opts = dict(qscale=5, gop_size=12, max_b_frames=2)
    je = _jax_enc(**opts)
    _feed(je, frames[:8], False, flush=False)
    assert len(je._pending) == 1

    def arr(x):
        return None if x is None else [np.asarray(p) for p in x]

    te = compat.encoder_state_from_numpy(
        W, H, arr(je._ref), frame_idx=je._frame_idx, device="cpu",
        packer={"last_sec": je._packer.last_sec,
                "prev_sec": je._packer.prev_sec},
        bframes={"prev_anchor": arr(je._prev_anchor),
                 "anchor_skip": je._anchor_skip,
                 "anchor_mvs": je._anchor_mvs,
                 "pending": [(arr(f.planes), d) for f, d in je._pending],
                 "disp_idx": je._disp_idx, "decode_idx": je._decode_idx,
                 "prev_anchor_disp": je._prev_anchor_disp,
                 "cur_anchor_disp": je._cur_anchor_disp},
        **opts)
    jp = _feed(je, frames[8:], False, start=8)
    tp = _feed(te, frames[8:], True, start=8)
    assert _types(jp) == _types(tp) == "PBBIBBPB"
    assert [p.pts for p in jp] == [p.pts for p in tp]
    assert [p.dts for p in jp] == [p.dts for p in tp]
    for a, b in zip(jp, tp):
        print(f"pts {a.pts}: {len(a.data)} vs {len(b.data)} bytes")
        assert abs(len(a.data) - len(b.data)) <= 0.01 * len(a.data) + 4
