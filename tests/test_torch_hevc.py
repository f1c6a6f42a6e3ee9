"""The port's HEVC decoder and stream generator (copies of the JAX
package's codecs/hevc/) against the JAX package's.

Every generator configuration of the JAX package's own conformance
tests (tests/test_hevc.py, which needs a reference ffmpeg) runs here
through both packages: the port's stream bytes must equal the JAX
generator's, and the port's decoded planes the JAX decoder's, bit for
bit. Each stream goes to both decoders whole, as one packet, as the
JAX package's tests give it (no container splits it). A few more cases
cover sizes the conformance tests do not: a partial last CTB row (the
shape of every 1080-line picture at 32x32 CTBs), a cropped
conformance window and a 2-slice I/P/B stream at 320x240.
"""
import random

import numpy as np
import pytest
import torch

from librempeg_tpu.codecs.hevc import cabac as JC
from librempeg_tpu.codecs.hevc import decoder as JD
from librempeg_tpu.codecs.hevc import tables as JT
from librempeg_tpu.core.packet import Packet as JPacket
from librempeg_tpu_torch.codecs.hevc import cabac as TC
from librempeg_tpu_torch.codecs.hevc import decoder as TD
from librempeg_tpu_torch.codecs.hevc import tables as TT
from librempeg_tpu_torch.core.packet import Packet as TPacket

# (w, h, generate_stream options): tests/test_hevc.py's checks, in order
CASES = {
    "flat_intra": (64, 64, dict(split_prob=0.0, density=0.0, seed=0)),
    "residuals": (64, 64, dict(split_prob=0.0, density=0.3, seed=1)),
    "quadtree_splits": (64, 64, dict(split_prob=0.5, nxn_prob=0.4, seed=2)),
    "high_amplitude": (64, 64, dict(amp=40, seed=3)),
    "qp12": (64, 64, dict(qp=12, seed=4)),
    "qp45": (64, 64, dict(qp=45, seed=5)),
    "multiframe_nonsquare": (96, 64, dict(split_prob=0.5, nxn_prob=0.5,
                                          seed=6, n_frames=2)),
    "ctb64": (64, 64, dict(ctb_log2=6, split_prob=0.6, seed=7)),
    "ctb16": (64, 64, dict(ctb_log2=4, split_prob=0.4, nxn_prob=0.5,
                           seed=8)),
    **{f"seed_sweep_{s}": (64, 64, dict(split_prob=0.45, nxn_prob=0.4,
                                        density=0.35, amp=12, seed=s))
       for s in range(30, 36)},
    "p_basic": (64, 64, dict(n_frames=6, seed=21, split_prob=0.4,
                             p_frames=True)),
    "p_merge1": (64, 64, dict(n_frames=5, seed=22, max_merge=1,
                              p_frames=True)),
    "p_merge2": (64, 64, dict(n_frames=5, seed=23, max_merge=2,
                              p_frames=True)),
    "p_qp12": (64, 64, dict(n_frames=4, seed=24, qp=12, p_frames=True)),
    "p_qp45": (64, 64, dict(n_frames=4, seed=25, qp=45, p_frames=True)),
    "p_nonsquare_parts": (96, 64, dict(n_frames=5, seed=26, split_prob=0.5,
                                       nxn_prob=0.4, p_frames=True)),
    "p_ctb16": (64, 64, dict(ctb_log2=4, n_frames=3, seed=27,
                             split_prob=0.4, p_frames=True)),
    "p_ctb64": (64, 64, dict(ctb_log2=6, n_frames=3, seed=28,
                             split_prob=0.6, p_frames=True)),
    "b_basic": (64, 64, dict(n_frames=5, seed=40, split_prob=0.4,
                             b_frames=True)),
    "b_merge1": (64, 64, dict(n_frames=5, seed=41, max_merge=1,
                              b_frames=True)),
    "b_merge3": (64, 64, dict(n_frames=5, seed=42, max_merge=3,
                              b_frames=True)),
    "b_mvd_l1_zero": (64, 64, dict(n_frames=5, seed=43, b_frames=True,
                                   mvd_l1_zero=True)),
    "b_parts": (96, 64, dict(n_frames=5, seed=44, split_prob=0.5,
                             nxn_prob=0.4, b_frames=True)),
    "b_ctb16": (64, 64, dict(ctb_log2=4, n_frames=5, seed=45,
                             split_prob=0.4, b_frames=True)),
    "b_deblock": (64, 64, dict(n_frames=5, seed=46, b_frames=True,
                               deblock=True)),
    "b_sao": (64, 64, dict(n_frames=5, seed=47, b_frames=True,
                           deblock=True, sao=True)),
    "b_slices3": (64, 64, dict(n_frames=5, seed=60, b_frames=True,
                               slices=3)),
    "b_slices2_filters": (64, 64, dict(n_frames=5, seed=61, b_frames=True,
                                       slices=2, deblock=True, sao=True)),
    "deblock_intra": (64, 64, dict(deblock=True, split_prob=0.4,
                                   nxn_prob=0.3, density=0.3, seed=20)),
    "deblock_intra_dense": (64, 64, dict(deblock=True, split_prob=0.0,
                                         density=0.6, amp=20, seed=21)),
    "deblock_offsets_pos": (64, 64, dict(deblock=True, density=0.4, amp=12,
                                         seed=22, beta_offset=4,
                                         tc_offset=2)),
    "deblock_offsets_neg": (64, 64, dict(deblock=True, density=0.4, amp=12,
                                         seed=23, beta_offset=-2,
                                         tc_offset=-2)),
    **{f"deblock_qp{qp}": (64, 64, dict(deblock=True, density=0.4, amp=10,
                                        qp=qp, seed=24 + qp))
       for qp in (18, 30, 42)},
    "deblock_p": (64, 64, dict(deblock=True, p_frames=True, n_frames=4,
                               density=0.3, seed=30)),
    "deblock_p_flat": (64, 64, dict(deblock=True, p_frames=True,
                                    n_frames=3, density=0.0, seed=31)),
    "sao_band_edge": (64, 64, dict(sao=True, seed=40)),
    "sao_band_edge_res": (64, 64, dict(sao=True, seed=41, density=0.4,
                                       amp=10)),
    "sao_after_deblock": (64, 64, dict(sao=True, deblock=True, seed=42)),
    "sao_after_deblock_p": (64, 64, dict(sao=True, deblock=True,
                                         p_frames=True, n_frames=3,
                                         seed=43)),
    "sao_luma_only": (64, 64, dict(sao=True, sao_chroma=False, seed=44)),
    **{f"sao_ctb{1 << c}": (64, 64, dict(sao=True, ctb_log2=c,
                                         seed=45 + c))
       for c in (4, 5, 6)},
    "slices2": (64, 64, dict(slices=2, seed=50)),
    "slices3_deblock": (64, 64, dict(slices=3, seed=51, deblock=True)),
    "slices4_ctb16": (64, 64, dict(slices=4, seed=53, ctb_log2=4)),
    "slices2_sao_p": (64, 64, dict(slices=2, seed=52, sao=True,
                                   p_frames=True, n_frames=3)),
    "slices3_sao_deblock_p": (64, 64, dict(slices=3, seed=54, sao=True,
                                           deblock=True, p_frames=True,
                                           n_frames=2)),
    # beyond the conformance tests: 72 lines are 2.25 rows of 32x32 CTBs
    "partial_ctb_row": (128, 72, dict(n_frames=3, seed=14, b_frames=True,
                                      deblock=True, sao=True, slices=2)),
    "cropped": (100, 60, dict(n_frames=2, seed=15, p_frames=True,
                              deblock=True)),
    "b_slices2_320x240": (320, 240, dict(n_frames=3, seed=16,
                                         b_frames=True, deblock=True,
                                         sao=True, slices=2)),
}


def jax_decode(stream: bytes) -> list:
    dec = JD.HevcDecoder()
    frames = dec.decode(JPacket(data=stream, pts=0)) + dec.flush()
    return [[np.asarray(p) for p in f.planes] for f in frames]


def port_decode(stream: bytes) -> list:
    dec = TD.HevcDecoder(device="cpu")
    frames = dec.decode(TPacket(data=stream, pts=0)) + dec.flush()
    assert all(isinstance(p, torch.Tensor) and p.device.type == "cpu"
               for f in frames for p in f.planes)
    return [[p.numpy() for p in f.planes] for f in frames]


@pytest.mark.parametrize("case", list(CASES))
def test_stream_and_decode_equal_jax(case):
    w, h, kw = CASES[case]
    want = JD.generate_stream(w, h, **kw)
    got = TD.generate_stream(w, h, **kw)
    assert got == want
    jf, tf = jax_decode(want), port_decode(got)
    assert len(tf) == len(jf) == kw.get("n_frames", 1)
    for a, b in zip(tf, jf):
        assert [p.shape for p in a] == [(h, w), (h // 2, w // 2),
                                        (h // 2, w // 2)]
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(pa, pb)


@pytest.mark.parametrize("seed", [7, 8])
def test_cabac_round_trip_equal_jax(seed):
    """tests/test_hevc.py's CABAC round trip through the port's coder,
    and its bytes equal to the JAX coder's."""
    rng = random.Random(seed)
    ops = [(rng.randrange(3), rng.randrange(2), rng.randrange(150))
           for _ in range(4000)]
    encs = [TC.CabacEncoder(0, 30), JC.CabacEncoder(0, 30)]
    for enc in encs:
        for kind, bit, ctx in ops:
            if kind == 0:
                enc.encode_decision(ctx, bit)
            elif kind == 1:
                enc.encode_bypass(bit)
        enc.encode_terminate(1)
    data = encs[0].bytes()
    assert data == encs[1].bytes()
    dec = TC.CabacDecoder(data, 0, 0, 30)
    for kind, bit, ctx in ops:
        if kind == 0:
            assert dec.decision(ctx) == bit
        elif kind == 1:
            assert dec.bypass() == bit
    assert dec.terminate() == 1 and not dec.error


def test_tables_equal_jax():
    names = [n for n in dir(JT) if n.isupper()]
    assert len(names) > 5
    for n in names:
        a, b = getattr(TT, n), getattr(JT, n)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, n


def test_frames_on_the_named_device():
    """With device=None the frames are numpy views, as the JAX
    package's; with device="cpu" CPU tensors; a CUDA request without a
    card, the default included, raises at construction."""
    stream = TD.generate_stream(64, 64, n_frames=3, b_frames=True, seed=3)
    dec = TD.HevcDecoder(device=None)
    frames = dec.decode(TPacket(data=stream, pts=0)) + dec.flush()
    assert all(isinstance(p, np.ndarray) for f in frames for p in f.planes)
    tf = port_decode(stream)
    for f, t in zip(frames, tf):
        for a, b in zip(f.planes, t):
            np.testing.assert_array_equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TD.HevcDecoder(device="cuda")
        with pytest.raises(RuntimeError):
            TD.HevcDecoder()


def test_display_pts_from_decode_order_packets():
    """One packet per picture, stamped 0, 1, 2, ... in decode order (as
    a raw stream's demuxer stamps them): the frames leave in display
    order with pts 0, 1, 2, ...; packets stamped with display times
    (I0 P2 B1 P4 B3) keep them. The JAX decoder gives each frame its
    packet's pts, so the first case reads 0, 2, 1, 4, 3 there."""
    from librempeg_tpu.codecs.hevc import ps as JPS

    stream = TD.generate_stream(64, 64, n_frames=5, b_frames=True, seed=4,
                                slices=2)
    head, pics = b"", []
    for t, nal in JPS.split_nals(stream, raw=True):
        unit = b"\x00\x00\x00\x01" + nal
        if t >= 32:
            head += unit
        elif nal[2] & 0x80:
            pics.append(head + unit)
            head = b""
        else:
            pics[-1] += unit
    assert len(pics) == 5

    def run(dec, packet_cls, stamps):
        out = [f for d, s in zip(pics, stamps)
               for f in dec.decode(packet_cls(data=d, pts=s, dts=s))]
        return out + dec.flush()

    j = run(JD.HevcDecoder(), JPacket, range(5))
    assert [f.pts for f in j] == [0, 2, 1, 4, 3]
    t = run(TD.HevcDecoder(device="cpu"), TPacket, range(5))
    assert [f.pts for f in t] == [0, 1, 2, 3, 4]
    for a, b in zip(t, j):
        for pa, pb in zip(a.planes, b.planes):
            np.testing.assert_array_equal(pa.numpy(), pb)
    shown = run(TD.HevcDecoder(device="cpu"), TPacket, [0, 2, 1, 4, 3])
    assert [f.pts for f in shown] == [0, 1, 2, 3, 4]
