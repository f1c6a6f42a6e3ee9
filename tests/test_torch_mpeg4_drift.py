"""The MPEG-4 encoder's reference is the picture its decoder rebuilds.

The port's encoder (librempeg_tpu_torch/codecs/mpeg4/encoder.py) takes,
for ME, MC and the next VOP, the integer picture its decoder
(codecs/mpeg4/_decoder.py) reconstructs from the written bits: the
decoder's dequantiser with its int16 storage, its simple_idct (as
float64 matrix products, exact), integer prediction. On a 96x64 clip,
P-only (g 12) and with B-VOPs (bf 2), at qscale 3, 5 and 8, the
decoder reproduces the encoder's reference of every I-VOP and P-VOP bit
for bit.

The JAX package's encoder keeps a float recon (clamped, not rounded)
from its float IDCT and predicts from it; its own decoder then drifts
from the first P-VOP, which the same test asserts on the unmodified
JAX encoder (more than 1000 of 6144 luma samples differ there). With
tools/mpeg4_jax_repair.py, the repair the goldens and the JAX side of
the parity tests run under, its decoder reproduces its reference
exactly too.
"""
import numpy as np
import pytest
import torch

from librempeg_tpu.codecs.mpeg4 import decoder as JD
from librempeg_tpu.codecs.mpeg4 import encoder as JE
from librempeg_tpu.core.frame import VideoFrame as JFrame
from librempeg_tpu.core.rational import Rational as JR
from librempeg_tpu_torch.codecs.mpeg4 import _decoder as TD
from librempeg_tpu_torch.codecs.mpeg4 import encoder as TE
from librempeg_tpu_torch.core.frame import VideoFrame as TFrame
from librempeg_tpu_torch.core.rational import Rational as TR
from test_torch_mpeg4_b import H, W, _clip
from tools.mpeg4_jax_repair import repaired

N = 12


def _np(x) -> np.ndarray:
    """A plane (tensor or array) as float64 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, np.float64)


def _encode(port: bool, q: int, bf: int):
    """The packets and each anchor's reference {pts: (y, u, v)}."""
    opts = dict(qscale=q, gop_size=12, max_b_frames=bf)
    if port:
        enc = TE.Mpeg4Encoder(width=W, height=H, framerate=TR(25, 1),
                              device="cpu", **opts)
    else:
        enc = JE.Mpeg4Encoder(width=W, height=H, framerate=JR(25, 1),
                              **opts)
    refs = {}
    inner = enc.encode_async

    def take(frame, **kw):
        h = inner(frame, **kw)
        refs[int(frame.pts)] = tuple(_np(r) for r in enc._ref)
        return h

    enc.encode_async = take
    pkts = []
    for i, planes in enumerate(_clip(N)):
        if port:
            f = TFrame(planes=tuple(torch.from_numpy(p) for p in planes),
                       format="yuv420p", width=W, height=H, pts=i,
                       time_base=TR(1, 25))
        else:
            f = JFrame(planes=planes, format="yuv420p", width=W, height=H,
                       pts=i, time_base=JR(1, 25))
        pkts += enc.encode(f)
    return pkts + enc.flush(), refs


def _decoded(dec, pkts):
    out = []
    for p in pkts:
        out += dec.decode(p)
    return {int(f.pts): tuple(_np(x) for x in f.planes)
            for f in out + dec.flush()}


def _mismatch(decoded, refs):
    """Per anchor pts: the samples of the decode that differ from the
    encoder's reference, over the three planes and in luma alone."""
    return {t: (sum(int((d != r).sum()) for d, r in zip(decoded[t], ref)),
                int((decoded[t][0] != ref[0]).sum()))
            for t, ref in sorted(refs.items())}


@pytest.mark.parametrize("bf", [0, 2], ids=["P", "B"])
@pytest.mark.parametrize("q", [3, 5, 8])
def test_port_decoder_reproduces_the_reference(q, bf):
    pkts, refs = _encode(True, q, bf)
    assert len(refs) == (N if not bf else 5)
    got = _mismatch(_decoded(TD.Mpeg4Decoder(device=None), pkts), refs)
    assert all(v == (0, 0) for v in got.values()), got
    # the reference is integer-valued in 0..255 (no float recon left)
    for ref in refs.values():
        for r in ref:
            assert np.array_equal(r, np.clip(np.round(r), 0, 255))


@pytest.mark.parametrize("q", [3, 5, 8])
def test_jax_reference_drifts_and_the_repair_holds(q):
    pkts, refs = _encode(False, q, 0)
    got = _mismatch(_decoded(JD.Mpeg4Decoder(), pkts), refs)
    assert got[1][1] > 1000, got            # the first P-VOP, luma
    assert all(got[t][0] > 0 for t in range(1, N))
    with repaired():
        pkts, refs = _encode(False, q, 0)
    got = _mismatch(_decoded(JD.Mpeg4Decoder(), pkts), refs)
    assert all(v == (0, 0) for v in got.values()), got


def test_an_overflowing_fetch_repacks_the_same_levels(monkeypatch):
    """A pass whose levels overflow the fetch layout's caps is re-packed
    from the levels it kept, in the full layout: the same packets as
    with caps that fit, and the decoder still rebuilds every
    reference."""
    want, _ = _encode(True, 3, 0)
    monkeypatch.setattr(TE.Mpeg4Encoder, "_fat_caps", lambda self: (2, 16))
    got, refs = _encode(True, 3, 0)
    assert [bytes(p.data) for p in got] == [bytes(p.data) for p in want]
    dec = _decoded(TD.Mpeg4Decoder(device=None), got)
    assert all(v == (0, 0) for v in _mismatch(dec, refs).values())


def test_slim_fetch_keeps_tails_past_block_32767():
    """The slim fetch layout sends the blocks with levels past zigzag 31
    by index in int16 slots. A 1080p frame has 48960 blocks, so a
    chroma block's index passes 32767: the port reads the slot unsigned
    and rebuilds every level; the JAX package reads it signed and files
    that block's tail under a luma block (its 1080p MPEG-4 then decodes
    to other pictures than its reference)."""
    import jax.numpy as jnp

    w, h = 1920, 1088
    nblk = (h // 8) * (w // 8) + 2 * (h // 16) * (w // 16)
    zz = np.zeros((nblk, 64), np.int16)
    rng = np.random.default_rng(5)
    for b in (7, 16305, 32767, 32768, 40000, nblk - 1):
        zz[b, rng.integers(0, 64, 6)] = rng.integers(-40, 40, 6)
        zz[b, 40] = 3
    tail = np.zeros(2, np.int16)
    port = TE.Mpeg4Encoder(width=w, height=h, framerate=TR(25, 1),
                           device="cpu")
    port._sp_init()
    assert port._sp_slim_ok
    packed = torch.cat(TE._sparsify_slim(torch.from_numpy(zz))).numpy()
    flat, _ = port._unsparsify_slim(np.concatenate([packed, tail]))
    assert np.array_equal(flat.reshape(nblk, 64), zz)
    jax_enc = JE.Mpeg4Encoder(width=w, height=h, framerate=JR(25, 1))
    jparts = JE._sparsify_slim(jnp.asarray(zz))
    jflat, _ = jax_enc._unsparsify_slim(np.concatenate(
        [np.asarray(p) for p in jparts] + [tail]))
    wrong = np.flatnonzero((jflat.reshape(nblk, 64) != zz).any(axis=1))
    # each tail past 32767 lost, and filed under index - 65536 + nblk
    moved = {b for b in (32768, 40000, nblk - 1)}
    assert set(wrong.tolist()) == moved | {b - 65536 + nblk for b in moved}
