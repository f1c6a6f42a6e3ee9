"""The port's H264Decoder(device="cpu") against the JAX package's
H264Decoder, host path (device=0) and XLA device path (device=1).

Decoded frames must be bit-exact (tolerance 0). The streams are made by
the JAX package's H264Encoder from numpy frames with fixed seeds: a
smooth-motion clip (IDR + all-inter P frames), a variety clip (every
MB shape, I4x4/I16x16 intra-in-P, so the intra and strong-deblock paths
run; without I_PCM, which would send its P frames to the host path, and
with it), and a clip with dense runs of adjacent intra MBs. On the CPU the port's P frames go through the plain versions of
the MC, intra and deblock kernels.
"""
import numpy as np
import pytest

from librempeg_tpu.codecs.h264.codec import H264Decoder as JDecoder
from librempeg_tpu.codecs.h264.codec import H264Encoder
from librempeg_tpu.core.frame import VideoFrame
from librempeg_tpu.core.rational import Rational
from librempeg_tpu_torch import compat
from librempeg_tpu_torch.codecs.h264.codec import H264Decoder as TDecoder
from librempeg_tpu_torch.core.packet import Packet as TPacket
from librempeg_tpu_torch.core.rational import Rational as TRational
from librempeg_tpu_torch.formats.api import CodecParameters as TPar


def _smooth(w=96, h=64, n=8):
    """Smooth-motion clip (keeps P frames all-inter), one GOP."""
    rng = np.random.default_rng(11)
    gy, gx = np.mgrid[0:h * 2, 0:w * 2]
    base = np.clip(128 + 60 * np.sin(gx / 23.0) * np.cos(gy / 17.0)
                   + rng.normal(0, 2, (h * 2, w * 2)), 0,
                   255).astype(np.uint8)
    frames = []
    for i in range(n):
        y = base[i:h + i, i * 2:w + i * 2]
        u = base[i // 2:h // 2 + i // 2, i:w // 2 + i]
        v = base[i // 2 + 4:h // 2 + i // 2 + 4, i + 2:w // 2 + i + 2]
        frames.append((y.copy(), u.copy(), v.copy()))
    return w, h, frames, dict(qp=26, g=n)


def _variety(w=80, h=48, n=8, pcm=0):
    """Every MB shape (but I_PCM unless `pcm`), incl. intra-in-P; IDR
    every 4 frames. With I_PCM (the JAX package's own torture stream)
    every P frame takes the native host path."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (h * 2, w * 2)).astype(np.uint8)
    frames = []
    for i in range(n):
        y = base[i:h + i, i * 2:w + i * 2].copy()
        u = rng.integers(90, 166, (h // 2, w // 2)).astype(np.uint8)
        v = rng.integers(90, 166, (h // 2, w // 2)).astype(np.uint8)
        frames.append((y, u, v))
    return w, h, frames, dict(qp=30, g=4, variety=1, pcm=pcm)


def _intra_heavy(w=96, h=64, n=6):
    """Dense intra-in-P: a top band and a centre block get fresh noise
    every frame, so the encoder falls back to runs of adjacent intra MBs
    (left/top/top-right neighbours that are themselves intra)."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, (h * 2, w * 2)).astype(np.uint8)
    frames = []
    for i in range(n):
        y = base[i:h + i, i * 2:w + i * 2].copy()
        y[:16, :] = rng.integers(0, 256, (16, w))
        y[32:64, 32:80] = rng.integers(0, 256, (32, 48))
        u = rng.integers(90, 166, (h // 2, w // 2)).astype(np.uint8)
        v = rng.integers(90, 166, (h // 2, w // 2)).astype(np.uint8)
        frames.append((y, u, v))
    return w, h, frames, dict(qp=28, g=n)


def _encode(clip):
    w, h, frames, opts = clip
    enc = H264Encoder(width=w, height=h, **opts)
    pkts = [enc.encode(VideoFrame(planes=p, format="yuv420p", width=w,
                                  height=h, pts=i,
                                  time_base=Rational(1, 25)))[0]
            for i, p in enumerate(frames)]
    return enc.codec_parameters(), pkts


def _tpkt(pkt):
    return TPacket(data=bytes(pkt.data), pts=pkt.pts, dts=pkt.dts,
                   time_base=TRational(1, 25))


def _tdecoder(par, **kw):
    return TDecoder(TPar(codec_type="video", codec_id="h264",
                         width=par.width, height=par.height,
                         extradata=par.extradata), device="cpu", **kw)


def _eq_frames(jf, tf):
    assert len(jf) == len(tf)
    for a, b in zip(jf, tf):
        assert (a.width, a.height, a.pts) == (b.width, b.height, b.pts)
        for pa, pb in zip(a.planes, b.planes):
            pa = np.asarray(pa)
            pb = pb.cpu().numpy()
            bad = np.count_nonzero(pa != pb)
            assert bad == 0, f"{bad}/{pa.size} samples differ"


CLIPS = {"smooth": _smooth, "variety": _variety,
         "variety_pcm": lambda: _variety(pcm=1), "intra_heavy": _intra_heavy}


# the JAX decoder's XLA device path (device=1) on the clips whose P
# frames it takes (I_PCM sends them to its host path; the dense-intra
# clip is held to the host path, which device=1 equals in the JAX
# package's own tests)
@pytest.mark.parametrize("clip,jax_device", [
    ("smooth", 0), ("smooth", 1), ("variety", 0), ("variety", 1),
    ("variety_pcm", 0), ("intra_heavy", 0)])
def test_decoder_bit_exact(clip, jax_device):
    par, pkts = _encode(CLIPS[clip]())
    jd = JDecoder(par, device=jax_device)
    td = _tdecoder(par)
    n = 0
    for pkt in pkts:
        jf, tf = jd.decode(pkt), td.decode(_tpkt(pkt))
        _eq_frames(jf, tf)
        n += len(tf)
    _eq_frames(jd.flush(), td.flush())
    assert n == len(pkts)


def test_decoder_decode_ahead_bit_exact():
    """The decode-ahead entropy worker (prefetch > 0) gives the same
    frames as the synchronous path."""
    par, pkts = _encode(_variety())
    jd = JDecoder(par, device=0)
    td = _tdecoder(par, prefetch=2)
    jf, tf = [], []
    for pkt in pkts:
        jf += jd.decode(pkt)
        tf += td.decode(_tpkt(pkt))
    jf += jd.flush()
    tf += td.flush()
    _eq_frames(jf, tf)


def test_decoder_from_numpy_state_mid_gop():
    """The port starts mid-GOP from the JAX decoder's DPB, POC state
    and parameter sets (compat.decoder_state_from_numpy) and decodes the
    rest of the GOP bit-exactly."""
    par, pkts = _encode(_smooth(n=8))
    jd = JDecoder(par, device=0)
    for pkt in pkts[:4]:
        jd.decode(pkt)
    dpb = [{"y": np.asarray(e[1][0] if e[1] is not None else e[3][0]),
            "u": np.asarray(e[1][1] if e[1] is not None else e[3][1]),
            "v": np.asarray(e[1][2] if e[1] is not None else e[3][2]),
            "frame_num": e[0], "poc": e[5], "long_term": e[6]}
           for e in jd._dpb]
    td = compat.decoder_state_from_numpy(
        jd.sps, jd.pps, dpb, jd._poc_state, jd._dec_count, device="cpu")
    for pkt in pkts[4:]:
        _eq_frames(jd.decode(pkt), td.decode(_tpkt(pkt)))
