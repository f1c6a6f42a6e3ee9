"""The whole slice -- H.264 decode -> scale -> MPEG-4 encode -> AVI --
through the JAX package's Transcoder and the port's (device="cpu").

The clip: 96x64, 12 frames, IDR every 6, every MB shape but I_PCM
(so the port's P frames take the tensor path with intra MBs in them),
made by the JAX package's H264Encoder from numpy frames with a fixed
seed. The encoder runs at a constant qscale: with a bit-rate target
the pipelined rate control picks each quantiser before or after the
previous frame's size is known depending on thread timing, in both
packages.

Tolerances: decoded frames bit-exact; packet count and VOP types
identical; encoder recon port vs JAX >= 40 dB PSNR on every frame
(float DCT/quantiser: a level on a rounding boundary may differ). The
P-VOP motion vectors are reported, not asserted: the encoder's
reference planes are unrounded float32 recon, so a recon sample that
lands on 2.9999998 in one package and 3.0 in the other truncates to
another byte in the half-pel search, and the integer search's bf16 SAD
is summed through a bf16 q/r split in the JAX package but exactly in
float32 in the port (ops/motion.py), which can break near-ties
differently.

test_slice_options_match_jax runs the same clip with the options of an
everyday transcode: -pix_fmt yuvj420p (the range change through the
scaler's RGB path), -bf 2 and -trellis 1. The encoder's input frames
(yuvj420p) are held to the scaler's tolerance (at most 0.1% of samples
differ, by at most 1), the packet types, pts and dts must be equal, and
the anchors' recon as above.
"""
import numpy as np
import pytest

from librempeg_tpu.codecs.h264 import codec as JC
from librempeg_tpu.codecs.h264.codec import H264Encoder
from librempeg_tpu.codecs.mpeg4 import encoder as JE
from librempeg_tpu.core.frame import VideoFrame
from librempeg_tpu.core.rational import Rational
from librempeg_tpu.formats.api import open_input
from librempeg_tpu.sched import pipeline as JP
from librempeg_tpu_torch.codecs.h264 import codec as TC
from librempeg_tpu_torch.codecs.mpeg4 import encoder as TE
from librempeg_tpu_torch.sched import pipeline as TP
from tools.mpeg4_jax_repair import repaired


@pytest.fixture(autouse=True, scope="module")
def _jax_mpeg4_reference():
    """The JAX encoder with its decoder's reference, as the port's
    encoder has it (tools/mpeg4_jax_repair.py): its float recon is the
    fault the port repairs, so byte and level comparisons hold the port
    to the repaired JAX encoder."""
    with repaired():
        yield


def make_clip(path, w=96, h=64, n=12):
    """Write a drifting-texture H.264 clip with intra-in-P to `path`."""
    rng = np.random.default_rng(3)
    gy, gx = np.mgrid[0:h * 2, 0:w * 2]
    base = np.clip(128 + 60 * np.sin(gx / 13.0) * np.cos(gy / 11.0)
                   + rng.normal(0, 6, (h * 2, w * 2)), 0,
                   255).astype(np.uint8)
    enc = H264Encoder(width=w, height=h, qp=28, g=6, variety=1, pcm=0)
    data = b""
    for i in range(n):
        y = base[i:h + i, i:w + i].copy()
        u = base[i // 2:h // 2 + i // 2, i:w // 2 + i].copy()
        v = base[i // 2 + 4:h // 2 + i // 2 + 4, i + 2:w // 2 + i + 2].copy()
        for p in enc.encode(VideoFrame(planes=(y, u, v), format="yuv420p",
                                       width=w, height=h, pts=i,
                                       time_base=Rational(1, 25))):
            data += bytes(p.data)
    with open(path, "wb") as f:
        f.write(data)


def _vop_types(path):
    out = ""
    for p in open_input(str(path)).packets():
        d = bytes(p.data)
        out += "IPBS"[d[d.index(b"\x00\x00\x01\xb6") + 4] >> 6]
    return out


def _psnr(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    mse = float((d * d).mean())
    return float("inf") if mse == 0 else 10 * np.log10(255 ** 2 / mse)


def _run(P, C, E, src, out, monkeypatch, codec_opts=None, pix_fmt="",
         enc_in=None, **spec_kw):
    """Transcode with package P, recording decoded frames (numpy), the
    encoder's recon after each frame and each P-VOP's MV field (the
    last 2 * nmb int16 of the packed fetch, in both packages); with
    enc_in, also the frames the synchronous (B-frame) encoder takes."""
    frames, recon, mvs = [], [], []
    dec_decode = C.H264Decoder.decode
    enc_async = E.Mpeg4Encoder.encode_async
    enc_encode = E.Mpeg4Encoder.encode

    def encode(self, frame):
        if enc_in is not None:
            enc_in.append([np.asarray(getattr(p, "cpu", lambda: p)())
                           for p in frame.planes])
        return enc_encode(self, frame)

    def decode(self, pkt):
        fs = dec_decode(self, pkt)
        frames.extend([np.asarray(getattr(p, "cpu", lambda: p)())
                       for p in f.planes] for f in fs)
        return fs

    def encode_async(self, frame, **kw):
        h = enc_async(self, frame, **kw)
        recon.append([np.asarray(getattr(p, "cpu", lambda: p)())
                      for p in self._ref])
        if not h["is_i"]:
            nmb = (self.cw // 16) * (self.ch // 16)
            packed = getattr(h["packed"], "cpu", lambda: h["packed"])()
            mvs.append(np.asarray(packed)[-2 * nmb:])
        return h

    monkeypatch.setattr(C.H264Decoder, "decode", decode)
    monkeypatch.setattr(E.Mpeg4Encoder, "encode_async", encode_async)
    monkeypatch.setattr(E.Mpeg4Encoder, "encode", encode)
    P.Transcoder(P.TranscodeSpec(
        input_url=str(src), output_url=str(out),
        video=P.StreamMap(codec="mpeg4",
                          codec_opts=codec_opts or {"qscale": 5},
                          width=64, height=48, pix_fmt=pix_fmt),
        **spec_kw)).run()
    monkeypatch.undo()
    return frames, recon, mvs


def test_slice_matches_jax(tmp_path, monkeypatch):
    src = tmp_path / "clip.264"
    make_clip(src)
    jf, jr, jm = _run(JP, JC, JE, src, tmp_path / "jax.avi", monkeypatch)
    tf, tr, tm = _run(TP, TC, TE, src, tmp_path / "port.avi", monkeypatch,
                      device="cpu")
    assert len(jf) == len(tf) == 12
    for i, (a, b) in enumerate(zip(jf, tf)):
        for pa, pb in zip(a, b):
            assert np.array_equal(pa, pb), f"decoded frame {i} differs"
    jt, tt = _vop_types(tmp_path / "jax.avi"), _vop_types(tmp_path /
                                                         "port.avi")
    assert jt == tt == "IPPPPPPPPPPP"
    psnrs = [min(_psnr(a, b) for a, b in zip(x, y))
             for x, y in zip(jr, tr)]
    print("recon PSNR port vs JAX per frame (dB):",
          " ".join(f"{p:.1f}" for p in psnrs))
    assert len(psnrs) == 12 and min(psnrs) >= 40
    assert len(jm) == len(tm) == 11
    diff = np.mean([np.any((a != b).reshape(-1, 2), axis=1).mean()
                    for a, b in zip(jm, tm)])
    print(f"P-VOP MBs whose MV differs, port vs JAX: {diff:.4f}")


def _timestamps(path):
    return [(p.pts, p.dts) for p in open_input(str(path)).packets()]


def test_slice_options_match_jax(tmp_path, monkeypatch):
    src = tmp_path / "clip.264"
    make_clip(src)
    kw = dict(codec_opts={"qscale": 5, "max_b_frames": 2, "trellis": 1},
              pix_fmt="yuvj420p")
    ji, ti = [], []
    jf, jr, jm = _run(JP, JC, JE, src, tmp_path / "jax.avi", monkeypatch,
                      enc_in=ji, **kw)
    tf, tr, tm = _run(TP, TC, TE, src, tmp_path / "port.avi", monkeypatch,
                      enc_in=ti, device="cpu", **kw)
    assert len(jf) == len(tf) == 12
    for i, (a, b) in enumerate(zip(jf, tf)):
        for pa, pb in zip(a, b):
            assert np.array_equal(pa, pb), f"decoded frame {i}"
    assert len(ji) == len(ti) == 12
    d = np.concatenate([np.abs(np.asarray(a, np.int32) - b).ravel()
                        for x, y in zip(ji, ti) for a, b in zip(x, y)])
    print(f"yuvj420p encoder input: {np.count_nonzero(d) / d.size:.6f} of "
          f"samples differ, max |d| {d.max()}")
    assert np.count_nonzero(d) / d.size <= 1e-3 and d.max() <= 1
    jt, tt = _vop_types(tmp_path / "jax.avi"), _vop_types(tmp_path /
                                                         "port.avi")
    assert jt == tt == "IPBBPBBPBBPB"
    assert _timestamps(tmp_path / "jax.avi") == \
        _timestamps(tmp_path / "port.avi")
    psnrs = [min(_psnr(a, b) for a, b in zip(x, y))
             for x, y in zip(jr, tr)]
    print("anchor recon PSNR port vs JAX (dB):",
          " ".join(f"{p:.1f}" for p in psnrs))
    assert len(psnrs) == 5 and min(psnrs) >= 40
    assert len(jm) == len(tm) == 4
    diff = np.mean([np.any((a != b).reshape(-1, 2), axis=1).mean()
                    for a, b in zip(jm, tm)])
    print(f"P-VOP MBs whose MV differs, port vs JAX: {diff:.4f}")


@pytest.mark.parametrize("argv", [
    ["-s", "64x48", "-b:v", "300k", "-g", "6"],
    ["-vf", "scale=64:48", "-q:v", "5"],
    ["-s", "64x48", "-pix_fmt", "yuvj420p", "-bf", "2", "-trellis", "1",
     "-q:v", "5"],
])
def test_cli_transcodes(tmp_path, argv):
    from librempeg_tpu_torch.cli import ffmpeg

    src = tmp_path / "clip.264"
    make_clip(src)
    out = tmp_path / "out.avi"
    assert ffmpeg.main(["-i", str(src), *argv, "-c:v", "mpeg4",
                        "-device", "cpu", "-y", str(out)]) == 0
    types = _vop_types(out)
    assert len(types) == 12 and types[0] == "I"
    with pytest.raises(SystemExit):
        ffmpeg.main(["-i", str(src), "-c:v", "libx264", str(out)])
