"""sched/checkpoint in the port, against the JAX package's.

The JAX package's own cases (tests/test_checkpoint.py) run in both
packages. Then, in the port: an AAC chain snapshotted while aresample's
compensation is active; a dithered chain (-af
aresample=48000:dither_method=lipshitz -c:a pcm_s16le), whose resumed
output equals the uninterrupted run's in the port and not in the JAX
package (its snapshot drops the ditherer's noise position and error
history); a FLAC chain, whose packets before the cut and after the
resume are the uninterrupted run's (the port's snapshot writes the
packet the encoder holds back for the final STREAMINFO); an MPEG-4
-q:v 5 transcode of an H.264 clip cut at an IDR from raw .264, Matroska, MPEG-TS and MP4, whose resumed packets equal
the uninterrupted run's tail (the JAX package resumes an MP4 input at
its first packet, since its snapshot drops the MP4 demuxer's list
cursor, and cannot transcode the MPEG-TS at all); a round trip of
every dtype a snapshot holds; tampered and JAX-package blobs refused.
The JAX sides of the two dropped-state cases assert the fault, so they
fail once the reference is mended.
"""
import io
import wave

import numpy as np
import pytest
import torch

from librempeg_tpu.core.errors import InvalidData as JInvalidData
from librempeg_tpu.sched import checkpoint as JCK
from librempeg_tpu.sched import pipeline as JP
from librempeg_tpu.utils import testgen
from librempeg_tpu_torch.formats.api import open_input
from librempeg_tpu_torch.sched import checkpoint as TCK
from librempeg_tpu_torch.sched import pipeline as TP

from tests.test_cli import make_wav
from tests.test_torch_slice import make_clip

PKG = {"jax": (JP, JCK), "torch": (TP, TCK)}


def _spec(pkg, src, out, **kw):
    P = PKG[pkg][0]
    smaps = {k: P.StreamMap(**kw.pop(k)) for k in ("audio", "video")
             if k in kw}
    if pkg == "torch":
        kw["device"] = "cpu"
    return P.TranscodeSpec(input_url=str(src), output_url=str(out),
                           **smaps, **kw)


def _send(tc, n, at=None):
    """Send the first n packets; at(tc, i) runs before packet i."""
    for i, pkt in enumerate(tc.demux.packets()):
        if at is not None:
            at(tc, i)
        tc.chains[pkt.stream_index].send_packet(pkt, tc.mux)
        if i + 1 == n:
            return


def _resume(pkg, spec_fn, blob, patch=None):
    """A fresh Transcoder restored from blob, run to its end."""
    P, CK = PKG[pkg]
    tc = P.Transcoder(spec_fn())
    if patch is not None:
        patch(tc)
    CK.restore(tc, blob)
    tc.run()


def _pcm(path):
    with wave.open(str(path)) as w:
        return w.readframes(w.getnframes())


# ---------------------------------------------------------------------------
# the JAX package's cases (tests/test_checkpoint.py), in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", list(PKG))
def test_resume_equals_uninterrupted(pkg, tmp_path):
    P, CK = PKG[pkg]
    make_wav(tmp_path / "in.wav", n=48000)

    def spec(out):
        return _spec(pkg, tmp_path / "in.wav", tmp_path / out,
                     audio=dict(codec="pcm_s16le", sample_rate=44100))

    P.Transcoder(spec("a.wav")).run()
    tc = P.Transcoder(spec("b1.wav"))
    _send(tc, 5)
    _resume(pkg, lambda: spec("b2.wav"), CK.snapshot(tc))
    a, b2 = _pcm(tmp_path / "a.wav"), _pcm(tmp_path / "b2.wav")
    assert len(b2) > 0 and a[len(a) - len(b2):] == b2


@pytest.mark.parametrize("pkg", list(PKG))
def test_snapshot_is_small(pkg, tmp_path):
    P, CK = PKG[pkg]
    make_wav(tmp_path / "in.wav", n=9600)
    tc = P.Transcoder(_spec(pkg, tmp_path / "in.wav", tmp_path / "o.wav",
                            audio=dict(codec="pcm_s16le",
                                       sample_rate=44100)))
    _send(tc, 1)
    assert 0 < len(CK.snapshot(tc)) < 1 << 20


# ---------------------------------------------------------------------------
# the port's cases
# ---------------------------------------------------------------------------


def _wav44(path, seconds=1.0):
    x = testgen.s16(testgen.audio_mix(44100, int(44100 * seconds), 2)).T
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(44100)
        w.writeframes(np.ascontiguousarray(x).tobytes())


def _swrs(tc):
    return [n.filter._swr for c in tc.chains.values()
            for n in c.graph.graph.nodes
            if getattr(n.filter, "_swr", None) is not None]


def test_aac_with_compensation_active_at_the_cut(tmp_path):
    """Compensation set before packet 3 of 11, still active at the cut
    after packet 5: the resumed AAC packets equal the uninterrupted
    run's, and the snapshot held the compensation's rational."""
    _wav44(tmp_path / "in.wav")

    def spec(out):
        return _spec("torch", tmp_path / "in.wav", tmp_path / out,
                     audio=dict(codec="aac", sample_rate=48000))

    def comp(tc, i):
        if i == 3:
            _swrs(tc)[0].set_compensation(300, 20000)

    def packets(out):          # ADTS frames (the file carries no pts)
        return [bytes(p.data) for p in
                open_input(str(tmp_path / out)).packets()]

    tc = TP.Transcoder(spec("a.aac"))
    _send(tc, 10 ** 6, comp)
    for c in tc.chains.values():
        c.finish(tc.mux)
    tc.mux.close()
    tc = TP.Transcoder(spec("b1.aac"))
    _send(tc, 5, comp)
    r = _swrs(tc)[0].resampler
    assert r._comp is not None and r._comp["remaining"] > 0
    blob = TCK.snapshot(tc)
    _resume("torch", lambda: spec("b2.aac"), blob)
    a, b = packets("a.aac"), packets("b2.aac")
    assert len(b) > 0 and a[len(a) - len(b):] == b
    rs = TCK.loads_state(blob, device="cpu")["chains"][0]["swr"]
    assert [s["resampler"]["_comp_pqr"][2] for s in rs if s] == \
        [r._comp["remaining"]]


@pytest.mark.parametrize("pkg", list(PKG))
def test_dithered_resume(pkg, tmp_path):
    """-af aresample=48000:dither_method=lipshitz -c:a pcm_s16le (in the
    JAX package -ar 48000 with a lipshitz Swr: its aresample has no
    dither option) of 0.4 s, cut after packet 5 of 18."""
    import librempeg_tpu.resample as JR

    _wav44(tmp_path / "in.wav", 0.4)
    if pkg == "torch":
        def spec(out):
            return _spec(pkg, tmp_path / "in.wav", tmp_path / out,
                         audio=dict(codec="pcm_s16le", filters=(
                             "aresample=48000:dither_method=lipshitz")))
        patch = None
    else:
        def spec(out):
            return _spec(pkg, tmp_path / "in.wav", tmp_path / out,
                         audio=dict(codec="pcm_s16le", sample_rate=48000))

        def patch(tc):
            for swr in _swrs(tc):
                swr._ditherer = JR.Ditherer("lipshitz")
    P, CK = PKG[pkg]
    tc = P.Transcoder(spec("a.wav"))
    if patch:
        patch(tc)
    tc.run()
    tc = P.Transcoder(spec("b1.wav"))
    if patch:
        patch(tc)
    _send(tc, 5)
    _resume(pkg, lambda: spec("b2.wav"), CK.snapshot(tc), patch)
    a, b = _pcm(tmp_path / "a.wav"), _pcm(tmp_path / "b2.wav")
    assert len(b) > 0
    # the fault of the reference: its resumed noise restarts at sample 0
    assert (a[len(a) - len(b):] == b) == (pkg == "torch")


def _recorded(tc) -> list:
    """The (data, pts, duration) of every packet tc's muxer is given."""
    got, write = [], tc.mux.write

    def rec(pkt):
        got.append((bytes(pkt.data), pkt.pts, pkt.duration))
        write(pkt)
    tc.mux.write = rec
    return got


def _streaminfo(path):
    from librempeg_tpu_torch.codecs.flac.codec import parse_streaminfo

    return parse_streaminfo(open_input(str(path)).streams[0]
                            .codecpar.extradata)


@pytest.mark.parametrize("pkg", list(PKG))
def test_flac_resume_keeps_every_frame(pkg, tmp_path):
    """-c:a flac of 1 s (11 frames), cut after packet 5 of 11: the
    packets written before the cut and after the resume are the
    uninterrupted run's. In the port the snapshot writes the packet the
    encoder holds back for the final STREAMINFO; the resumed file's
    STREAMINFO has every sample and an unknown (zero) MD5, since the
    restored encoder did not hash the samples before the cut, and the
    uninterrupted file's has the MD5 of the input."""
    import hashlib

    P, CK = PKG[pkg]
    _wav44(tmp_path / "in.wav")

    def spec(out):
        return _spec(pkg, tmp_path / "in.wav", tmp_path / out,
                     audio=dict(codec="flac"))

    tc = P.Transcoder(spec("a.flac"))
    full = _recorded(tc)
    tc.run()
    tc = P.Transcoder(spec("b1.flac"))
    head = _recorded(tc)
    _send(tc, 5)
    blob = CK.snapshot(tc)
    tail: list = []
    _resume(pkg, lambda: spec("b2.flac"), blob,
            lambda t: tail.append(_recorded(t)))
    assert len(full) == 11 and head and tail[0]
    assert head + tail[0] == full
    if pkg == "torch":
        si, sr = _streaminfo(tmp_path / "a.flac"), \
            _streaminfo(tmp_path / "b2.flac")
        assert si["total_samples"] == sr["total_samples"] == 44100
        assert si["md5"] == hashlib.md5(_pcm(tmp_path / "in.wav")).digest()
        assert sr["md5"] == b"\0" * 16


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """An 18-frame H.264 clip (IDR every 6 frames) as .264 and
    stream-copied into MP4, Matroska and MPEG-TS by the port."""
    d = tmp_path_factory.mktemp("ck")
    es = str(d / "clip.264")
    make_clip(es, w=64, h=48, n=18)
    out = {"264": es}
    for ext in ("mp4", "mkv", "ts"):
        out[ext] = str(d / f"clip.{ext}")
        TP.Transcoder(TP.TranscodeSpec(
            input_url=es, output_url=out[ext],
            video=TP.StreamMap(codec="copy"), device="cpu")).run()
    return out


CUT = 12        # packets sent before the snapshot; packet 12 is an IDR


def _decode_ahead(tc):
    """The port's H.264 decoder as on the card: two packets parsed
    ahead (the CPU default is none), so a cut finds frames in flight."""
    tc.chains[0].decoder.opts["prefetch"] = 2


def _video_run(pkg, src, out, cut=None):
    """-c:v mpeg4 -q:v 5 into Matroska; with cut, snapshot after `cut`
    packets and resume in a fresh Transcoder. Returns the packets."""
    P, CK = PKG[pkg]
    patch = _decode_ahead if pkg == "torch" else None

    def spec(o):
        return _spec(pkg, src, o, video=dict(
            codec="mpeg4", codec_opts={"quality_scale": 5}))

    if cut is None:
        P.Transcoder(spec(out)).run()
    else:
        tc = P.Transcoder(spec(out + ".head.mkv"))
        if patch:
            patch(tc)
        _send(tc, cut)
        _resume(pkg, lambda: spec(out), CK.snapshot(tc), patch)
    return [(bytes(p.data), int(p.flags)) for p in open_input(out).packets()]


@pytest.mark.parametrize("src", ["264", "mkv", "ts", "mp4"])
def test_video_resumes_at_an_idr(clips, src, tmp_path):
    full = _video_run("torch", clips[src], str(tmp_path / "u.mkv"))
    got = _video_run("torch", clips[src], str(tmp_path / "r.mkv"), CUT)
    assert len(full) == 18 and got == full[CUT:]
    # the JAX package
    if src == "ts":
        # its demuxer gives the encoder a 0x0 stream
        with pytest.raises(JInvalidData, match="sparse fetch overflow"):
            _video_run("jax", clips[src], str(tmp_path / "j.mkv"), CUT)
        return
    jgot = _video_run("jax", clips[src], str(tmp_path / "j.mkv"), CUT)
    if src == "mp4":
        # the fault of the reference: it resumes at packet 0
        assert len(jgot) == 18
    else:
        jfull = _video_run("jax", clips[src], str(tmp_path / "ju.mkv"))
        assert jgot == jfull[CUT:]


def test_every_dtype_round_trips():
    state = {
        "tensors": tuple(torch.arange(-3, 5).to(dt) for dt in (
            torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64,
            torch.float32, torch.float64, torch.bool)),
        "arrays": [np.arange(6, dtype=dt).reshape(2, 3) for dt in (
            np.uint8, np.int16, np.int32, np.int64, np.float32,
            np.float64)],
        "scalars": [0, -1, 2 ** 62, 1.5, True, None, "s"],
        "bytes": b"\x00\x01\xff",
        5: {"nested": (1, [2.0, (3,)])},
    }
    got = TCK.loads_state(TCK.dumps_state(state), device="cpu")
    assert set(got) == set(state)
    for a, b in zip(state["tensors"], got["tensors"]):
        assert isinstance(b, torch.Tensor) and b.dtype == a.dtype
        assert torch.equal(a, b)
    for a, b in zip(state["arrays"], got["arrays"]):
        assert b.dtype == a.dtype and np.array_equal(a, b)
    assert got["scalars"] == state["scalars"]
    assert got["bytes"] == state["bytes"] and got[5] == state[5]


def test_loads_state_defaults_to_the_card():
    """As every entry point, loads_state puts the tensors on the card
    unless its caller names another device; without a card it raises."""
    blob = TCK.dumps_state({"a": torch.ones(3)})
    if torch.cuda.is_available():
        assert TCK.loads_state(blob)["a"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device 'cuda'"):
            TCK.loads_state(blob)


def test_tampered_and_foreign_blobs_are_refused(tmp_path):
    blob = TCK.dumps_state({"a": torch.ones(3)})
    with pytest.raises(ValueError, match="bad magic"):
        TCK.loads_state(b"X" + blob[1:], device="cpu")
    with pytest.raises(ValueError, match="JAX package"):
        TCK.loads_state(JCK.dumps_state({"a": np.ones(3)}), device="cpu")
    # an npz whose array is pickled objects: np.load refuses it
    buf = io.BytesIO()
    np.savez(buf, a0=np.array([{"x": 1}], dtype=object))
    head = blob[:blob.index(b"PK")]
    with pytest.raises(ValueError):
        TCK.loads_state(head + buf.getvalue(), device="cpu")
    with pytest.raises(TypeError):
        TCK.dumps_state({"a": object()})
