"""Write the audio codec test streams of the PyTorch port's tests and of
chip_smoke.py's acodecs phase into tests/data/torch_port/acodecs/.

    python tools/torch_port_audio_fixtures.py [--out DIR]

Each stream is encoded from a seeded signal (`make_signal`: two tones
with vibrato, low noise, and a sharp decaying burst every 1.1 s that
makes the encoders switch to short blocks) by a system library driven
through ctypes, so the tests and chip_smoke.py read committed files
and need none of these libraries:

- libopus (`libopus.so.0`), through the constants and the Ogg writer
  (`write_ogg`) of tools/gen_silk_vectors.py, whose `encode` has a fixed
  2 s signal: `opus_celt.ogg` (CELT only, fullband stereo, 96 kb/s,
  20 ms frames, 5 s), `opus_hybrid.ogg` (hybrid, fullband stereo,
  48 kb/s, 20 ms, 5 s), `opus_silk40.ogg` and `opus_silk60.ogg` (SILK
  only, wideband mono, 24 kb/s, 40 and 60 ms frames, 3 s);
- libvorbisenc, libvorbis and libogg (`libvorbisenc.so.2`,
  `libvorbis.so.0`, `libogg.so.0`): `vorbis.ogg`, 44.1 kHz stereo, VBR
  quality 0.4, 5 s;
- libmp3lame (`libmp3lame.so.0`): `mp3.mp3`, 44.1 kHz joint stereo CBR
  128 kb/s with its Xing/LAME (Info) tag, 5 s, and `mp3_mono32k.mp3`,
  32 kHz mono, 64 kb/s, 1 s;
- libtwolame (`libtwolame.so.0`): `mp2.mp2`, 48 kHz stereo, 192 kb/s,
  5 s.

The rates and channel counts are those users meet; only the length is
cut. It prints each file's size and md5 (PERF.md section 4 lists them).
The encoders are deterministic for a given library build; a rebuild of
these files against other library versions changes the bytes, and the
goldens (tools/torch_port_goldens.py --acodecs) must then be rewritten.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_tool(name: str):
    """tools/<name>.py as a module, leaving sys.path as it is."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


G = load_tool("gen_silk_vectors")

OUT = os.path.join(ROOT, "tests", "data", "torch_port", "acodecs")
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float


def _lib(name: str, sigs: dict) -> ctypes.CDLL:
    """The library with argtypes and restype declared for each function
    of `sigs` (name -> (restype, argtypes))."""
    lib = ctypes.CDLL(name)
    for fn, (res, args) in sigs.items():
        getattr(lib, fn).restype = res
        getattr(lib, fn).argtypes = args
    return lib
SEED = 15
OPUS_APPLICATION_AUDIO = 2049
MODE_CELT_ONLY = 1002


def make_signal(seconds: float, rate: int, channels: int,
                seed: int = SEED) -> np.ndarray:
    """[n, channels] float32 in [-1, 1): a 220 Hz and a 1375 Hz tone
    with slow vibrato, noise 40 dB down, and every 1.1 s a burst of
    noise with a 0.2 ms attack and a 30 ms decay (a transient)."""
    rng = np.random.default_rng(seed)
    n = int(round(seconds * rate))
    t = np.arange(n) / rate
    cols = []
    for c in range(channels):
        vib = 1 + 0.004 * np.sin(2 * np.pi * (5.0 + c) * t)
        x = (0.30 * np.sin(2 * np.pi * 220.0 * np.cumsum(vib) / rate)
             + 0.12 * np.sin(2 * np.pi * 1375.0 * t + c)
             + 0.01 * rng.standard_normal(n))
        for start in np.arange(0.35, seconds, 1.1):
            s = int(start * rate)
            m = min(n - s, int(0.2 * rate))
            k = np.arange(m) / rate
            env = np.minimum(k / 2e-4, 1.0) * np.exp(-k / 0.03)
            x[s:s + m] += 0.5 * env * rng.standard_normal(m)
        cols.append(x)
    return np.clip(np.stack(cols, 1), -0.95, 0.95).astype(np.float32)


def s16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16)


# -- Opus ------------------------------------------------------------------

def opus_packets(sig: np.ndarray, mode: str, bw: str, dur_ms: int,
                 bitrate: int) -> list[bytes]:
    """libopus packets of `sig` ([n, ch] at 48 kHz), one frame each;
    mode "celt" forces CELT only (application audio), "silk"/"hybrid"
    as tools/gen_silk_vectors.py forces them (application voip)."""
    lib = _lib("libopus.so.0", {
        "opus_encoder_create": (_P, (ctypes.c_int32, _I, _I,
                                     ctypes.POINTER(_I))),
        "opus_encoder_ctl": (_I, (_P, _I, _I)),
        "opus_encode_float": (ctypes.c_int32, (
            _P, ctypes.POINTER(_F), _I, ctypes.c_char_p, ctypes.c_int32)),
        "opus_encoder_destroy": (None, (_P,))})
    ch = sig.shape[1]
    err = ctypes.c_int()
    app = OPUS_APPLICATION_AUDIO if mode == "celt" \
        else G.OPUS_APPLICATION_VOIP
    enc = lib.opus_encoder_create(48000, ch, app, ctypes.byref(err))
    assert err.value == 0, err.value
    force = {"celt": MODE_CELT_ONLY, "silk": G.MODE_SILK_ONLY,
             "hybrid": G.MODE_HYBRID}[mode]
    for req, val in ((G.OPUS_SET_BITRATE, bitrate),
                     (G.OPUS_SET_BANDWIDTH, G.BW[bw]),
                     (G.OPUS_SET_COMPLEXITY, 10),
                     (G.OPUS_SET_FORCE_MODE, force)):
        assert lib.opus_encoder_ctl(enc, req, val) == 0, req
    frame = 48 * dur_ms
    out = ctypes.create_string_buffer(4000)
    pkts = []
    for i in range(0, len(sig) - frame + 1, frame):
        chunk = np.ascontiguousarray(sig[i:i + frame])
        n = lib.opus_encode_float(
            enc, chunk.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            frame, out, 4000)
        assert n > 0, n
        pkts.append(bytes(out.raw[:n]))
    lib.opus_encoder_destroy(enc)
    return pkts


def write_opus(path: str, mode: str, bw: str, ch: int, dur_ms: int,
               bitrate: int, seconds: float) -> None:
    pkts = opus_packets(make_signal(seconds, 48000, ch), mode, bw, dur_ms,
                        bitrate)
    G.write_ogg(path, pkts, ch, dur_ms)


# -- Vorbis ----------------------------------------------------------------

class _OggPacket(ctypes.Structure):
    _fields_ = [("packet", ctypes.c_void_p), ("bytes", ctypes.c_long),
                ("b_o_s", ctypes.c_long), ("e_o_s", ctypes.c_long),
                ("granulepos", ctypes.c_int64),
                ("packetno", ctypes.c_int64)]


class _OggPage(ctypes.Structure):
    _fields_ = [("header", ctypes.c_void_p),
                ("header_len", ctypes.c_long),
                ("body", ctypes.c_void_p), ("body_len", ctypes.c_long)]


def write_vorbis(path: str, rate: int, ch: int, quality: float,
                 seconds: float) -> None:
    """libvorbisenc's VBR encode of make_signal, paged by libogg. The
    library states are opaque buffers larger than their structs."""
    pkt, pg = ctypes.POINTER(_OggPacket), ctypes.POINTER(_OggPage)
    ogg = _lib("libogg.so.0", {
        "ogg_stream_init": (_I, (_P, _I)),
        "ogg_stream_packetin": (_I, (_P, pkt)),
        "ogg_stream_pageout": (_I, (_P, pg)),
        "ogg_stream_flush": (_I, (_P, pg)),
        "ogg_stream_clear": (_I, (_P,))})
    vorbis = _lib("libvorbis.so.0", {
        "vorbis_info_init": (None, (_P,)),
        "vorbis_comment_init": (None, (_P,)),
        "vorbis_analysis_init": (_I, (_P, _P)),
        "vorbis_block_init": (_I, (_P, _P)),
        "vorbis_analysis_headerout": (_I, (_P, _P, pkt, pkt, pkt)),
        "vorbis_analysis_buffer": (ctypes.POINTER(ctypes.POINTER(_F)),
                                   (_P, _I)),
        "vorbis_analysis_wrote": (_I, (_P, _I)),
        "vorbis_analysis_blockout": (_I, (_P, _P)),
        "vorbis_analysis": (_I, (_P, pkt)),
        "vorbis_bitrate_addblock": (_I, (_P,)),
        "vorbis_bitrate_flushpacket": (_I, (_P, pkt)),
        "vorbis_block_clear": (_I, (_P,)),
        "vorbis_dsp_clear": (None, (_P,)),
        "vorbis_comment_clear": (None, (_P,)),
        "vorbis_info_clear": (None, (_P,))})
    venc = _lib("libvorbisenc.so.2", {
        "vorbis_encode_init_vbr": (_I, (_P, _L, _L, _F))})
    vi, vc, vd, vb, os_ = (ctypes.create_string_buffer(1 << 14)
                           for _ in range(5))
    vorbis.vorbis_info_init(vi)
    assert venc.vorbis_encode_init_vbr(vi, ch, rate, quality) == 0
    vorbis.vorbis_comment_init(vc)
    assert vorbis.vorbis_analysis_init(vd, vi) == 0
    assert vorbis.vorbis_block_init(vd, vb) == 0
    assert ogg.ogg_stream_init(os_, SEED) == 0
    out = bytearray()
    page = _OggPage()

    def pages(flush: bool):
        fn = ogg.ogg_stream_flush if flush else ogg.ogg_stream_pageout
        while fn(os_, ctypes.byref(page)):
            out.extend(ctypes.string_at(page.header, page.header_len))
            out.extend(ctypes.string_at(page.body, page.body_len))

    hdr = [_OggPacket() for _ in range(3)]
    assert vorbis.vorbis_analysis_headerout(
        vd, vc, *(ctypes.byref(h) for h in hdr)) == 0
    for h in hdr:
        ogg.ogg_stream_packetin(os_, ctypes.byref(h))
    pages(flush=True)          # audio starts on a fresh page

    sig = make_signal(seconds, rate, ch)
    op = _OggPacket()
    step = 1024

    def blocks():
        while vorbis.vorbis_analysis_blockout(vd, vb) == 1:
            vorbis.vorbis_analysis(vb, None)
            vorbis.vorbis_bitrate_addblock(vb)
            while vorbis.vorbis_bitrate_flushpacket(vd, ctypes.byref(op)):
                ogg.ogg_stream_packetin(os_, ctypes.byref(op))
                pages(flush=False)

    for i in range(0, len(sig), step):
        n = min(step, len(sig) - i)
        buf = vorbis.vorbis_analysis_buffer(vd, n)
        for c in range(ch):
            col = np.ascontiguousarray(sig[i:i + n, c])   # kept alive
            ctypes.memmove(buf[c], col.ctypes.data, 4 * n)
        vorbis.vorbis_analysis_wrote(vd, n)
        blocks()
    vorbis.vorbis_analysis_wrote(vd, 0)       # end of stream
    blocks()
    pages(flush=True)
    for fn, arg in ((ogg.ogg_stream_clear, os_),
                    (vorbis.vorbis_block_clear, vb),
                    (vorbis.vorbis_dsp_clear, vd),
                    (vorbis.vorbis_comment_clear, vc),
                    (vorbis.vorbis_info_clear, vi)):
        fn(arg)
    open(path, "wb").write(bytes(out))


# -- MP3 -------------------------------------------------------------------

def write_mp3(path: str, rate: int, ch: int, kbps: int,
              seconds: float) -> None:
    """LAME CBR with its Info tag: the first frame of the stream is
    overwritten with lame_get_lametag_frame after the flush, as the
    LAME frontend does."""
    sets = ("lame_set_in_samplerate", "lame_set_out_samplerate",
            "lame_set_num_channels", "lame_set_brate", "lame_set_mode",
            "lame_set_quality", "lame_set_bWriteVbrTag")
    lame = _lib("libmp3lame.so.0", {
        "lame_init": (_P, ()), "lame_init_params": (_I, (_P,)),
        "lame_encode_buffer": (_I, (_P, _P, _P, _I, ctypes.c_char_p, _I)),
        "lame_encode_flush": (_I, (_P, ctypes.c_char_p, _I)),
        "lame_get_lametag_frame": (ctypes.c_size_t, (
            _P, ctypes.c_char_p, ctypes.c_size_t)),
        "lame_close": (_I, (_P,)),
        **{fn: (_I, (_P, _I)) for fn in sets}})
    gf = lame.lame_init()
    for fn, val in (("lame_set_in_samplerate", rate),
                    ("lame_set_out_samplerate", rate),
                    ("lame_set_num_channels", ch),
                    ("lame_set_brate", kbps),
                    ("lame_set_mode", 1 if ch == 2 else 3),   # JOINT / MONO
                    ("lame_set_quality", 2),
                    ("lame_set_bWriteVbrTag", 1)):
        assert getattr(lame, fn)(gf, val) == 0, fn
    assert lame.lame_init_params(gf) == 0
    pcm = s16(make_signal(seconds, rate, ch))
    left = np.ascontiguousarray(pcm[:, 0])
    right = np.ascontiguousarray(pcm[:, ch - 1])
    size = int(1.25 * len(pcm) + 7200)
    buf = ctypes.create_string_buffer(size)
    n = lame.lame_encode_buffer(gf, left.ctypes.data, right.ctypes.data,
                                len(pcm), buf, size)
    assert n >= 0, n
    data = bytearray(buf.raw[:n])
    m = lame.lame_encode_flush(gf, buf, size)
    assert m >= 0, m
    data += buf.raw[:m]
    tag = ctypes.create_string_buffer(4096)
    k = lame.lame_get_lametag_frame(gf, tag, 4096)
    assert 0 < k <= len(data), k
    data[:k] = tag.raw[:k]
    lame.lame_close(gf)
    open(path, "wb").write(bytes(data))


# -- MP2 -------------------------------------------------------------------

def write_mp2(path: str, rate: int, ch: int, kbps: int,
              seconds: float) -> None:
    """twolame's layer II encode (stereo mode for two channels)."""
    sets = ("twolame_set_in_samplerate", "twolame_set_out_samplerate",
            "twolame_set_num_channels", "twolame_set_bitrate",
            "twolame_set_mode")
    tl = _lib("libtwolame.so.0", {
        "twolame_init": (_P, ()), "twolame_init_params": (_I, (_P,)),
        "twolame_encode_buffer_interleaved": (_I, (
            _P, _P, _I, ctypes.c_char_p, _I)),
        "twolame_encode_flush": (_I, (_P, ctypes.c_char_p, _I)),
        "twolame_close": (None, (ctypes.POINTER(_P),)),
        **{fn: (_I, (_P, _I)) for fn in sets}})
    opts = _P(tl.twolame_init())
    for fn, val in (("twolame_set_in_samplerate", rate),
                    ("twolame_set_out_samplerate", rate),
                    ("twolame_set_num_channels", ch),
                    ("twolame_set_bitrate", kbps),
                    ("twolame_set_mode", 0 if ch == 2 else 3)):
        assert getattr(tl, fn)(opts, val) == 0, fn
    assert tl.twolame_init_params(opts) == 0
    pcm = np.ascontiguousarray(s16(make_signal(seconds, rate, ch)))
    size = len(pcm) * 2 + 16384
    buf = ctypes.create_string_buffer(size)
    n = tl.twolame_encode_buffer_interleaved(opts, pcm.ctypes.data,
                                             len(pcm), buf, size)
    assert n >= 0, n
    data = buf.raw[:n]
    m = tl.twolame_encode_flush(opts, buf, size)
    assert m >= 0, m
    data += buf.raw[:m]
    tl.twolame_close(ctypes.byref(opts))
    open(path, "wb").write(data)


#: file -> (writer, arguments)
STREAMS = {
    "opus_celt.ogg": (write_opus, ("celt", "fb", 2, 20, 96000, 5.0)),
    "opus_hybrid.ogg": (write_opus, ("hybrid", "fb", 2, 20, 48000, 5.0)),
    "opus_silk40.ogg": (write_opus, ("silk", "wb", 1, 40, 24000, 3.0)),
    "opus_silk60.ogg": (write_opus, ("silk", "wb", 1, 60, 24000, 3.0)),
    "vorbis.ogg": (write_vorbis, (44100, 2, 0.4, 5.0)),
    "mp3.mp3": (write_mp3, (44100, 2, 128, 5.0)),
    "mp3_mono32k.mp3": (write_mp3, (32000, 1, 64, 1.0)),
    "mp2.mp2": (write_mp2, (48000, 2, 192, 5.0)),
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    total = 0
    for name, (fn, fargs) in STREAMS.items():
        path = os.path.join(args.out, name)
        fn(path, *fargs)
        data = open(path, "rb").read()
        total += len(data)
        print(f"{name} {len(data)} {hashlib.md5(data).hexdigest()}")
    print(f"total {total} bytes")


if __name__ == "__main__":
    main()
