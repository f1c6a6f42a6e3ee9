"""Run-time repairs of the JAX package's audio faults that the port does
not copy, for the tests and the goldens that hold the port to the JAX
package. Nothing in the JAX package is edited: each repair swaps a
function or a constant for the duration of a `with` block, or rewrites
the JAX package's output.

- `mpegaudio_repaired()`: the MPEG audio synthesis window and trim. The
  JAX decoders (librempeg_tpu/codecs/mpegaudio.py, mp3dec.py) build the
  D window with the sign of taps 320, 384 and 448 flipped, where
  libavcodec's ff_mpa_synth_init keeps it (D[512 - i] = -D[i] but for i
  a multiple of 64), and trim 481 samples that libavcodec never trims
  (SYNTH_DELAY). For an MP3 whose Info/Xing frame carries a LAME tag
  they also keep the samples libavformat trims: the encoder delay plus
  the decoder's 529 at the start, and the padding less 529 at the end
  (mp3dec.c's start_skip_samples and first_discard_sample). Inside the
  block the window is libavcodec's, nothing is trimmed for the synthesis,
  and the JAX MP3 decoder trims a tagged stream as libavcodec does after
  libavformat.
- `vorbis_repaired()`: the Vorbis floor. The JAX decoder's floor 1
  (librempeg_tpu/codecs/vorbis/decoder.py `_floor1_synth`) marks a
  nonzero point alone as used, where the Vorbis I spec (section 7.2.4,
  step 1) marks its low and high neighbours too, so a neighbour whose
  own value was predicted is left out of the curve. Inside the block
  the curve is the spec's, and the last packet of an Ogg Vorbis stream
  is trimmed to the end granule, as libavformat's oggparsevorbis.c
  trims it (the JAX demuxer trims nothing).
- `aac_mdct_exact()`: not a fault but an accuracy: the JAX AAC
  encoder's MDCT is XLA's float32 matmul, whose sums stray from the
  exact transform by more than the port's (torch's float32 matmul, on
  the CPU and the card); on K5's MP3 input that flips one rate-control
  decision at frame 103, where the exact MDCT does not. Inside the
  block the JAX encoder takes the MDCT in float64, rounded once to
  float32: with it its packets are the port's but one and its decoded
  SNR the port's to 1e-7 dB, while the JAX encoder given its own MDCT
  values gives its own bytes (its quantiser and rate control are the
  port's).
- `framemd5_repaired(text)`: the JAX framemd5 muxer stops its header
  before libavformat's last line, "#stream#, dts, pts, ...": the text
  with that line put in.
- `wav_tags_repaired(raw)`: the JAX WAV muxer writes no `fact` chunk
  for an ADPCM stream and a byte rate of rate x block / samples a
  block; libavformat's wavenc.c writes a fact chunk with the sample
  count and the codec's bit rate over 8 (AVCodecContext's default 128
  kb/s for libavcodec's ADPCM encoders): the file with both.

Used by tests/test_torch_mpegaudio.py, test_torch_vorbis.py,
test_torch_libav_audio.py and the framemd5 comparisons of the tests,
and by tools/torch_port_goldens.py.
"""
from __future__ import annotations

import contextlib
import struct

import numpy as np

#: libavformat's framemd5 header's last line (hashenc.c)
FRAMEMD5_COLUMNS = "#stream#, dts,        pts, duration,     size, hash\n"
#: the MPEG audio decoder's delay (libavformat's 528 + 1)
MPA_DECODER_DELAY = 529


def framemd5_repaired(text):
    """A framemd5 text (str or bytes) of the JAX package with
    libavformat's last header line after its other header lines."""
    if isinstance(text, bytes):
        return framemd5_repaired(text.decode()).encode()
    lines = text.splitlines(keepends=True)
    k = 0
    while k < len(lines) and lines[k].startswith("#"):
        k += 1
    if not lines or not lines[0].startswith("#format:") \
            or FRAMEMD5_COLUMNS in lines[:k]:
        return text
    return "".join(lines[:k] + [FRAMEMD5_COLUMNS] + lines[k:])


def synthesis_window(half) -> np.ndarray:
    """libavcodec's D window from the integer half it stores, scaled as
    the JAX decoder scales its own."""
    d = np.zeros(512)
    half = np.asarray(half, np.float64)
    for i in range(257):
        d[i] = half[i]
        if i:
            d[512 - i] = half[i] if i % 64 == 0 else -half[i]
    return d / (1 << 15)


def keep_span(frames, at: int, start: int, end):
    """The JAX decoders' trims: of `frames`, whose first sample is
    sample `at` of the decoded stream, keep samples [start, end) (end
    None: to the end), each kept frame's pts moved by the samples cut
    from its start; a frame left empty is dropped. Returns the frames and
    the count of samples decoded after them. The port applies the same
    trims as side data, once, in librempeg_tpu_torch/core/sidedata.py
    `trim`."""
    out = []
    for f in frames:
        n = f.nb_samples
        lo, hi = max(at, start), at + n if end is None else min(at + n, end)
        if hi > lo:
            tb = f.time_base
            shift = (lo - at) * tb.den // (f.sample_rate * tb.num)
            out.append(f.replace(data=f.data[:, lo - at:hi - at],
                                 pts=f.pts + shift))
        at += n
    return out, at


def lame_trim(data: bytes):
    """(start skip, end sample) of an MP3 whose first frame is an
    Info/Xing frame with a LAME, Lavf or Lavc tag, in samples of the
    decoded stream from its first sample; None without one. The port
    reads the same fields in librempeg_tpu_torch/formats/mp3.py
    `Mp3Demuxer._lame_tag`; this copy stays apart so that the JAX side
    of a comparison runs none of the port's code."""
    from librempeg_tpu.formats.mp3 import FrameHeader

    pos = 0
    if data[:3] == b"ID3":
        pos = 10 + ((data[6] & 0x7F) << 21 | (data[7] & 0x7F) << 14
                    | (data[8] & 0x7F) << 7 | (data[9] & 0x7F))
    while pos + 4 <= len(data) and FrameHeader.parse(data[pos:pos + 4]) \
            is None:
        pos += 1
    h = FrameHeader.parse(data[pos:pos + 4])
    if h is None:
        return None
    frame = data[pos:pos + h.frame_size]
    for tag in (b"Xing", b"Info"):
        k = frame.find(tag)
        if k <= 0:
            continue
        flags = int.from_bytes(frame[k + 4:k + 8], "big")
        nfr = int.from_bytes(frame[k + 8:k + 12], "big") if flags & 1 else 0
        p = k + 8 + 4 * bool(flags & 1) + 4 * bool(flags & 2) \
            + 100 * bool(flags & 4) + 4 * bool(flags & 8)
        if frame[p:p + 4] not in (b"LAME", b"Lavf", b"Lavc"):
            return None
        v = int.from_bytes(frame[p + 21:p + 24], "big")
        start = (v >> 12) + MPA_DECODER_DELAY
        end = nfr * h.samples + MPA_DECODER_DELAY - (v & 4095) if nfr \
            else None
        return start, end
    return None


@contextlib.contextmanager
def mpegaudio_repaired():
    from librempeg_tpu.codecs import mp3dec as JM3
    from librempeg_tpu.codecs import mpegaudio as JMA
    from librempeg_tpu.codecs.mpegaudio_tables import ENWINDOW
    from librempeg_tpu.formats import mp3 as JMP3

    window = JMA._D.copy()
    delays = (JMA.SYNTH_DELAY, JM3.SYNTH_DELAY)
    read_header, decode = JMP3.Mp3Demuxer.read_header, JM3.Mp3Decoder.decode
    init = JM3.Mp3Decoder.__init__

    def tagged_header(self, io):
        start = io.tell()
        head = io.read(1 << 16)
        io.seek(start)
        read_header(self, io)
        trim = lame_trim(head)
        if trim is not None:
            self.streams[0].codecpar.extra["lame_trim"] = trim

    def init_trim(self, params=None, **opts):
        init(self, params, **opts)
        self._trim = params.extra.get("lame_trim") if params is not None \
            else None
        self._at = 0                          # samples decoded so far

    def trimmed(self, pkt):
        frames = decode(self, pkt)
        if not getattr(self, "_trim", None):
            return frames
        out, self._at = keep_span(frames, self._at, *self._trim)
        return out

    JMA._D[:] = synthesis_window(ENWINDOW)
    JMA.SYNTH_DELAY = JM3.SYNTH_DELAY = 0
    JMP3.Mp3Demuxer.read_header = tagged_header
    JM3.Mp3Decoder.__init__, JM3.Mp3Decoder.decode = init_trim, trimmed
    try:
        yield
    finally:
        JMA._D[:] = window
        JMA.SYNTH_DELAY, JM3.SYNTH_DELAY = delays
        JMP3.Mp3Demuxer.read_header = read_header
        JM3.Mp3Decoder.__init__, JM3.Mp3Decoder.decode = init, decode


def floor1_synth(self, fl, ys, n: int) -> np.ndarray:
    """The JAX decoder's `_floor1_synth` with the spec's step 1: a
    nonzero point marks its two neighbours as curve points too."""
    from librempeg_tpu.codecs.vorbis import decoder as JV

    rng = JV._RANGES[fl.mult - 1]
    npost = len(fl.xlist)
    step2 = [False] * npost
    final = [0] * npost
    step2[0] = step2[1] = True
    final[0], final[1] = ys[0], ys[1]
    for i in range(2, npost):
        lo, hi = fl.neigh[i - 2]
        pred = JV._render_point(fl.xlist[lo], final[lo],
                                fl.xlist[hi], final[hi], fl.xlist[i])
        val, high_room, low_room = ys[i], rng - pred, pred
        room = 2 * min(high_room, low_room)
        if not val:
            final[i] = pred
            continue
        step2[lo] = step2[hi] = step2[i] = True
        if val >= room:
            final[i] = val - low_room + pred if high_room > low_room \
                else pred - val + high_room - 1
        elif val & 1:
            final[i] = pred - ((val + 1) >> 1)
        else:
            final[i] = pred + (val >> 1)
    out = np.zeros(n)
    lx, ly = 0, final[fl.sorted_idx[0]] * fl.mult
    for k in fl.sorted_idx[1:]:
        if not step2[k]:
            continue
        hx, hy = fl.xlist[k], final[k] * fl.mult
        if hx > lx:
            JV._render_line(lx, ly, hx, hy, out, n)
        lx, ly = hx, hy
    if lx < n:
        out[lx:] = JV._INV_DB[min(int(ly), 255)]
    return out


@contextlib.contextmanager
def aac_mdct_exact():
    import types

    from librempeg_tpu.codecs.aac import codec as JAAC
    from librempeg_tpu.ops import tx as JTX

    def mdct(x):
        n = x.shape[-1] // 2
        exact = np.asarray(x, np.float64) @ JTX._mdct_fwd_basis(n).T
        return exact.astype(np.float32)

    plain = JAAC.tx
    JAAC.tx = types.SimpleNamespace(**{**vars(JTX), "mdct": mdct})
    try:
        yield
    finally:
        JAAC.tx = plain


@contextlib.contextmanager
def vorbis_repaired():
    from librempeg_tpu.codecs.vorbis import decoder as JV
    from librempeg_tpu.formats import ogg as JOGG

    synth, decode = JV.VorbisDecoder._floor1_synth, JV.VorbisCodec.decode
    read_packet = JOGG.OggDemuxer.read_packet

    def last_granule(self):
        pkt = read_packet(self)
        if self._cursor == len(self._pkts) and \
                self.streams[0].codecpar.codec_id == "vorbis":
            pkt.side_data["end_granule"] = self._pkts[-1][0]
        return pkt

    def trimmed(self, pkt):
        out, self._at = keep_span(decode(self, pkt),
                                  self.__dict__.get("_at", 0), 0,
                                  pkt.side_data.get("end_granule"))
        return out

    JV.VorbisDecoder._floor1_synth = floor1_synth
    JV.VorbisCodec.decode = trimmed
    JOGG.OggDemuxer.read_packet = last_granule
    try:
        yield
    finally:
        JV.VorbisDecoder._floor1_synth = synth
        JV.VorbisCodec.decode = decode
        JOGG.OggDemuxer.read_packet = read_packet


#: AVCodecContext's default bit rate, which libavcodec's ADPCM encoders
#: keep (the byte rate of their WAV header)
ADPCM_BIT_RATE = 128000


def wav_tags_repaired(raw: bytes) -> bytes:
    """A JAX package's ADPCM (IMA or MS) WAV file as libavformat writes
    it: the byte rate the codec's bit rate over 8 and a `fact` chunk with
    the sample count (every block full: the JAX encoder pads the last)
    after the fmt chunk."""
    assert raw[:4] == b"RIFF" and raw[8:16] == b"WAVEfmt "
    size = struct.unpack("<I", raw[16:20])[0]
    fmt = bytearray(raw[20:20 + size])
    tag, _, _, _, balign = struct.unpack("<HHIIH", fmt[:14])
    assert tag in (0x0002, 0x0011) and b"fact" not in raw[:64]
    spb = struct.unpack("<H", fmt[18:20])[0]
    fmt[8:12] = struct.pack("<I", ADPCM_BIT_RATE // 8)
    rest = raw[20 + size:]
    assert rest[:4] == b"data"
    nbytes = struct.unpack("<I", rest[4:8])[0]
    fact = b"fact" + struct.pack("<II", 4, nbytes // balign * spb)
    body = b"WAVEfmt " + raw[16:20] + bytes(fmt) + fact + rest
    return b"RIFF" + struct.pack("<I", len(body)) + body
