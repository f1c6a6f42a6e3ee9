"""The port's text subtitles against the JAX package's, on the CPU: the
SubRip demuxer and muxer (formats/srt.py), the subrip and ass decoders
and the subrip encoder (codecs/subtitles.py), load_cues, the subtitle
stream of the transcode (_SubtitleChain: srt in, srt out, with -map and
-ss), and the subtitles filter's burn-in.

Packets, cues and written bytes are equal exactly; the burned-in planes
bit for bit (the coverage on the host, the blend on the frame's device
in the JAX package's float32 order).
"""
import os

import numpy as np
import pytest

from librempeg_tpu.cli.ffmpeg import parse_args as jparse
from librempeg_tpu.codecs import subtitles as JS
from librempeg_tpu.core.packet import Packet as JPacket
from librempeg_tpu.core.rational import Rational as JR
from librempeg_tpu.formats.api import open_input as jopen
from librempeg_tpu.sched.pipeline import Transcoder as JTranscoder
from librempeg_tpu_torch.cli.ffmpeg import parse_args as tparse
from librempeg_tpu_torch.codecs import subtitles as TS
from librempeg_tpu_torch.core.packet import Packet as TPacket
from librempeg_tpu_torch.core.rational import Rational as TR
from librempeg_tpu_torch.formats.api import open_input as topen
from librempeg_tpu_torch.sched.pipeline import Transcoder as TTranscoder
from test_torch_filters2 import assert_same, run_both

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")
CUES = os.path.join(DATA, "delivery", "cues.srt")
FONT = os.path.join(DATA, "fonts", "DejaVuSansMono.ttf")

ASS_LINES = [
    "0,0,Default,,0,0,0,,{\\b1}Bold{\\b0} and\\Nnext line",
    "Dialogue: 0,0:00:01.00,0:00:02.00,Default,,0,0,0,,Hard\\hspace",
    "3,0,Default,,0,0,0,,{\\an8}top\\ntext",
]


def _packets(open_input, path):
    d = open_input(path)
    par = [(s.codecpar.codec_type, s.codecpar.codec_id) for s in d.streams]
    out = [(p.stream_index, p.pts, p.dts, p.duration, bytes(p.data))
           for p in d.packets()]
    d.close()
    return par, out


def test_srt_demuxer_matches_jax():
    j, t = _packets(jopen, CUES), _packets(topen, CUES)
    assert j == t
    assert t[0] == [("subtitle", "subrip")] and len(t[1]) == 4


def test_decoders_and_encoder_match_jax():
    for name in ("subrip", "ass"):
        jd = JS.SubripDecoder() if name == "subrip" else JS.AssDecoder()
        td = (TS.SubripDecoder if name == "subrip" else TS.AssDecoder)(
            device="cpu")
        lines = ASS_LINES if name == "ass" else [
            "<i>it</i> is\n<b>two</b> lines", "plain", "\x00a&lt;b"]
        for i, line in enumerate(lines):
            jc = jd.decode(JPacket(data=line.encode(), pts=1000 * i,
                                   duration=700, time_base=JR(1, 1000)))
            tc = td.decode(TPacket(data=line.encode(), pts=1000 * i,
                                   duration=700, time_base=TR(1, 1000)))
            assert [(c.text, c.markup, c.pts, c.duration) for c in jc] == \
                [(c.text, c.markup, c.pts, c.duration) for c in tc]
            jp = JS.SubripEncoder().encode(jc[0])
            tp = TS.SubripEncoder().encode(tc[0])
            assert [(bytes(p.data), p.pts, p.duration) for p in jp] == \
                [(bytes(p.data), p.pts, p.duration) for p in tp]


def test_load_cues_matches_jax():
    j = JS.load_cues(CUES)
    t = TS.load_cues(CUES, device="cpu")
    assert [(c.text, c.markup, c.pts, c.duration) for c in j] == \
        [(c.text, c.markup, c.pts, c.duration) for c in t]


@pytest.mark.parametrize("extra", [[], ["-map", "0:s"], ["-ss", "0.3"]],
                         ids=["all", "map", "seek"])
def test_subtitle_chain_matches_jax(tmp_path, extra):
    outs = []
    for parse, tc, tag in ((jparse, JTranscoder, "j"),
                           (tparse, TTranscoder, "t")):
        out = str(tmp_path / f"{tag}.srt")
        argv = ["-i", CUES] + extra + ["-y", out]
        if tag == "t":
            argv = argv[:-1] + ["-device", "cpu", out]
        stats = tc(parse(argv)[0]).run()
        with open(out, "rb") as f:
            outs.append((stats["packets"], f.read()))
    assert outs[0] == outs[1]
    assert outs[1][1].count(b"-->") == (4 if not extra or extra[0] == "-map"
                                        else 2)


@pytest.mark.parametrize("opts", ["", ":fontsize=10:alpha=0.6"],
                         ids=["auto", "sized"])
def test_burn_in_matches_jax(opts):
    desc = f"subtitles={CUES}:fontfile={FONT}{opts}"
    jo, to = run_both(desc, n=24)
    assert_same(jo, to)
    plain = run_both("null", n=24)[1]
    changed = [i for i, (f, g) in enumerate(zip(to, plain))
               if not np.array_equal(np.asarray(f.planes[0]),
                                     np.asarray(g.planes[0]))]
    # cues cover frames 0-13, 15-18 and 20-22 at 25 fps
    assert changed == list(range(14)) + [15, 16, 17, 18, 20, 21, 22]
