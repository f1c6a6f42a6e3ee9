"""ffmpeg-style command line for the port's transcode slices.

A thin wrapper over sched.pipeline.Transcoder that accepts only the
options the slices implement:

    python -m librempeg_tpu_torch.cli.ffmpeg [-f FMT] [INPUT OPTIONS] -i IN
        [-ss T] [-t T] [-metadata K=V] [-r RATE]
        [-s WxH] [-vf GRAPH] [-pix_fmt F] [-c:v mpeg4|mjpeg|rawvideo|copy]
        [-b:v N | -q:v N] [-g N] [-bf N] [-trellis N] [-frames:v N]
        [-c:a aac|pcm_s16le] [-b:a N] [-ar RATE] [-ac N] [-af CHAIN]
        [-frames:a N] [-vn] [-an] [-device cuda|cpu] [-y] [-f FMT] OUT

Video: H.264, MJPEG (in AVI, raw .mjpeg, or image2 files such as
thumb_%03d.jpg), or a source filter graph (-f lavfi -i
"testsrc=size=1920x1088:duration=2", "sine=frequency=1000:duration=10")
in, each also from MP4/MOV, Matroska, MPEG-TS, Y4M or raw video; MPEG-4
or MJPEG in AVI, MP4, Matroska or MPEG-TS, raw MJPEG (-f mjpeg), image2
(-f image2, one file per frame), Y4M, raw video, or the hash muxers
(-f framemd5, framecrc, md5, crc, null) out. -f before -i names the
input format, after it the output's. Without -c:v the output format
picks the codec (mjpeg for image2 and mjpeg; rawvideo for the hash
muxers, yuv4mpegpipe and rawvideo; mpeg4 otherwise); -c:v copy passes
the packets through (H.264 and HEVC into MP4 and Matroska as avcC and
hvcC). Before -i, -s, -r/-framerate, -pix_fmt, -ar, -ac/-channels and
-ch_layout describe a headerless input (-f rawvideo, -f s16le). -ss T
seeks the input (the container to the keyframe at or before T, then an
exact decode-and-drop), -t T stops after T seconds of it (T in seconds
or HH:MM:SS.mmm), -metadata key=value tags the output, -r RATE after
-i appends fps=RATE to the -vf chain. -vf takes a filter graph (crop, pad,
hflip, vflip, transpose, fps, trim, setpts, scale, format, colorspace,
eq, gblur, boxblur, lutyuv, drawbox, fade, minterpolate, ...), -af an
audio one (highpass, lowpass, equalizer, bass, aecho, afade, ...). -q:v
is the MPEG-4 qscale, or for mjpeg a quality of 100 - 3.1 q (the JAX
package's rule). -pix_fmt appends format=F after the scale (e.g.
yuvj420p, a range change); -bf sets the B-VOPs between anchors (0-4);
-trellis the RD quantisation of MPEG-4 I/P-VOPs or of the JPEG AC
levels (0-2).

Audio (PCM WAV or ADTS AAC in; AAC in ADTS, or s16 PCM in WAV or AVI,
out): -ar appends aresample=RATE to the -af chain, -ac appends
aformat=channel_layouts=<the default layout of N channels> when N
differs from the input; -b:a is the AAC bit rate (0 or absent: constant
quality). The audio codec defaults to pcm_s16le. -vn and -an drop the
video or audio streams. -af aresample=RATE:dither_method=M (rectangular,
triangular, triangular_hp, or the noise shapers lipshitz and f_weighted)
dithers where the resampled samples return to an integer format, as
from a 16-bit WAV to pcm_s16le. For example

    python -m librempeg_tpu_torch.cli.ffmpeg -i in.wav -ar 48000 \
        -c:a aac -b:a 128k -y out.aac
    python -m librempeg_tpu_torch.cli.ffmpeg -i in.wav \
        -af aresample=48000:dither_method=lipshitz -c:a pcm_s16le -y out.wav

-device defaults to cuda; without a card the run fails rather than
moving to the CPU.
"""
from __future__ import annotations

import os
import sys
import time

from librempeg_tpu_torch.core.rational import Rational
from librempeg_tpu_torch.core.samplefmt import ChannelLayout
from librempeg_tpu_torch.sched.pipeline import (
    StreamMap,
    TranscodeSpec,
    Transcoder,
)


class CliError(SystemExit):
    pass


def _int(s: str) -> int:
    """'4000000', '4M' or '500k'."""
    mult = {"k": 1000, "K": 1000, "m": 1_000_000, "M": 1_000_000}
    if s and s[-1] in mult:
        return int(float(s[:-1]) * mult[s[-1]])
    return int(s)


def _parse_time(s: str) -> float:
    """'12.5' or 'HH:MM:SS.mmm'."""
    t = 0.0
    for part in s.split(":"):
        t = t * 60 + float(part)
    return t


def parse_args(argv: list[str]) -> tuple[TranscodeSpec, bool]:
    smap = StreamMap()
    audio = StreamMap(codec="pcm_s16le")
    kw: dict = {"input_url": None, "output_url": None}
    in_opts: dict = {}               # options before -i, for the demuxer
    overwrite = False
    fmt = None                       # -f: for the next -i or the output
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-y", "-n"):
            overwrite = a == "-y"
            i += 1
            continue
        if a in ("-vn", "-an"):
            kw["no_video" if a == "-vn" else "no_audio"] = True
            i += 1
            continue
        if not a.startswith("-") or a == "-":
            if kw["output_url"] is not None:
                raise CliError(f"unexpected argument {a!r}")
            kw["output_url"] = a
            kw["output_format"], fmt = fmt, None
            i += 1
            continue
        if i + 1 >= len(argv):
            raise CliError(f"option {a} needs an argument")
        v = argv[i + 1]
        i += 2
        pre_input = kw["input_url"] is None
        if a == "-i":
            kw["input_url"] = v
            kw["input_format"], fmt = fmt, None
            kw["input_opts"], in_opts = in_opts, {}
        elif a == "-f":
            fmt = v
        elif a in ("-c:v", "-vcodec", "-codec:v"):
            smap.codec = v
        elif a in ("-s", "-video_size", "-s:v"):
            w, _, h = v.lower().partition("x")
            if pre_input:
                in_opts["width"], in_opts["height"] = int(w), int(h)
            else:
                smap.width, smap.height = int(w), int(h)
        elif a in ("-r", "-framerate", "-r:v"):
            rate = (Rational(*map(int, v.split("/"))) if "/" in v
                    else Rational.from_float(float(v)))
            if pre_input:
                in_opts["framerate"] = rate
            else:
                f = f"fps={rate.num}/{rate.den}"
                smap.filters = f"{smap.filters},{f}" if smap.filters else f
        elif a == "-ss":
            kw["seek"] = _parse_time(v)
        elif a == "-t":
            kw["duration"] = _parse_time(v)
        elif a == "-metadata":
            if "=" not in v:
                raise CliError("-metadata needs key=value")
            key, _, val = v.partition("=")
            kw.setdefault("metadata", {})[key] = val
        elif a in ("-vf", "-filter:v"):
            smap.filters = v
        elif a in ("-b:v", "-b"):
            smap.codec_opts["bit_rate"] = _int(v)
        elif a == "-g":
            smap.codec_opts["gop_size"] = int(v)
        elif a == "-bf":
            smap.codec_opts["max_b_frames"] = int(v)
        elif a == "-trellis":
            smap.codec_opts["trellis"] = int(v)
        elif a == "-pix_fmt":
            if pre_input:
                in_opts["pix_fmt"] = v
            else:
                smap.pix_fmt = v
        elif a in ("-q:v", "-qscale:v"):
            smap.codec_opts["quality_scale"] = float(v)
        elif a in ("-frames:v", "-vframes"):
            smap.frames_limit = int(v)
        elif a in ("-c:a", "-acodec", "-codec:a"):
            audio.codec = v
        elif a == "-b:a":
            audio.codec_opts["bit_rate"] = _int(v)
        elif a == "-ar":
            if pre_input:
                in_opts["sample_rate"] = int(v)
            else:
                audio.sample_rate = int(v)
        elif a in ("-ac", "-channels", "-ch_layout"):
            n = (ChannelLayout.from_string(v).nb_channels
                 if a == "-ch_layout" else int(v))
            if pre_input:
                in_opts["channels"] = n
            else:
                audio.channels = n
        elif a in ("-af", "-filter:a"):
            audio.filters = v
        elif a in ("-frames:a", "-aframes"):
            audio.frames_limit = int(v)
        elif a == "-device":
            kw["device"] = v
        else:
            raise CliError(f"option {a} is not supported by the port")
    if not kw["input_url"] or not kw["output_url"]:
        raise CliError("usage: -i INPUT [options] OUTPUT")
    return TranscodeSpec(video=smap, audio=audio, **kw), overwrite


def main(argv: list[str] | None = None) -> int:
    spec, overwrite = parse_args(sys.argv[1:] if argv is None else argv)
    if os.path.exists(spec.output_url) and not overwrite:
        raise CliError(f"{spec.output_url} exists (use -y to overwrite)")
    t0 = time.perf_counter()
    stats = Transcoder(spec).run()
    dt = time.perf_counter() - t0
    n = sum(stats["frames"].values())
    print(f"frames={n} packets={stats['packets']} time={dt:.3f}s "
          f"fps={n / dt:.2f}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
