"""ffmpeg-style command line for the port's transcode slices.

A thin wrapper over sched.pipeline.Transcoder that accepts the options
the slices implement and passes any other -name value to the codecs:

    python -m librempeg_tpu_torch.cli.ffmpeg [-f FMT] [INPUT OPTIONS] -i IN
        [-ss T] [-t T | -to T] [-metadata K=V] [-r RATE]
        [-s WxH] [-vf GRAPH] [-pix_fmt F]
        [-c:v h264|mpeg4|mpeg2video|mpeg1video|mjpeg|rawvideo|copy]
        [-b:v N | -q:v N] [-g N] [-bf N] [-trellis N] [-frames:v N]
        [-c:a aac|pcm_s16le] [-b:a N] [-ar RATE] [-ac N] [-af CHAIN]
        [-frames:a N] [-vn] [-an] [-c CODEC] [-map SPEC]...
        [-v LEVEL] [-progress URL] [-stats_period S] [-benchmark]
        [-threads N] [-NAME[:v|:a] VALUE] [-device cuda|cpu] [-y]
        [-f FMT] OUT

Video: H.264, MJPEG (in AVI, raw .mjpeg, or image2 files such as
thumb_%03d.jpg), or a source filter graph (-f lavfi -i
"testsrc=size=1920x1088:duration=2", "sine=frequency=1000:duration=10")
in, each also from MP4/MOV, Matroska, MPEG-TS, Y4M or raw video, and
MPEG-1/2 video (raw .m1v/.m2v/.mpgv, MPEG-TS, Matroska); H.264 (raw
.264 or in MP4, Matroska, MPEG-TS), MPEG-1/2 video (raw .m1v/.m2v or in
MPEG-TS, stream type 0x01/0x02, or Matroska), MPEG-4 or MJPEG in AVI,
MP4, Matroska or MPEG-TS, raw MJPEG (-f mjpeg), image2
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
or HH:MM:SS.mmm), -to T stops at position T (after an -ss on its side
of -i, or an output -ss, the run lasts T - ss; after an input -ss the
output's timestamps restart at 0 and -to acts as -t; -t wins; -to at
or before -ss raises), -metadata key=value tags the output, -r RATE after
-i appends fps=RATE to the -vf chain. -vf takes a filter graph (crop, pad,
hflip, vflip, transpose, fps, trim, setpts, scale, format, colorspace,
eq, gblur, boxblur, lutyuv, drawbox, fade, minterpolate, ...), -af an
audio one (highpass, lowpass, equalizer, bass, aecho, afade, ...). -q:v
is the MPEG-4 qscale, or for mjpeg a quality of 100 - 3.1 q (the JAX
package's rule). -pix_fmt appends format=F after the scale (e.g.
yuvj420p, a range change); -bf sets the B-VOPs between anchors (0-4);
-trellis the RD quantisation of MPEG-4 I/P-VOPs or of the JPEG AC
levels (0-2). -g and -bf reach H.264's g and bf and MPEG-1/2's g. Any
other -NAME VALUE after -i is a private codec option (-qp 26 -sr 4
-cabac 1 -variety 1 -pcm 0 for h264): -NAME:v / -NAME:a for the video
or audio encoder, which must declare it, and unscoped for every
encoder that declares it (one that none declares raises); before -i it
goes to the demuxer. For example

    python -m librempeg_tpu_torch.cli.ffmpeg -i in.264 -c:v h264 -qp 26 \
        -bf 1 -y out.mp4
    python -m librempeg_tpu_torch.cli.ffmpeg -i in.264 -c:v mpeg2video \
        -q:v 5 -f mpegts -y out.ts

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

-c (or -codec) names the codec of every stream (-c copy remuxes);
-map 0, 0:v, 0:a, 0:s, 0:N or 0:v:N selects input streams (all when
none is given); a subtitle stream (SubRip, ASS) is re-encoded as
SubRip. -v/-loglevel sets the log level; -progress URL writes
ffmpeg's key=value blocks (frame, fps, out_time_us, out_time, speed,
progress=continue|end) every -stats_period seconds and at the end
("-" or pipe:1 for stdout); -benchmark prints the run's CPU times and
peak memory; -threads N caps the host's torch threads.

-mesh SPEC (data=2,spatial=3) runs the transcode over a mesh of
distinct devices, cuda:0 .. cuda:k-1 (k the product of the sizes; it
fails when the machine has fewer, and on -device cpu): the scaler's
vertical GEMM split over output rows when they divide by spatial, and
each MPEG-4 P-VOP over row bands when its coded height divides by
16 * spatial (at 1280x720 only spatial in {3, 5, 9, 15, 45}; 2 and 4
leave it whole). The output bytes are those of the run without -mesh.

-device defaults to cuda; without a card the run fails rather than
moving to the CPU.
"""
from __future__ import annotations

import os
import sys
import time

import torch

from librempeg_tpu_torch.core.log import set_level
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
    return int(float(s))


def _parse_time(s: str) -> float:
    """'12.5' or 'HH:MM:SS.mmm'."""
    t = 0.0
    for part in s.split(":"):
        t = t * 60 + float(part)
    return t


def parse_args(argv: list[str]) -> tuple[TranscodeSpec, bool]:
    """The transcode spec and -y of a command line (parse_cli's
    spec and its "overwrite")."""
    spec, glob = parse_cli(argv)
    return spec, glob["overwrite"]


def parse_cli(argv: list[str]) -> tuple[TranscodeSpec, dict]:
    """The transcode spec and the run's global options: overwrite (-y),
    benchmark, threads, progress (a file name or "-"/"pipe:1" for
    stdout) and stats_period. -v sets the log level as it is read."""
    glob: dict = {"overwrite": False, "benchmark": False, "threads": 0,
                  "progress": "", "stats_period": 0.5}
    smap = StreamMap()
    audio = StreamMap(codec="pcm_s16le")
    kw: dict = {"input_url": None, "output_url": None}
    in_opts: dict = {}               # options before -i, for the demuxer
    fmt = None                       # -f: for the next -i or the output
    to = None                        # -to: a position, before or after -i
    to_input = ss_input = False
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-y", "-n"):
            glob["overwrite"] = a == "-y"
            i += 1
            continue
        if a == "-benchmark":
            glob["benchmark"] = True
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
        elif a in ("-c", "-codec"):
            smap.codec = audio.codec = v
        elif a in ("-c:v", "-vcodec", "-codec:v"):
            smap.codec = v
        elif a in ("-v", "-loglevel"):
            set_level(v)
        elif a == "-progress":
            glob["progress"] = v
        elif a == "-stats_period":
            glob["stats_period"] = float(v)
        elif a == "-threads":
            glob["threads"] = int(v)
        elif a == "-map":
            kw.setdefault("maps", []).append(v)
        elif a == "-mesh":
            kw["mesh"] = v
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
            ss_input = pre_input
        elif a == "-t":
            kw["duration"] = _parse_time(v)
        elif a == "-to":
            to, to_input = _parse_time(v), pre_input
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
        elif a in ("-q:v", "-qscale:v", "-q"):
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
        elif pre_input:
            in_opts[a[1:]] = v       # a demuxer option; unknown ones raise
        elif a.endswith(":v"):
            smap.codec_opts[a[1:-2]] = v
        elif a.endswith(":a"):
            audio.codec_opts[a[1:-2]] = v
        else:
            # a private codec option for every encoder that declares it
            # (ffmpeg_opt.c's AVDictionary pass-through); the Transcoder
            # raises if none does
            kw.setdefault("codec_opts", {})[a[1:]] = v
    if not kw["input_url"] or not kw["output_url"]:
        raise CliError("usage: -i INPUT [options] OUTPUT")
    if to is not None and "duration" not in kw:
        kw["duration"] = _to_duration(to, to_input, kw.get("seek", 0.0),
                                      ss_input)
    return TranscodeSpec(video=smap, audio=audio, **kw), glob


def _to_duration(to: float, to_input: bool, ss: float,
                 ss_input: bool) -> float:
    """-to as ffmpeg reads it: a position on the timeline of the side it
    is given on. After an -ss, the run lasts to - ss, except that an
    input -ss with an output -to starts the output's timestamps again
    at 0, so there -to is the duration. (The JAX package reads
    every -to as a duration.)"""
    if ss and not (ss_input and not to_input):
        if to <= ss:
            raise CliError(f"-to {to} is not after -ss {ss}")
        return to - ss
    if to <= 0:
        raise CliError(f"-to {to} must be positive")
    return to


def _progress_writer(url: str):
    """The -progress feed (ffmpeg.c's key=value blocks, each ended by
    progress=continue or progress=end), as the JAX package writes it:
    (callback for Transcoder.run, the stream to close or None)."""
    io = sys.stdout if url in ("-", "pipe:", "pipe:1") else open(url, "w")

    def write(st):
        h = int(st["out_time_s"] // 3600)
        m = int(st["out_time_s"] // 60) % 60
        sec = st["out_time_s"] % 60
        io.write(f"frame={st['frame']}\n"
                 f"fps={st['fps']:.2f}\n"
                 f"out_time_us={int(st['out_time_s'] * 1e6)}\n"
                 f"out_time={h:02d}:{m:02d}:{sec:09.6f}\n"
                 f"speed={st['speed']:.3g}x\n"
                 f"progress={'end' if st['done'] else 'continue'}\n")
        io.flush()

    return write, (None if io is sys.stdout else io)


def main(argv: list[str] | None = None) -> int:
    spec, glob = parse_cli(sys.argv[1:] if argv is None else argv)
    if os.path.exists(spec.output_url) and not glob["overwrite"]:
        raise CliError(f"{spec.output_url} exists (use -y to overwrite)")
    if glob["threads"]:
        # the host's share of the run (the JAX package parses -threads
        # and uses it nowhere)
        torch.set_num_threads(glob["threads"])
    t0 = time.perf_counter()
    progress, prog_io = (_progress_writer(glob["progress"])
                         if glob["progress"] else (None, None))
    try:
        stats = Transcoder(spec).run(progress=progress,
                                     progress_interval=glob["stats_period"])
    finally:
        if prog_io is not None:
            prog_io.close()
    dt = time.perf_counter() - t0
    n = sum(stats["frames"].values())
    print(f"frames={n} packets={stats['packets']} time={dt:.3f}s "
          f"fps={n / dt:.2f}", file=sys.stderr)
    if glob["benchmark"]:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF)
        print(f"bench: utime={ru.ru_utime:.3f}s stime={ru.ru_stime:.3f}s "
              f"rtime={dt:.3f}s", file=sys.stderr)
        print(f"bench: maxrss={ru.ru_maxrss}KiB", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
