"""ffmpeg-style command line for the port's transcode slice.

A thin wrapper over sched.pipeline.Transcoder that accepts only the
options the slice implements:

    python -m librempeg_tpu_torch.cli.ffmpeg -i IN.264
        [-s WxH | -vf scale=W:H] -c:v mpeg4 [-b:v N] [-g N]
        [-frames:v N] [-device cuda|cpu] [-y] OUT.avi

-device defaults to cuda; without a card the run fails rather than
moving to the CPU.
"""
from __future__ import annotations

import os
import sys
import time

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


def parse_args(argv: list[str]) -> tuple[TranscodeSpec, bool]:
    smap = StreamMap(codec="mpeg4")
    kw: dict = {"input_url": None, "output_url": None}
    overwrite = False
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-y", "-n"):
            overwrite = a == "-y"
            i += 1
            continue
        if not a.startswith("-") or a == "-":
            if kw["output_url"] is not None:
                raise CliError(f"unexpected argument {a!r}")
            kw["output_url"] = a
            i += 1
            continue
        if i + 1 >= len(argv):
            raise CliError(f"option {a} needs an argument")
        v = argv[i + 1]
        i += 2
        if a == "-i":
            kw["input_url"] = v
        elif a in ("-c:v", "-vcodec", "-codec:v"):
            smap.codec = v
        elif a == "-s":
            w, _, h = v.partition("x")
            smap.width, smap.height = int(w), int(h)
        elif a in ("-vf", "-filter:v"):
            smap.filters = v
        elif a in ("-b:v", "-b"):
            smap.codec_opts["bit_rate"] = _int(v)
        elif a == "-g":
            smap.codec_opts["gop_size"] = int(v)
        elif a in ("-q:v", "-qscale:v"):
            smap.codec_opts["qscale"] = int(v)
        elif a in ("-frames:v", "-vframes"):
            smap.frames_limit = int(v)
        elif a == "-device":
            kw["device"] = v
        else:
            raise CliError(f"option {a} is not supported by the port")
    if not kw["input_url"] or not kw["output_url"]:
        raise CliError("usage: -i INPUT [options] OUTPUT.avi")
    if smap.codec != "mpeg4":
        raise CliError(f"-c:v {smap.codec}: the port encodes mpeg4 only")
    return TranscodeSpec(video=smap, **kw), overwrite


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
