"""ffprobe-compatible CLI.

Analog of fftools/ffprobe.c with its pluggable text
formatters (fftools/textformat/tf_{default,compact,csv,flat,ini,json,
xml}.c): -show_format, -show_streams, -show_packets through
-of/-print_format writers.

A copy of librempeg_tpu/cli/ffprobe.py (host code, no JAX), imports
rewritten.
"""
from __future__ import annotations

import json
import sys

from librempeg_tpu_torch.core.rational import NOPTS
from librempeg_tpu_torch.formats.api import open_input


def probe(url: str, format: str | None = None, count_packets: bool = False,
          **opts) -> dict:
    """Collect format/stream metadata (probe_file analog)."""
    d = open_input(url, format, **opts)
    info: dict = {"format": {
        "filename": url,
        "format_name": d.NAME,
        "format_long_name": d.LONG_NAME,
        "nb_streams": len(d.streams),
    }}
    if d.duration != NOPTS:
        info["format"]["duration"] = f"{d.duration / 1_000_000:.6f}"
    for k, v in d.metadata.items():
        info["format"][f"TAG:{k}"] = v
    streams = []
    for st in d.streams:
        par = st.codecpar
        s = {
            "index": st.index,
            "codec_name": par.codec_id,
            "codec_type": par.codec_type,
            "time_base": f"{st.time_base.num}/{st.time_base.den}",
        }
        if par.codec_type == "video":
            s.update(width=par.width, height=par.height,
                     pix_fmt=par.pix_fmt)
            if par.framerate.num:
                s["avg_frame_rate"] = f"{par.framerate.num}/{par.framerate.den}"
        elif par.codec_type == "audio":
            s.update(sample_rate=str(par.sample_rate),
                     channels=par.nb_channels)
        if st.duration != NOPTS:
            dur = st.duration * st.time_base.num / st.time_base.den
            s["duration"] = f"{dur:.6f}"
        streams.append(s)
    info["streams"] = streams
    if count_packets:
        counts: dict[int, int] = {}
        pkts = []
        for pkt in d.packets():
            counts[pkt.stream_index] = counts.get(pkt.stream_index, 0) + 1
            pkts.append({
                "codec_type": d.streams[pkt.stream_index].codecpar.codec_type,
                "stream_index": pkt.stream_index,
                "pts": None if pkt.pts == NOPTS else pkt.pts,
                "dts": None if pkt.dts == NOPTS else pkt.dts,
                "duration": pkt.duration,
                "size": str(len(pkt.data)),
            })
        info["packets"] = pkts
        for s in streams:
            s["nb_read_packets"] = str(counts.get(s["index"], 0))
    d.close()
    return info


# ---------------------------------------------------------------------------
# Writers (textformat analogs)
# ---------------------------------------------------------------------------


def write_json(info: dict, out) -> None:
    out.write(json.dumps(info, indent=4) + "\n")


def write_default(info: dict, out) -> None:
    for st in info.get("streams", []):
        out.write("[STREAM]\n")
        for k, v in st.items():
            out.write(f"{k}={v}\n")
        out.write("[/STREAM]\n")
    if "format" in info:
        out.write("[FORMAT]\n")
        for k, v in info["format"].items():
            out.write(f"{k}={v}\n")
        out.write("[/FORMAT]\n")


def write_flat(info: dict, out) -> None:
    for i, st in enumerate(info.get("streams", [])):
        for k, v in st.items():
            vv = f'"{v}"' if isinstance(v, str) else v
            out.write(f"streams.stream.{i}.{k}={vv}\n")
    for k, v in info.get("format", {}).items():
        vv = f'"{v}"' if isinstance(v, str) else v
        out.write(f"format.{k}={vv}\n")


def write_csv(info: dict, out) -> None:
    for st in info.get("streams", []):
        out.write("stream," + ",".join(str(v) for v in st.values()) + "\n")
    if "format" in info:
        out.write("format," + ",".join(
            str(v) for v in info["format"].values()) + "\n")


def write_ini(info: dict, out) -> None:
    for i, st in enumerate(info.get("streams", [])):
        out.write(f"[streams.stream.{i}]\n")
        for k, v in st.items():
            out.write(f"{k}={v}\n")
        out.write("\n")
    if "format" in info:
        out.write("[format]\n")
        for k, v in info["format"].items():
            out.write(f"{k}={v}\n")


def write_xml(info: dict, out) -> None:
    out.write('<?xml version="1.0" encoding="UTF-8"?>\n<ffprobe>\n')
    out.write("    <streams>\n")
    for st in info.get("streams", []):
        attrs = " ".join(f'{k}="{v}"' for k, v in st.items())
        out.write(f"        <stream {attrs}/>\n")
    out.write("    </streams>\n")
    if "format" in info:
        attrs = " ".join(f'{k}="{v}"' for k, v in info["format"].items())
        out.write(f"    <format {attrs}/>\n")
    out.write("</ffprobe>\n")


_WRITERS = {
    "json": write_json,
    "default": write_default,
    "flat": write_flat,
    "csv": write_csv,
    "compact": write_csv,
    "ini": write_ini,
    "xml": write_xml,
}


def main(argv: list[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    url = None
    fmt = None
    writer = "default"
    show = set()
    count_packets = False
    in_opts: dict = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-of", "-print_format", "-output_format"):
            i += 1
            writer = argv[i].split("=")[0]
        elif a == "-show_format":
            show.add("format")
        elif a == "-show_streams":
            show.add("streams")
        elif a == "-show_packets":
            show.add("packets")
            count_packets = True
        elif a == "-count_packets":
            count_packets = True
        elif a == "-f":
            i += 1
            fmt = argv[i]
        elif a in ("-v", "-loglevel"):
            i += 1
        elif a == "-i":
            i += 1
            url = argv[i]
        elif not a.startswith("-"):
            url = a
        i += 1
    if url is None:
        print("usage: ffprobe [-show_format] [-show_streams] [-of json] url",
              file=sys.stderr)
        return 1
    info = probe(url, fmt, count_packets=count_packets)
    if show:
        info = {k: v for k, v in info.items()
                if k in show or (k == "streams" and "streams" in show)
                or (k == "format" and "format" in show)
                or (k == "packets" and "packets" in show)}
    _WRITERS.get(writer, write_default)(info, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
