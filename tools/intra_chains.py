#!/usr/bin/env python3
"""The intra MBs of the bench clip's P frames and their dependence chains.

    python3 tools/intra_chains.py [--device cpu|cuda]

Decodes assets/bench_1080p.264 with the port's H.264 decoder and, for
each P frame that takes the device path, counts its intra MBs (I16x16
and I4x4), the dependent steps of its intra list under the intra
kernel's wait (each MB one step after its latest intra neighbour among
left, top-left, top and top-right: intra_pallas.dependent_steps) and the
widest step (the most MBs that can run at once). These are counts, not
times; the last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
from collections import Counter
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
ASSET = os.path.join(ROOT, "assets", "bench_1080p.264")


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu")
    dev = ap.parse_args(argv).device

    from librempeg_tpu_torch.codecs.h264 import decode_step as DS
    from librempeg_tpu_torch.codecs.h264 import intra_pallas as IP
    from librempeg_tpu_torch.codecs.h264.codec import H264Decoder
    from librempeg_tpu_torch.formats.api import open_input

    frames = []
    orig = DS.decode_p_step

    def count(*args):
        kind, ilist, mb_w = args[3], args[6], args[12]
        mbs = ilist.tolist()
        steps = Counter(IP.dependent_levels(mbs, mb_w).values())
        n_i4 = int((kind[ilist.long()] == 2).sum()) if mbs else 0
        frames.append({"intra": len(mbs), "i4x4": n_i4,
                       "steps": len(steps),
                       "widest": max(steps.values(), default=0)})
        return orig(*args)

    DS.decode_p_step = count
    try:
        demux = open_input(ASSET)
        dec = H264Decoder(demux.streams[0].codecpar, device=dev,
                          prefetch=0)
        for pkt in demux.packets():
            dec.decode(pkt)
        dec.flush()
        demux.close()
    finally:
        DS.decode_p_step = orig
    tot = {k: sum(f[k] for f in frames) for k in ("intra", "i4x4", "steps")}
    print(f"{len(frames)} P frames; intra MBs {tot['intra']} "
          f"({tot['i4x4']} I4x4) in {tot['steps']} dependent steps; per "
          f"frame: intra {min(f['intra'] for f in frames)}-"
          f"{max(f['intra'] for f in frames)}, steps "
          f"{min(f['steps'] for f in frames)}-"
          f"{max(f['steps'] for f in frames)}, widest step "
          f"{min(f['widest'] for f in frames)}-"
          f"{max(f['widest'] for f in frames)}; first P frame "
          f"{frames[0]}", flush=True)
    print(json.dumps({"frames": frames, "total": tot}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
