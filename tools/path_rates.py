#!/usr/bin/env python3
"""The two paths' rates of the checkout this script lives in, on the card.

    python3 tools/path_rates.py [--rounds N]

Builds the checkout's kernels, then runs chip_smoke.py's fps phase (the
bench transcode, 16 warm frames then 24 timed) and its kernel-leg phase
(4 chained steps held to the JAX package's goldens, then one warm pass
timed) N times (default 1), with every check those phases make. To
compare two commits on one card, unpack both (git archive), copy this
file into each one's tools/ and run them in turns in one call: A B B A.
The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=1)
    rounds = ap.parse_args(argv).rounds
    import torch

    if not torch.cuda.is_available():
        print("path_rates: needs a CUDA card", file=sys.stderr)
        return 2
    os.environ["LIBREMPEG_TIMING"] = "1"
    import chip_smoke as CS
    from librempeg_tpu_torch import kernels
    from librempeg_tpu_torch.kernels import _build
    from librempeg_tpu_torch.native import build as native

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    native.get()
    for name in kernels.sources():
        _build.load(name)
    leg = CS.leg_inputs("cuda")
    e2e, kleg = [], []
    for _ in range(rounds):
        with tempfile.TemporaryDirectory() as td:
            e2e.append(CS.fps_phase("cuda", os.path.join(td, "fps.avi"),
                                    None)["fps"])
        kleg.append(CS.kernel_leg_phase("cuda", leg, None)["fps"])
    print(json.dumps({"root": os.path.basename(ROOT), "device": smi,
                      "e2e_fps": e2e, "kernel_leg_fps": kleg}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
