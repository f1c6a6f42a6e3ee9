#!/usr/bin/env python3
"""What nvcc makes of the port's CUDA kernels, on the card's machine.

    python3 tools/kernel_resources.py [SOURCE ...]

For each csrc/<SOURCE>.cu (default: all of kernels.sources()) it compiles
a cubin with the flags of kernels/_build.py plus -Xptxas -v into a
temporary directory and prints, per kernel, the registers, spill bytes
and static shared memory that ptxas reports, and the number of SASS
instructions cuobjdump shows. Needs nvcc (and cuobjdump beside it); the
last line is one JSON object.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def resources(name: str, tmp: str, src: str | None = None) -> dict:
    """{kernel: {registers, spill_bytes, static_smem, sass}} of
    csrc/<name>.cu (or of the source file `src`)."""
    from librempeg_tpu_torch.kernels import _build

    nvcc = _build._nvcc()
    if src is None:
        src = os.path.join(ROOT, "librempeg_tpu_torch", "csrc", f"{name}.cu")
    cubin = os.path.join(tmp, f"{name}.cubin")
    proc = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-cubin", "-Xptxas", "-v", "-o", cubin, src],
        capture_output=True, text=True, check=True)
    out: dict[str, dict] = {}
    fn = None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[fn]["static_smem"] = int(s.group(1)) if s else 0
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", cubin],
        capture_output=True, text=True, check=True).stdout
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {})["sass"] = 0
        elif fn and re.match(r"\s+/\*[0-9a-f]{4}\*/\s+\S", line):
            out[fn]["sass"] += 1
    return out


def main(argv) -> int:
    from librempeg_tpu_torch import kernels

    names = argv or kernels.sources()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            res[name] = resources(name, tmp)
            for fn, r in res[name].items():
                print(f"{name}: {fn}: {r}", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
