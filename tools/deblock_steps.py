#!/usr/bin/env python3
"""Where the deblock kernel's time goes, on the card.

    python3 tools/deblock_steps.py

Times the package's deblock kernel (kernels.deblock.launch) with
chip_smoke.py's CUDA-event timer on random P frames
(deblock_pallas.random_p_frame), dense (most edges filter) and sparse
(closer to a real P frame), of several MB shapes: one MB row (120 and
240 MBs wide), one MB column (68 and 136 MBs tall) and 120x68; and on
the bench asset's first P frame
(120x68 MBs, as chip_smoke.py times it). The slope over the row width
is the time of one MB step within a block (two edge passes, the
write-back and the publish); the slope over the column height is the
time a row adds when it must wait for the row above (a step plus the
handoff between blocks). Needs a CUDA card; the last line is one JSON
object.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SHAPES = ((120, 1), (240, 1), (1, 68), (1, 136), (120, 68))


def synthetic(mb_w: int, mb_h: int, sparse: bool):
    """deblock_pallas.random_p_frame on the card -> (y, u, v), packed
    params."""
    import torch

    from librempeg_tpu_torch.codecs.h264 import deblock_pallas as DP

    planes, args = DP.random_p_frame(mb_w, mb_h, sparse=sparse)
    args = [torch.from_numpy(a).cuda() for a in args]
    return ([torch.from_numpy(p).cuda() for p in planes],
            DP.deblock_params(*args, mb_w, mb_h))


def bench_frame():
    """The bench asset's first P frame before its deblock (MC, residual
    and intra on the card, as chip_smoke.py's kernel phases run them)
    -> (y, u, v), the packed parameters, mb_w, mb_h."""
    import chip_smoke as CS
    from librempeg_tpu_torch.codecs.h264 import deblock_pallas as DP
    from librempeg_tpu_torch.codecs.h264 import device_recon as DR
    from librempeg_tpu_torch.codecs.h264 import intra_pallas as IP
    from librempeg_tpu_torch.codecs.h264 import mc_pallas as MC

    (idx, vals, qp, kind, info, i4m, ilist, mv, ref, luma4, upad, vpad,
     mb_w, mb_h, cqo, ao, bo, _, _), _ = CS.capture_p_frame("cuda")
    pred = MC.mc_predict(luma4, upad, vpad, mv, ref, mb_w, mb_h)
    y, u, v, lres_t, cres_t = DR.recon_p_frame_pred_noscan(
        *pred, idx, vals, qp, kind, mb_w, mb_h, cqo, fold_i16=True)
    scal = IP.build_intra_scalars(ilist, kind, info, i4m, mb_w, mb_h)
    planes = IP.intra_scan_pallas(y, u, v, scal, lres_t, cres_t, mb_w, mb_h)
    return (list(planes), DP.deblock_params(idx, vals, mv, ref, qp, kind,
                                            mb_w, mb_h, cqo, ao, bo),
            mb_w, mb_h)


def kernel_ms(planes, P, mb_w: int, mb_h: int) -> float:
    """Median device ms of one deblock call, the planes restored before
    each."""
    import chip_smoke as CS
    from librempeg_tpu_torch.kernels import deblock as KD

    work = [p.clone() for p in planes]

    def restore():
        for w, p in zip(work, planes):
            w.copy_(p)

    return CS.device_ms(lambda: KD.launch(*work, P, mb_w, mb_h), restore)


def main(argv) -> int:
    import argparse

    argparse.ArgumentParser(description=__doc__.split("\n")[0]) \
        .parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("deblock_steps: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    res = {}
    for kind in ("dense", "sparse"):
        t = {s: kernel_ms(*synthetic(*s, kind == "sparse"), *s)
             for s in SHAPES}
        res[kind] = {
            "step_us": (t[240, 1] - t[120, 1]) / 120 * 1e3,
            "row_us": (t[1, 136] - t[1, 68]) / 68 * 1e3,
            "ms_120x68": t[120, 68],
            "per_254_us": t[120, 68] / 254 * 1e3}
        r = res[kind]
        print(f"{kind}: MB step {r['step_us']:.3f} us, row handoff + step "
              f"{r['row_us']:.3f} us, 120x68 {r['ms_120x68']:.4f} ms = "
              f"{r['per_254_us']:.3f} us over 254 steps", flush=True)
    res["bench_ms"] = kernel_ms(*bench_frame())
    print(f"bench P frame: {res['bench_ms']:.4f} ms", flush=True)
    print(json.dumps({"device": smi, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
