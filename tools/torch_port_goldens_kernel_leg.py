"""Make the kernel-leg goldens that chip_smoke.py holds the PyTorch port
to.

Runs the JAX package (the reference) on the CPU the way bench.py's
kernel leg runs it: parallel.pipeline.transcode_step on 8 testgen
frames at 1920x1088, scaled to 1280x720 at qscale 4, 4 chained steps
whose recon becomes the next step's reference, starting from a random
reference (numpy default_rng(0)). For each step it keeps the int8 MV
field and a strided sample of the luma recon (float16), and writes them
to tests/data/torch_port/kernel_leg.npz.

    python tools/torch_port_goldens_kernel_leg.py [--calibrate]

--calibrate also runs the port's transcode_step on the CPU on the same
inputs and prints, per step, the share of blocks whose MV equals the
JAX package's and the PSNR of the port's luma recon against the JAX
package's (whole plane and the stored sample): the numbers the bounds
in chip_smoke.py were set from.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from librempeg_tpu.parallel.pipeline import transcode_step  # noqa: E402
from librempeg_tpu.utils import testgen  # noqa: E402

OUT = os.path.join(REPO, "tests", "data", "torch_port", "kernel_leg.npz")
BATCH, H, W, DH, DW, ITERS, QSCALE = 8, 1088, 1920, 720, 1280, 4, 4.0
# luma recon sample: rows OFF::RS, columns OFF::CS of every frame
OFF, RS, CS = 7, 16, 32


def leg_inputs():
    """bench.py's kernel-leg inputs as numpy: (y, u, v) float32 batches
    and the random first reference."""
    planes = [testgen.video_yuv420(W, H, i) for i in range(BATCH)]
    y, u, v = (np.stack(p).astype(np.float32) for p in zip(*planes))
    ref = np.random.default_rng(0).integers(0, 256, (BATCH, DH, DW)) \
        .astype(np.float32)
    return y, u, v, ref


def psnr(a, b) -> float:
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    mse = float((d * d).mean())
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def main(argv) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calibrate", action="store_true",
                    help="also run the port on the CPU and print agreement")
    calibrate = ap.parse_args(argv).calibrate
    y, u, v, ref = leg_inputs()
    jy, ju, jv = (jnp.asarray(a) for a in (y, u, v))
    jref = jnp.asarray(ref)
    mvs, samples, recons = [], [], []
    for step in range(ITERS):
        t0 = time.perf_counter()
        out = transcode_step(jy, ju, jv, jref, dst_h=DH, dst_w=DW,
                             qscale=QSCALE)
        jref = out["y"]
        mv = np.asarray(out["mv"])
        rec = np.asarray(jref)
        mvs.append(mv.astype(np.int8))
        samples.append(rec[:, OFF::RS, OFF::CS].astype(np.float16))
        if calibrate:
            recons.append(rec)
        print(f"JAX step {step}: {time.perf_counter() - t0:.1f} s, "
              f"|mv| max {int(np.abs(mv).max())}")
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, mv=np.stack(mvs), y_sample=np.stack(samples),
                        sample=np.array([OFF, RS, CS], np.int32))
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes")
    if calibrate:
        import torch

        from librempeg_tpu_torch.parallel import pipeline as TP

        ty, tu, tv, tref = (torch.from_numpy(a) for a in (y, u, v, ref))
        for step in range(ITERS):
            out = TP.transcode_step(ty, tu, tv, tref, DH, DW, QSCALE)
            tref = out["y"]
            rec = tref.numpy()
            eq = (out["mv"].numpy() == mvs[step]).all(-1).mean()
            smp = rec[:, OFF::RS, OFF::CS]
            print(f"port step {step}: MVs equal on {eq:.6f} of blocks, "
                  f"luma recon PSNR {psnr(rec, recons[step]):.2f} dB "
                  f"(sample {psnr(smp, samples[step]):.2f} dB)")


if __name__ == "__main__":
    main(sys.argv[1:])
