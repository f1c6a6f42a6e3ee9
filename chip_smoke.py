#!/usr/bin/env python3
"""Smoke run of the PyTorch port (librempeg_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--profile DIR]

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the native host library and the four CUDA kernels, from the
   sources in this checkout;
3. one phase per kernel: the kernel against its plain PyTorch version on
   the card, on real inputs (the first P frame of assets/bench_1080p.264
   for the H.264 kernels; the encoder's first I-VOP recon and the next
   scaled frame for the half-pel kernel), bit-exact, with the median of
   25 synchronised runs of each;
4. slice: the bench transcode (1080p H.264 -> 1280x720 MPEG-4 at 4 Mb/s)
   through Transcoder on the card. Every decoded frame's md5 must match
   the JAX package's (tests/data/torch_port), the AVI must hold 48
   packets with an I-VOP every 12, the mean in-loop recon PSNR must be
   within 0.5 dB of the JAX package's, and every kernel must have
   launched during this run;
5. fps: steady-state transcode rate measured like bench.py's e2e leg
   (16 warm frames, then 24 timed, each window ending in chain.sync()),
   with the stage split. --profile DIR adds a torch.profiler window of
   8 frames; its table goes to DIR/chip_smoke_profile.txt.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ASSET = os.path.join(ROOT, "assets", "bench_1080p.264")
GOLD = os.path.join(ROOT, "tests", "data", "torch_port")
PSNR_TOL_DB = 0.5
RUNS = 25

KERNELS = {
    "mc": ("librempeg_tpu_torch/csrc/mc.cu",
           "librempeg_tpu/codecs/h264/mc_pallas.py:324"),
    "intra": ("librempeg_tpu_torch/csrc/intra.cu",
              "librempeg_tpu/codecs/h264/intra_pallas.py:578"),
    "deblock": ("librempeg_tpu_torch/csrc/deblock.cu",
                "librempeg_tpu/codecs/h264/deblock_pallas.py:275"),
    "hpel": ("librempeg_tpu_torch/csrc/hpel.cu",
             "librempeg_tpu/codecs/mpeg4/me_pallas.py:479"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what) -> None:
    """Fail the run (a plain assert would vanish under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def median_ms(fn, restore=None, runs: int = RUNS, warm: int = 3) -> float:
    """Median wall time of fn() in ms over `runs` runs after `warm`
    warm-up runs, each bracketed by torch.cuda.synchronize();
    restore() (untimed) runs before each call."""
    import torch

    ts = []
    for i in range(warm + runs):
        if restore is not None:
            restore()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warm:
            ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def max_abs_err(got, want) -> float:
    err = 0.0
    for a, b in zip(got, want):
        check(a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape))
        err = max(err, float((a.double() - b.double()).abs().max()))
    return err


def frame_md5(planes) -> str:
    h = hashlib.md5()
    for p in planes:
        h.update(p.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def avi_payloads(path: str) -> list[bytes]:
    """Video chunk payloads of an AVI's movi list, in file order."""
    data = open(path, "rb").read()
    pos = 12
    while pos + 12 <= len(data):
        cid, size = data[pos:pos + 4], int.from_bytes(data[pos + 4:pos + 8],
                                                      "little")
        if cid == b"LIST" and data[pos + 8:pos + 12] == b"movi":
            out, p, end = [], pos + 12, pos + 8 + size
            while p + 8 <= end:
                ck = data[p:p + 4]
                n = int.from_bytes(data[p + 4:p + 8], "little")
                if ck[2:] in (b"dc", b"db"):
                    out.append(data[p + 8:p + 8 + n])
                p += 8 + n + (n & 1)
            return out
        pos += 8 + size + (size & 1)
    raise AssertionError("no movi list in the AVI")


def vop_type(data: bytes) -> str:
    i = data.index(b"\x00\x00\x01\xb6")
    return "IPBS"[data[i + 4] >> 6]


def capture_p_frame(dev):
    """Decode the asset on `dev` up to its first P frame and return the
    arguments that frame's decode step received."""
    from librempeg_tpu_torch.codecs.h264 import decode_step as DS
    from librempeg_tpu_torch.codecs.h264.codec import H264Decoder
    from librempeg_tpu_torch.formats.api import open_input

    captured = []
    orig = DS.decode_p_step

    def capture(*args):
        captured.append(args)
        return orig(*args)

    DS.decode_p_step = capture
    try:
        demux = open_input(ASSET)
        dec = H264Decoder(demux.streams[0].codecpar, device=dev,
                          prefetch=0)
        frames = []
        for pkt in demux.packets():
            frames += dec.decode(pkt)
            if captured:
                break
        frames += dec.flush()
        demux.close()
    finally:
        DS.decode_p_step = orig
    return captured[0], frames


def kernel_phases(dev) -> dict:
    import torch

    from librempeg_tpu_torch.codecs.h264 import deblock_pallas as DP
    from librempeg_tpu_torch.codecs.h264 import device_recon as DR
    from librempeg_tpu_torch.codecs.h264 import intra_pallas as IP
    from librempeg_tpu_torch.codecs.h264 import mc_pallas as MC
    from librempeg_tpu_torch.codecs.mpeg4 import encoder as ME
    from librempeg_tpu_torch.codecs.mpeg4 import me_pallas as MEP
    from librempeg_tpu_torch.kernels import deblock as KD
    from librempeg_tpu_torch.kernels import intra as KI
    from librempeg_tpu_torch.ops import motion
    from librempeg_tpu_torch.scale import get_scaler

    args, frames = capture_p_frame(dev)
    (idx, vals, qp, kind, info, i4m, ilist, mv, ref, luma4, upad, vpad,
     mb_w, mb_h, cqo, ao, bo, _, _) = args
    res = {}

    # MC: the P frame's motion field over its DPB refpack
    margs = (luma4, upad, vpad, mv, ref, mb_w, mb_h)
    got = MC.mc_predict(*margs)
    want = MC.mc_predict_plain(*margs)
    err = max_abs_err(got, want)
    check(err == 0, f"mc kernel differs from its plain version: {err}")
    res["mc"] = {"max_abs_err": err,
                 "ms": median_ms(lambda: MC.mc_predict(*margs)),
                 "plain_ms": median_ms(lambda: MC.mc_predict_plain(*margs)),
                 "shape": f"{mb_w * mb_h} MBs, {luma4.shape[0]} ref"}

    # intra: the frame's intra MBs over its residual-added planes
    y, u, v, lres_t, cres_t = DR.recon_p_frame_pred_noscan(
        *got, idx, vals, qp, kind, mb_w, mb_h, cqo, fold_i16=True)
    scal = IP.build_intra_scalars(ilist, kind, info, i4m, mb_w, mb_h)
    want = IP.intra_scan_plain(y, u, v, scal, lres_t, cres_t, mb_w, mb_h)
    work = [p.clone() for p in (y, u, v)]
    got = IP.intra_scan_pallas(*work, scal, lres_t, cres_t, mb_w, mb_h)
    err = max_abs_err(got, want)
    check(err == 0, f"intra kernel differs from its plain version: {err}")
    t4, t16, tc = IP._tables(y.device)

    def restore_intra():
        for w_, p in zip(work, (y, u, v)):
            w_.copy_(p)

    res["intra"] = {
        "max_abs_err": err,
        "ms": median_ms(lambda: KI.launch(*work, scal, t4, t16, tc, lres_t,
                                          cres_t, mb_w, mb_h),
                        restore_intra),
        "plain_ms": median_ms(lambda: IP.intra_scan_plain(
            y, u, v, scal, lres_t, cres_t, mb_w, mb_h)),
        "shape": f"{ilist.numel()} intra MBs of {mb_w * mb_h}"}

    # deblock: the intra-complete frame
    y, u, v = want
    want = DR.deblock_frame(y, u, v, idx, vals, mv, ref, qp, kind, mb_w,
                            mb_h, cqo, ao, bo)
    work = [p.clone() for p in (y, u, v)]
    got = DP.deblock_frame_pallas(*work, idx, vals, mv, ref, qp, kind, mb_w,
                                  mb_h, cqo, ao, bo)
    err = max_abs_err(got, want)
    check(err == 0, f"deblock kernel differs from its plain version: {err}")
    P = DP.deblock_params(idx, vals, mv, ref, qp, kind, mb_w, mb_h, cqo, ao,
                          bo)

    def restore_db():
        for w_, p in zip(work, (y, u, v)):
            w_.copy_(p)

    res["deblock"] = {
        "max_abs_err": err,
        "ms": median_ms(lambda: KD.launch(*work, P, mb_w, mb_h),
                        restore_db),
        "params_ms": median_ms(lambda: DP.deblock_params(
            idx, vals, mv, ref, qp, kind, mb_w, mb_h, cqo, ao, bo)),
        "plain_ms": median_ms(lambda: DR.deblock_frame(
            y, u, v, idx, vals, mv, ref, qp, kind, mb_w, mb_h, cqo, ao, bo)),
        "shape": f"{mb_w}x{mb_h} MBs, {mb_w + 2 * mb_h - 2} diagonals"}

    # half-pel: the encoder's recon of its first I-VOP (the bench
    # settings), the next scaled frame as the current picture
    sc = get_scaler("yuv420p", frames[0].width, frames[0].height, "yuv420p",
                    1280, 720)
    enc = ME.Mpeg4Encoder(width=1280, height=720, bit_rate=4_000_000,
                          device=dev)
    enc.encode(sc.scale_frame(frames[0]))
    ry, ru, rv = enc._ref
    cur = sc.scale_planes(frames[1].planes)[0].to(torch.float32)
    mv_i = motion.full_search_mc_xla(cur[None], ry[None], 8, 16, 2)[0][0]
    hargs = (cur, ry, ru, rv, mv_i)
    got = MEP.hpel_refine_mc(*hargs)
    want = MEP.hpel_refine_mc_plain(*hargs)
    err = max_abs_err(got, want)
    check(err == 0, f"hpel kernel differs from its plain version: {err}")
    res["hpel"] = {"max_abs_err": err,
                   "ms": median_ms(lambda: MEP.hpel_refine_mc(*hargs)),
                   "plain_ms": median_ms(
                       lambda: MEP.hpel_refine_mc_plain(*hargs)),
                   "shape": "1280x720, 3600 MBs"}
    return res


def slice_phase(dev, out_avi: str) -> dict:
    """The main path, once, with the launch counters reset before it."""
    import torch

    from librempeg_tpu_torch import kernels
    from librempeg_tpu_torch.sched.pipeline import (
        StreamMap,
        TranscodeSpec,
        Transcoder,
    )

    tc = Transcoder(TranscodeSpec(
        input_url=ASSET, output_url=out_avi, device=dev,
        video=StreamMap(codec="mpeg4", codec_opts={"bit_rate": 4_000_000},
                        width=1280, height=720)))
    chain = tc.chains[0]
    chain.encoder.recon_psnr = []
    md5s = []
    dec_decode, dec_flush = chain.decoder.decode, chain.decoder.flush

    def decode(pkt):
        fs = dec_decode(pkt)
        md5s.extend(frame_md5(f.planes) for f in fs)
        return fs

    def flush():
        fs = dec_flush()
        md5s.extend(frame_md5(f.planes) for f in fs)
        return fs

    chain.decoder.decode, chain.decoder.flush = decode, flush
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    stats = tc.run()
    dt = time.perf_counter() - t0
    counts = kernels.counts()
    peak = torch.cuda.max_memory_allocated()

    gold_md5 = open(os.path.join(GOLD, "bench_1080p_frames.md5")).read() \
        .split()
    gold = json.load(open(os.path.join(GOLD, "bench_1080p_transcode.json")))
    bad = [i for i, (a, b) in enumerate(zip(md5s, gold_md5)) if a != b]
    check(len(md5s) == len(gold_md5) == 48, (len(md5s), len(gold_md5)))
    check(not bad, f"decoded frames differ from the JAX package's: {bad}")
    pkts = avi_payloads(out_avi)
    types = "".join(vop_type(p) for p in pkts)
    check(len(pkts) == 48, f"{len(pkts)} packets in the AVI")
    want = "".join("I" if i % 12 == 0 else "P" for i in range(48))
    check(types == want, f"VOP types {types}")
    check(types == gold["vop_types"], (types, gold["vop_types"]))
    psnr = chain.encoder.recon_psnr
    check(len(psnr) == 48 and all(p == p and p > 20 for p in psnr), psnr)
    mean = statistics.fmean(psnr)
    gmean = gold["mean_recon_psnr_db"]
    check(abs(mean - gmean) <= PSNR_TOL_DB, (mean, gmean))
    missing = [k for k, n in counts.items() if n <= 0]
    check(not missing, f"kernels not launched on the main path: {missing}")
    return {"frames": stats["frames"][0], "packets": len(pkts),
            "vop_types": types, "mean_recon_psnr_db": mean,
            "jax_mean_recon_psnr_db": gmean, "launches": counts,
            "wall_s": dt, "avi_bytes": os.path.getsize(out_avi),
            "peak_device_mib": peak / 2 ** 20}


def fps_phase(dev, out_avi: str, profile_dir: str | None) -> dict:
    """Steady-state fps as bench.py's e2e leg measures it."""
    import torch

    from librempeg_tpu_torch.sched.pipeline import (
        StreamMap,
        TranscodeSpec,
        Transcoder,
    )
    from librempeg_tpu_torch.utils import stagetimer

    tc = Transcoder(TranscodeSpec(
        input_url=ASSET, output_url=out_avi, device=dev,
        video=StreamMap(codec="mpeg4", codec_opts={"bit_rate": 4_000_000},
                        width=1280, height=720)))
    it = tc.demux.packets()
    chain = tc.chains[0]
    for _ in range(16):
        chain.send_packet(next(it), tc.mux)
    chain.sync()
    stagetimer.reset()
    t0 = time.perf_counter()
    for _ in range(24):
        chain.send_packet(next(it), tc.mux)
    chain.sync()
    dt = time.perf_counter() - t0
    out = {"fps": 24 / dt, "split_s": {k: v["s"] for k, v in
                                       stagetimer.report().items()}}
    if profile_dir is not None:
        from torch.profiler import ProfilerActivity, profile as prof

        os.makedirs(profile_dir, exist_ok=True)
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            for _ in range(8):
                chain.send_packet(next(it), tc.mux)
            chain.sync()
            wall = time.perf_counter() - t0
        ka = p.key_averages()
        # device-side events only (kernels, copies): the operator rows
        # repeat the time of the kernels they launched
        dev_us = sum(e.self_device_time_total for e in ka
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        out["profile_8_frames"] = {"wall_ms": wall * 1e3,
                                   "device_busy_ms": dev_us / 1e3,
                                   "device_idle_share": 1 - dev_us / 1e3
                                   / (wall * 1e3)}
        with open(os.path.join(profile_dir, "chip_smoke_profile.txt"),
                  "w") as f:
            f.write(ka.table(sort_by="self_device_time_total",
                             row_limit=40))
    for pkt in it:
        chain.send_packet(pkt, tc.mux)
    chain.finish(tc.mux)
    tc.mux.close()
    tc.demux.close()
    torch.cuda.synchronize()
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch "
                                 "port on one NVIDIA card.")
    ap.add_argument("--profile", metavar="DIR", dest="profile_dir",
                    help="profile 8 frames; write the table into DIR")
    profile_dir = ap.parse_args(argv).profile_dir
    if not os.path.isdir(os.path.join(ROOT, "librempeg_tpu_torch")):
        print("chip_smoke: librempeg_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "smoke run needs an NVIDIA card", file=sys.stderr)
        return 2
    # the stage timer reads its switch when the port is imported
    os.environ["LIBREMPEG_TIMING"] = "1"
    sys.path.insert(0, ROOT)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda})")
    dev = "cuda"

    from librempeg_tpu_torch.kernels import _build
    from librempeg_tpu_torch.native import build as native

    t0 = time.perf_counter()
    check(native.get() is not None, "native host library did not build")
    log(f"build native: {time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        t0 = time.perf_counter()
        _build.load(name)
        log(f"build {name}: {time.perf_counter() - t0:.2f} s")

    kres = kernel_phases(dev)
    for name, r in kres.items():
        log(f"kernel {name}: bit-exact, {r['ms']:.3f} ms vs plain "
            f"{r['plain_ms']:.3f} ms ({r['shape']})")

    with tempfile.TemporaryDirectory() as td:
        s = slice_phase(dev, os.path.join(td, "slice.avi"))
        log(f"slice: {s['frames']} frames, {s['packets']} packets "
            f"{s['vop_types']}, md5 ok, recon PSNR {s['mean_recon_psnr_db']:.4f}"
            f" dB (JAX {s['jax_mean_recon_psnr_db']:.4f}), launches "
            f"{s['launches']}, {s['wall_s']:.2f} s, peak device memory "
            f"{s['peak_device_mib']:.1f} MiB, {s['avi_bytes']} AVI bytes")
        f = fps_phase(dev, os.path.join(td, "fps.avi"), profile_dir)
    log(f"fps: {f['fps']:.3f} (steady state, 24 frames after 16 warm)")
    log("split: " + json.dumps(f["split_s"]))
    if "profile_8_frames" in f:
        log("profile: " + json.dumps(f["profile_8_frames"]))

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": s["launches"][name],
         "max_abs_err": kres[name]["max_abs_err"], "ms": kres[name]["ms"],
         "plain_ms": kres[name]["plain_ms"]} for name in KERNELS]}
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
