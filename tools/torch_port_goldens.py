"""Make the goldens that chip_smoke.py holds the PyTorch port to.

Runs the JAX package (the reference) on the CPU:

* decodes assets/bench_1080p.264 and writes the md5 of every decoded
  frame (Y, U, V bytes in order) to
  tests/data/torch_port/bench_1080p_frames.md5;
* runs the bench transcode (1280x720 MPEG-4 at 4 Mb/s, the product path
  of bench.py's e2e leg) and records the packet count, the VOP coding
  types and the encoder's in-loop recon PSNR against its scaled input,
  frame by frame, in tests/data/torch_port/bench_1080p_transcode.json;
* counts the intra MBs in each of the asset's P frames (the intra
  kernel runs only on P frames that have some) into the same file.

Usage: python tools/torch_port_goldens.py
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from librempeg_tpu.codecs.h264 import parse as P  # noqa: E402
from librempeg_tpu.codecs.h264.codec import H264Decoder  # noqa: E402
from librempeg_tpu.codecs.mpeg4 import encoder as ME  # noqa: E402
from librempeg_tpu.formats.api import open_input  # noqa: E402
from librempeg_tpu.native import build as native  # noqa: E402
from librempeg_tpu.sched.pipeline import (  # noqa: E402
    StreamMap,
    TranscodeSpec,
    Transcoder,
)

ASSET = os.path.join(REPO, "assets", "bench_1080p.264")
OUT = os.path.join(REPO, "tests", "data", "torch_port")


def frame_md5(planes) -> str:
    h = hashlib.md5()
    for p in planes:
        h.update(np.ascontiguousarray(np.asarray(p), np.uint8).tobytes())
    return h.hexdigest()


def decode_md5s(path: str) -> list[str]:
    demux = open_input(path)
    dec = H264Decoder(demux.streams[0].codecpar, device=0)
    return [frame_md5(f.planes) for f in dec.frames(demux.packets())]


def intra_mbs_in_p(path: str) -> list[int]:
    """Intra MB count of each P frame of a single-slice stream."""
    sps = pps = None
    counts = []
    for raw in P.split_annexb(open(path, "rb").read()):
        nal = P.NalUnit.parse(raw)
        if nal.type == 7:
            sps = P.parse_sps(nal.rbsp)
        elif nal.type == 8:
            pps = P.parse_pps(nal.rbsp, sps)
        elif nal.type in (1, 5):
            sh = P.parse_slice_header(nal.rbsp, sps, pps, nal.type,
                                      nal.ref_idc)
            if sh.slice_type != "P":
                continue
            res = native.h264_decode_slice_cavlc(
                nal.rbsp, sh.data_bit_pos, sps.pic_width_in_mbs,
                sps.pic_height_in_map_units, sh.first_mb, 0, sh.qp,
                sh.num_ref_idx_l0, sh.num_ref_idx_l1)
            counts.append(int(np.count_nonzero(res["kind"] >= 2)))
    return counts


def vop_type(data: bytes) -> str:
    """Coding type of the first VOP in an MPEG-4 packet (I, P or B)."""
    i = bytes(data).index(b"\x00\x00\x01\xb6")
    return "IPBS"[bytes(data)[i + 4] >> 6]


def psnr(planes, recon) -> float:
    """PSNR (dB) over all samples of the three planes (the port's
    Mpeg4Encoder computes the same figure)."""
    se, n = 0.0, 0
    for p, r in zip(planes, recon):
        d = np.asarray(p, np.float64) - np.asarray(r, np.float64)
        se += float((d * d).sum())
        n += d.size
    return float("inf") if se == 0 else \
        10.0 * float(np.log10(255.0 ** 2 * n / se))


def bench_transcode() -> dict:
    psnrs = []
    orig = ME.Mpeg4Encoder.encode_async

    def encode_async(self, frame, **kw):
        h = orig(self, frame, **kw)
        psnrs.append(psnr(h["planes"], self._ref))
        return h

    ME.Mpeg4Encoder.encode_async = encode_async
    try:
        with tempfile.TemporaryDirectory() as td:
            out = os.path.join(td, "bench.avi")
            Transcoder(TranscodeSpec(
                input_url=ASSET, output_url=out,
                video=StreamMap(codec="mpeg4",
                                codec_opts={"bit_rate": 4_000_000},
                                width=1280, height=720))).run()
            pkts = list(open_input(out).packets())
    finally:
        ME.Mpeg4Encoder.encode_async = orig
    return {"packets": len(pkts),
            "vop_types": "".join(vop_type(p.data) for p in pkts),
            "recon_psnr_db": psnrs,
            "mean_recon_psnr_db": float(np.mean(psnrs))}


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    md5s = decode_md5s(ASSET)
    with open(os.path.join(OUT, "bench_1080p_frames.md5"), "w") as f:
        f.write("\n".join(md5s) + "\n")
    intra = intra_mbs_in_p(ASSET)
    print(f"{len(md5s)} frames; intra MBs in P frames: {intra}")
    tc = bench_transcode()
    tc["intra_mbs_in_p_frames"] = intra
    with open(os.path.join(OUT, "bench_1080p_transcode.json"), "w") as f:
        json.dump(tc, f, indent=1)
    print(f"transcode: {tc['packets']} packets, mean recon PSNR "
          f"{tc['mean_recon_psnr_db']:.4f} dB")


if __name__ == "__main__":
    main()
