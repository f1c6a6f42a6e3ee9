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
  kernel runs only on P frames that have some) into the same file, with
  each VOP's quantiser in coding order;
* runs the options transcode (the same at -pix_fmt yuvj420p -g 12 -bf 2
  -trellis 1) and writes tests/data/torch_port/bench_1080p_options.npz:
  the VOP types, pts and dts in decode order, each VOP's quantiser, the
  PSNR of every decoded frame (the JAX package's MPEG-4 decoder) against
  the encoder's input, in display order, and rows OFF::RS of the three
  planes of the first yuvj420p frame the encoder takes.

* with --audio, only the audio goldens: 10 s of testgen.audio_mix at
  44.1 kHz stereo s16 as a WAV (its md5), through -ar 48000 -c:a
  pcm_s16le (the resampled length and 16 windows of 1024 samples) and
  -ar 48000 -c:a aac -b:a 128k (every packet's pts and size, the total
  bytes, and the JAX package's decoder's SNR on its own stream against
  its resampled input) into tests/data/torch_port/audio_aac.npz.

* with --jpeg, only the JPEG goldens: chip_smoke.py's JPEG commands
  (jpeg_commands: A the asset to -pix_fmt yuvj420p -c:v mjpeg -q:v 3 in
  AVI, B that AVI to -vf scale=1280:720 -c:v mpeg4 -q:v 4, C the
  thumbnails -vf fps=5,crop=1440:1080,scale=320:240 -q:v 2 -f image2,
  given -c:v mjpeg, which the JAX package does not pick itself) through
  the JAX package's CLI parser and Transcoder, into
  tests/data/torch_port/bench_1080p_mjpeg.npz: per frame of A the
  packet's size and md5, the md5 of the JAX decoder's planes and their
  PSNR per plane against the yuvj420p frames the encoder took, and the
  psnr and ssim graphs' stats of that decode against those frames;
  frame 0 coded at -q:v 31 (its bytes and the JAX decoder's md5) and
  A's own packet 0 at -q:v 3 (its bytes; its md5s are A's first); B's
  VOP types, pts and decoded PSNR per frame (the JAX MPEG-4 decoder,
  against the encoder's input); C's pts and sizes.

* with --filters, only the filter goldens (filters_goldens): F1-F4 and
  the graph-API graphs of chip_smoke.py's filters phase through the
  JAX package, with the ties of the graphs fed by scale=960:544
  (scaled_ties), into tests/data/torch_port/bench_1080p_filters.npz.

* with --containers, only the containers goldens
  (tests/data/torch_port/bench_1080p_containers.json).

* with --encoders, only the encoders goldens: chip_smoke.py's encoders
  commands (encoders_commands) through the JAX package's CLI parser and
  Transcoder, into tests/data/torch_port/bench_1080p_encoders.json: E1
  (H.264, -qp 26 -sr 4 -bf 1 in MP4; the JAX CLI drops -bf, so its
  encoder is given bf=1 itself) every packet's md5, size, pts, dts and
  key flag, the SPS/PPS md5, ffprobe's JSON of the MP4 and the JAX
  decoder's md5 of every frame; E2 (E1's packets through
  h264_cavlc2cabac) the same for the CABAC stream, whose JAX decode must
  give E1's md5s; E3 (MPEG-2 -q:v 5 in MPEG-TS) the packets, the PMT's
  stream types (the JAX muxer's 0x06), the JAX decoder's md5s and the
  PSNR of each decoded frame against the encoder's input. About two
  minutes on an 8-core CPU (E1's encode at 1920x1088).

* with --hevc, only the hevc goldens (hevc_goldens): chip_smoke.py's
  hevc commands (hevc_commands) through the JAX package's CLI parser and
  Transcoder, into tests/data/torch_port/bench_1080p_hevc.json: H0 the
  JAX generator's stream (md5, bytes) and its access units' md5s; H1
  the JAX decoder's frame hashes; H2 each copy's md5, ffprobe JSON and
  packet hashes; H3's VOP types, pts, sizes and decoded PSNR (the JAX
  MPEG-4 decoder, against the encoder's input); P1's PNG files (given
  -c:v png, which the JAX package does not pick itself), the rgb24
  frames' hashes and, per frame, the samples where the JAX package's
  float32 conversion differs from the exact one (chip_smoke.rgb24_exact;
  all at its ties) with their values; G1's GIF and its frames as the
  JAX GIF demuxer reads them. The JAX package's raw HEVC demuxer ends an access unit at every
  slice segment, a fault that breaks its decode of this 2-slice stream
  (ROADMAP section 3b), so the JAX runs are given whole access units:
  its demuxer's split, regrouped at each first_slice_segment_in_pic_flag
  (whole_access_units). About three minutes on an 8-core CPU (the
  host-numpy HEVC generator and three decodes at 1920x1080).

* with --acodecs, only the audio codec goldens (acodecs_goldens):
  chip_smoke.py's acodecs commands K1-K10 through the JAX package, into
  tests/data/torch_port/bench_acodecs.json, and the JAX decode of K10's
  HE-AAC stream (every ACODECS_K10_STEP-th sample) into
  tests/data/torch_port/bench_acodecs_k10.npz. About 90 s on an 8-core
  CPU. K8 and K9 (libavcodec's E-AC-3 and 5.1 AC-3 streams) are decoded
  with libavcodec's dither patched into the JAX decoder
  (tools/ac3_jax_dither.py), which leaves zeros there (ROADMAP section
  3b); the port's decoder gives those samples float for float. K4, K5
  and K6 run the JAX Vorbis and MPEG audio decoders with the port's
  repairs (tools/audio_jax_repair.py: the Vorbis floor and end trim,
  libavcodec's synthesis window without the 481-sample trim, the LAME
  tag's gapless trim), and K7's WAV md5s are of the JAX file with
  libavformat's fact chunk and byte rate put in.

The framemd5 texts the goldens keep (--containers) carry libavformat's
last header line, "#stream#, dts, ...", which the JAX muxer leaves out
(tools/audio_jax_repair.py `framemd5_repaired`).

Every MPEG-4 golden (the bench transcode, the options transcode, JPEG's
B, F1, F2 and F4, the containers' V, H3, D2) comes from the JAX encoder
with its reference repaired at run time (tools/mpeg4_jax_repair.py):
its recon is the picture its decoder rebuilds, as the port's encoder
has it, where the unmodified JAX encoder predicts from a float recon
its decoder never has (ROADMAP section 3b).

Usage: python tools/torch_port_goldens.py [--audio | --jpeg | --filters |
       --containers | --encoders | --hevc | --acodecs | --delivery]
       [--calibrate | --check-port]
       [--graphs]

--calibrate also runs the options transcode through the port on the CPU
and prints its agreement with the JAX package's: the share of the first
yuvj420p frame's samples that differ and their PSNR (whole frame and
stored rows), the VOP types, and the mean decoded PSNR of the I/P and
the B frames (each against its own encoder input) -- the numbers the
options phase of chip_smoke.py sets its floors from. The port takes
about 10 minutes at this size on a CPU.

--check-port writes nothing and runs no JAX transcode: it runs the
port's options transcode on the CPU and holds it to the stored
bench_1080p_options.npz as chip_smoke.py's options phase does (the
quantisers, and the decoded I/P and B PSNR means within
OPTIONS_PSNR_TOL_DB). Run from a copy of the repo with a fault planted
in the port, it reads how far that fault moves those numbers.

With --audio or --jpeg, --calibrate also runs chip_smoke.py's audio or
JPEG checks on the port on the CPU with no limits and prints what they
read (the numbers the phase's limits come from); --check-port runs them
with chip_smoke.py's limits against the stored npz and writes nothing.
With --filters, --graphs keeps to the graph-API graphs.
The port's JPEG paths take about 6 minutes on an 8-core CPU.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from librempeg_tpu.codecs.h264 import parse as P  # noqa: E402
from librempeg_tpu.codecs.h264.codec import H264Decoder  # noqa: E402
from librempeg_tpu.codecs.mpeg4 import encoder as ME  # noqa: E402
from librempeg_tpu.codecs.mpeg4.decoder import Mpeg4Decoder  # noqa: E402
from librempeg_tpu.formats.api import open_input  # noqa: E402
from librempeg_tpu.native import build as native  # noqa: E402
from librempeg_tpu.sched import pipeline as JP  # noqa: E402
from librempeg_tpu.sched.pipeline import (  # noqa: E402
    StreamMap,
    TranscodeSpec,
    Transcoder,
)
from tools.audio_jax_repair import (  # noqa: E402
    aac_mdct_exact,
    framemd5_repaired,
    mpegaudio_repaired,
    vorbis_repaired,
    wav_tags_repaired,
)

ASSET = os.path.join(REPO, "assets", "bench_1080p.264")
OUT = os.path.join(REPO, "tests", "data", "torch_port")
OPTIONS_OUT = os.path.join(OUT, "bench_1080p_options.npz")
# the options transcode: -s 1280x720 -pix_fmt yuvj420p -b:v 4M -g 12
# -bf 2 -trellis 1
OPTIONS = {"bit_rate": 4_000_000, "gop_size": 12, "max_b_frames": 2,
           "trellis": 1}
OPTIONS_PIX_FMT = "yuvj420p"
# rows OFF::RS of the first yuvj420p frame's planes
OFF, RS = 3, 7
# chip_smoke.py's limit on the decoded PSNR means of the options path
OPTIONS_PSNR_TOL_DB = 0.02
AUDIO_OUT = os.path.join(OUT, "audio_aac.npz")
JPEG_OUT = os.path.join(OUT, "bench_1080p_mjpeg.npz")
FILTERS_OUT = os.path.join(OUT, "bench_1080p_filters.npz")
CONTAINERS_OUT = os.path.join(OUT, "bench_1080p_containers.json")
ENCODERS_OUT = os.path.join(OUT, "bench_1080p_encoders.json")
HEVC_OUT = os.path.join(OUT, "bench_1080p_hevc.json")
ACODECS_OUT = os.path.join(OUT, "bench_acodecs.json")
ACODECS_K10_OUT = os.path.join(OUT, "bench_acodecs_k10.npz")
DELIVERY_OUT = os.path.join(OUT, "bench_delivery.json")


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


def recording_vops(packer_cls, vops: list):
    """Patch packer_cls.vop to append (coding type, display index,
    quantiser) of every VOP header it writes; returns the original."""
    orig = packer_cls.vop

    def vop(self, bw, coding_type, frame_idx, qscale=None):
        vops.append((coding_type, frame_idx,
                     self.qscale if qscale is None else qscale))
        return orig(self, bw, coding_type, frame_idx, qscale)

    packer_cls.vop = vop
    return orig


def bench_transcode() -> dict:
    psnrs, vops = [], []
    orig = ME.Mpeg4Encoder.encode_async

    def encode_async(self, frame, **kw):
        h = orig(self, frame, **kw)
        psnrs.append(psnr(h["planes"], self._ref))
        return h

    ME.Mpeg4Encoder.encode_async = encode_async
    orig_vop = recording_vops(ME._Mpeg4Packer, vops)
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
        ME._Mpeg4Packer.vop = orig_vop
    return {"packets": len(pkts),
            "vop_types": "".join(vop_type(p.data) for p in pkts),
            "recon_psnr_db": psnrs,
            "mean_recon_psnr_db": float(np.mean(psnrs)),
            "qscale": [q for _, _, q in vops]}


def options_transcode(pipeline, encoder_mod, **spec_kw) -> dict:
    """The options transcode through a package's Transcoder (its
    pipeline and mpeg4 encoder modules): the encoder's packets (decode
    order, with its pts and dts), VOP records, the encoder's input
    frames (numpy, display order) and the decoded frames (the JAX
    package's MPEG-4 decoder, display order)."""
    vops, inputs, pkts = [], [], []
    enc_cls = encoder_mod.Mpeg4Encoder
    orig, orig_flush = enc_cls.encode, enc_cls.flush

    def encode(self, frame):
        inputs.append(tuple(np.asarray(getattr(p, "cpu", lambda: p)())
                            for p in frame.planes))
        out = orig(self, frame)
        pkts.extend(out)
        return out

    def flush(self):
        out = orig_flush(self)
        pkts.extend(out)
        return out

    enc_cls.encode, enc_cls.flush = encode, flush
    orig_vop = recording_vops(encoder_mod._Mpeg4Packer, vops)
    try:
        with tempfile.TemporaryDirectory() as td:
            out = os.path.join(td, "options.avi")
            pipeline.Transcoder(pipeline.TranscodeSpec(
                input_url=ASSET, output_url=out,
                video=pipeline.StreamMap(codec="mpeg4", codec_opts=OPTIONS,
                                         width=1280, height=720,
                                         pix_fmt=OPTIONS_PIX_FMT),
                **spec_kw)).run()
            muxed = [bytes(p.data) for p in open_input(out).packets()]
    finally:
        enc_cls.encode, enc_cls.flush = orig, orig_flush
        encoder_mod._Mpeg4Packer.vop = orig_vop
    assert muxed == [bytes(p.data) for p in pkts]
    dec = Mpeg4Decoder()
    decoded = [tuple(np.asarray(p) for p in f.planes)
               for pk in pkts for f in dec.decode(pk)]
    decoded += [tuple(np.asarray(p) for p in f.planes) for f in dec.flush()]
    return {"packets": pkts, "vops": vops, "inputs": inputs,
            "decoded": decoded}


def options_summary(run: dict) -> dict:
    types = "".join("IPB"[t] for t, _, _ in run["vops"])
    disp = {d: "IPB"[t] for t, d, _ in run["vops"]}
    ps = [psnr(a, b) for a, b in zip(run["inputs"], run["decoded"])]
    b = [p for i, p in enumerate(ps) if disp[i] == "B"]
    ip = [p for i, p in enumerate(ps) if disp[i] != "B"]
    return {"types": types, "psnr": ps, "mean_ip": float(np.mean(ip)),
            "mean_b": float(np.mean(b))}


def write_options_goldens(run: dict) -> dict:
    summ = options_summary(run)
    pk = run["packets"]
    check = "".join(vop_type(p.data) for p in pk)
    assert check == summ["types"], (check, summ["types"])
    assert len(run["decoded"]) == len(run["inputs"]) == len(pk)
    y, u, v = run["inputs"][0]
    np.savez_compressed(
        OPTIONS_OUT, vop_types=np.array(summ["types"]),
        pts=np.array([p.pts for p in pk], np.int32),
        dts=np.array([p.dts for p in pk], np.int32),
        qscale=np.array([q for _, _, q in run["vops"]], np.int32),
        decoded_psnr_db=np.array(summ["psnr"], np.float64),
        y_sample=y[OFF::RS], u_sample=u[OFF::RS], v_sample=v[OFF::RS],
        sample=np.array([OFF, RS], np.int32))
    print(f"options: {len(pk)} packets {summ['types']}, decoded PSNR I/P "
          f"{summ['mean_ip']:.4f} dB, B {summ['mean_b']:.4f} dB; wrote "
          f"{OPTIONS_OUT}: {os.path.getsize(OPTIONS_OUT)} bytes")
    return summ


def calibrate(jrun: dict, jsumm: dict) -> None:
    """The port's options transcode on the CPU against the JAX
    package's run."""
    from librempeg_tpu_torch.codecs.mpeg4 import encoder as TE
    from librempeg_tpu_torch.sched import pipeline as TP

    t0 = time.perf_counter()
    trun = options_transcode(TP, TE, device="cpu")
    tsumm = options_summary(trun)
    print(f"port options transcode on the CPU: "
          f"{time.perf_counter() - t0:.1f} s")
    a = np.concatenate([p.ravel() for p in jrun["inputs"][0]])
    b = np.concatenate([p.ravel() for p in trun["inputs"][0]])
    d = np.abs(a.astype(np.int32) - b)
    rows = [np.concatenate([p[OFF::RS].ravel() for p in r["inputs"][0]])
            for r in (jrun, trun)]
    print(f"first yuvj420p frame: {np.count_nonzero(d) / d.size:.6f} of "
          f"samples differ (max |d| {d.max()}), PSNR "
          f"{psnr([a], [b]):.2f} dB, stored rows "
          f"{psnr([rows[0]], [rows[1]]):.2f} dB")
    print(f"VOP types equal: {tsumm['types'] == jsumm['types']} "
          f"({tsumm['types']})")
    print(f"decoded PSNR I/P mean: port {tsumm['mean_ip']:.4f} dB, JAX "
          f"{jsumm['mean_ip']:.4f} dB; B mean: port {tsumm['mean_b']:.4f}"
          f" dB, JAX {jsumm['mean_b']:.4f} dB")
    print("quantisers equal:", [q for *_, q in trun["vops"]]
          == [q for *_, q in jrun["vops"]])
    print("pts and dts equal:", [(p.pts, p.dts) for p in trun["packets"]]
          == [(p.pts, p.dts) for p in jrun["packets"]])


def check_port() -> bool:
    """The port's options transcode on the CPU against the stored
    goldens; True where it passes chip_smoke.py's options checks."""
    from librempeg_tpu_torch.codecs.mpeg4 import encoder as TE
    from librempeg_tpu_torch.sched import pipeline as TP

    gold = np.load(OPTIONS_OUT)
    t0 = time.perf_counter()
    trun = options_transcode(TP, TE, device="cpu")
    ts = options_summary(trun)
    print(f"port options transcode on the CPU: "
          f"{time.perf_counter() - t0:.1f} s")
    disp = {d: "IPB"[t] for t, d, _ in trun["vops"]}
    gp = gold["decoded_psnr_db"]
    gmean = {k: float(np.mean([gp[i] for i in range(len(gp))
                               if (disp[i] == "B") == (k == "b")]))
             for k in ("ip", "b")}
    qs = [int(q) for *_, q in trun["vops"]]
    first_q = next((i for i, (a, b) in enumerate(zip(qs, gold["qscale"]))
                    if a != b), None)
    gaps = {"ip": ts["mean_ip"] - gmean["ip"], "b": ts["mean_b"] - gmean["b"]}
    ok = (ts["types"] == str(gold["vop_types"]) and first_q is None
          and all(abs(g) <= OPTIONS_PSNR_TOL_DB for g in gaps.values()))
    print(f"VOP types equal: {ts['types'] == str(gold['vop_types'])}; first "
          f"VOP whose quantiser differs: {first_q}; decoded PSNR I/P mean "
          f"{ts['mean_ip']:.4f} dB (JAX {gmean['ip']:.4f}, gap "
          f"{gaps['ip']:+.4f}), B mean {ts['mean_b']:.4f} dB (JAX "
          f"{gmean['b']:.4f}, gap {gaps['b']:+.4f}); limit "
          f"{OPTIONS_PSNR_TOL_DB} dB: {'pass' if ok else 'FAIL'}")
    return ok


def audio_goldens() -> dict:
    """The JAX package's audio transcodes of chip_smoke.py's clip."""
    import chip_smoke as CS

    from librempeg_tpu.codecs.aac.decoder import AacDecoder
    from librempeg_tpu.core.packet import Packet
    from librempeg_tpu.formats import api as FA
    from librempeg_tpu.utils import testgen

    x = testgen.s16(testgen.audio_mix(CS.AUDIO_IN_RATE,
                                      CS.AUDIO_IN_RATE * CS.AUDIO_SECONDS))
    with tempfile.TemporaryDirectory() as td:
        wav = os.path.join(td, "in.wav")
        mux = FA.open_output(wav)
        mux.add_stream(FA.CodecParameters(
            codec_type="audio", codec_id="pcm_s16le",
            sample_rate=CS.AUDIO_IN_RATE, nb_channels=2))
        mux.write(Packet(data=np.ascontiguousarray(x.T).tobytes(), pts=0))
        mux.close()
        md5 = hashlib.md5(open(wav, "rb").read()).hexdigest()

        def run(out, **smap):
            tc = Transcoder(TranscodeSpec(
                input_url=wav, output_url=os.path.join(td, out),
                audio=StreamMap(**smap)))
            pk, write = [], tc.mux.write

            def rec(p):
                pk.append((p.pts, len(p.data)))
                write(p)

            tc.mux.write = rec
            tc.run()
            return os.path.join(td, out), pk

        rs_path, _ = run("rs.wav", codec="pcm_s16le",
                         sample_rate=CS.AUDIO_OUT_RATE)
        d = FA.open_input(rs_path)
        rs = np.frombuffer(b"".join(bytes(p.data) for p in d.packets()),
                           "<i2").reshape(-1, 2).T
        aac_path, pk = run("out.aac", codec="aac",
                           sample_rate=CS.AUDIO_OUT_RATE,
                           codec_opts={"bit_rate": CS.AUDIO_BIT_RATE})
        data = open(aac_path, "rb").read()
        d = FA.open_input(aac_path)
        dec = AacDecoder(d.streams[0].codecpar)
        decoded = np.concatenate([np.asarray(dec.decode(p)[0].data)
                                  for p in d.packets()], 1)
    starts = np.linspace(0, rs.shape[1] - CS.AUDIO_WIN, 16).astype(np.int64)
    return {"wav_md5": md5, "rs_len": rs.shape[1], "rs_win_starts": starts,
            "rs_windows": np.stack([rs[:, s:s + CS.AUDIO_WIN]
                                    for s in starts]),
            "aac_pts": np.array([p for p, _ in pk], np.int64),
            "aac_sizes": np.array([n for _, n in pk], np.int32),
            "aac_bytes": len(data), "aac_snr_db": CS.snr_db(rs, decoded)}


def audio_port(limits: bool) -> bool:
    """chip_smoke.py's audio checks on the port on the CPU against the
    stored npz, with its limits (or none); prints what they read."""
    import chip_smoke as CS

    if not limits:
        CS.AUDIO_RS_SHARE = CS.AUDIO_BYTES_TOL = CS.AUDIO_SNR_TOL_DB = \
            float("inf")
    gold = np.load(AUDIO_OUT)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        try:
            r = CS.audio_transcode_checks("cpu", td, gold)
        except RuntimeError as e:
            print(f"port audio checks on the CPU: FAIL: {e}")
            return False
    rel = r["aac_bytes"] / r["golden_aac_bytes"] - 1
    print(f"port audio checks on the CPU ({time.perf_counter() - t0:.1f} s"
          f"): resampled windows {r['rs_share_differ']:.6f} of samples "
          f"differ; AAC {r['packets']} packets, {r['aac_bytes']} bytes (JAX "
          f"{r['golden_aac_bytes']}, {rel:+.5f}), decoded SNR {r['snr_db']:.4f} dB (JAX "
          f"{r['golden_snr_db']:.4f}, {r['snr_db'] - r['golden_snr_db']:+.4f})"
          f"; -ac 1 max |d| {r['ac_max_err_lsb']:.3f} LSB; limits "
          f"{'on' if limits else 'off'}: pass")
    return True


def jpeg_goldens() -> dict:
    """The JAX package's runs of chip_smoke.py's JPEG commands."""
    import chip_smoke as CS

    from librempeg_tpu.cli.ffmpeg import parse_args
    from librempeg_tpu.codecs.jpeg.decoder import decode_jpeg
    from librempeg_tpu.codecs.jpeg.encoder import encode_jpeg
    from librempeg_tpu.core.packet import Packet
    from librempeg_tpu.core.rational import Rational
    from librempeg_tpu.filters import GraphRunner, StreamProps

    def run(argv, keep=None):
        tc = Transcoder(parse_args(argv)[0])
        pk, write = [], tc.mux.write

        def rec(p):
            pk.append((p.pts, bytes(p.data)))
            write(p)

        tc.mux.write = rec
        if keep is not None:
            enc = tc.chains[0].encoder
            name = "encode_async" if tc.chains[0]._pipelined else "encode"
            inner = getattr(enc, name)

            def take(frame, **kw):
                keep.append([np.asarray(p) for p in frame.planes])
                return inner(frame, **kw)

            setattr(enc, name, take)
        tc.run()
        return pk

    def plane_psnr(a, b):
        d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
        mse = float((d * d).mean())
        return float("inf") if mse == 0 else 10 * np.log10(255 ** 2 / mse)

    with tempfile.TemporaryDirectory() as td:
        cmd = CS.jpeg_commands(td)
        src = []
        pa = run(cmd["A"], src)
        dec = [decode_jpeg(d) for _, d in pa]
        tb = Rational(1, 25)
        props = StreamProps(media="video", width=1920, height=1088,
                            pix_fmt="yuvj420p", frame_rate=Rational(25, 1),
                            time_base=tb)
        stats = {}
        for name, keys in (("psnr", ("psnr_y", "psnr_u", "psnr_v",
                                     "psnr_avg")),
                           ("ssim", ("ssim_y", "ssim_u", "ssim_v",
                                     "ssim_all"))):
            g = GraphRunner(f"[in][in2]{name}", [props, props])
            for i, (f, s) in enumerate(zip(dec, src)):
                g.push(f.replace(pts=i, time_base=tb).replace(
                    planes=tuple(s)), 1)
                g.push(f.replace(pts=i, time_base=tb), 0)
            g.finish()
            st = next(n.filter.stats for n in g.graph.nodes
                      if n.filter.NAME == name)
            stats[name] = np.array([[x[k] for k in keys] for x in st])
        first = dec[0].replace(planes=tuple(src[0]))
        stored = encode_jpeg(first, quality=int(max(2, min(100, round(
            100 - CS.JPEG_STORED_Q * 3.1)))))
        bin_ = []
        pb = run(cmd["B"], bin_)
        mdec = Mpeg4Decoder()
        back = [f for p, d in pb for f in mdec.decode(
            Packet(data=d, pts=p))] + mdec.flush()
        c = cmd["C"]
        pc = run(c[:-1] + ["-c:v", "mjpeg"] + c[-1:])
    return {
        "a_sizes": np.array([len(d) for _, d in pa], np.int32),
        "a_md5": np.array([hashlib.md5(d).hexdigest() for _, d in pa]),
        "a_dec_md5": np.array([frame_md5(f.planes) for f in dec]),
        "a_psnr": np.array([[plane_psnr(a, b) for a, b in zip(f.planes, s)]
                            for f, s in zip(dec, src)]),
        "psnr": stats["psnr"], "ssim": stats["ssim"],
        "stored_jpeg": np.frombuffer(stored, np.uint8),
        "stored_md5": frame_md5(decode_jpeg(stored).planes),
        "a0_jpeg": np.frombuffer(pa[0][1], np.uint8),
        "b_types": "".join(vop_type(d) for _, d in pb),
        "b_pts": np.array([p for p, _ in pb], np.int64),
        "b_psnr": np.array([psnr(s, f.planes) for s, f in zip(bin_, back)]),
        "c_pts": np.array([p for p, _ in pc], np.int64),
        "c_sizes": np.array([len(d) for _, d in pc], np.int32),
    }


def jpeg_port(limits: bool) -> bool:
    """chip_smoke.py's JPEG paths and checks on the port on the CPU
    against the stored npz, with its limits (or none); prints what they
    read."""
    import chip_smoke as CS

    gold = np.load(JPEG_OUT)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        try:
            r = CS.jpeg_checks("cpu", CS.jpeg_paths("cpu", td), gold,
                               limits=limits)
        except RuntimeError as e:
            print(f"port JPEG checks on the CPU: FAIL: {e}")
            return False
    print(f"port JPEG checks on the CPU ({time.perf_counter() - t0:.1f} s, "
          f"limits {'on' if limits else 'off'}): pass")
    print(f"  A: {r['a_bytes']} bytes (JAX {int(gold['a_sizes'].sum())}), "
          f"largest packet size gap {r['a_size_rel_max']:.6f}, "
          f"{r['a_identical']} of 48 packets byte-identical; decoded PSNR "
          f"per plane {[round(x, 4) for x in r['a_psnr_mean']]} dB, gap "
          f"{[round(x, 5) for x in r['a_psnr_gap']]}")
    for name in ("psnr", "ssim"):
        print(f"  {name} graph means {[round(x, 6) for x in r[name + '_mean']]}"
              f", gap {[float(f'{x:.3g}') for x in r[name + '_gap']]}")
    print(f"  B: {r['b_types']}, decoded mean {r['b_psnr_mean']:.4f} dB, gap "
          f"{r['b_psnr_gap']:+.5f}")
    print(f"  C: sizes {r['c_bytes']}, largest gap {r['c_size_rel_max']:.6f}")
    return True


def filters_goldens() -> dict:
    """The JAX package's runs of chip_smoke.py's filter slice: F1-F4
    (filters_commands) through its CLI parser and Transcoder, and the
    graph-API graphs (FILTER_GRAPHS) on its decode of the asset. One
    repair of the reference: boxblur sums in int32 (the exact box mean)
    where the JAX package's float32 summed-area table loses the low bits
    of its prefix sums past 2^24 (ROADMAP section 3); the replacement
    traces, so F1's eq, gblur and boxblur still compile into one XLA
    program."""
    import chip_smoke as CS
    import jax.numpy as jnp

    from librempeg_tpu.cli.ffmpeg import parse_args
    from librempeg_tpu.codecs.aac.decoder import AacDecoder
    from librempeg_tpu.core.eval_expr import eval_expr
    from librempeg_tpu.core.frame import AudioFrame, VideoFrame
    from librempeg_tpu.core.rational import Rational
    from librempeg_tpu.core.samplefmt import ChannelLayout
    from librempeg_tpu.filters import GraphRunner, StreamProps
    from librempeg_tpu.filters import video2 as V2
    from librempeg_tpu.ops import motion as JM

    def boxblur_exact(self, frame, pad=0):
        r = int(eval_expr(str(self.opts["luma_radius"]),
                          {"w": frame.width, "h": frame.height}))
        if r <= 0:
            return [(0, frame)]
        n = 2 * r + 1
        planes = []
        for p in frame.planes:
            x = jnp.asarray(p).astype(jnp.int32)
            h, w = x.shape
            xp = jnp.pad(x, ((r, r), (r, r)), mode="edge")
            c = jnp.cumsum(jnp.cumsum(jnp.pad(xp, ((1, 0), (1, 0))),
                                      axis=0), axis=1)
            s = (c[n:n + h, n:n + w] - c[:h, n:n + w]
                 - c[n:n + h, :w] + c[:h, :w])
            y = s.astype(jnp.float32) / float(n * n)
            planes.append(jnp.clip(jnp.floor(y + 0.5), 0, 255)
                          .astype(jnp.uint8))
        return [(0, frame.replace(planes=tuple(planes)))]

    def run(argv, on_input):
        tc = Transcoder(parse_args(argv)[0])
        pk, write = [], tc.mux.write

        def rec(p):
            pk.append((p.pts, bytes(p.data)))
            write(p)

        tc.mux.write = rec
        chain = tc.chains[0]
        name = "encode_async" if getattr(chain, "_pipelined", False) \
            else "encode"
        inner = getattr(chain.encoder, name)

        def take(frame, **kw):
            on_input(frame)
            return inner(frame, **kw)

        setattr(chain.encoder, name, take)
        tc.run()
        return pk

    psnrs, mvs = [], []
    orig_async = ME.Mpeg4Encoder.encode_async

    def encode_async(self, frame, **kw):
        h = orig_async(self, frame, **kw)
        psnrs.append(psnr(h["planes"], self._ref))
        return h

    orig_search = JM.full_search_mc_xla
    orig_box = V2.BoxBlurFilter.filter_frame

    def search(cur, ref, *a, **kw):
        # minterpolate's eager searches (the encoder's run traced)
        out = orig_search(cur, ref, *a, **kw)
        if not isinstance(out[0], jax.core.Tracer):
            mvs.append(CS.digest(out[0]))
        return out

    gold = {}
    ME.Mpeg4Encoder.encode_async = encode_async
    JM.full_search_mc_xla = search
    V2.BoxBlurFilter.filter_frame = boxblur_exact
    try:
        with tempfile.TemporaryDirectory() as td:
            wav = os.path.join(td, "in.wav")
            x = CS.write_audio_wav(wav, CS.AUDIO_SECONDS)
            cmd = CS.filters_commands(td, wav)
            for name, key in (("F1", "f1"), ("F2", "f2"), ("F4v", "f4v")):
                psnrs.clear()
                mvs.clear()
                ins = []
                pk = run(cmd[name], lambda f, ins=ins: ins.append(
                    CS.frame_stats(f.planes, 64,
                                   len(ins) in CS.FILTER_SAMPLE_FRAMES)))
                gold.update({
                    f"{key}_types": "".join(vop_type(d) for _, d in pk),
                    f"{key}_pts": np.array([p for p, _ in pk], np.int64),
                    f"{key}_sizes": np.array([len(d) for _, d in pk],
                                             np.int32),
                    f"{key}_psnr": np.array(psnrs),
                    f"{key}_md5": np.stack([np.frombuffer(a, np.uint8)
                                            for a, _, _ in ins]),
                    f"{key}_sums": np.array([b for _, b, _ in ins],
                                            np.int64),
                    f"{key}_rows": np.stack([c for _, _, c in ins
                                             if c is not None])})
                if name == "F2":
                    gold["f2_mv"] = np.stack([np.frombuffer(m, np.uint8)
                                              for m in mvs])
                print(f"{name}: {len(pk)} packets, {len(ins)} frames, "
                      f"{len(mvs)} searches", flush=True)
            for name, key in (("F3", "f3"), ("F4a", "f4a")):
                ins = []
                pk = run(cmd[name], lambda f, ins=ins: ins.append(
                    np.asarray(f.data)))
                data = np.concatenate(ins, 1)
                d = open_input(cmd[name][-1])
                dec = AacDecoder(d.streams[0].codecpar)
                y = np.concatenate([np.asarray(dec.decode(p)[0].data)
                                    for p in d.packets()], 1)
                ref = data if data.dtype == np.int16 else \
                    data.astype(np.float64) * 32768.0
                gold.update({
                    f"{key}_in_md5": np.frombuffer(CS.digest(data),
                                                   np.uint8),
                    f"{key}_pts": np.array([p for p, _ in pk], np.int64),
                    f"{key}_sizes": np.array([len(b) for _, b in pk],
                                             np.int32),
                    f"{key}_snr": CS.snr_db(ref, y)})
                print(f"{name}: {len(pk)} packets", flush=True)
            demux = open_input(ASSET)
            dec = H264Decoder(demux.streams[0].codecpar, device=0)
            frames = [f.replace(pts=i, time_base=Rational(1, 25))
                      for i, f in enumerate(dec.frames(demux.packets()))]
            graphs = CS.filters_graphs(frames, x, td, {
                "GraphRunner": GraphRunner, "StreamProps": StreamProps,
                "Rational": Rational, "VideoFrame": VideoFrame,
                "AudioFrame": AudioFrame, "ChannelLayout": ChannelLayout,
                "to_data": lambda a: a})
    finally:
        ME.Mpeg4Encoder.encode_async = orig_async
        JM.full_search_mc_xla = orig_search
        V2.BoxBlurFilter.filter_frame = orig_box
    graphs.pop("_scaled")
    for name, g in graphs.items():
        k = f"g_{name}"
        gold.update({f"{k}_md5": np.stack([np.frombuffer(a, np.uint8)
                                           for a in g["md5"]]),
                     f"{k}_pts": np.array(g["pts"], np.int64),
                     f"{k}_sums": np.array(g["sums"], np.int64),
                     f"{k}_numel": np.array(g["numel"], np.int64)})
        if g["rows"]:
            gold[f"{k}_rows"] = np.stack(g["rows"])
    gold.update(scaled_ties([[np.asarray(p) for p in f.planes]
                             for f in frames], gold))
    return gold


def scaled_ties(frames, gold) -> dict:
    """The JAX package's resize matrices of scale=960:544 (scale_m<source
    size>) and the ties of the graphs it feeds (chip_smoke.py's
    FILTER_SCALED_GRAPHS): each decoded frame (frames: per frame its
    planes) scaled exactly (chip_smoke.scale_exact); per output of each
    graph, each plane's count of ties and the tie mask of its sampled
    rows. Asserts that the JAX package's outputs in gold are the exact
    rounding off the ties, and prints how many samples are ties."""
    import chip_smoke as CS

    from librempeg_tpu.ops.fir import resize_matrix

    out = {f"scale_m{n}": resize_matrix(n, n // 2)
           for n in (1088, 1920, 544, 960)}
    exact, ties = [], []
    for planes in frames:
        rt = CS.scale_exact(planes, out)
        exact.append([r.numpy().astype(np.uint8) for r, _ in rt])
        ties.append([t.numpy() for _, t in rt])
    n_ties = sum(int(t.sum()) for f in ties for t in f)
    n_all = sum(t.size for f in ties for t in f)
    print(f"scale=960:544: {n_ties} of {n_all} scaled samples are ties",
          flush=True)
    for name in CS.FILTER_SCALED_GRAPHS:
        k = f"g_{name}"
        outs = range(len(gold[f"{k}_pts"]))
        count = np.array([[int(t.sum()) for t in
                           CS.scaled_graph_planes(name, ties, i)]
                          for i in outs], np.int64)
        sums = np.array([[int(p.astype(np.int64).sum()) for p in
                          CS.scaled_graph_planes(name, exact, i)]
                         for i in outs], np.int64)
        assert (np.abs(gold[f"{k}_sums"] - sums) <= count).all(), name
        sampled = [i for i in outs if i in CS.FILTER_SAMPLE_FRAMES]
        tie_rows = [CS.sample_rows(CS.scaled_graph_planes(name, ties, i), 64)
                    for i in sampled]     # as filters_graphs samples them
        differ = 0
        for got, i, t in zip(gold[f"{k}_rows"], sampled, tie_rows):
            want = CS.sample_rows(CS.scaled_graph_planes(name, exact, i), 64)
            assert not ((got != want) & ~t).any(), (name, i)
            differ += int((got != want).sum())
        print(f"  {name}: the JAX package's sampled rows differ from the "
              f"exact rounding on {differ} of {sum(t.sum() for t in tie_rows)}"
              f" ties", flush=True)
        out.update({f"{k}_ties": count, f"{k}_tie_rows": np.stack(tie_rows)})
    return out


def filters_port(limits: bool, graphs_only: bool = False) -> bool:
    """chip_smoke.py's filter paths, graphs and checks on the port on
    the CPU against the stored npz, with its limits (or none); prints
    what they read. graphs_only: the graph-API graphs alone."""
    import chip_smoke as CS

    gold = np.load(FILTERS_OUT)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        try:
            if graphs_only:
                run = {"wav": CS.write_audio_wav(os.path.join(td, "in.wav"),
                                                 CS.AUDIO_SECONDS)}
            else:
                run = CS.filters_paths("cpu", td)
            graphs = CS.filters_graphs(CS.decoded_frames("cpu"), run["wav"],
                                       td, CS.port_graph_pkg("cpu"))
            if graphs_only:
                r = {"graphs": CS.graph_checks(
                    graphs, gold, CS.check if limits else lambda ok, w: None)}
            else:
                r = CS.filters_checks("cpu", run, gold, graphs,
                                      limits=limits)
        except RuntimeError as e:
            print(f"port filter checks on the CPU: FAIL: {e}")
            return False
    print(f"port filter checks on the CPU ({time.perf_counter() - t0:.1f} "
          f"s, limits {'on' if limits else 'off'}): pass")
    for key in ("f1", "f2", "f4v", "f3", "f4a"):
        if key in r:
            print(f"  {key}: {json.dumps(r[key])}")
    print(f"  graphs: {json.dumps(r['graphs'])}")
    return True



def jax_cli_run(argv: list[str], on_input=None, prepare=None) -> dict:
    """One command line through the JAX package's CLI parser and
    Transcoder, with the packets the muxer receives (pts, size), each
    frame the encoder takes passed to on_input, prepare(transcoder)
    before the run; an exception is returned as its text."""
    from librempeg_tpu.cli.ffmpeg import parse_args

    spec, _ = parse_args(argv)
    tc = Transcoder(spec)
    pk, write = [], tc.mux.write

    def rec(p):
        pk.append((int(p.pts), len(p.data)))
        write(p)

    tc.mux.write = rec
    chain = tc.chains[0]
    if on_input is not None:
        name = "encode_async" if getattr(chain, "_pipelined", False) \
            else "encode"
        enc = getattr(chain.encoder, name)

        def take(frame, **kw):
            on_input(frame)
            return enc(frame, **kw)

        setattr(chain.encoder, name, take)
    if prepare is not None:
        prepare(tc)
    try:
        tc.run()
    except Exception as e:          # the goldens record the refusal
        return {"error": f"{type(e).__name__}: {e}", "packets": pk}
    return {"packets": pk}


def containers_goldens() -> dict:
    """The JAX package's runs of chip_smoke.py's containers commands."""
    import chip_smoke as CS

    from librempeg_tpu.cli import ffprobe
    from librempeg_tpu.codecs.aac.decoder import AacDecoder
    from librempeg_tpu.codecs.mpeg4.decoder import Mpeg4Decoder
    from librempeg_tpu.core.packet import Packet
    from librempeg_tpu.core.rational import NOPTS
    from librempeg_tpu.formats import api as FA
    from librempeg_tpu.utils import testgen

    x = testgen.s16(testgen.audio_mix(CS.AUDIO_IN_RATE,
                                      CS.AUDIO_IN_RATE * CS.AUDIO_SECONDS))
    gold: dict = {"remux_md5": {}, "ffprobe": {}, "framemd5": {},
                  "seek": {}, "seek_error": {}, "aac": {}}

    def file_packets(path):
        d = FA.open_input(path)
        out = [(None if p.pts == NOPTS else int(p.pts), bytes(p.data))
               for p in d.packets()]
        d.close()
        return out

    with tempfile.TemporaryDirectory() as td:
        wav = os.path.join(td, "in.wav")
        mux = FA.open_output(wav)
        mux.add_stream(FA.CodecParameters(
            codec_type="audio", codec_id="pcm_s16le",
            sample_rate=CS.AUDIO_IN_RATE, nb_channels=2))
        mux.write(Packet(data=np.ascontiguousarray(x.T).tobytes(), pts=0))
        mux.close()
        cmd = CS.containers_commands(td, wav)
        for e in CS.CONT_SOURCES[1:]:
            jax_cli_run(cmd[f"R_{e}"])
            path = cmd[f"R_{e}"][-1]
            gold["remux_md5"][e] = hashlib.md5(
                open(path, "rb").read()).hexdigest()
            gold["ffprobe"][e] = CS.probe_json(ffprobe, path)
        frames_md5 = open(os.path.join(OUT, "bench_1080p_frames.md5")
                          ).read().split()
        for s in CS.CONT_SOURCES:
            r = jax_cli_run(cmd[f"D_{s}"])
            assert "error" not in r, r
            text = framemd5_repaired(open(cmd[f"D_{s}"][-1]).read())
            assert [ln.split(", ")[-1] for ln in CS.md5_lines(text)[1]] \
                == frames_md5, s
            gold["framemd5"][s] = text
            r = jax_cli_run(cmd[f"S_{s}"])
            gold["seek"][s] = (None if "error" in r else framemd5_repaired(
                open(cmd[f"S_{s}"][-1]).read()))
            gold["seek_error"][s] = r.get("error")
        # MPEG-4 in MP4: VOP types, pts, sizes, recon PSNR, and the
        # decoded PSNR of the first VOPs against the encoder's input
        psnrs, inputs = [], []
        orig = ME.Mpeg4Encoder.encode_async

        def encode_async(self, frame, **kw):
            h = orig(self, frame, **kw)
            psnrs.append(psnr(h["planes"], self._ref))
            return h

        def on_input(frame):
            if len(inputs) < CS.CONT_READBACK:
                inputs.append([np.asarray(p) for p in frame.planes])

        ME.Mpeg4Encoder.encode_async = encode_async
        try:
            r = jax_cli_run(cmd["V"], on_input=on_input)
        finally:
            ME.Mpeg4Encoder.encode_async = orig
        assert "error" not in r, r
        fp = file_packets(cmd["V"][-1])
        dec = Mpeg4Decoder()
        back = [f for p, d in fp[:CS.CONT_READBACK]
                for f in dec.decode(Packet(data=d, pts=p))] + dec.flush()
        gold["v"] = {
            "types": "".join(vop_type(d) for _, d in fp),
            "pts": [p for p, _ in r["packets"]],
            "sizes": [n for _, n in r["packets"]],
            "file_pts": [p for p, _ in fp],
            "recon_psnr": psnrs,
            "readback_psnr": float(np.mean([
                CS.planes_psnr_db(a, f.planes)
                for a, f in zip(inputs, back)]))}
        # AAC in MP4 and Matroska: pts, sizes, the JAX decoder's SNR on
        # its own stream against the encoder's input
        for e in ("mp4", "mkv"):
            ins = []
            r = jax_cli_run(cmd[f"A_{e}"],
                            on_input=lambda f: ins.append(np.asarray(f.data)))
            fp = file_packets(cmd[f"A_{e}"][-1])
            adts = os.path.join(td, f"a_{e}.aac")
            with open(adts, "wb") as f:
                f.write(b"".join(d for _, d in fp))
            d = FA.open_input(adts)
            dec = AacDecoder(d.streams[0].codecpar)
            y = np.concatenate([np.asarray(dec.decode(p)[0].data)
                                for p in d.packets()], 1)
            xin = np.concatenate(ins, 1)
            ref = xin if xin.dtype == np.int16 else \
                xin.astype(np.float64) * 32768.0
            gold["aac"][e] = {"pts": [p for p, _ in r["packets"]],
                              "sizes": [n for _, n in r["packets"]],
                              "file_pts": [p for p, _ in fp],
                              "snr_db": CS.snr_db(ref, y)}
    return gold


def jax_encode_run(argv: list[str], codec_opts: dict) -> dict:
    """One command line through the JAX package's CLI parser and
    Transcoder, with `codec_opts` given to the video encoder directly;
    returns the packets the muxer receives, the encoder's codec
    parameters and the frames it takes."""
    from librempeg_tpu.cli.ffmpeg import parse_args

    spec, _ = parse_args(argv)
    spec.video.codec_opts.update(codec_opts)
    tc = Transcoder(spec)
    got = {"pkts": [], "inputs": []}
    write = tc.mux.write

    def rec(p):
        got["pkts"].append(p)
        write(p)

    tc.mux.write = rec
    enc = tc.chains[0].encoder
    encode = enc.encode

    def take(frame):
        got["inputs"].append([np.asarray(p) for p in frame.planes])
        return encode(frame)

    enc.encode = take
    got["par"] = enc.codec_parameters()
    tc.run()
    return got


def encoders_goldens() -> dict:
    """The JAX package's runs of chip_smoke.py's encoders commands."""
    import chip_smoke as CS

    from librempeg_tpu.cli import ffprobe
    from librempeg_tpu.codecs.bsf import find_bsf
    from librempeg_tpu.codecs.mpeg12.decoder import Mpeg12Decoder
    from librempeg_tpu.formats.api import CodecParameters

    gold: dict = {}
    with tempfile.TemporaryDirectory() as td:
        cmd = CS.encoders_commands(td)
        # E1: the JAX CLI stores -bf as max_b_frames, which its pipeline
        # drops with a warning (the fault ROADMAP section 3b names); the
        # encoder is given bf itself so that it codes the B frame
        e1 = jax_encode_run(cmd["E1"], {"bf": "1"})
        demux = open_input(cmd["E1"][-1])
        dec = H264Decoder(demux.streams[0].codecpar, device=0)
        md5s = [frame_md5(f.planes) for f in dec.frames(demux.packets())]
        gold["e1"] = {
            "extradata_md5": hashlib.md5(e1["par"].extradata).hexdigest(),
            "packets": [CS.packet_record(p) for p in e1["pkts"]],
            "ffprobe": CS.probe_json(ffprobe, cmd["E1"][-1]),
            "decoded_md5": md5s}
        # E2: the same packets through h264_cavlc2cabac
        par = CodecParameters(codec_type="video", codec_id="h264",
                              width=e1["par"].width,
                              height=e1["par"].height,
                              extradata=e1["par"].extradata)
        bsf = find_bsf("h264_cavlc2cabac")(par)
        cabac = [q for p in e1["pkts"] for q in bsf.filter(p)]
        dec = H264Decoder(par, device=0)
        assert [frame_md5(f.planes) for f in dec.frames(cabac)] == md5s
        gold["e2"] = {
            "extradata_md5": hashlib.md5(par.extradata).hexdigest(),
            "packets": [CS.packet_record(p) for p in cabac]}
        # E3: MPEG-2 in MPEG-TS; the JAX muxer's PMT says 0x06
        e3 = jax_encode_run(cmd["E3"], {})
        dec = Mpeg12Decoder()
        frames = [f for p in e3["pkts"] for f in dec.decode(p)] + \
            dec.flush()
        gold["e3"] = {
            "packets": [CS.packet_record(p) for p in e3["pkts"]],
            "stream_types": CS.ts_stream_types(cmd["E3"][-1]),
            "decoded_md5": [frame_md5(f.planes) for f in frames],
            "psnr": [CS.planes_psnr_db(x, [np.asarray(p) for p in f.planes])
                     for x, f in zip(e3["inputs"], frames)]}
    return gold


def whole_access_units(split):
    """The JAX package's HevcDemuxer._split with its packets regrouped
    into one a picture: a packet holding a slice segment whose
    first_slice_segment_in_pic_flag (the first bit after the 2-byte NAL
    header) is 0 joins the packet before it."""

    def regrouped(self, data):
        extradata, segments = split(self, data)
        aus = []
        for seg in segments:
            vcl = seg[seg.rindex(b"\x00\x00\x00\x01") + 4:]
            if aus and not vcl[2] & 0x80:
                aus[-1] += seg
            else:
                aus.append(seg)
        return extradata, aus

    return regrouped


def md5_rows(path: str) -> list[str]:
    """The hash of each frame or packet line of a framemd5 file."""
    return [ln.split(",")[5].strip() for ln in open(path).read().splitlines()
            if not ln.startswith("#")]


def hevc_goldens() -> dict:
    """The JAX package's runs of chip_smoke.py's hevc commands, given
    whole access units."""
    import glob

    import torch

    import chip_smoke as CS

    from librempeg_tpu.cli import ffprobe
    from librempeg_tpu.codecs.hevc.decoder import HevcDecoder, generate_stream
    from librempeg_tpu.core.packet import Packet
    from librempeg_tpu.formats import rawes

    gold: dict = {"remux_md5": {}, "ffprobe": {}, "packet_md5": {}}
    split = rawes.HevcDemuxer._split
    rawes.HevcDemuxer._split = whole_access_units(split)
    try:
        with tempfile.TemporaryDirectory() as td:
            cmd = CS.hevc_commands(td)
            kw = dict(CS.HEVC_STREAM)
            stream = generate_stream(kw.pop("width"), kw.pop("height"), **kw)
            with open(cmd["H1"][1], "wb") as f:
                f.write(stream)
            gold["h0"] = {"md5": hashlib.md5(stream).hexdigest(),
                          "bytes": len(stream)}
            demux = open_input(cmd["H1"][1])
            aus = [bytes(p.data) for p in demux.packets()]
            assert len(aus) == CS.HEVC_STREAM["n_frames"]
            gold["au_md5"] = [hashlib.md5(a).hexdigest() for a in aus]
            dec = HevcDecoder()
            frames = [f for i, a in enumerate(aus)
                      for f in dec.decode(Packet(data=a, pts=i))]
            frames += dec.flush()
            gold["decoded_md5"] = [frame_md5(f.planes) for f in frames]
            # the JAX decoder stamps each frame with its packet's pts
            assert [f.pts for f in frames] == [0, 2, 1]
            for e in CS.HEVC_CONTAINERS:
                assert "error" not in jax_cli_run(cmd[f"H2_{e}"])
                path = cmd[f"H2_{e}"][-1]
                gold["remux_md5"][e] = hashlib.md5(
                    open(path, "rb").read()).hexdigest()
                gold["ffprobe"][e] = CS.probe_json(ffprobe, path)
                assert "error" not in jax_cli_run(cmd[f"H2P_{e}"])
                gold["packet_md5"][e] = md5_rows(cmd[f"H2P_{e}"][-1])
            assert "error" not in jax_cli_run(cmd["H2D_mkv"])
            assert md5_rows(cmd["H2D_mkv"][-1]) == gold["decoded_md5"]
            inputs = []
            r = jax_cli_run(cmd["H3"], on_input=lambda f: inputs.append(
                [np.asarray(p) for p in f.planes]))
            assert "error" not in r, r
            d = open_input(cmd["H3"][-1])
            fp = [(int(p.pts), bytes(p.data)) for p in d.packets()]
            dec = Mpeg4Decoder()
            back = [f for p, b in fp
                    for f in dec.decode(Packet(data=b, pts=p))] + dec.flush()
            gold["h3"] = {
                "types": "".join(vop_type(b) for _, b in fp),
                "pts": [p for p, _ in r["packets"]],
                "sizes": [n for _, n in r["packets"]],
                "psnr": [CS.planes_psnr_db(x, f.planes)
                         for x, f in zip(inputs, back)]}
            # P1: the rgb24 frames as the flips of the JAX package's
            # float32 conversion from the exact one, all at its ties
            yuv, rgb = [], []

            def keep_decoded(tc):
                dec = tc.chains[0].decoder
                decode = dec.decode

                def rec(pkt):
                    out = decode(pkt)
                    yuv.extend([np.array(p) for p in f.planes] for f in out)
                    return out

                dec.decode = rec

            argv = cmd["P1"][:-2] + ["-c:v", "png"] + cmd["P1"][-2:]
            assert "error" not in jax_cli_run(
                argv, on_input=lambda f: rgb.append(np.array(f.planes[0])),
                prepare=keep_decoded)
            flips = []
            for f, x in zip(yuv, rgb):
                exact, tie = CS.rgb24_exact(f)
                got = torch.from_numpy(x).to(torch.float64)
                assert not bool(((got != exact) & ~tie).any())
                idx = torch.nonzero((got != exact).flatten())[:, 0]
                flips.append([idx.tolist(),
                              got.flatten()[idx].to(torch.int64).tolist()])
            gold["p1"] = {"rgb_md5": [frame_md5([x]) for x in rgb],
                          "jax_flips": flips, "png_md5": [
                hashlib.md5(open(f, "rb").read()).hexdigest()
                for f in sorted(glob.glob(os.path.join(td, "thumb_*.png")))]}
            assert len(gold["p1"]["png_md5"]) == len(rgb) == CS.IMG_FRAMES
            assert "error" not in jax_cli_run(cmd["G1"])
            assert "error" not in jax_cli_run(cmd["G1D"])
            gold["g1"] = {"gif_md5": hashlib.md5(
                open(cmd["G1"][-1], "rb").read()).hexdigest(),
                "frame_md5": md5_rows(cmd["G1D"][-1])}
    finally:
        rawes.HevcDemuxer._split = split
    return gold


def acodecs_goldens() -> dict:
    """The JAX package's runs of chip_smoke.py's acodecs commands on the
    CPU, with the repairs the port makes applied to its output."""
    import chip_smoke as CS

    from librempeg_tpu.cli import ffprobe
    from librempeg_tpu.codecs.aac.decoder import AacDecoder
    from librempeg_tpu.codecs.flac.codec import build_streaminfo
    from librempeg_tpu.codecs.pcm import from_float
    from librempeg_tpu.formats.api import open_input as jopen
    from librempeg_tpu.resample import Swr

    def md5(path):
        return hashlib.md5(open(path, "rb").read()).hexdigest()

    def ok(argv, **kw):
        r = jax_cli_run(argv, **kw)
        assert "error" not in r, (argv, r)
        return r

    def wav_s16(path):
        return CS.s16_digest(CS.read_wav(path)[1])

    gold: dict = {}
    with tempfile.TemporaryDirectory() as td:
        wav = os.path.join(td, "in.wav")
        x = CS.write_audio_wav(wav, CS.AUDIO_SECONDS)
        gold["wav_md5"] = md5(wav)
        cmd = CS.acodecs_commands(td, wav)

        # K1: the JAX muxer leaves STREAMINFO as the encoder opened it (0
        # samples, zero MD5); the golden carries the final one
        ok(cmd["K1"])
        data = bytearray(open(cmd["K1"][-1], "rb").read())
        block = CS.ACODECS_FLAC_BLOCK
        assert bytes(data[8:42]) == build_streaminfo(
            CS.AUDIO_IN_RATE, 2, 16, 0, block)
        data[8:42] = build_streaminfo(
            CS.AUDIO_IN_RATE, 2, 16, x.shape[1], block,
            hashlib.md5(np.ascontiguousarray(x.T).astype("<i2")
                        .tobytes()).digest())
        with open(cmd["K1"][-1], "wb") as f:
            f.write(data)
        ok(cmd["K1D"])
        rows = CS.framemd5_rows(cmd["K1D"][-1])
        n = len(rows)
        # the JAX decoder's pts of the short last frame: frame_no x its
        # own size; the golden carries frame_no x the block size
        last = x.shape[1] - (n - 1) * block
        assert [p for p, _ in rows] == [i * block for i in range(n - 1)] \
            + [(n - 1) * last]
        gold["k1"] = {"md5": hashlib.md5(data).hexdigest(),
                      "hashes": [h for _, h in rows],
                      "pts": [i * block for i in range(n)]}

        # K2
        ok(cmd["K2"])
        ok(cmd["K2_mkv"])
        r = ok(cmd["K2D"])
        gold["k2"] = {
            "md5": md5(cmd["K2"][-1]), "bytes": os.path.getsize(cmd["K2"][-1]),
            "pts": [p for p, _ in r["packets"]],
            "s16": wav_s16(cmd["K2D"][-1]),
            "ffprobe": {"ac3": CS.probe_json(ffprobe, cmd["K2"][-1]),
                        "mkv": CS.probe_json(ffprobe, cmd["K2_mkv"][-1])}}

        # K3: the JAX graph takes every decoder's samples as s16p and its
        # aresample has no dither_method, so the chain runs by hand: the
        # JAX decoder, s16 (aformat), the JAX Swr with the shaper, whose
        # scan runs one channel at a time (XLA fuses channel 0 of a
        # stereo scan's feedback sums otherwise; test_torch_resample.py)
        from librempeg_tpu.codecs.opus.codec import OpusDecoder
        from librempeg_tpu.resample import dither as JD

        scan = JD._shape_scan

        def per_channel(xl, noise, coefs, err0):
            parts = [scan(xl[c:c + 1], noise[c:c + 1], coefs,
                          err0[:, c:c + 1]) for c in range(xl.shape[0])]
            return (np.concatenate([np.asarray(y) for y, _ in parts]),
                    np.concatenate([np.asarray(h) for _, h in parts], 1))

        d = jopen(cmd["K3"][1])
        dec = OpusDecoder(d.streams[0].codecpar)
        swr = Swr(48000, 44100, in_layout=2, in_fmt="s16p", out_fmt="s16p",
                  dither="lipshitz")
        outs = []
        JD._shape_scan = per_channel
        try:
            for p in d.packets():
                for f in dec.decode(p):
                    s16 = from_float(np.asarray(f.data), "s16p")
                    outs.append(swr.convert_frame(f.replace(
                        data=s16, sample_fmt="s16p")).data)
            outs.append(swr.flush_frame().data)
        finally:
            JD._shape_scan = scan
        d.close()
        gold["k3"] = {"s16": CS.s16_digest(np.concatenate(outs, 1))}
        ok(cmd["K3H"])
        rows = CS.framemd5_rows(cmd["K3H"][-1])
        hyb = os.path.join(td, "k3h.wav")
        ok(["-i", cmd["K3H"][1], "-c:a", "pcm_s16le", "-y", hyb])
        gold["k3"].update({"hybrid_pts": [p for p, _ in rows],
                           "hybrid_hashes": [h for _, h in rows],
                           "hybrid_s16": wav_s16(hyb)})

        # K4: the JAX Vorbis decoder with the port's floor repair and the
        # end granule's trim
        with vorbis_repaired():
            ok(cmd["K4"])
        gold["k4"] = {"s16": wav_s16(cmd["K4"][-1])}

        # K5: SNR of the JAX decoder on the JAX stream against the
        # samples the JAX encoder took
        # (the JAX MP3 decoder with libavcodec's window and the LAME
        # tag's trim, the port's repairs; the AAC encoder's MDCT exact,
        # tools/audio_jax_repair.py aac_mdct_exact)
        inputs = []
        with mpegaudio_repaired(), aac_mdct_exact():
            r = ok(cmd["K5"], on_input=lambda f: inputs.append(
                np.asarray(f.data, np.float64)))
        ref = np.concatenate(inputs, 1)
        d = jopen(cmd["K5"][-1])
        adec = AacDecoder(d.streams[0].codecpar)
        decoded = np.concatenate([np.asarray(f.data) for p in d.packets()
                                  for f in adec.decode(p)], 1)
        d.close()
        gold["k5"] = {"pts": [p for p, _ in r["packets"]],
                      "bytes": sum(n for _, n in r["packets"]),
                      "snr_db": CS.snr_db(ref * 32768.0, decoded)}

        # K6: the JAX MP2 decoder with libavcodec's window, untrimmed
        ok(cmd["K6"])
        with mpegaudio_repaired():
            ok(cmd["K6D"])
        gold["k6"] = {"md5": md5(cmd["K6"][-1]),
                      "s16": wav_s16(cmd["K6D"][-1])}

        # K7: the JAX WAV header with libavformat's fact chunk and byte
        # rate, the port's repair
        for k in ("K7i", "K7m"):
            ok(cmd[k])
            ok(cmd[k + "D"])
            raw = wav_tags_repaired(open(cmd[k][-1], "rb").read())
            gold[k.lower()] = {"md5": hashlib.md5(raw).hexdigest(), "rows": [
                list(r) for r in CS.framemd5_rows(cmd[k + "D"][-1])]}

        # K8, K9: libavcodec's E-AC-3 and 5.1 AC-3 streams, decoded with
        # libavcodec's dither filled in. The JAX demuxer counts 5
        # channels for 5.1 AC-3 (no LFE), so its WAV header says 5 over
        # six-channel data: the golden reads the data chunk as the
        # decoder's 6 channels, the port's repair
        from tools.ac3_jax_dither import dithered

        def wav_data(path, ch):
            raw = open(path, "rb").read()
            assert raw[36:40] == b"data"
            return CS.s16_digest(np.frombuffer(raw[44:], "<i2")
                                 .reshape(-1, ch).T, CS.ACODECS_AC3_WINDOWS)

        with dithered():
            for k, (_, ch) in CS.ACODECS_K8.items():
                r = ok(cmd[k])
                gold[k.lower()] = {"pts": [p for p, _ in r["packets"]],
                                   "s16": wav_data(cmd[k][-1], ch)}
            r = ok(cmd["K9"])
        gold["k9"] = {"pts": [p for p, _ in r["packets"]],
                      "s16": wav_data(cmd["K9"][-1], 6)}
        ok(cmd["K9_mkv"])
        d = jopen(cmd["K9_mkv"][-1])
        assert d.streams[0].codecpar.nb_channels == 5
        pk = [(int(p.pts), bytes(p.data)) for p in d.packets()]
        d.close()
        gold["k9"].update({
            "mkv_pts": [p for p, _ in pk],
            "mkv_packets_md5": hashlib.md5(b"".join(b for _, b in pk))
            .hexdigest()})
        # the Matroska copy's decode: pts in its 1/1000 time base
        with dithered():
            r = ok(cmd["K9D"])
        gold["k9"]["mkv_decode_pts"] = [p for p, _ in r["packets"]]
        assert wav_data(cmd["K9D"][-1], 6) == gold["k9"]["s16"]

        # K10: the JAX generator's HE-AAC stream (the port's writer gives
        # its bytes), its JAX decode and the JAX CLI's WAV packets
        from librempeg_tpu.codecs.aac.sbr import generate_he_stream

        data = generate_he_stream(**CS.ACODECS_K10)
        with open(cmd["K10"][1], "wb") as f:
            f.write(data)
        d = jopen(cmd["K10"][1])
        adec = AacDecoder(d.streams[0].codecpar)
        frames = [f for p in d.packets() for f in adec.decode(p)]
        d.close()
        assert {f.sample_rate for f in frames} == \
            {2 * CS.ACODECS_K10["core_rate"]}
        r = ok(cmd["K10"])
        gold["k10"] = {
            "md5": hashlib.md5(data).hexdigest(),
            "pts": [int(f.pts) for f in frames],
            "cli_pts": [p for p, _ in r["packets"]],
            "pcm": np.ascontiguousarray(np.concatenate(
                [np.asarray(f.data) for f in frames], 1)
                [:, ::CS.ACODECS_K10_STEP], np.float32)}
    return gold


def delivery_goldens() -> dict:
    """The JAX package's runs of chip_smoke.py's delivery commands (the
    MPEG-4 repair applied, as in every run of this tool): D1's FLV md5
    and ffprobe JSON; D1a's AAC packets as its FLV would carry them
    (the JAX muxer writes the AAC encoder's ADTS frames with no
    AudioSpecificConfig, so its own FLV has no stream; the golden keeps
    the frames' millisecond tag times, their bytes without the ADTS
    headers and the JAX decoder's SNR on them); D2's frame md5s, D2E's
    VOP types, pts, sizes and recon PSNR, D2S's md5; D3's ebur128 and
    loudnorm measurements and the s16 loudnorm writes; D4's progress
    keys; D5's and D5M's files; which of the asset's access units are
IDRs."""
    import chip_smoke as CS

    from librempeg_tpu.cli import ffmpeg as jcli
    from librempeg_tpu.cli import ffprobe
    from librempeg_tpu.codecs.aac.decoder import AacDecoder
    from librempeg_tpu.core.log import get_level, set_level
    from librempeg_tpu.core.packet import Packet
    from librempeg_tpu.formats import api as FA
    from librempeg_tpu.utils import testgen

    x = testgen.s16(testgen.audio_mix(CS.AUDIO_IN_RATE,
                                      CS.AUDIO_IN_RATE * CS.AUDIO_SECONDS))
    gold: dict = {}

    def md5(path):
        return hashlib.md5(open(path, "rb").read()).hexdigest()

    with tempfile.TemporaryDirectory() as td:
        wav = os.path.join(td, "in.wav")
        mux = FA.open_output(wav)
        mux.add_stream(FA.CodecParameters(
            codec_type="audio", codec_id="pcm_s16le",
            sample_rate=CS.AUDIO_IN_RATE, nb_channels=2))
        mux.write(Packet(data=np.ascontiguousarray(x.T).tobytes(), pts=0))
        mux.close()
        gold["wav_md5"] = md5(wav)
        for d in ("hls", "dash"):
            os.makedirs(os.path.join(td, d))
        cmd = CS.delivery_commands(td, wav)
        flv = cmd["D1"][-1]
        assert "error" not in jax_cli_run(cmd["D1"])
        gold["d1"] = {"md5": md5(flv),
                      "ffprobe": CS.probe_json(ffprobe, flv)}
        d = FA.open_input(CS.ASSET)
        gold["idr"] = [any(n[0] & 0x1F == 5 for n in P.split_annexb(
            bytes(p.data))) for p in d.packets()]
        d.close()

        aac = []

        def keep_aac(tc):
            write = tc.mux.write

            def rec(p):
                aac.append(p)
                write(p)

            tc.mux.write = rec

        assert "error" not in jax_cli_run(cmd["D1a"], prepare=keep_aac)
        adts = os.path.join(td, "d1a.aac")
        with open(adts, "wb") as f:
            f.write(b"".join(bytes(p.data) for p in aac))
        d = FA.open_input(adts)
        dec = AacDecoder(d.streams[0].codecpar)
        y = np.concatenate([np.asarray(dec.decode(p)[0].data)
                            for p in d.packets()], 1)
        d.close()
        gold["d1a"] = {
            "pts_ms": [int(p.dts * 1000 * p.time_base.num
                           / p.time_base.den) for p in aac],
            "raw_bytes": sum(len(p.data) - (7 if p.data[1] & 1 else 9)
                             for p in aac),
            "snr_db": CS.snr_db(x, y)}

        assert "error" not in jax_cli_run(cmd["D2"])
        frames = [ln.split(", ")[-1] for ln in
                  CS.md5_lines(open(cmd["D2"][-1]).read())[1]]
        psnrs = []
        orig = ME.Mpeg4Encoder.encode_async

        def encode_async(self, frame, **kw):
            h = orig(self, frame, **kw)
            psnrs.append(psnr(h["planes"], self._ref))
            return h

        ME.Mpeg4Encoder.encode_async = encode_async
        try:
            r = jax_cli_run(cmd["D2E"])
        finally:
            ME.Mpeg4Encoder.encode_async = orig
        assert "error" not in r, r
        pay = CS.avi_payloads(cmd["D2E"][-1])
        assert "error" not in jax_cli_run(cmd["D2S"])
        gold["d2"] = {"frames": frames,
                      "types": "".join(vop_type(p) for p in pay),
                      "pts": [p for p, _ in r["packets"]],
                      "sizes": [n for _, n in r["packets"]],
                      "recon_psnr": psnrs,
                      "srt_md5": md5(cmd["D2S"][-1])}

        tcs = []
        for name in ("D3M", "D3N"):
            assert "error" not in jax_cli_run(cmd[name], prepare=tcs.append)
        d = FA.open_input(cmd["D3N"][-1])
        s16 = np.frombuffer(b"".join(bytes(p.data) for p in d.packets()),
                            "<i2").reshape(-1, 2).T
        d.close()
        gold["d3"] = {"ebur128": CS.loudness_of(tcs[0]),
                      "loudnorm": CS.loudness_of(tcs[1]),
                      "s16": CS.s16_digest(s16, CS.LOUD_WINDOWS)}

        level = get_level()
        try:
            assert jcli.main(cmd["D4"]) == 0
        finally:
            set_level(level)
        prog = open(cmd["D4"][cmd["D4"].index("-progress") + 1]).read() \
            .splitlines()
        gold["d4"] = {"progress_keys": [ln.split("=")[0]
                                        for ln in prog[-6:]]}
        for name, sub in (("D5", "hls"), ("D5M", "dash")):
            assert "error" not in jax_cli_run(cmd[name])
            gold[name.lower()] = {"md5s": CS.dir_md5s(os.path.join(td, sub))}
    return gold


def delivery_port(limits: bool) -> bool:
    """D3's measurement and loudnorm on the port on the CPU against the
    stored goldens (the phase's D3 checks, printed), and with limits=
    False the gap a planted fault makes: the K-weighting's shelf 0.01 dB
    off."""
    import chip_smoke as CS

    from librempeg_tpu_torch.filters import loudness as TL
    from librempeg_tpu_torch.cli.ffmpeg import parse_args as tparse
    from librempeg_tpu_torch.formats.api import open_input as topen
    from librempeg_tpu_torch.sched.pipeline import Transcoder as TT

    gold = json.load(open(DELIVERY_OUT))
    ok = True
    with tempfile.TemporaryDirectory() as td:
        wav = os.path.join(td, "in.wav")
        CS.write_audio_wav(wav, CS.AUDIO_SECONDS)
        cmd = CS.delivery_commands(td, wav)
        shelf = TL._SHELF_B
        for fault in ((False, True) if not limits else (False,)):
            if fault:
                g = 10 ** (0.01 / 20)
                TL._SHELF_B = tuple(b * g for b in shelf)
            try:
                tc = TT(tparse(cmd["D3M"] + ["-device", "cpu"])[0])
                tc.run()
            finally:
                TL._SHELF_B = shelf
            m = CS.loudness_of(tc)
            gaps = {k: abs(m[k] - gold["d3"]["ebur128"][k]) for k in m}
            within = (gaps["I"] <= CS.LOUD_I_TOL
                      and gaps["LRA"] <= CS.LOUD_LRA_TOL
                      and gaps["peak"] <= CS.LOUD_PEAK_TOL)
            print(f"D3 {'planted shelf +0.01 dB' if fault else 'clean'}: "
                  f"{m}, gaps {gaps}, within the limits: {within}")
            ok = ok and (within != fault)
        tc = TT(tparse(cmd["D3N"] + ["-device", "cpu"])[0])
        tc.run()
        d = topen(cmd["D3N"][-1])
        s16 = np.frombuffer(b"".join(bytes(p.data) for p in d.packets()),
                            "<i2").reshape(-1, 2).T
        got = CS.s16_digest(s16, CS.LOUD_WINDOWS)
        d = np.abs(np.array(got["windows"], np.int32)
                   - np.array(gold["d3"]["s16"]["windows"], np.int32))
        share = np.count_nonzero(d) / d.size
        print(f"D3N loudnorm s16: md5 equal to the JAX package's "
              f"{got['md5'] == gold['d3']['s16']['md5']}; stored windows "
              f"{share:.6f} of samples off, max {d.max()} (limit "
              f"{CS.LOUD_S16_SHARE}, 1)")
        ok = ok and share <= CS.LOUD_S16_SHARE and d.max() <= 1
    return ok


def main(argv) -> None:
    """Every run under the MPEG-4 reference repair (see the module
    docstring)."""
    from tools.mpeg4_jax_repair import repaired

    with repaired():
        _main(argv)


def _main(argv) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calibrate", action="store_true",
                    help="also run the port's options transcode on the CPU "
                    "and print its agreement")
    ap.add_argument("--check-port", action="store_true",
                    help="only run the port's options transcode on the "
                    "CPU against the stored goldens; write nothing")
    ap.add_argument("--audio", action="store_true",
                    help="only the audio goldens (audio_aac.npz)")
    ap.add_argument("--jpeg", action="store_true",
                    help="only the JPEG goldens (bench_1080p_mjpeg.npz)")
    ap.add_argument("--graphs", action="store_true",
                    help="with --filters --check-port or --calibrate: the "
                    "graph-API graphs alone")
    ap.add_argument("--filters", action="store_true",
                    help="only the filter goldens (bench_1080p_filters.npz)")
    ap.add_argument("--containers", action="store_true",
                    help="only the containers goldens "
                    "(bench_1080p_containers.json)")
    ap.add_argument("--encoders", action="store_true",
                    help="only the encoders goldens "
                    "(bench_1080p_encoders.json)")
    ap.add_argument("--hevc", action="store_true",
                    help="only the hevc goldens (bench_1080p_hevc.json)")
    ap.add_argument("--acodecs", action="store_true",
                    help="only the audio codec goldens (bench_acodecs.json)")
    ap.add_argument("--delivery", action="store_true",
                    help="only the delivery goldens (bench_delivery.json)")
    args = ap.parse_args(argv)
    if args.delivery:
        if args.check_port or args.calibrate:
            sys.exit(0 if delivery_port(limits=args.check_port) else 1)
        t0 = time.perf_counter()
        gold = delivery_goldens()
        with open(DELIVERY_OUT, "w") as f:
            json.dump(gold, f, indent=0, sort_keys=True)
        print(f"delivery goldens (JAX, CPU, {time.perf_counter() - t0:.1f} "
              f"s): D1 {gold['d1']['md5']}; D1a {len(gold['d1a']['pts_ms'])}"
              f" AAC frames, {gold['d1a']['raw_bytes']} bytes, SNR "
              f"{gold['d1a']['snr_db']:.4f} dB; D2E {gold['d2']['types']} "
              f"{sum(gold['d2']['sizes'])} bytes, recon "
              f"{np.mean(gold['d2']['recon_psnr']):.4f} dB; D3 "
              f"{gold['d3']['ebur128']}; D5 {len(gold['d5']['md5s'])} "
              f"files, D5M {len(gold['d5m']['md5s'])}; "
              f"{os.path.getsize(DELIVERY_OUT)} bytes")
        return
    if args.acodecs:
        t0 = time.perf_counter()
        gold = acodecs_goldens()
        np.savez_compressed(ACODECS_K10_OUT, pcm=gold["k10"].pop("pcm"))
        with open(ACODECS_OUT, "w") as f:
            json.dump(gold, f, separators=(",", ":"), sort_keys=True)
        print(f"acodecs goldens (JAX, CPU, {time.perf_counter() - t0:.1f} "
              f"s): K1 {len(gold['k1']['hashes'])} FLAC frames; K2 "
              f"{gold['k2']['bytes']} bytes; K5 {len(gold['k5']['pts'])} "
              f"packets, {gold['k5']['bytes']} bytes, SNR "
              f"{gold['k5']['snr_db']:.4f} dB; "
              f"{os.path.getsize(ACODECS_OUT)} bytes")
        return
    if args.hevc:
        t0 = time.perf_counter()
        gold = hevc_goldens()
        with open(HEVC_OUT, "w") as f:
            json.dump(gold, f, indent=0, sort_keys=True)
        print(f"hevc goldens (JAX, CPU, {time.perf_counter() - t0:.1f} s): "
              f"H0 {gold['h0']['bytes']} bytes; H3 {gold['h3']['types']} "
              f"pts {gold['h3']['pts']} sizes {gold['h3']['sizes']} PSNR "
              f"{[round(x, 4) for x in gold['h3']['psnr']]} dB; P1 "
              f"{len(gold['p1']['png_md5'])} files; "
              f"{os.path.getsize(HEVC_OUT)} bytes")
        return
    if args.encoders:
        t0 = time.perf_counter()
        gold = encoders_goldens()
        with open(ENCODERS_OUT, "w") as f:
            json.dump(gold, f, indent=0, sort_keys=True)
        print(f"encoders goldens (JAX, CPU, "
              f"{time.perf_counter() - t0:.1f} s): E1 "
              f"{sum(p[1] for p in gold['e1']['packets'])} bytes, E2 "
              f"{sum(p[1] for p in gold['e2']['packets'])} bytes, E3 "
              f"{sum(p[1] for p in gold['e3']['packets'])} bytes, stream "
              f"types {gold['e3']['stream_types']}, decoded PSNR "
              f"{[round(x, 4) for x in gold['e3']['psnr']]} dB; "
              f"{os.path.getsize(ENCODERS_OUT)} bytes")
        return
    if args.containers:
        t0 = time.perf_counter()
        gold = containers_goldens()
        with open(CONTAINERS_OUT, "w") as f:
            json.dump(gold, f, indent=0, sort_keys=True)
        print(f"containers goldens (JAX, CPU, "
              f"{time.perf_counter() - t0:.1f} s): remux md5 "
              f"{gold['remux_md5']}; seek errors {gold['seek_error']}; V "
              f"{gold['v']['types']} {sum(gold['v']['sizes'])} bytes, recon "
              f"{np.mean(gold['v']['recon_psnr']):.4f} dB, read back "
              f"{gold['v']['readback_psnr']:.4f} dB; AAC "
              f"{ {e: round(a['snr_db'], 4) for e, a in gold['aac'].items()} }"
              f" dB; {os.path.getsize(CONTAINERS_OUT)} bytes")
        return
    if args.filters:
        if args.check_port:
            sys.exit(0 if filters_port(True, args.graphs) else 1)
        os.makedirs(OUT, exist_ok=True)
        t0 = time.perf_counter()
        gold = filters_goldens()
        np.savez_compressed(FILTERS_OUT, **gold)
        print(f"filter goldens (JAX, CPU, {time.perf_counter() - t0:.1f} s):"
              f" F1 {gold['f1_types']} {int(gold['f1_sizes'].sum())} bytes "
              f"{gold['f1_psnr'].mean():.4f} dB; F2 "
              f"{int(gold['f2_sizes'].sum())} bytes "
              f"{gold['f2_psnr'].mean():.4f} dB, {len(gold['f2_mv'])} "
              f"searches; F4 {int(gold['f4v_sizes'].sum())} bytes; F3 SNR "
              f"{float(gold['f3_snr']):.4f} dB, F4 audio SNR "
              f"{float(gold['f4a_snr']):.4f} dB; "
              f"{os.path.getsize(FILTERS_OUT)} bytes")
        if args.calibrate:
            filters_port(False, args.graphs)
        return
    if args.jpeg:
        if args.check_port:
            sys.exit(0 if jpeg_port(limits=True) else 1)
        os.makedirs(OUT, exist_ok=True)
        t0 = time.perf_counter()
        gold = jpeg_goldens()
        np.savez_compressed(JPEG_OUT, **gold)
        print(f"JPEG goldens (JAX, CPU, {time.perf_counter() - t0:.1f} s): "
              f"A {int(gold['a_sizes'].sum())} bytes, decoded PSNR per plane "
              f"{gold['a_psnr'].mean(0).round(4).tolist()} dB, psnr graph "
              f"{gold['psnr'].mean(0).round(4).tolist()}, ssim graph "
              f"{gold['ssim'].mean(0).round(6).tolist()}; stored frame "
              f"{gold['stored_jpeg'].size} bytes, A's packet 0 "
              f"{gold['a0_jpeg'].size} bytes; B {gold['b_types']} "
              f"decoded {gold['b_psnr'].mean():.4f} dB; C sizes "
              f"{gold['c_sizes'].tolist()}, pts {gold['c_pts'].tolist()}; "
              f"{os.path.getsize(JPEG_OUT)} bytes")
        if args.calibrate:
            jpeg_port(limits=False)
        return
    if args.audio:
        if args.check_port:
            sys.exit(0 if audio_port(limits=True) else 1)
        os.makedirs(OUT, exist_ok=True)
        t0 = time.perf_counter()
        gold = audio_goldens()
        np.savez_compressed(AUDIO_OUT, **gold)
        print(f"audio goldens (JAX, CPU, {time.perf_counter() - t0:.1f} s): "
              f"{len(gold['aac_pts'])} packets, {gold['aac_bytes']} bytes, "
              f"decoded SNR {gold['aac_snr_db']:.4f} dB, resampled length "
              f"{gold['rs_len']}, WAV md5 {gold['wav_md5']}")
        if args.calibrate:
            audio_port(limits=False)
        return
    if args.check_port:
        sys.exit(0 if check_port() else 1)
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
    t0 = time.perf_counter()
    run = options_transcode(JP, ME)
    print(f"options transcode (JAX, CPU): {time.perf_counter() - t0:.1f} s")
    summ = write_options_goldens(run)
    if args.calibrate:
        calibrate(run, summ)


if __name__ == "__main__":
    main(sys.argv[1:])
