#!/usr/bin/env python3
"""Smoke run of the PyTorch port (librempeg_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--profile DIR]

It drives eleven paths and ten kernels. Phases, in order; any failure
raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the native host library and the CUDA kernels, from the
   sources in this checkout (one nvcc per source, all at once);
3. one phase per kernel: the kernel against its plain PyTorch version on
   the card, on real inputs, with the median of 25 synchronised runs of
   each (host wall time, wrapper included: ms, plain_ms), the median
   device time of 25 calls by CUDA events, each behind a stream sleep
   (device_ms, the launch floor included), the device time of one call
   of 25 issued back to back between one event pair (device_ms_b2b, the
   median of 3 such runs), and the least time the card could take for
   the same work (bound_ms, from the call's shapes: the bytes moved at
   3.35 TB/s or the operations at 67 TFLOP/s, whichever is longer). A
   torch.profiler window over one intra, one deblock, one mc, one hpel
   and one residual call must show each as one kernel launch and
   nothing else. The H.264 kernels (mc, intra,
   deblock, residual) take the first P frame of assets/bench_1080p.264,
   the residual kernel through the windowless packer; the half-pel
   kernels (hpel, the fused form of the encoder's path, and its per-MB
   halves hpel_luma and hpel_chroma) the encoder's first I-VOP recon and
   the next scaled frame; the full search (fsearch) the kernel leg's
   first step. All bit-exact, except fsearch on float inputs (see
   fsearch_phase). Then quant_phase: the MPEG-4 quantisers (intra DC
   and AC, inter, the trellis's first levels) at qscale 3, 5 and 7 on
   the spec DCT coefficients of the asset's first two frames scaled to
   1280x720, computed once on the CPU and copied to the card, equal to
   the CPU's level for level (a division by a Python scalar, which the
   card takes as a product with the rounded reciprocal, is counted
   beside them);
4. slice: the bench transcode (1080p H.264 -> 1280x720 MPEG-4 at 4 Mb/s)
   through Transcoder on the card. Every decoded frame's md5 must match
   the JAX package's (tests/data/torch_port), the AVI must hold 48
   packets with an I-VOP every 12, the mean in-loop recon PSNR must be
   within 0.5 dB of the JAX package's, and mc, intra, deblock and hpel
   must have launched during this run (hpel once per P-VOP, hpel_luma
   and hpel_chroma never). Each frame's recon PSNR and quantiser print
   beside the JAX package's, with the first frame where they part;
5. fps: steady-state transcode rate measured like bench.py's e2e leg
   (16 warm frames, then 24 timed, each window ending in chain.sync()),
   with the stage split. --profile DIR adds a torch.profiler window of
   8 frames; its table goes to DIR/chip_smoke_profile.txt;
6. options: the same transcode with the options of an everyday one
   (-pix_fmt yuvj420p -g 12 -bf 2 -trellis 1 -b:v 4M), through the
   scaler's RGB path, trellis I/P-VOPs and plain-torch B-VOPs, held to
   tests/data/torch_port/bench_1080p_options.npz: decoded md5s, 48
   packets with the JAX package's VOP types in decode order, rising dts
   and pts a permutation of 0..47, the first yuvj420p frame against the
   JAX package's sampled rows, every VOP's quantiser equal to the JAX
   package's, the decoded I/P and B PSNR means (the port's vendored
   MPEG-4 decoder, against the port's own encoder input) within
   0.02 dB of the JAX package's, every I/P-VOP decoded to the encoder's
   reference exactly (its integer picture), and mc, intra and deblock
   44 launches
   each, hpel once per P-VOP and the per-MB forms never. A second,
   unhooked run gives the rate and stage split; the checked run times
   each B-VOP device pass and each trellis frame (one lattice call);
7. audio: the audio transcode (-ar 48000 -c:a aac -b:a 128k) of 10 s of
   testgen.audio_mix at 44.1 kHz stereo s16 written as a WAV, held to
   tests/data/torch_port/audio_aac.npz (audio_transcode_checks): the
   WAV's md5, the resampler alone (-c:a pcm_s16le: length exact, the
   golden's sampled windows), the AAC packets' pts exact, every ADTS
   header valid, the bytes and the port's decoded SNR within limits of
   the JAX package's, and -ac 1 on 2 s (mono, the rematrix within 1
   LSB). The noise shaper's kernel (shape_scan) is held equal by value
   (its fast rounding may give +0.0 where rint gives -0.0; see
   csrc/shape_scan.cu) to its plain version on the resampled clip with
   both shapers, in two chunks, then launches once per WAV packet of
   -af aresample=48000:dither_method=lipshitz -c:a pcm_s16le over the
   whole clip, every launch replayed through the plain version and
   equal by value; the phase prints the stage split, the realtime
   factor, the MDCT's device time apart from the host quantiser, and
   its wall time;
8. jpeg: the JPEG/MJPEG path through cli.ffmpeg's parser and Transcoder
   (jpeg_commands): A, the asset to -pix_fmt yuvj420p -c:v mjpeg -q:v 3
   in AVI (the H.264 decode's mc, intra and deblock kernels 44 times
   each); B, that AVI to -vf scale=1280:720 -c:v mpeg4 -q:v 4 (the JPEG
   decode, hpel once per P-VOP); C, thumbnails -vf
   fps=5,crop=1440:1080,scale=320:240 -q:v 2 -f image2 (mc, intra,
   deblock 44 times each again); C2, -c:v copy of those files into raw
   MJPEG; then the psnr and ssim two-input graphs of A's decode against
   its yuvj420p source, on the card and on the CPU. Held to
   tests/data/torch_port/bench_1080p_mjpeg.npz (jpeg_checks): A's 48
   key packets, pts exact, each size within JPEG_SIZE_REL of the JAX
   package's, the byte-identical count printed, every packet decoded on
   the card equal to its CPU decode, identical packets and the stored
   -q:v 31 frame and the JAX package's own packet 0 of A (-q:v 3) to the
   JAX decoder's md5, decoded PSNR per plane within
   JPEG_PSNR_TOL_DB; B's VOP types and pts exact, its decoded mean within
   JPEG_B_PSNR_TOL_DB; C's names, pts and sizes, C2 splitting back into
   the files' bytes; the graphs within METRIC_DEV_DB / METRIC_DEV_SSIM of
   the CPU and within the limits of the JAX package's means. Each path's
   frames/s and stage split (jpeg.device, jpeg.fetch, jpeg.scan) print;
9. filters: the filter slice through cli.ffmpeg's parser and Transcoder
   (filters_commands) at the asset's full 1920x1088: F1 -vf F1_VF
   (colorspace, eq, gblur, boxblur, lutyuv, drawbox, fade) to MPEG-4 at
   -q:v 4, F2 -vf minterpolate=fps=50 (the full-search kernel once per
   interpolated frame, 47 launches, r = 8), F3 the 10 s WAV through -af
   F3_AF (a run of four biquads: the biquad kernel once per WAV packet
   for all four, 431 launches; aecho, afade) to AAC, F4 -f lavfi
   testsrc (2 s) to
   MPEG-4 and sine (10 s) to AAC; then the graph-API graphs
   (FILTER_GRAPHS: xfade, the stacks and tile after a scale, lut3d with
   a generated 33^3 cube, concat, reverse, select, thumbnail on the
   decode; showwaves, showspectrum and afir on F3's samples). Held to
   tests/data/torch_port/bench_1080p_filters.npz (filters_checks):
   VOP types and pts exact, bytes and mean recon PSNR within
   FILT_BYTES_REL / FILT_PSNR_TOL_DB, F2's and F4's encoder input and
   F2's MV fields equal to the JAX package's, F1's within the float
   limits (plane sums, sampled rows), the audio paths' encoder input
   exact, AAC pts exact, bytes and SNR within the audio limits, the
   exact graphs' outputs equal, lut3d within FILT_SUM_TOL and FILT_SHARE,
   the scaled frames equal to the exact scale off ties of its rounding
   (FILT_TIE), each output of the stacks and tile equal to them stacked
   or tiled and off the JAX package's only at ties. Every biquad launch
   of F3 is replayed through the plain cascade
   (kernels.biquad.biquad_cascade_plain), equal by value, and so is
   every launch of SINGLE_BIQUAD, a graph-API graph of one biquad on the
   WAV (a run of one stage); the full search equals its plain version
   on minterpolate's inputs at r = 8 and r = 16;
10. containers: the container layer, -ss/-t, checkpoint/resume and the
   profiler through cli.ffmpeg's parser and Transcoder
   (containers_commands), held to
   tests/data/torch_port/bench_1080p_containers.json (the JAX package's
   runs of the same command lines on the CPU): the asset stream-copied
   into MP4, Matroska and MPEG-TS (each file's md5 and its ffprobe
   -show_streams -show_format -show_packets JSON equal to the JAX
   package's); each of the four sources decoded to framemd5 (the text
   equal to the JAX package's, the 48 hashes those of
   bench_1080p_frames.md5, mc, intra and deblock 44 launches a run);
   -ss 0.5 -t 1.0 from each (frames 13-37 of its decode, the text equal
   to the JAX package's where that package can seek); the Matroska copy
   to 1280x720 MPEG-4 -q:v 5 in MP4 (VOP types and pts exact, bytes and
   mean recon PSNR within FILT_BYTES_REL / FILT_PSNR_TOL_DB, the MP4's
   packets the encoder's byte for byte, the first CONT_READBACK VOPs
   read back by the vendored decoder to the encoder's references
   exactly, hpel once per P-VOP); the WAV to 48 kHz
   AAC in MP4 and Matroska (pts exact, bytes and SNR within the audio
   limits); checkpoint/resume on the card (that
   MPEG-4 transcode from Matroska and from MP4 snapshotted after packet
   CONT_CUT, an IDR, and restored into a fresh Transcoder: the rest of
   its packets equal the uninterrupted run's byte for byte; the dithered
   WAV snapshotted after CONT_DITHER_CUT packets: the resumed samples
   equal the uninterrupted run's, shape_scan once a packet on both sides
   of the cut); and utils.profiler.device_trace over one decode, in a
   fresh process, whose Chrome trace must count as many mc, intra and
   deblock kernels as the launch counters, with the card's busy time and
   idle share read from it;
11. encoders: the H.264 and MPEG-2 encoders, the CAVLC -> CABAC bsf and
   the MPEG-1/2 decoder through cli.ffmpeg's parser and Transcoder
   (encoders_commands) at 1920x1088, held to
   tests/data/torch_port/bench_1080p_encoders.json (the JAX package's
   runs on the CPU): E1, the asset's first ENC_E1_FRAMES frames to
   -c:v h264 -qp 26 -sr 4 -bf 1 in MP4 (I0 P2 B1 P3): every packet's
   md5, size, pts, dts and flags, the SPS/PPS and the ffprobe JSON the
   JAX package's; e1.mp4 decoded on the card to the JAX decode's md5s,
   each reference frame equal to the encoder's deblocked recon, mc,
   intra and deblock once per P frame; E2, E1's packets through h264_cavlc2cabac,
   the JAX bsf's bytes, decoded on the card to E1's frames; E3, the
   first ENC_E3_FRAMES frames to -c:v mpeg2video -q:v 5 -f mpegts: the
   PMT says 0x02, the file reads back to the encoder's packets, the
   card's decode equals the encoder's recon, and the packets are the
   JAX package's (or, where MPEG-2's float64 DCT rounds a tie the other
   way on this host, within the sizes and PSNR limits set beside
   ENC_E3_FRAMES); E1 copied to a raw .264 decodes on the card to E1's
   frames with pts 0 1 2 3 (the display-pts repair). Wall time, frames/s
   and the stage split of E1 and E3 print beside the card's name and
   power limit;
12. hevc: the HEVC decoder, its raw stream and its containers, PNG and
   GIF through cli.ffmpeg's parser and Transcoder (hevc_commands), held
   to tests/data/torch_port/bench_1080p_hevc.json (the JAX package's runs
   on the CPU, given whole access units): H0, the port's generate_stream
   at 1920x1080 (HEVC_STREAM: I0 P2 B1, two slice segments a picture, a
   partial last CTB row) byte for byte the JAX generator's, and its three
   access units; H1, the raw .265 to framemd5: the JAX decoder's hashes,
   pts 0 1 2, the frames CUDA tensors before the hash muxer fetches
   them; H2, its copy into MP4, Matroska and MPEG-TS: each file the JAX
   package's, three packets, ffprobe JSON the JAX package's (hevc,
   1920x1080, yuv420p; in MPEG-TS the size the JAX package reads 0x0),
   packet hashes the access units', the Matroska copy decoded to H1's
   hashes; H3, the MP4 to 1280x720 MPEG-4 -q:v 5: VOP types, packet count
   and pts exact (pts sorted: the JAX run's frames keep their packets'
   decode order), bytes and decoded PSNR within FILT_BYTES_REL /
   FILT_PSNR_TOL_DB, hpel once per P-VOP (a P-VOP whose levels
   overflow the sparse fetch layout is re-packed in a larger one);
   P1, the asset's first IMG_FRAMES frames to -pix_fmt rgb24
   thumb_%03d.png with no -c:v (PNG by the extension): each rgb24 frame
   the exact conversion off its ties and the JAX package's (rebuilt
   from the golden's flips) but at ties, its PNG file the JAX package's
   where the frame is, read back to the frames; G1, the same frames to
   an animated GIF: the JAX package's file where every frame is the JAX
   package's, read back to the frames' palette colours. Each command's
   wall time, launches and stage split print beside the card's name and
   power limit;
13. acodecs: the audio codecs and their containers through
   cli.ffmpeg's parser and Transcoder (acodecs_commands), held to
   tests/data/torch_port/bench_acodecs.json (the JAX package's runs on
   the CPU, the FLAC repairs applied; the Opus, Vorbis, MP3 and MP2
   inputs are committed streams, tools/torch_port_audio_fixtures.py):
   K1, the audio phase's 10 s WAV to FLAC: the JAX encoder's bytes with
   the final STREAMINFO, the decode's hashes, pts 0, 4096, ..., the
   WAV's samples in CUDA tensors, the Ogg and Matroska copies' packets
   the FLAC file's; K2, 2 s to AC-3 at 192 kb/s (identical, or within
   FILT_BYTES_REL), copied into Matroska and decoded (pts exact),
   ffprobe JSON of both files the JAX package's; K3, the CELT stream
   through aresample=44100 with the lipshitz shaper to FLAC (the
   encoder's s16 negotiated onto the aresample, its float input
   converted to s16 first): shape_scan once a dithered frame, every
   launch equal to the
   plain scan by value; the hybrid stream to framemd5, every frame's
   hash the JAX package's; K4, the Vorbis stream through highpass and
   lowpass (one biquad launch a frame, each equal to the plain cascade);
   the s16 of K2, K3, the hybrid stream, K4 and K6 exact (the md5 of
   every sample); K5, the MP3 to AAC in MP4 (packets and
   pts exact, bytes and SNR within AUDIO_BYTES_TOL, AUDIO_SNR_TOL_DB);
   K6, the MP2 copied into Matroska and decoded; K7, 5 s to IMA and MS
   ADPCM in WAV and back to framemd5, exact. Each command's wall time,
   launches and stage split print beside the card's name and power
   limit;
14. delivery: D1-D6 of delivery_commands through cli.ffmpeg's parser
   and Transcoder (D4 through its main), held to tests/data/torch_port/
   bench_delivery.json (the JAX package's runs on the CPU) and to
   bench_1080p_frames.md5: D1 the asset into FLV (-c copy; the file's
   md5 and ffprobe JSON the JAX package's) and decoded on the card to
   the asset's frames (mc, intra, deblock once per P frame), and the
   WAV to AAC in FLV (the port writes the AudioSpecificConfig the JAX
   muxer leaves out: tag pts exact, bytes and SNR within the audio
   limits); D2 the FLV's first DELIVERY_FRAMES frames with the
   committed cues burned in and a %{n} drawtext box (the committed
   DejaVu Sans Mono through the port's TrueType reader; the blend on
   the card), every frame's md5 the JAX package's, and the same to
   MPEG-4 -q:v 3 (VOP types and pts exact, bytes and recon PSNR within
   FILT_*, its first DELIVERY_READBACK VOPs decoded to the encoder's
   references exactly), the cues through the subtitle stream (the JAX
   package's SubRip bytes); D3 ebur128 and loudnorm on the WAV (the
   port's resampler to 48 kHz on the card; I, LRA and peak within
   LOUD_*, loudnorm's s16 exact); D4 the FLV's video to Matroska under
   -map 0:v -c copy -progress -stats_period -v -benchmark -threads (the
   FLV's packets, the JAX package's progress keys ending
   progress=end); D5 the asset into HLS and DASH (files the JAX
   package's), each read back over http:// from a loopback server and
   decoded to the asset's frames; D6 the asset's first
   DELIVERY_RTSP_AUS access units pushed by a scripted RTSP peer
   (interleaved RTP, FU-A) to the listening demuxer and decoded on the
   card to the first frames. Sockets on 127.0.0.1 only, each wait at
   most DELIVERY_TIMEOUT;
15. kernel leg: parallel.transcode_step as bench.py's kernel leg runs it
   (8 testgen frames 1920x1088 -> 1280x720, qscale 4, 4 chained steps),
   held to the JAX package's goldens (tests/data/torch_port/
   kernel_leg.npz); fsearch must launch once per step; then one warm
   pass of the 4 steps is timed (--profile: and one more profiled, its
   table in DIR/chip_smoke_profile_kernel_leg.txt).

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ASSET = os.path.join(ROOT, "assets", "bench_1080p.264")
GOLD = os.path.join(ROOT, "tests", "data", "torch_port")
PSNR_TOL_DB = 0.5
RUNS = 25
# H100 SXM peaks (NVIDIA's data sheet): HBM rate, float32 outside the
# tensor cores
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# the stream sleeps this long (about 1 ms) before each timed call, so
# the host's enqueue of the call does not show in its device time
SLEEP_CYCLES = 2_000_000
# the sleep before a back-to-back run (about 25 ms): the host issues its
# RUNS calls meanwhile (device_ms_b2b)
B2B_SLEEP_CYCLES = 50_000_000
NO_LIBRARY = ("no single PyTorch call computes this function (a search "
              "argmin, an order-dependent filter chain, a serial "
              "prediction walk, sub-pel MC at per-block MVs, an integer "
              "butterfly)")

KERNELS = {
    # name: (source, the TPU kernel it replaces, PERF.md table row, the
    # path whose run counts its launches)
    "mc": ("librempeg_tpu_torch/csrc/mc.cu",
           "librempeg_tpu/codecs/h264/mc_pallas.py:324", "1", "e2e"),
    "deblock": ("librempeg_tpu_torch/csrc/deblock.cu",
                "librempeg_tpu/codecs/h264/deblock_pallas.py:275", "2",
                "e2e"),
    "intra": ("librempeg_tpu_torch/csrc/intra.cu",
              "librempeg_tpu/codecs/h264/intra_pallas.py:578", "3", "e2e"),
    "hpel": ("librempeg_tpu_torch/csrc/hpel.cu",
             "librempeg_tpu/codecs/mpeg4/me_pallas.py:479", "4 "
             "(_refine_mc_luma_group me_pallas.py:259, _mc_chroma_group "
             ":427)", "e2e"),
    "hpel_luma": ("librempeg_tpu_torch/csrc/hpel.cu",
                  "librempeg_tpu/codecs/mpeg4/me_pallas.py:131", "4b",
                  "kernel phase (per-MB forms)"),
    "hpel_chroma": ("librempeg_tpu_torch/csrc/hpel.cu",
                    "librempeg_tpu/codecs/mpeg4/me_pallas.py:343", "4b",
                    "kernel phase (per-MB forms)"),
    "fsearch": ("librempeg_tpu_torch/csrc/fsearch.cu",
                "librempeg_tpu/ops/pallas/mesearch.py:95", "5",
                "kernel_leg"),
    "residual": ("librempeg_tpu_torch/csrc/residual.cu",
                 "librempeg_tpu/codecs/h264/residual_pallas.py:257", "6",
                 "kernel phase (no path runs it)"),
    # a lax.scan in the JAX package, not a Pallas kernel
    "shape_scan": ("librempeg_tpu_torch/csrc/shape_scan.cu",
                   "librempeg_tpu/resample/dither.py:47", "7",
                   "audio (aresample=48000:dither_method=lipshitz)"),
    # a lax.scan in the JAX package, not a Pallas kernel
    "biquad": ("librempeg_tpu_torch/csrc/biquad.cu",
               "librempeg_tpu/filters/biquads.py:27", "8",
               "filters (F3: the run -af highpass,lowpass,equalizer,bass "
               "in one launch a packet)"),
}
E2E_KERNELS = tuple(n for n, k in KERNELS.items() if k[3] == "e2e")

# the kernel leg (bench.py _leg_kernel)
LEG_BATCH, LEG_H, LEG_W, LEG_DH, LEG_DW, LEG_ITERS = 8, 1088, 1920, 720, 1280, 4
LEG_QSCALE = 4.0
# Bounds against the JAX package's goldens, set from a full-size run of
# the port against the JAX package on a CPU
# (tools/torch_port_goldens_kernel_leg.py --calibrate): MVs equal on
# 1.000000, 0.984826, 0.935139, 0.844896 of blocks at steps 0-3, luma
# recon sample PSNR 67.29, 56.43, 50.43, 47.15 dB. Each step's reference
# is the previous step's recon, so last-bit float differences in the
# scale and DCT flip a few levels at step 0 and then break near-ties of
# later searches (testgen's diagonal ramp matches itself shifted along
# the anti-diagonal). Step 0 sees the same inputs in both packages and
# keeps 99.5%; later steps allow three times the measured share of
# differing MVs. Where MVs differ, the JAX package's MV must cost no
# less than the port's on the port's own inputs (a tie, not a miss).
LEG_MV_FLOOR = (0.995, 0.954, 0.805, 0.534)
LEG_PSNR_DB = 40.0

# the options path (cli: -s 1280x720 -pix_fmt yuvj420p -b:v 4M -g 12
# -bf 2 -trellis 1)
OPTIONS = {"bit_rate": 4_000_000, "gop_size": 12, "max_b_frames": 2,
           "trellis": 1}
OPTIONS_PIX_FMT = "yuvj420p"
# the first yuvj420p frame against the JAX package's stored rows. On a
# CPU the port's frame equals the JAX package's in every sample
# (tools/torch_port_goldens.py --calibrate, CHANGES.md); the card's
# float32 GEMMs sum in another order, so a sample on a rounding
# boundary may move by 1: a floor of 50 dB allows about 0.6% of samples
# off by one
RANGE_PSNR_FLOOR_DB = 50.0
# The options path encodes synchronously, so its rate control sees the
# same bits in every run: every quantiser must equal the JAX package's,
# and the decoded I/P and B PSNR means lie within this of its means.
# The port reads gaps of +0.0038 and +0.0053 dB on a CPU
# (tools/torch_port_goldens.py --check-port) and +0.0047 and +0.0061 on
# an H100. A trellis lambda of 0.95 q^2 in place of 0.85 q^2, planted in
# a copy, reads -0.0207 and +0.0444 dB and changes VOP 26's quantiser;
# a bidirectional prediction rounded down reads +0.0038 and -0.0075 with
# every quantiser equal, and only the CPU tests catch it (PERF.md)
OPTIONS_PSNR_TOL_DB = 0.02

# the audio path (cli: -i in.wav -ar 48000 -c:a aac -b:a 128k out.aac):
# AUDIO_SECONDS of testgen.audio_mix at 44.1 kHz stereo s16, held to
# tests/data/torch_port/audio_aac.npz (tools/torch_port_goldens.py
# --audio); the WAV demuxer's packets hold AUDIO_CHUNK samples
AUDIO_IN_RATE, AUDIO_OUT_RATE = 44100, 48000
AUDIO_SECONDS, AUDIO_AC_SECONDS = 10, 2
AUDIO_BIT_RATE = 128_000
AUDIO_CHUNK = 1024
AUDIO_WIN = 1024           # samples per stored window of the resampled s16
SCAN_N = 4096              # samples per channel of the shape_scan check
# Limits, from the port on a CPU against the goldens
# (tools/torch_port_goldens.py --audio --calibrate / --check-port) and
# faults planted in copies (PERF.md section 6). Resampled s16
# windows: the CPU port differs on 0 samples; a Kaiser beta of 8.5 in
# place of 9 on 3.6% (max |d| 5); the card's GEMM sums in another order,
# which flips about 2e-4 of samples on a CPU at other call sizes. AAC
# bytes: the CPU port's equal the golden's; the rate control holds them
# within 0.005% under both planted faults, so this limit catches only a
# wrong rate. Decoded SNR: the CPU port reads +0.0059 dB; an AAC rate
# loop accepting 0.8-1.2 of the budget in place of 0.85-1.1 reads
# -0.0428, a psy SMR of 28 dB in place of 29 reads -0.1514.
AUDIO_RS_SHARE = 2e-3
AUDIO_BYTES_TOL = 5e-3
AUDIO_SNR_TOL_DB = 0.03
# cycles of one dependent float operation on the SM (the shortest
# pipeline latency): the shape_scan kernel's bound is its serial chain
DEP_OP_CYCLES = 4
# the biquad run's bound: N samples of one stage's chain (4 dependent
# operations each), then one handoff a further stage: the next stage's
# out (one operation) after the round trip of csrc/biquad.cu round_trip
# (its dependent operations per sample format, rintf counted as one)
BIQUAD_CHAIN_OPS = 4
BIQUAD_TRIP_OPS = {"flt": 0, "dbl": 0, "s16": 5, "s32": 4, "u8": 5}
# the graph-API graph whose launches hold a one-stage run on a path
SINGLE_BIQUAD = "lowpass=f=3000"
# the MPEG-4 quantisers' levels on the card against the CPU's
QUANT_QSCALES = (3, 5, 7)

# the JPEG/MJPEG path (the commands of jpeg_commands), held to
# tests/data/torch_port/bench_1080p_mjpeg.npz
# (tools/torch_port_goldens.py --jpeg). Limits from the port on a CPU
# against the goldens (--jpeg --calibrate) and faults planted in copies
# (--jpeg --check-port; PERF.md section 2)
JPEG_GOLD = "bench_1080p_mjpeg.npz"
JPEG_FRAMES, JPEG_THUMBS = 48, 10
JPEG_STORED_Q = 31         # -q:v of the stored frame 0 (quality 4)
JPEG_SIZE_REL = 5e-3       # each packet's bytes against the JAX package's
JPEG_PSNR_TOL_DB = 0.02    # decoded per-plane PSNR means (path A)
JPEG_B_PSNR_TOL_DB = 0.02  # path B's decoded mean
JPEG_SSIM_TOL = 1e-4       # the ssim graph's mean against the JAX package's
METRIC_DEV_DB = 1e-3       # psnr on the card against the CPU
METRIC_DEV_SSIM = 1e-5     # ssim on the card against the CPU

# the filter slice (filters_commands and FILTER_GRAPHS), held to
# tests/data/torch_port/bench_1080p_filters.npz
# (tools/torch_port_goldens.py --filters)
FILTERS_GOLD = "bench_1080p_filters.npz"
F1_VF = ("colorspace=all=bt709:ispace=bt470bg:iprimaries=bt470bg,"
         "eq=contrast=1.1:brightness=0.02:saturation=1.2,gblur=sigma=1.5,"
         "boxblur=2,lutyuv=y=val*0.9+16,drawbox=64:64:320:180:white:t=4,"
         "fade=in:0:12")
F3_AF = ("highpass=f=80,lowpass=f=12000,equalizer=f=3000:g=3:w=1,"
         "bass=g=-2,aecho=0.8:0.5:40:0.3,afade=t=in:d=1")
F4_SECONDS, SINE_SECONDS = 2, 10
FILTER_SAMPLE_FRAMES = (0, 24)   # frames whose sampled rows are stored
# Limits of the float contracts against the JAX package's outputs
# (PERF.md section 2): packet bytes of a constant-qscale MPEG-4 stream
# and its mean in-loop recon PSNR; per plane, the plane-sum gap per
# sample; in sampled rows, the share of samples that differ and the
# largest difference (lut3d's slope can carry a difference of 1 in its
# RGB input to 2)
FILT_BYTES_REL = 5e-3
FILT_PSNR_TOL_DB = 0.02
FILT_SUM_TOL = 1e-3
FILT_SHARE = 1e-3
FILT_LUT_MAX = 2
# F1: frames of the encoder input equal to the JAX package's, at least
FILT_F1_EQUAL = 40
# the graphs fed by scale=960:544 (scaled_graph_checks). Each output
# must equal the port's own scaled frames stacked or tiled, exactly.
# Each scaled sample, and against the JAX package's outputs each sampled
# sample, may differ only by 1 and only at a tie: where its exact value
# (float64 through the JAX package's resize matrices, stored with the
# goldens) lies within FILT_TIE of k + 0.5. The asset's flat areas put
# many samples on ties of the 2:1 resize (tools/torch_port_goldens.py
# --filters prints how many), and there a float32 GEMM, whose error here
# stays under 4e-4 (eight taps a pass, two passes, sums below 330),
# picks the side by its summation order: the JAX package's own float32
# and the exact rounding part on many of them. Each plane sum may move
# by at most its plane's count of ties.
FILTER_SCALED_GRAPHS = ("hstack", "vstack", "tile")
FILT_TIE = 1e-3


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


def device_ms(fn, restore=None, runs: int = RUNS, warm: int = 3) -> float:
    """Median device time of fn() in ms over `runs` calls after `warm`
    warm-up calls: a CUDA event pair around each call, recorded behind
    a sleep of the stream, so the interval holds only the call's device
    work; restore() (untimed) runs before each call."""
    import torch

    pairs = []
    for i in range(warm + runs):
        if restore is not None:
            restore()
        torch.cuda._sleep(SLEEP_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        if i >= warm:
            pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def device_ms_b2b(fn, prepare=None, runs: int = RUNS, windows: int = 3,
                  warm: int = 3) -> float:
    """Device time of one call of fn() in ms without the launch floor:
    the median over `windows` windows of `runs` calls issued back to
    back between one event pair, behind one long sleep of the stream,
    divided by `runs`. Whatever fn launches (a fill, a copy) is in the
    window. The sleep must outlast the host's issue of the calls: if the
    card has reached the first event when the last call is issued, the
    host set the pace, and the run fails. Kernels that write their
    inputs take prepare(), which makes one call's inputs, and fn(inputs);
    a window's `runs` inputs are made before its sleep."""
    import torch

    for _ in range(warm):
        fn() if prepare is None else fn(prepare())
    per = []
    for _ in range(windows):
        ins = None if prepare is None else [prepare() for _ in range(runs)]
        torch.cuda.synchronize()
        torch.cuda._sleep(B2B_SLEEP_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for i in range(runs):
            fn() if ins is None else fn(ins[i])
        e1.record()
        check(not e0.query(), "device_ms_b2b: the card reached the first "
              "event before the host had issued the last call")
        torch.cuda.synchronize()
        per.append(e0.elapsed_time(e1) / runs)
    return statistics.median(per)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved: int, ops: float) -> dict:
    """The least time the card could take: the bytes moved (each input
    read once, each output written once) at the HBM rate, or the
    operations at the float32 rate, whichever is longer."""
    tb = moved / HBM_BYTES_S * 1e3
    to = ops / F32_OPS_S * 1e3
    return {"bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "bytes": moved, "ops": ops, "library_ms": None,
            "library_note": NO_LIBRARY}


def floor_ms() -> dict:
    """device_ms and device_ms_b2b of an empty kernel (a stream sleep of
    0 cycles): what each timing gives for a launch that does no work."""
    import torch

    def empty():
        torch.cuda._sleep(0)
    return {"device_ms": device_ms(empty),
            "device_ms_b2b": device_ms_b2b(empty)}


def timed(fn, restore=None, inplace=None) -> dict:
    """Wall ms (host clock around a synchronise, wrapper included),
    device ms and back-to-back device ms of fn(); a kernel that writes
    its inputs passes inplace = (prepare, run) for the back-to-back run
    (device_ms_b2b)."""
    b2b = device_ms_b2b(fn) if inplace is None else device_ms_b2b(
        inplace[1], inplace[0])
    return {"ms": median_ms(fn, restore), "device_ms": device_ms(fn, restore),
            "device_ms_b2b": b2b}


def mc_read_bytes(luma4, upad, vpad, mv, ref, mb_w: int) -> int:
    """The reference bytes the MC must read for this motion field, each
    counted once over the frame (the index math of device_recon._mc):
    the luma4 samples under each 4x4 block's two quarter-pel taps (one
    plane at full-pel positions), and the U and V samples under each 2x2
    chroma block's bilinear taps of non-zero weight (2x2 at integer
    positions, up to 3x3)."""
    import torch

    from librempeg_tpu_torch.codecs.h264 import device_recon as DR

    dev, nmb = luma4.device, mv.shape[0]
    nref, _, hp, wp = luma4.shape
    hc, wc = upad.shape[1:]
    mb = torch.arange(nmb, device=dev)[:, None]
    b = torch.arange(16, device=dev)
    ys = (mb // mb_w * 16 + b // 4 * 4).reshape(-1)
    xs = (mb % mb_w * 16 + b % 4 * 4).reshape(-1)
    mvx, mvy = (mv[:, :, i].reshape(-1).long() for i in (0, 1))
    r = ref.long()[:, b // 8 * 2 + b % 4 // 2].reshape(-1).clamp(0, nref - 1)
    qm = torch.as_tensor(DR._QM, device=dev).long()[(mvy & 3) * 4 + (mvx & 3)]
    iy = (ys + (mvy >> 2) + DR.PAD).clamp(3, hp - 8)
    ix = (xs + (mvx >> 2) + DR.PAD).clamp(3, wp - 8)
    k = torch.arange(4, device=dev)
    luma = torch.cat([
        (((r * 4 + qm[:, p])[:, None, None] * hp
          + (iy + qm[:, p + 1])[:, None, None] + k[:, None]) * wp
         + (ix + qm[:, p + 2])[:, None, None] + k).reshape(-1)
        for p in (0, 3)]).unique().numel()
    cy = (ys // 2 + (mvy >> 3) + DR.PADC).clamp(0, hc - 4)[:, None, None]
    cx = (xs // 2 + (mvx >> 3) + DR.PADC).clamp(0, wc - 4)[:, None, None]
    k = torch.arange(3, device=dev)
    need = (((k < 2)[:, None] | ((mvy & 7) != 0)[:, None, None])
            & ((k < 2) | ((mvx & 7) != 0)[:, None, None]))
    addr = ((r[:, None, None] * hc + cy + k[:, None]) * wc + cx + k)
    return luma + 2 * addr[need].unique().numel()


def launch_check(runs: dict) -> dict:
    """Kernel launches on the card in one torch.profiler window (a second
    window in one process may record no device events) over runs
    {name: run}, called in turn: each call must be one launch of the
    kernel `name` and nothing else (the deblock's scratch is made once
    per stream, and an epoch in each call spares a fill; the intra
    kernel keeps its state in shared memory; mc and hpel allocate their
    outputs and launch one kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof

    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        # a window's first device event can go unrecorded: open it with
        # a short sleep kernel, and drop that kernel from the record
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for run in runs.values():
            run()
            torch.cuda.synchronize()
    names = [e.name for e in p.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "spin_kernel" not in e.name]
    check(len(names) == len(runs), f"launches on the card: {names}")
    for name in runs:
        check(sum(name in n for n in names) == 1,
              f"{name} launches on the card: {names}")
    return {name: {"kernels": 1, "other": 0} for name in runs}


def max_abs_err(got, want) -> float:
    err = 0.0
    for a, b in zip(got, want):
        check(a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape))
        if a.numel():
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


def hpel_inputs(dev, frames):
    """The half-pel kernels' inputs on the bench path: the encoder's
    recon of its first I-VOP (the bench settings) as the reference, the
    next scaled frame as the current picture, and the encoder's integer
    MVs -> (cur, ref_y, ref_u, ref_v, mv_i)."""
    import torch

    from librempeg_tpu_torch.codecs.mpeg4 import encoder as ME
    from librempeg_tpu_torch.ops import motion
    from librempeg_tpu_torch.scale import get_scaler

    sc = get_scaler("yuv420p", frames[0].width, frames[0].height, "yuv420p",
                    1280, 720)
    enc = ME.Mpeg4Encoder(width=1280, height=720, bit_rate=4_000_000,
                          device=dev)
    enc.encode(sc.scale_frame(frames[0]))
    ry, ru, rv = enc._ref
    cur = sc.scale_planes(frames[1].planes)[0].to(torch.float32)
    mv_i = motion.full_search_mc_xla(cur[None], ry[None], 8, 16, 2)[0][0]
    return cur, ry, ru, rv, mv_i


def launches_of(name: str, run) -> int:
    """Launches of kernel `name` in one call of run() (the per-MB forms
    and the residual kernel, which no path runs)."""
    from librempeg_tpu_torch import kernels

    kernels.reset_counts()
    run()
    n = kernels.counts()[name]
    check(n == 1, f"{name} kernel launches: {n}")
    return n


def kernel_phases(dev) -> dict:
    import torch

    from librempeg_tpu_torch.codecs.h264 import deblock_pallas as DP
    from librempeg_tpu_torch.codecs.h264 import device_recon as DR
    from librempeg_tpu_torch.codecs.h264 import intra_pallas as IP
    from librempeg_tpu_torch.codecs.h264 import mc_pallas as MC
    from librempeg_tpu_torch.codecs.h264 import residual_pallas as RP
    from librempeg_tpu_torch.codecs.mpeg4 import me_pallas as MEP
    from librempeg_tpu_torch.kernels import deblock as KD
    from librempeg_tpu_torch.kernels import hpel as KH
    from librempeg_tpu_torch.kernels import intra as KI
    from librempeg_tpu_torch.kernels import mc as KM

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
    nmb = mb_w * mb_h
    res["mc"] = {"max_abs_err": err,
                 **timed(lambda: MC.mc_predict(*margs)),
                 "plain_ms": median_ms(lambda: MC.mc_predict_plain(*margs)),
                 # the reference samples the motion field reads, the
                 # MVs, refs and predictions; a 6-tap FIR in each
                 # direction plus the quarter-pel average, about 30
                 # operations per luma sample; 8 per chroma sample
                 # (bilinear)
                 **bound(mc_read_bytes(*margs[:5], mb_w)
                         + nbytes(mv, ref, *got),
                         nmb * (256 * 30 + 128 * 8)),
                 "shape": f"{nmb} MBs, {luma4.shape[0]} ref"}

    # intra: the frame's intra MBs over its residual-added planes
    y, u, v, lres_t, cres_t = DR.recon_p_frame_pred_noscan(
        *got, idx, vals, qp, kind, mb_w, mb_h, cqo, fold_i16=True)
    scal = IP.build_intra_scalars(ilist, kind, info, i4m, mb_w, mb_h)
    want = IP.intra_scan_plain(y, u, v, scal, lres_t, cres_t, mb_w, mb_h)
    iwork = [p.clone() for p in (y, u, v)]
    got = IP.intra_scan_pallas(*iwork, scal, lres_t, cres_t, mb_w, mb_h)
    err = max_abs_err(got, want)
    check(err == 0, f"intra kernel differs from its plain version: {err}")

    def restore_intra():
        for w_, p in zip(iwork, (y, u, v)):
            w_.copy_(p)

    n_intra = ilist.numel()
    n_i4 = int((kind[ilist.long()] == 2).sum())
    steps = IP.dependent_steps(ilist.tolist(), mb_w)

    def run_intra(planes=iwork):
        KI.launch(*planes, scal, lres_t, cres_t, mb_w, mb_h)

    def fresh_planes(src=(y, u, v)):
        return [p.clone() for p in src]

    res["intra"] = {
        "max_abs_err": err,
        **timed(run_intra, restore_intra, (fresh_planes, run_intra)),
        "plain_ms": median_ms(lambda: IP.intra_scan_plain(
            y, u, v, scal, lres_t, cres_t, mb_w, mb_h)),
        # per intra MB: its 384 samples written, about 75 neighbour
        # samples read, its int32 residuals (16x16 + 2x8x8) read; about
        # 10 operations per sample (prediction, residual add, clip)
        **bound(n_intra * (384 + 75 + 4 * 384), n_intra * 384 * 10),
        "steps": steps,
        "shape": f"{n_intra} intra MBs of {mb_w * mb_h} ({n_intra - n_i4} "
                 f"I16x16, {n_i4} I4x4), a dependence chain of {steps} MB "
                 f"steps"}

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

    def run_db(planes=work):
        KD.launch(*planes, P, mb_w, mb_h)

    def fresh_db(src=(y, u, v)):
        return [p.clone() for p in src]

    res["deblock"] = {
        "max_abs_err": err,
        **timed(run_db, restore_db, (fresh_db, run_db)),
        "params_ms": median_ms(lambda: DP.deblock_params(
            idx, vals, mv, ref, qp, kind, mb_w, mb_h, cqo, ao, bo)),
        "plain_ms": median_ms(lambda: DR.deblock_frame(
            y, u, v, idx, vals, mv, ref, qp, kind, mb_w, mb_h, cqo, ao, bo)),
        # planes read and written once, the packed parameters read once;
        # per MB 192 line filters (8 luma edges x 16 lines, 2 x 4 chroma
        # edges x 8 lines) of about 30 operations
        **bound(2 * nbytes(y, u, v) + nbytes(P), nmb * 192 * 30),
        "shape": f"{mb_w}x{mb_h} MBs, one launch, a dependence chain of "
                 f"{mb_w + 2 * mb_h - 2} MB steps"}

    hargs = hpel_inputs(dev, frames)
    cur, ry, ru, rv, mv_i = hargs
    got = MEP.hpel_refine_mc(*hargs)
    err = max_abs_err(got, MEP.hpel_refine_mc_plain(*hargs))
    check(err == 0, f"hpel kernel differs from its plain version: {err}")
    res["hpel"] = {
        "max_abs_err": err,
        **timed(lambda: MEP.hpel_refine_mc(*hargs)),
        "plain_ms": median_ms(lambda: MEP.hpel_refine_mc_plain(*hargs)),
        # the luma and the chroma together: 25 half-pel candidates per
        # MB, each sample an interpolation (3 operations) and a SAD term
        # (3); bilinear chroma, about 8 operations per sample
        **bound(nbytes(*hargs, *got), cur.numel() * 25 * 6
                + 2 * ru.numel() * 8),
        "shape": "1280x720, 3600 MBs, luma and chroma"}
    mv_h = got[0]

    # the per-MB forms: the two halves on their own
    largs = (cur, ry, mv_i)
    got = MEP.refine_mc_luma(*largs)
    err = max_abs_err(got, MEP.refine_mc_luma_plain(*largs))
    check(err == 0, f"hpel luma kernel differs from its plain version: "
          f"{err}")
    res["hpel_luma"] = {
        "max_abs_err": err,
        "launches": launches_of("hpel_luma",
                                lambda: MEP.refine_mc_luma(*largs)),
        **timed(lambda: MEP.refine_mc_luma(*largs)),
        "plain_ms": median_ms(lambda: MEP.refine_mc_luma_plain(*largs)),
        # 25 half-pel candidates per MB, each sample an interpolation (3
        # operations) and a SAD term (3)
        **bound(nbytes(*largs, *got), cur.numel() * 25 * 6),
        "shape": "1280x720, 3600 MBs"}
    cargs = (ru, rv, mv_h)
    err = max_abs_err(MEP.mc_chroma(*cargs), MEP.mc_chroma_plain(*cargs))
    check(err == 0, f"hpel chroma kernel differs from its plain version: "
          f"{err}")
    res["hpel_chroma"] = {
        "max_abs_err": err,
        "launches": launches_of("hpel_chroma",
                                lambda: MEP.mc_chroma(*cargs)),
        **timed(lambda: MEP.mc_chroma(*cargs)),
        "plain_ms": median_ms(lambda: MEP.mc_chroma_plain(*cargs)),
        # bilinear interpolation, about 8 operations per output sample
        **bound(nbytes(*cargs) + 2 * nbytes(ru), 2 * ru.numel() * 8),
        "shape": "2x 640x360, 3600 MBs"}

    # residual: the P frame's coefficients as compact rows (no window:
    # the JAX package's packer cannot take this frame)
    coeffs = DR.dense_coeffs(idx, vals, nmb)
    host = (coeffs.cpu().numpy(), qp.cpu().numpy(), kind.cpu().numpy(),
            cqo, mb_w, mb_h)
    windowed = RP.pack_residual_host(*host)[2]
    ids, levels = RP.compact_rows(*host)
    packed = torch.from_numpy(RP.pack_rows(ids, levels)).to(dev)
    got = RP.expand_residual(packed, None, nmb)
    launches = launches_of("residual",
                           lambda: RP.expand_residual(packed, None, nmb))
    err = max_abs_err([got], [RP.expand_residual_plain(packed, nmb)])
    check(err == 0, f"residual kernel differs from its plain version: {err}")
    lres, cres = DR._residuals(coeffs, qp, cqo, nmb, is_i16=kind == 3)
    want = RP.spatial_from_residuals(lres, cres).to(torch.float32)
    err_dr = max_abs_err([got[:nmb]], [want])
    check(err_dr == 0, f"residual kernel differs from device_recon."
          f"_residuals: {err_dr}")
    res["residual"] = {
        "max_abs_err": err, "launches": launches,
        **timed(lambda: RP.expand_residual(packed, None, nmb)),
        "plain_ms": median_ms(lambda: RP.expand_residual_plain(packed,
                                                               nmb)),
        # the packed rows read, the dense output written (each float
        # once, zeros included); per row a dequantised 4x4 butterfly,
        # about 96 operations
        **bound(nbytes(packed, got), len(ids) * 96),
        "shape": f"{len(ids)} rows, {nmb} MBs (the JAX packer's 512-row "
                 f"window {'holds' if windowed else 'overflows'})"}
    restore_db()
    restore_intra()
    checked = launch_check({
        "intra": run_intra,
        "deblock": lambda: KD.launch(*work, P, mb_w, mb_h),
        "mc": lambda: KM.launch(*margs),
        "hpel": lambda: KH.launch(*hargs),
        "residual": lambda: RP.expand_residual(packed, None, nmb)})
    for name, c in checked.items():
        res[name]["launch_check"] = c

    return res


def leg_inputs(dev):
    """bench.py's kernel-leg inputs (the same numpy as
    tools/torch_port_goldens_kernel_leg.py): 8 testgen frames and the
    seed-0 random first reference, float32 on `dev`."""
    import numpy as np
    import torch

    from librempeg_tpu_torch.utils import testgen

    planes = [testgen.video_yuv420(LEG_W, LEG_H, i)
              for i in range(LEG_BATCH)]
    y, u, v = (torch.from_numpy(np.stack(p).astype(np.float32)).to(dev)
               for p in zip(*planes))
    ref = np.random.default_rng(0).integers(0, 256, (LEG_BATCH, LEG_DH,
                                                     LEG_DW))
    return y, u, v, torch.from_numpy(ref.astype(np.float32)).to(dev)


def fsearch_phase(dev, leg) -> dict:
    """The full search at the kernel leg's first step: the scaled luma
    against the random reference, r = 4. (a) cur rounded to integers:
    bit-exact. (b) the real float cur: the kernel sums each block in
    another order than the plain version, so MVs equal on >= 99.9% of
    blocks, costs within 1e-5 relative and pred equal where MVs are."""
    from librempeg_tpu_torch.ops.pallas import mesearch as MS
    from librempeg_tpu_torch.parallel import pipeline as PP

    y, _, _, ref = leg
    cur = PP.resize_clip(y, LEG_DH, LEG_DW)
    cur_i = cur.round()
    err = max_abs_err(MS.full_search_mc(cur_i, ref, 4),
                      MS.full_search_mc_plain(cur_i, ref, 4))
    check(err == 0, f"fsearch kernel differs from its plain version on "
          f"integer inputs: {err}")
    (gm, gc, gp), (wm, wc, wp) = (MS.full_search_mc(cur, ref, 4),
                                  MS.full_search_mc_plain(cur, ref, 4))
    same = (gm == wm).all(-1)
    share = float(same.float().mean())
    rel = float(((gc - wc).abs() / wc.clamp(min=1.0))[same].max())
    bs = 16
    pix = same.repeat_interleave(bs, 1).repeat_interleave(bs, 2)
    pred_ok = bool((gp == wp)[pix].all())
    check(share >= 0.999 and rel <= 1e-5 and pred_ok,
          f"fsearch on float inputs: MVs equal on {share}, cost rel err "
          f"{rel}, pred equal where MVs are: {pred_ok}")
    nmb = LEG_BATCH * (LEG_DH // 16) * (LEG_DW // 16)
    return {"max_abs_err": err, "float_mv_equal": share,
            "float_cost_rel_err": rel,
            **timed(lambda: MS.full_search_mc(cur, ref, 4)),
            "plain_ms": median_ms(lambda: MS.full_search_mc_plain(cur, ref,
                                                                  4)),
            # 81 candidates x 256 samples, a subtract, an absolute value
            # and an add each
            **bound(nbytes(cur, ref, gm, gc, gp), nmb * 81 * 256 * 3),
            "shape": f"{LEG_BATCH}x{LEG_DH}x{LEG_DW}, r=4, "
                     f"{LEG_BATCH * (LEG_DH // 16) * (LEG_DW // 16)} MBs"}


def block_cost(cur, ref, mv, r: int = 4):
    """The full search's cost of each block at the given MVs."""
    import torch

    from librempeg_tpu_torch.ops import motion

    n, h, w = cur.shape
    ref_pad = motion._edge_pad(ref, r, r).to(torch.bfloat16)
    by = (torch.arange(h // 16, device=cur.device) * 16)[None, :, None]
    bx = (torch.arange(w // 16, device=cur.device) * 16)[None, None, :]
    win = motion._gather_windows(ref_pad, by + mv[..., 0] + r,
                                 bx + mv[..., 1] + r, 16)
    curb = cur.to(torch.bfloat16).reshape(n, h // 16, 16, w // 16, 16) \
        .permute(0, 1, 3, 2, 4)
    return (curb - win).abs().to(torch.float32).sum(dim=(-2, -1))


def psnr_db(a, b) -> float:
    d = a.double() - b.double()
    mse = float((d * d).mean())
    return float("inf") if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def kernel_leg_phase(dev, leg, profile_dir: str | None) -> dict:
    """The kernel leg's 4 chained steps, held to the JAX package's
    goldens, with the launch counters reset before them; then one warm
    pass timed, and with --profile one more under torch.profiler."""
    import numpy as np
    import torch

    from librempeg_tpu_torch import kernels
    from librempeg_tpu_torch.parallel import pipeline as PP
    from librempeg_tpu_torch.parallel import transcode_step

    gold = np.load(os.path.join(GOLD, "kernel_leg.npz"))
    off, rs, cs = (int(x) for x in gold["sample"])
    y, u, v, ref = leg
    cur = PP.resize_clip(y, LEG_DH, LEG_DW)
    nblk = LEG_BATCH * (LEG_DH // 16) * (LEG_DW // 16)
    kernels.reset_counts()
    steps = []
    for step in range(LEG_ITERS):
        out = transcode_step(y, u, v, ref, LEG_DH, LEG_DW, LEG_QSCALE)
        steps.append((ref, out))
        ref = out["y"]
    torch.cuda.synchronize()
    counts = kernels.counts()
    check(counts["fsearch"] == LEG_ITERS,
          f"fsearch launches on the kernel leg: {counts['fsearch']}")
    res = {"launches": counts, "mv_equal": [], "psnr_db": [],
           "tie_excess_max": []}
    for step, (prev, out) in enumerate(steps):
        mv = out["mv"]
        check(tuple(mv.shape) == (LEG_BATCH, LEG_DH // 16, LEG_DW // 16, 2)
              and tuple(out["y"].shape) == (LEG_BATCH, LEG_DH, LEG_DW),
              (step, mv.shape, out["y"].shape))
        for k in ("y", "u", "v", "levels_y", "levels_u", "levels_v"):
            check(bool(torch.isfinite(out[k]).all()), (step, k, "finite"))
        jmv = torch.from_numpy(gold["mv"][step].astype(np.int32)).to(dev)
        same = (mv == jmv).all(-1)
        share = float(same.float().mean())
        smp = out["y"][:, off::rs, off::cs]
        p = psnr_db(smp, torch.from_numpy(
            gold["y_sample"][step].astype(np.float32)).to(dev))
        pc, jc = block_cost(cur, prev, mv), block_cost(cur, prev, jmv)
        excess = float((pc - jc).max())
        check(share >= LEG_MV_FLOOR[step],
              f"kernel leg step {step}: MVs equal the JAX package's on "
              f"{share} of {nblk} blocks (< {LEG_MV_FLOOR[step]})")
        check(p >= LEG_PSNR_DB, f"kernel leg step {step}: luma recon PSNR "
              f"{p} dB against the JAX package's")
        check(bool((jc >= pc * (1 - 1e-5)).all()),
              f"kernel leg step {step}: the JAX package's MV beats the "
              f"port's on some block by {excess}")
        res["mv_equal"].append(share)
        res["psnr_db"].append(p)
        res["tie_excess_max"].append(excess)
    del steps

    def chained():
        ref = leg[3]
        for _ in range(LEG_ITERS):
            ref = transcode_step(y, u, v, ref, LEG_DH, LEG_DW,
                                 LEG_QSCALE)["y"]
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chained()
    dt = time.perf_counter() - t0
    res["fps"] = LEG_BATCH * LEG_ITERS / dt
    res["wall_s"] = dt
    if profile_dir is not None:
        res["profile"] = profile_window(chained, os.path.join(
            profile_dir, "chip_smoke_profile_kernel_leg.txt"))
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
    qs = []
    enc_async = chain.encoder.encode_async

    def encode_async(frame, **kw):
        h = enc_async(frame, **kw)
        qs.append(h["q"])
        return h

    chain.encoder.encode_async = encode_async
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
    gq, gp = gold["qscale"], gold["recon_psnr_db"]
    log("slice per frame: recon PSNR port / JAX (dB), quantiser port / JAX")
    for i, (p, q) in enumerate(zip(psnr, qs)):
        log(f"  {i:2d} {types[i]} {p:.4f} / {gp[i]:.4f}  q {q} / {gq[i]}")
    first_q = next((i for i, (a, b) in enumerate(zip(qs, gq)) if a != b),
                   None)
    first_p = next((i for i, (a, b) in enumerate(zip(psnr, gp))
                    if abs(a - b) > 0.01), None)
    log(f"slice: first frame whose quantiser differs from the JAX "
        f"package's: {first_q}; first frame whose recon PSNR differs by "
        f"more than 0.01 dB: {first_p}")
    missing = [k for k in E2E_KERNELS if counts[k] <= 0]
    check(not missing, f"kernels not launched on the e2e path: {missing}")
    check(counts["hpel"] == types.count("P") and counts["hpel_luma"] == 0
          and counts["hpel_chroma"] == 0,
          f"half-pel launches on the e2e path: {counts}")
    return {"frames": stats["frames"][0], "packets": len(pkts),
            "vop_types": types, "mean_recon_psnr_db": mean,
            "jax_mean_recon_psnr_db": gmean, "launches": counts,
            "first_q_diff": first_q, "first_psnr_diff": first_p,
            "wall_s": dt, "avi_bytes": os.path.getsize(out_avi),
            "peak_device_mib": peak / 2 ** 20}


def profile_window(run, table_path: str) -> dict:
    """Run run() (which ends in a synchronise) under torch.profiler;
    write the table of device time by name to table_path and return the
    window's wall time, device busy time and device idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof

    os.makedirs(os.path.dirname(table_path), exist_ok=True)
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    ka = p.key_averages()
    # device-side events only (kernels, copies): the operator rows
    # repeat the time of the kernels they launched
    dev_us = sum(e.self_device_time_total for e in ka
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    with open(table_path, "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=40))
    return {"wall_ms": wall * 1e3, "device_busy_ms": dev_us / 1e3,
            "device_idle_share": 1 - dev_us / 1e3 / (wall * 1e3)}


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
        def frames():
            for _ in range(8):
                chain.send_packet(next(it), tc.mux)
            chain.sync()

        out["profile_8_frames"] = profile_window(
            frames, os.path.join(profile_dir, "chip_smoke_profile.txt"))
    for pkt in it:
        chain.send_packet(pkt, tc.mux)
    chain.finish(tc.mux)
    tc.mux.close()
    tc.demux.close()
    torch.cuda.synchronize()
    return out


def planes_psnr_db(a, b) -> float:
    """psnr_db over all samples of the numpy planes in a and b."""
    import numpy as np
    import torch

    def flat(planes):
        return torch.from_numpy(np.concatenate(
            [np.asarray(p, np.float64).ravel() for p in planes]))

    return psnr_db(flat(a), flat(b))


def options_spec(dev, out_avi: str):
    from librempeg_tpu_torch.sched.pipeline import (
        StreamMap,
        TranscodeSpec,
    )

    return TranscodeSpec(
        input_url=ASSET, output_url=out_avi, device=dev,
        video=StreamMap(codec="mpeg4", codec_opts=dict(OPTIONS), width=1280,
                        height=720, pix_fmt=OPTIONS_PIX_FMT))


def options_phase(dev, out_avi: str) -> dict:
    """The options path once, checked, with the launch counters reset
    before it and the B-VOP pass and the trellis quantiser timed (a
    synchronise around each); then once more unhooked for the rate and
    stage split."""
    import numpy as np
    import torch

    from librempeg_tpu_torch import kernels
    from librempeg_tpu_torch.codecs.mpeg4 import encoder as ME
    from librempeg_tpu_torch.codecs.mpeg4 import trellis as RD
    from librempeg_tpu_torch.codecs.mpeg4._decoder import Mpeg4Decoder
    from librempeg_tpu_torch.formats.api import open_input
    from librempeg_tpu_torch.sched.pipeline import Transcoder
    from librempeg_tpu_torch.utils import stagetimer

    gold = np.load(os.path.join(GOLD, "bench_1080p_options.npz"))
    gold_md5 = open(os.path.join(GOLD, "bench_1080p_frames.md5")).read() \
        .split()
    tc = Transcoder(options_spec(dev, out_avi))
    chain = tc.chains[0]
    md5s, inputs, written, vops = [], [], [], []
    b_ms, rd_ms = [], []
    dec_decode, dec_flush = chain.decoder.decode, chain.decoder.flush
    enc_encode, mux_write = chain.encoder.encode, tc.mux.write
    packer_vop = ME._Mpeg4Packer.vop
    b_device, quantize_rd = ME._encode_b_device, RD.quantize_rd

    def decode(pkt):
        fs = dec_decode(pkt)
        md5s.extend(frame_md5(f.planes) for f in fs)
        return fs

    def flush():
        fs = dec_flush()
        md5s.extend(frame_md5(f.planes) for f in fs)
        return fs

    def encode(frame):
        check(frame.format == OPTIONS_PIX_FMT, frame.format)
        inputs.append(tuple(p.cpu().numpy() for p in frame.planes))
        return enc_encode(frame)

    def write(pkt):
        written.append((pkt.pts, pkt.dts, vop_type(bytes(pkt.data))))
        return mux_write(pkt)

    def vop(self, bw, coding_type, frame_idx, qscale=None):
        vops.append(("IPB"[coding_type], frame_idx, qscale))
        return packer_vop(self, bw, coding_type, frame_idx, qscale)

    def timed_call(fn, into):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    chain.decoder.decode, chain.decoder.flush = decode, flush
    chain.encoder.encode, tc.mux.write = encode, write
    refs = {}
    keep_references(chain.encoder, refs)
    ME._Mpeg4Packer.vop = vop
    ME._encode_b_device = timed_call(b_device, b_ms)
    RD.quantize_rd = timed_call(quantize_rd, rd_ms)
    kernels.reset_counts()
    try:
        t0 = time.perf_counter()
        tc.run()
        wall_checked = time.perf_counter() - t0
        counts = kernels.counts()
    finally:
        ME._Mpeg4Packer.vop = packer_vop
        ME._encode_b_device, RD.quantize_rd = b_device, quantize_rd

    bad = [i for i, (a, b) in enumerate(zip(md5s, gold_md5)) if a != b]
    check(len(md5s) == 48 and not bad,
          f"options: decoded frames differ from the JAX package's: "
          f"{len(md5s)} frames, {bad}")
    types = "".join(t for _, _, t in written)
    gtypes = str(gold["vop_types"])
    check(len(written) == 48, f"options: {len(written)} packets")
    check(types == gtypes, f"options: VOP types {types} (JAX {gtypes})")
    check(types == "".join(vop_type(p) for p in avi_payloads(out_avi)),
          "options: the AVI's VOP types differ from the packets written")
    dts = [d for _, d, _ in written]
    pts = [p for p, _, _ in written]
    check(all(b > a for a, b in zip(dts, dts[1:])), f"options: dts {dts}")
    check(sorted(pts) == list(range(48)), f"options: pts {pts}")
    check(pts == gold["pts"].tolist() and dts == gold["dts"].tolist(),
          "options: pts/dts differ from the JAX package's")

    # the range conversion: the first yuvj420p frame at the encoder
    off, rs = (int(x) for x in gold["sample"])
    first = inputs[0]
    jrows = [gold[f"{c}_sample"] for c in "yuv"]
    rows = [p[off::rs] for p in first]
    d = np.concatenate([np.abs(a.astype(np.int32) - b).ravel()
                        for a, b in zip(rows, jrows)])
    range_share = float(np.count_nonzero(d) / d.size)
    range_psnr = planes_psnr_db(rows, jrows)
    check(range_psnr >= RANGE_PSNR_FLOOR_DB,
          f"options: first yuvj420p frame {range_psnr} dB against the JAX "
          f"package's rows (floor {RANGE_PSNR_FLOOR_DB})")

    # decoded quality: the vendored decoder over the AVI's 48 VOPs, each
    # frame against the port's own encoder input
    t0 = time.perf_counter()
    dec = Mpeg4Decoder(device=None)  # host numpy planes
    demux = open_input(out_avi)
    decoded = [f for pk in demux.packets() for f in dec.decode(pk)]
    decoded += dec.flush()
    demux.close()
    decode_s = time.perf_counter() - t0
    check(len(decoded) == 48, f"options: {len(decoded)} decoded frames")
    # the decoder rebuilds each I/P-VOP's reference exactly
    bad = same_pictures(decoded, refs)
    check(len(refs) == types.count("I") + types.count("P") and bad == [],
          f"options: {len(refs)} references; the decoder's pictures that "
          f"are not the encoder's: {bad}")
    psnr = [planes_psnr_db(a, f.planes) for a, f in zip(inputs, decoded)]
    disp = {i: t for t, i, _ in vops}
    gpsnr = gold["decoded_psnr_db"].tolist()
    mean = {}
    for kind, pick in (("ip", lambda t: t != "B"), ("b", lambda t: t == "B")):
        idx = [i for i in range(48) if pick(disp[i])]
        mean[kind] = (statistics.fmean(psnr[i] for i in idx),
                      statistics.fmean(gpsnr[i] for i in idx))
        check(abs(mean[kind][0] - mean[kind][1]) <= OPTIONS_PSNR_TOL_DB,
              f"options: decoded {kind} PSNR mean {mean[kind]} (limit "
              f"{OPTIONS_PSNR_TOL_DB} dB)")
    log("options per frame (display order): type, decoded PSNR port / JAX "
        "(dB), quantiser port / JAX")
    pq = {i: q for _, i, q in vops}
    gq = {i: int(q) for (_, i, _), q in zip(vops, gold["qscale"])}
    for i in range(48):
        log(f"  {i:2d} {disp[i]} {psnr[i]:.4f} / {gpsnr[i]:.4f}  q {pq[i]} / "
            f"{gq[i]}")
    qs = [q for _, _, q in vops]
    first_q = next((k for k, (a, b) in enumerate(zip(qs, gold["qscale"]))
                    if a != b), None)
    check(len(qs) == 48 and first_q is None,
          f"options: VOP {first_q} (coding order) is the first whose "
          f"quantiser differs from the JAX package's")

    n_pvop = types.count("P")
    check(len(rd_ms) == types.count("I") + n_pvop,
          f"options: {len(rd_ms)} trellis calls for {types.count('I')} "
          f"I- and {n_pvop} P-VOPs (one per frame)")
    check(counts["mc"] == counts["intra"] == counts["deblock"] == 44,
          f"options: H.264 kernel launches {counts}")
    check(counts["hpel"] == n_pvop and counts["hpel_luma"] == 0
          and counts["hpel_chroma"] == 0,
          f"options: half-pel launches {counts} for {n_pvop} P-VOPs")

    # the rate and stage split, unhooked
    stagetimer.reset()
    tc2 = Transcoder(options_spec(dev, out_avi + ".2.avi"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tc2.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"frames": 48, "vop_types": types, "launches": counts,
            "range_share_differ": range_share, "range_psnr_db": range_psnr,
            "decoded_psnr_ip_db": mean["ip"], "decoded_psnr_b_db": mean["b"],
            "psnr_db": psnr, "jax_psnr_db": gpsnr, "first_q_diff": first_q,
            "fps": 48 / wall, "wall_s": wall, "checked_wall_s": wall_checked,
            "split_s": {k: v["s"] for k, v in stagetimer.report().items()},
            "b_pass_ms": statistics.median(b_ms), "b_passes": len(b_ms),
            "trellis_frame_ms": statistics.median(rd_ms),
            "trellis_frames": len(rd_ms), "decode_check_s": decode_s}


# -- the audio path ----------------------------------------------------------

def sync(dev) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def write_audio_wav(path: str, seconds: int):
    """testgen.audio_mix at 44.1 kHz stereo as s16, written as a WAV by
    the port's muxer; returns the [2, n] int16 samples."""
    import numpy as np

    from librempeg_tpu_torch.core.packet import Packet
    from librempeg_tpu_torch.formats import api as FA
    from librempeg_tpu_torch.utils import testgen

    x = testgen.s16(testgen.audio_mix(AUDIO_IN_RATE, AUDIO_IN_RATE * seconds))
    mux = FA.open_output(path)
    mux.add_stream(FA.CodecParameters(
        codec_type="audio", codec_id="pcm_s16le", sample_rate=AUDIO_IN_RATE,
        nb_channels=2))
    mux.write(Packet(data=np.ascontiguousarray(x.T).tobytes(), pts=0))
    mux.close()
    return x


def read_wav(path: str):
    """(rate, [channels, n] int16) of a pcm_s16le WAV."""
    import numpy as np

    from librempeg_tpu_torch.formats.api import open_input

    d = open_input(path)
    par = d.streams[0].codecpar
    check(par.codec_id == "pcm_s16le", par.codec_id)
    raw = b"".join(bytes(p.data) for p in d.packets())
    d.close()
    return par.sample_rate, np.frombuffer(raw, "<i2").reshape(
        -1, par.nb_channels).T


def adts_lengths(data: bytes, rate_index: int = 3,
                 channels: int = 2) -> list[int]:
    """The frame lengths of an ADTS stream, each header checked: sync
    word, AAC LC, the rate index (3: 48 kHz, 4: 44.1 kHz), the channel
    configuration, and lengths that add up to the stream."""
    out, pos = [], 0
    while pos < len(data):
        h = data[pos:pos + 7]
        ln = (h[3] & 3) << 11 | h[4] << 3 | h[5] >> 5 if len(h) == 7 else 0
        check(len(h) == 7 and h[0] == 0xFF and h[1] & 0xF6 == 0xF0
              and h[2] >> 6 == 1 and (h[2] >> 2) & 0xF == rate_index
              and ((h[2] & 1) << 2 | h[3] >> 6) == channels
              and 7 < ln <= len(data) - pos,
              f"ADTS header at byte {pos}: {h.hex()}")
        out.append(ln)
        pos += ln
    return out


def snr_db(ref_s16, decoded) -> float:
    """SNR (dB) of decoded AAC samples (one 1024-sample frame late, the
    MDCT overlap) against the s16 input the encoder took."""
    import numpy as np

    ref = np.asarray(ref_s16, np.float64) / 32768.0
    y = np.asarray(decoded, np.float64)[:, 1024:1024 + ref.shape[1]]
    e = ref[:, :y.shape[1]] - y
    return float(10 * np.log10((ref ** 2).sum() / (e ** 2).sum()))


def audio_run(dev, wav: str, out: str, **smap) -> dict:
    """One audio transcode of `wav` through Transcoder, with the packets
    the muxer receives recorded as (pts, dts, bytes) and the stage split
    (reset before the run)."""
    from librempeg_tpu_torch.sched.pipeline import (
        StreamMap,
        TranscodeSpec,
        Transcoder,
    )
    from librempeg_tpu_torch.utils import stagetimer

    tc = Transcoder(TranscodeSpec(input_url=wav, output_url=out, device=dev,
                                  audio=StreamMap(**smap)))
    pk = []
    write = tc.mux.write

    def rec(p):
        pk.append((p.pts, p.dts, len(p.data)))
        write(p)

    tc.mux.write = rec
    stagetimer.reset()
    sync(dev)
    t0 = time.perf_counter()
    stats = tc.run()
    sync(dev)
    return {"wall_s": time.perf_counter() - t0, "packets": pk,
            "frames": stats["frames"],
            "split_s": {k: v["s"] for k, v in stagetimer.report().items()}}


def audio_transcode_checks(dev, td: str, gold) -> dict:
    """The audio path's checks against the JAX package's goldens (also
    run on the CPU by tools/torch_port_goldens.py --audio --check-port):
    the 10 s WAV -> -ar 48000 -c:a pcm_s16le (the resampler alone: length
    exact, the golden's sampled windows within AUDIO_RS_SHARE and 1
    LSB), -> -ar 48000 -c:a aac -b:a 128k (packets and pts exact, ADTS
    headers valid, bytes within AUDIO_BYTES_TOL, the port's decoder on
    the card within AUDIO_SNR_TOL_DB of the golden's SNR, each against
    its own package's resampled input), and 2 s at -ac 1 (mono, equal to
    build_matrix(stereo, mono) applied to the input within 1 LSB)."""
    import numpy as np
    import torch

    from librempeg_tpu_torch.codecs.aac.decoder import AacDecoder
    from librempeg_tpu_torch.core.samplefmt import MONO, STEREO
    from librempeg_tpu_torch.formats.api import open_input
    from librempeg_tpu_torch.resample.rematrix import build_matrix

    wav = os.path.join(td, "in.wav")
    x = write_audio_wav(wav, AUDIO_SECONDS)
    md5 = hashlib.md5(open(wav, "rb").read()).hexdigest()
    check(md5 == str(gold["wav_md5"]), f"input WAV md5 {md5}")

    # the resampler alone
    rs_path = os.path.join(td, "rs.wav")
    rs_run = audio_run(dev, wav, rs_path, codec="pcm_s16le",
                       sample_rate=AUDIO_OUT_RATE)
    rate, rs = read_wav(rs_path)
    check(rate == AUDIO_OUT_RATE and rs.shape == (2, int(gold["rs_len"])),
          f"resampled WAV {rate} Hz {rs.shape}, golden {gold['rs_len']}")
    win = np.stack([rs[:, s:s + AUDIO_WIN] for s in gold["rs_win_starts"]])
    d = np.abs(win.astype(np.int32) - gold["rs_windows"])
    rs_share = np.count_nonzero(d) / d.size
    check(rs_share <= AUDIO_RS_SHARE and d.max() <= 1,
          f"resampled s16 windows: {rs_share} of samples differ from the "
          f"JAX package's, max |d| {d.max()}")

    # the transcode
    aac_path = os.path.join(td, "out.aac")
    run = audio_run(dev, wav, aac_path, codec="aac",
                    sample_rate=AUDIO_OUT_RATE,
                    codec_opts={"bit_rate": AUDIO_BIT_RATE})
    data = open(aac_path, "rb").read()
    lens = adts_lengths(data)
    pts = [p for p, _, _ in run["packets"]]
    check(len(lens) == len(pts) == len(gold["aac_pts"]),
          f"{len(lens)} ADTS frames, {len(pts)} packets, golden "
          f"{len(gold['aac_pts'])}")
    check(pts == [int(p) for p in gold["aac_pts"]]
          and all(p == t for p, t, _ in run["packets"]),
          "packet pts/dts differ from the JAX package's")
    check(lens == [n for _, _, n in run["packets"]], "ADTS lengths")
    gbytes = int(gold["aac_bytes"])
    check(abs(len(data) - gbytes) <= AUDIO_BYTES_TOL * gbytes,
          f"{len(data)} AAC bytes, golden {gbytes}")
    t0 = time.perf_counter()
    demux = open_input(aac_path)
    dec = AacDecoder(demux.streams[0].codecpar, device=dev)
    decoded = torch.cat([dec.decode(p)[0].data for p in demux.packets()], 1)
    decoded = decoded.cpu().numpy()
    demux.close()
    decode_s = time.perf_counter() - t0
    check(np.isfinite(decoded).all() and decoded.shape[0] == 2,
          decoded.shape)
    snr = snr_db(rs, decoded)
    gsnr = float(gold["aac_snr_db"])
    check(abs(snr - gsnr) <= AUDIO_SNR_TOL_DB,
          f"decoded SNR {snr} dB, golden {gsnr}")

    # -ac 1
    wav2 = os.path.join(td, "in2.wav")
    x2 = write_audio_wav(wav2, AUDIO_AC_SECONDS)
    mono_path = os.path.join(td, "mono.wav")
    audio_run(dev, wav2, mono_path, codec="pcm_s16le", channels=1)
    rate, mono = read_wav(mono_path)
    want = build_matrix(STEREO, MONO).astype(np.float64) @ x2
    ac_err = float(np.abs(mono - want).max())
    check(rate == AUDIO_IN_RATE and mono.shape == (1, x2.shape[1])
          and ac_err <= 1.0, f"-ac 1: {rate} Hz {mono.shape}, max |d| "
          f"{ac_err} LSB")
    return {"x": x, "rs": rs, "rs_share_differ": rs_share,
            "rs_wall_s": rs_run["wall_s"], "packets": len(pts),
            "aac_bytes": len(data), "golden_aac_bytes": gbytes,
            "snr_db": snr, "golden_snr_db": gsnr, "decode_check_s": decode_s,
            "ac_max_err_lsb": ac_err, "wall_s": run["wall_s"],
            "split_s": run["split_s"]}


def sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.split()[0]) * 1e6


def audio_phase(dev) -> dict:
    """The audio path on the card: the shape_scan kernel against its
    plain version, the transcode checks (audio_transcode_checks), the
    kernel on the path (the 10 s clip through aresample with a noise
    shaper to s16), and the times."""
    import numpy as np
    import torch

    from librempeg_tpu_torch import kernels
    from librempeg_tpu_torch.ops import tx
    from librempeg_tpu_torch.resample import dither as RD
    from librempeg_tpu_torch.resample.resampler import Resampler

    t_phase = time.perf_counter()
    gold = np.load(os.path.join(GOLD, "audio_aac.npz"))
    with tempfile.TemporaryDirectory() as td:
        res = audio_transcode_checks(dev, td, gold)
    x = torch.from_numpy(res.pop("x")).to(dev)
    rs = res.pop("rs")

    # the kernel against its plain version: the resampled clip in LSB
    # units and the ditherer's noise, in two chunks carried through the
    # returned history
    r = Resampler(AUDIO_IN_RATE, AUDIO_OUT_RATE, 2, device=dev)
    xl = (r.process(x[:, :4000].float() / 32768.0) * 32768.0)[:, :SCAN_N]
    xl = xl.contiguous()
    check(xl.shape == (2, SCAN_N), xl.shape)
    noise = torch.from_numpy(RD.Ditherer("lipshitz")._noise(
        (2, SCAN_N))).to(dev)
    err = 0.0
    for method, cs in sorted(RD._SHAPER_COEFS.items()):
        coefs = torch.tensor(cs, dtype=torch.float32, device=dev)
        e0 = torch.zeros((len(cs), 2), dtype=torch.float32, device=dev)
        outs = {}
        for name, fn in (("kernel", RD.shape_scan),
                         ("plain", RD.shape_scan_plain)):
            y1, h1 = fn(xl[:, :2000], noise[:, :2000], coefs, e0)
            y2, h2 = fn(xl[:, 2000:], noise[:, 2000:], coefs, h1)
            outs[name] = (torch.cat([y1, y2], 1), h2)
        sync(dev)
        e = max_abs_err(outs["kernel"], outs["plain"])
        check(e == 0, f"shape_scan ({method}) differs from its plain "
              f"version: {e}")
        err = max(err, e)

    # the kernel on the path: the CLI's -af aresample=48000:
    # dither_method=lipshitz -c:a pcm_s16le over the clip, one convert
    # (one launch) per WAV packet. Every launch is recorded (its inputs
    # and outputs are fresh tensors that nothing writes afterwards) and
    # replayed through the plain version below, equal by value.
    calls = []
    kernel = RD.shape_scan

    def recorded(*a):
        out = kernel(*a)
        calls.append((a, out))
        return out

    with tempfile.TemporaryDirectory() as td:
        wav = os.path.join(td, "in.wav")
        write_audio_wav(wav, AUDIO_SECONDS)
        out = os.path.join(td, "dither.wav")
        RD.shape_scan = recorded
        kernels.reset_counts()
        try:
            drun = audio_run(dev, wav, out, codec="pcm_s16le",
                             filters=f"aresample={AUDIO_OUT_RATE}:"
                                     "dither_method=lipshitz")
        finally:
            RD.shape_scan = kernel
        launches = kernels.counts()["shape_scan"]
        rate, yd = read_wav(out)
    n_packets = -(-AUDIO_SECONDS * AUDIO_IN_RATE // AUDIO_CHUNK)
    check(launches == len(calls) == n_packets,
          f"shape_scan launches {launches}, {len(calls)} calls, for "
          f"{n_packets} WAV packets")
    check(rate == AUDIO_OUT_RATE and yd.shape == rs.shape,
          f"dithered WAV {rate} Hz {yd.shape}, undithered {rs.shape}")
    # the plain version on the same inputs, the calls of one length
    # stacked along the channels
    replay_err = shape_scan_replay(calls, dev)
    d = yd.astype(np.float64) - rs
    d_snr = float(10 * np.log10((rs.astype(np.float64) ** 2).sum()
                                / (d ** 2).sum()))
    check(d_snr > 55.0, f"dithered path: SNR {d_snr} dB against the "
          f"undithered resampler")

    # times on the inputs of one convert of the path
    args = calls[len(calls) // 2][0]
    n = args[0].shape[1]
    k = args[2].shape[0]
    chain_ops = k + 4
    lat_ms = n * chain_ops * DEP_OP_CYCLES / sm_clock_hz() * 1e3
    byte_ms = nbytes(*args, args[0], args[3]) / HBM_BYTES_S * 1e3
    kern = {
        "max_abs_err": max(err, replay_err), "launches": launches,
        **timed(lambda: RD.shape_scan(*args)),
        "plain_ms": median_ms(lambda: RD.shape_scan_plain(*args), runs=3,
                              warm=1),
        "bound_ms": max(lat_ms, byte_ms),
        "bound_by": "operations" if lat_ms >= byte_ms else "bytes",
        "bound_note": f"a serial chain: {n} steps of {chain_ops} dependent "
                      f"operations at {DEP_OP_CYCLES} cycles each and the "
                      f"highest SM clock; the bytes take {byte_ms:.6f} ms",
        "library_ms": None,
        "library_note": "no single PyTorch call computes an error-feedback "
                        "quantiser",
        "shape": f"2 channels x {n} samples (a convert of the path), "
                 f"K={k}; equal by value on all {launches} launches of the "
                 f"path "
                 f"and at 2 x {SCAN_N} in two chunks, both shapers"}
    w = torch.randn(2, 2048, device=dev)
    mdct_ms = device_ms(lambda: tx.mdct(w))
    split = res["split_s"]
    n_frames = res["packets"]
    res.update({
        "kernel": kern, "dither_path_s": drun["wall_s"], "dither_snr_db": d_snr,
        "realtime_factor": AUDIO_SECONDS / res["wall_s"],
        "mdct_device_ms": mdct_ms,
        "mdct_stage_ms_per_frame": split.get("aac.mdct", 0) / n_frames * 1e3,
        "quant_ms_per_frame": split.get("aac.quant", 0) / n_frames * 1e3,
        "phase_s": time.perf_counter() - t_phase})
    return res


# -- the JPEG/MJPEG path -----------------------------------------------------

def jpeg_commands(td: str) -> dict:
    """The JPEG phase's command lines (cli.ffmpeg), with outputs in td:
    A the MJPEG transcode of the asset, B its MJPEG AVI back to MPEG-4,
    C thumbnails as image2 files, C2 their stream copy to raw MJPEG."""
    j = os.path.join
    return {
        "A": ["-i", ASSET, "-pix_fmt", "yuvj420p", "-c:v", "mjpeg", "-q:v",
              "3", "-y", j(td, "mjpeg.avi")],
        "B": ["-i", j(td, "mjpeg.avi"), "-vf", "scale=1280:720", "-c:v",
              "mpeg4", "-q:v", "4", "-y", j(td, "back.avi")],
        "C": ["-i", ASSET, "-vf", "fps=5,crop=1440:1080,scale=320:240",
              "-q:v", "2", "-f", "image2", j(td, "thumb_%03d.jpg")],
        "C2": ["-i", j(td, "thumb_%03d.jpg"), "-c:v", "copy", "-f", "mjpeg",
               "-y", j(td, "thumbs.mjpeg")],
    }


def cli_run(argv: list[str], dev: str, keep_input: bool = False,
            on_input=None, prepare=None) -> dict:
    """One command line through cli.ffmpeg's parser and Transcoder, with
    the packets the muxer receives recorded as (pts, bytes, key), the
    frames the encoder takes (keep_input; or each passed to on_input),
    the launch counts and the stage split of the run (both reset before
    it). prepare(transcoder) runs before the run."""
    from librempeg_tpu_torch import kernels
    from librempeg_tpu_torch.cli.ffmpeg import parse_args
    from librempeg_tpu_torch.core.packet import PktFlags
    from librempeg_tpu_torch.sched.pipeline import Transcoder
    from librempeg_tpu_torch.utils import stagetimer

    spec, _ = parse_args(argv + ["-device", dev])
    tc = Transcoder(spec)
    pk, inputs = [], []
    write = tc.mux.write

    def rec(p):
        pk.append((p.pts, bytes(p.data), bool(p.flags & PktFlags.KEY)))
        write(p)

    tc.mux.write = rec
    chain = tc.chains[0]
    if keep_input or on_input is not None:
        name = "encode_async" if getattr(chain, "_pipelined", False) \
            else "encode"
        enc = getattr(chain.encoder, name)
        keep = inputs.append if keep_input else on_input

        def take(frame, **kw):
            keep(frame)
            return enc(frame, **kw)

        setattr(chain.encoder, name, take)
    if prepare is not None:
        prepare(tc)
    stagetimer.reset()
    kernels.reset_counts()
    sync(dev)
    t0 = time.perf_counter()
    tc.run()
    sync(dev)
    wall = time.perf_counter() - t0
    return {"wall_s": wall, "packets": pk, "inputs": inputs,
            "launches": kernels.counts(),
            "split_s": {k: v["s"] for k, v in stagetimer.report().items()}}


def metric_stats(name: str, mains, refs, dev) -> list[dict]:
    """The two-input `name` graph (psnr or ssim) over main frames
    against reference frames (frame i of each at pts i), on `dev`: each
    frame's stats."""
    from librempeg_tpu_torch.core.rational import Rational
    from librempeg_tpu_torch.filters import GraphRunner, StreamProps

    f, tb = mains[0], Rational(1, 25)
    props = StreamProps(media="video", width=f.width, height=f.height,
                        pix_fmt=f.format, frame_rate=Rational(25, 1),
                        time_base=tb)
    g = GraphRunner(f"[in][in2]{name}", [props, props])
    for i, (m, r) in enumerate(zip(mains, refs)):
        g.push(r.to_device(dev).replace(pts=i, time_base=tb), 1)
        g.push(m.to_device(dev).replace(pts=i, time_base=tb), 0)
    g.finish()
    return next(n.filter.stats for n in g.graph.nodes
                if n.filter.NAME == name)


def jpeg_paths(dev: str, td: str) -> dict:
    """Paths A, B, C and C2 once each on `dev`, with what the checks
    read: A's packets and yuvj420p encoder input, B's packets and
    scaled encoder input, C's files and C2's stream."""
    cmd = jpeg_commands(td)
    out = {}
    for name, keep in (("A", True), ("B", True), ("C", False),
                       ("C2", False)):
        out[name] = cli_run(cmd[name], dev, keep_input=keep)
    out["thumb_files"] = sorted(
        f for f in os.listdir(td) if f.startswith("thumb_"))
    out["thumb_bytes"] = [open(os.path.join(td, f), "rb").read()
                          for f in out["thumb_files"]]
    out["thumbs_mjpeg"] = os.path.join(td, "thumbs.mjpeg")
    return out


def jpeg_checks(dev: str, run: dict, gold, limits: bool = True) -> dict:
    """Hold the JPEG paths' outputs to the goldens (with the limits, or
    none) and return what the checks read."""
    import numpy as np
    import torch

    from librempeg_tpu_torch.codecs.jpeg.decoder import decode_jpeg
    from librempeg_tpu_torch.codecs.mpeg4._decoder import Mpeg4Decoder
    from librempeg_tpu_torch.core.packet import Packet
    from librempeg_tpu_torch.formats.api import open_input

    inf = float("inf")
    size_rel = JPEG_SIZE_REL if limits else inf
    res = {}

    # A: 48 key packets, pts exact, sizes against the JAX package's
    pa = run["A"]["packets"]
    check(len(pa) == JPEG_FRAMES and all(k for _, _, k in pa)
          and [p for p, _, _ in pa] == list(range(JPEG_FRAMES)),
          f"path A: {len(pa)} packets, pts {[p for p, _, _ in pa]}")
    md5s = [hashlib.md5(d).hexdigest() for _, d, _ in pa]
    rel = [len(d) / int(n) - 1 for (_, d, _), n in zip(pa, gold["a_sizes"])]
    res["a_size_rel_max"] = max(abs(r) for r in rel)
    res["a_bytes"] = sum(len(d) for _, d, _ in pa)
    res["a_identical"] = sum(a == b for a, b in zip(md5s, gold["a_md5"]))
    check(res["a_size_rel_max"] <= size_rel,
          f"path A: a packet's size is {res['a_size_rel_max']:.5f} off the "
          f"JAX package's (limit {JPEG_SIZE_REL})")

    # the decoder: on `dev` equal to the CPU decode; identical packets to
    # the JAX decoder's md5; the stored -q:v 31 frame and the JAX
    # package's packet 0 of A (-q:v 3) to theirs
    decoded, bad = [], []
    for i, (_, d, _) in enumerate(pa):
        f = decode_jpeg(d, device=dev)
        decoded.append(f.replace(pts=i))
        if torch.device(dev).type != "cpu":
            c = decode_jpeg(d, device="cpu")
            if not all(torch.equal(x.cpu(), y) for x, y in zip(f.planes,
                                                              c.planes)):
                bad.append(i)
        if md5s[i] == gold["a_md5"][i] and \
                frame_md5(f.planes) != gold["a_dec_md5"][i]:
            bad.append(i)
    check(not bad, f"path A: packets {bad} decode otherwise on {dev} than "
          f"on the CPU or than the JAX decoder")
    stored = decode_jpeg(gold["stored_jpeg"].tobytes(), device=dev)
    check(frame_md5(stored.planes) == str(gold["stored_md5"]),
          "the stored -q:v 31 frame decodes otherwise than in the JAX "
          "package")
    a0 = gold["a0_jpeg"].tobytes()
    check(hashlib.md5(a0).hexdigest() == gold["a_md5"][0] and
          frame_md5(decode_jpeg(a0, device=dev).planes) ==
          gold["a_dec_md5"][0],
          "the JAX package's packet 0 of path A decodes otherwise than in "
          "the JAX package")

    # A: decoded PSNR per plane against the yuvj420p encoder input
    src = run["A"]["inputs"]
    check(len(src) == JPEG_FRAMES and src[0].format == "yuvj420p",
          f"path A: {len(src)} encoder inputs")
    psnr = np.array([[psnr_db(a, b) for a, b in zip(f.planes, s.planes)]
                     for f, s in zip(decoded, src)])
    res["a_psnr_mean"] = psnr.mean(0).tolist()
    res["a_psnr_gap"] = (psnr.mean(0) - gold["a_psnr"].mean(0)).tolist()
    check(max(abs(g) for g in res["a_psnr_gap"]) <=
          (JPEG_PSNR_TOL_DB if limits else inf),
          f"path A: decoded PSNR means {res['a_psnr_mean']} are "
          f"{res['a_psnr_gap']} dB off the JAX package's")

    # the metric graphs: main = A's decode, reference = its source
    for name, tol_dev, tol_gold, keys in (
            ("psnr", METRIC_DEV_DB, JPEG_PSNR_TOL_DB,
             ("psnr_y", "psnr_u", "psnr_v", "psnr_avg")),
            ("ssim", METRIC_DEV_SSIM, JPEG_SSIM_TOL,
             ("ssim_y", "ssim_u", "ssim_v", "ssim_all"))):
        st = metric_stats(name, decoded, src, dev)
        check(len(st) == JPEG_FRAMES, f"{name}: {len(st)} frames")
        got = np.array([[s[k] for k in keys] for s in st], np.float64)
        if torch.device(dev).type != "cpu":
            cpu = metric_stats(name, decoded, src, "cpu")
            want = np.array([[s[k] for k in keys] for s in cpu], np.float64)
            res[f"{name}_dev_err"] = float(np.abs(got - want).max())
            check(res[f"{name}_dev_err"] <= tol_dev,
                  f"{name} on {dev} is {res[f'{name}_dev_err']} off the CPU")
        res[f"{name}_mean"] = got.mean(0).tolist()
        res[f"{name}_gap"] = (got.mean(0) - gold[name].mean(0)).tolist()
        check(max(abs(g) for g in res[f"{name}_gap"]) <=
              (tol_gold if limits else inf),
              f"{name} means {res[f'{name}_mean']} are {res[f'{name}_gap']}"
              f" off the JAX package's")

    # B: MPEG-4 of A's AVI: VOP types and pts exact, decoded mean
    pb = run["B"]["packets"]
    types = "".join(vop_type(d) for _, d, _ in pb)
    check(len(pb) == JPEG_FRAMES and types == str(gold["b_types"])
          and [p for p, _, _ in pb] == gold["b_pts"].tolist(),
          f"path B: {len(pb)} packets, types {types}")
    dec = Mpeg4Decoder(device=None)  # host numpy planes
    back = [f for p, d, _ in pb for f in dec.decode(
        Packet(data=d, pts=p))] + dec.flush()
    bsrc = [tuple(p.cpu().numpy() for p in f.planes)
            for f in run["B"]["inputs"]]
    check(len(back) == len(bsrc) == JPEG_FRAMES,
          f"path B: {len(back)} decoded, {len(bsrc)} encoded frames")
    res["b_types"] = types
    res["b_psnr_mean"] = statistics.fmean(
        planes_psnr_db(a, f.planes) for a, f in zip(bsrc, back))
    res["b_psnr_gap"] = res["b_psnr_mean"] - float(gold["b_psnr"].mean())
    check(abs(res["b_psnr_gap"]) <= (JPEG_B_PSNR_TOL_DB if limits else inf),
          f"path B: decoded mean {res['b_psnr_mean']} dB is "
          f"{res['b_psnr_gap']} off the JAX package's")

    # C: the thumbnails' names, pts and sizes; C2 splits back into them
    pc = run["C"]["packets"]
    names = [f"thumb_{i:03d}.jpg" for i in range(1, len(pc) + 1)]
    check(len(pc) == JPEG_THUMBS and run["thumb_files"] == names
          and [p for p, _, _ in pc] == gold["c_pts"].tolist(),
          f"path C: files {run['thumb_files']}, pts "
          f"{[p for p, _, _ in pc]}")
    res["c_size_rel_max"] = max(abs(len(d) / int(n) - 1) for (_, d, _), n
                                in zip(pc, gold["c_sizes"]))
    check(res["c_size_rel_max"] <= size_rel,
          f"path C: a thumbnail's size is {res['c_size_rel_max']:.5f} off "
          f"the JAX package's")
    check(run["thumb_bytes"] == [d for _, d, _ in pc],
          "path C: the files differ from the packets written")
    split = [bytes(p.data) for p in open_input(run["thumbs_mjpeg"])
             .packets()]
    check(split == run["thumb_bytes"] and [d for _, d, _ in
                                           run["C2"]["packets"]] == split,
          "path C2: the raw MJPEG stream does not split into the "
          "thumbnails' bytes")
    res["c_bytes"] = [len(d) for _, d, _ in pc]
    return res


def jpeg_phase(dev: str) -> dict:
    """The JPEG paths on the card, checked against the goldens, with
    each path's rate, stage split and kernel launches."""
    import numpy as np

    gold = np.load(os.path.join(GOLD, JPEG_GOLD))
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        run = jpeg_paths(dev, td)
        res = jpeg_checks(dev, run, gold)
    la, lb, lc = (run[k]["launches"] for k in "ABC")
    check(la["mc"] == la["deblock"] == la["intra"] == 44 and
          lc["mc"] == lc["deblock"] == lc["intra"] == 44,
          f"jpeg: H.264 kernel launches A {la}, C {lc}")
    n_p = res["b_types"].count("P")
    check(lb["hpel"] == n_p and lb["hpel_luma"] == lb["hpel_chroma"] == 0
          and lb["mc"] == 0, f"jpeg: path B launches {lb} for {n_p} P-VOPs")
    res["launches"] = {k: la[k] + lb[k] + lc[k] + run["C2"]["launches"][k]
                       for k in la}
    for k in ("A", "B", "C", "C2"):
        res[f"{k}_wall_s"] = run[k]["wall_s"]
        res[f"{k}_split_s"] = run[k]["split_s"]
    res["fps"] = {"A": JPEG_FRAMES / run["A"]["wall_s"],
                  "B": JPEG_FRAMES / run["B"]["wall_s"],
                  "C": JPEG_FRAMES / run["C"]["wall_s"]}
    res["phase_s"] = time.perf_counter() - t_phase
    return res


# -- the filter slice ---------------------------------------------------------

def filters_commands(td: str, wav: str) -> dict:
    """The filter phase's command lines (cli.ffmpeg), outputs in td: F1
    broadcast preparation, F2 25 -> 50 fps, F3 audio clean-up of the WAV
    at `wav`, F4 the lavfi sources (video, then audio)."""
    j = os.path.join
    return {
        "F1": ["-i", ASSET, "-vf", F1_VF, "-c:v", "mpeg4", "-q:v", "4",
               "-y", j(td, "f1.avi")],
        "F2": ["-i", ASSET, "-vf", "minterpolate=fps=50", "-c:v", "mpeg4",
               "-q:v", "4", "-y", j(td, "f2.avi")],
        "F3": ["-i", wav, "-af", F3_AF, "-c:a", "aac", "-b:a", "128k", "-y",
               j(td, "f3.aac")],
        "F4v": ["-f", "lavfi", "-i", f"testsrc=size=1920x1088:rate=25:"
                f"duration={F4_SECONDS}", "-c:v", "mpeg4", "-q:v", "4", "-y",
                j(td, "f4.avi")],
        "F4a": ["-f", "lavfi", "-i", f"sine=frequency=1000:duration="
                f"{SINE_SECONDS}", "-c:a", "aac", "-b:a", "128k", "-y",
                j(td, "f4.aac")],
    }


def host(x):
    """A tensor or array as a numpy array on the host."""
    import numpy as np

    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def keep_references(enc, into: dict, n: int | None = None) -> None:
    """Wrap an MPEG-4 encoder's encode_async so that the reference of
    each I/P-VOP it codes (the recon planes it predicts from next, on
    the host), of the first n if n is given, lands in `into` under its
    display index (the B-frame scheduler passes it; without B-VOPs it
    is the call's number)."""
    inner = enc.encode_async

    def take(frame, **kw):
        h = inner(frame, **kw)
        if n is None or len(into) < n:
            into[kw.get("display_idx", len(into))] = tuple(
                host(p) for p in enc._ref)
        return h

    enc.encode_async = take


def same_pictures(frames, refs: dict) -> list:
    """The (display index, plane) of every decoded picture, frames in
    display order, that is not the encoder's reference of that index
    (cropped to the picture: the reference is padded to whole MBs)."""
    import numpy as np

    bad = []
    for i, ref in sorted(refs.items()):
        if i >= len(frames):
            bad.append((i, "not decoded"))
            continue
        for k, (a, b) in enumerate(zip(frames[i].planes, ref)):
            a = np.asarray(a)
            if not np.array_equal(a, b[:a.shape[0], :a.shape[1]]):
                bad.append((i, k))
    return bad


def digest(*arrays) -> bytes:
    """md5 of the arrays' bytes in order (float arrays with -0.0 made
    +0.0, so equal values digest equally)."""
    import numpy as np

    h = hashlib.md5()
    for a in arrays:
        a = np.ascontiguousarray(host(a))
        if a.dtype.kind == "f":
            a = a + a.dtype.type(0)
        h.update(a.tobytes())
    return h.digest()


def sample_rows(planes, step: int):
    """Every step-th row of each plane, from row step // 2, in one
    flat array."""
    import numpy as np

    return np.concatenate([host(p)[step // 2::step].reshape(-1)
                           for p in planes])


def frame_stats(planes, step: int, rows: bool):
    """A frame's md5 digest, per-plane sums and (rows) its sample_rows."""
    import numpy as np

    ps = [host(p) for p in planes]
    sums = [int(p.astype(np.int64).sum()) for p in ps]
    return digest(*ps), sums, sample_rows(ps, step) if rows else None


def scaled_graph_planes(name: str, frames, i: int) -> list:
    """Output i of a graph of FILTER_SCALED_GRAPHS from its inputs
    (frames: per frame its planes, numpy arrays): hstack and vstack join
    frame i and frame n - 1 - i, tile=2x2 puts frames 4i..4i+3 in two
    rows of two."""
    import numpy as np

    if name == "tile":
        f = frames[4 * i:4 * i + 4]
        return [np.concatenate([np.concatenate([f[0][k], f[1][k]], 1),
                                np.concatenate([f[2][k], f[3][k]], 1)], 0)
                for k in range(len(f[0]))]
    axis = 1 if name == "hstack" else 0
    return [np.concatenate([a, b], axis)
            for a, b in zip(frames[i], frames[-1 - i])]


def write_cube(path: str, n: int = 33) -> str:
    """A smooth non-linear 3D LUT in .cube text (and a 64-entry 1D one
    at path + "1d"), generated from a formula."""
    import numpy as np

    with open(path, "w") as f:
        f.write(f"TITLE \"generated\"\nLUT_3D_SIZE {n}\n")
        for b in range(n):
            for g in range(n):
                for r in range(n):
                    R, G, B = r / (n - 1), g / (n - 1), b / (n - 1)
                    f.write(f"{R ** 0.8 * 0.9 + 0.05 * B:.6f} "
                            f"{G * G * 0.7 + 0.2 * R:.6f} "
                            f"{np.sin(B * 1.4) * 0.8 + 0.1:.6f}\n")
    with open(path + "1d", "w") as f:
        f.write("LUT_1D_SIZE 64\nDOMAIN_MIN 0 0 0\nDOMAIN_MAX 1 1 1\n")
        for i in range(64):
            t = i / 63
            f.write(f"{t ** 0.7:.6f} {t * t:.6f} {1 - t:.6f}\n")
    return path


def afir_ir():
    """The afir graph's impulse response: 0.5 s of seeded noise decaying
    with a 0.1 s time constant, mono s16."""
    import numpy as np

    n = AUDIO_IN_RATE // 2
    rng = np.random.default_rng(0)
    ir = rng.standard_normal(n) * np.exp(-np.arange(n) / (0.1 * AUDIO_IN_RATE))
    return np.round(np.clip(ir * 0.3, -1, 1) * 32767).astype(np.int16)[None]


FILTER_GRAPHS = {
    # name: (description, inputs, what goes in; see filters_graph_inputs)
    "xfade_fade": ("[in][in2]xfade=transition=fade:duration=0.8:offset=0.4",
                   "decode, negated decode"),
    "xfade_dissolve": ("[in][in2]xfade=transition=dissolve:duration=0.8:"
                       "offset=0.4", "decode, negated decode"),
    "xfade_wipeleft": ("[in][in2]xfade=transition=wipeleft:duration=0.8:"
                       "offset=0.4", "decode, negated decode"),
    "hstack": ("[in][in2]hstack", "scaled frame i, scaled frame 47 - i"),
    "vstack": ("[in][in2]vstack", "scaled frame i, scaled frame 47 - i"),
    "tile": ("tile=2x2", "scaled frames"),
    "lut3d": ("format=rgb24,lut3d=file={cube}:interp=tetrahedral",
              "decode"),
    "concat": ("[in][in2]concat=n=2:v=1:a=0",
               "frames 0-23, frames 24-47 from pts 0"),
    "reverse": ("reverse", "frames 0-11"),
    "select": ("select=mod(n\\,3)", "decode"),
    "thumbnail": ("thumbnail=12", "decode"),
    "showwaves": ("showwaves=s=1280x240", "F3's WAV samples"),
    "showspectrum": ("showspectrum=s=512x256", "F3's WAV samples"),
    "afir": ("[in][in2]afir", "F3's WAV samples, afir_ir()"),
}
# the graphs whose outputs are float contracts (lut3d; the scaler's
# GEMMs in front of the stacks and tile): sums and sampled rows, not
# md5s, are held against the JAX package's
FILTER_FLOAT_GRAPHS = ("hstack", "vstack", "tile", "lut3d")


def filters_graphs(frames, audio, td: str, pkg: dict) -> dict:
    """The graph-API graphs (FILTER_GRAPHS) of one package (pkg: its
    GraphRunner, StreamProps, Rational, VideoFrame, AudioFrame,
    ChannelLayout and a to_data(numpy) for sample arrays) over decoded
    frames and the WAV's [2, n] int16 samples: per graph, each output
    frame's digest, plane sums, pts and (float graphs, sampled frames)
    rows."""
    G, SP, R = pkg["GraphRunner"], pkg["StreamProps"], pkg["Rational"]
    AF, CL, to_data = pkg["AudioFrame"], pkg["ChannelLayout"], pkg["to_data"]
    tb = R(1, 25)
    f0 = frames[0]

    def vprops(w, h, fmt="yuv420p"):
        return SP(media="video", width=w, height=h, pix_fmt=fmt,
                  frame_rate=R(25, 1), time_base=tb)

    def run(desc, ins, props):
        g = G(desc, props)
        out = []
        for pad, f in ins:
            out += g.push(f, pad)
        return out + g.finish()

    def one(desc, fs, props=None):
        return run(desc, [(0, f) for f in fs],
                   props or vprops(f0.width, f0.height))

    neg = one("negate", frames)
    scaled = one("scale=960:544", frames)
    cube = write_cube(os.path.join(td, "graph.cube"))
    outs = {}
    for name in ("xfade_fade", "xfade_dissolve", "xfade_wipeleft"):
        p = vprops(f0.width, f0.height)
        outs[name] = run(FILTER_GRAPHS[name][0],
                         [x for a, b in zip(frames, neg)
                          for x in ((1, b), (0, a))], [p, p])
    ps = vprops(960, 544)
    for name in ("hstack", "vstack"):
        outs[name] = run(FILTER_GRAPHS[name][0],
                         [x for i in range(len(scaled))
                          for x in ((1, scaled[-1 - i]), (0, scaled[i]))],
                         [ps, ps])
    outs["tile"] = one("tile=2x2", scaled, ps)
    outs["lut3d"] = one(FILTER_GRAPHS["lut3d"][0].format(cube=cube), frames)
    p = vprops(f0.width, f0.height)
    half = len(frames) // 2
    outs["concat"] = run(FILTER_GRAPHS["concat"][0],
                         [(0, f) for f in frames[:half]]
                         + [(1, f.replace(pts=i)) for i, f in
                            enumerate(frames[half:])], [p, p])
    outs["reverse"] = one("reverse", frames[:12])
    outs["select"] = one(FILTER_GRAPHS["select"][0], frames)
    outs["thumbnail"] = one("thumbnail=12", frames)

    ap = SP(media="audio", sample_rate=AUDIO_IN_RATE, sample_fmt="s16p",
            layout=CL.default(2), time_base=R(1, AUDIO_IN_RATE))
    chunks = [(0, AF(data=to_data(audio[:, s:s + AUDIO_CHUNK]),
                     sample_rate=AUDIO_IN_RATE, sample_fmt="s16p",
                     layout=CL.default(2), pts=s,
                     time_base=R(1, AUDIO_IN_RATE)))
              for s in range(0, audio.shape[1], AUDIO_CHUNK)]
    for name in ("showwaves", "showspectrum"):
        outs[name] = run(FILTER_GRAPHS[name][0], chunks, ap)
    ir = afir_ir()
    irp = SP(media="audio", sample_rate=AUDIO_IN_RATE, sample_fmt="s16p",
             layout=CL.default(1), time_base=R(1, AUDIO_IN_RATE))
    ir_frame = AF(data=to_data(ir), sample_rate=AUDIO_IN_RATE,
                  sample_fmt="s16p", layout=CL.default(1), pts=0,
                  time_base=R(1, AUDIO_IN_RATE))
    outs["afir"] = run("[in][in2]afir", [(1, ir_frame)] + chunks,
                       [ap, irp])

    res = {}
    for name, fs in outs.items():
        if name == "afir":
            res[name] = {"n": len(fs), "pts": [f.pts for f in fs],
                         "md5": [digest(f.data) for f in fs],
                         "sums": [[int(host(f.data).astype("int64").sum())]
                                  for f in fs], "rows": [],
                         "numel": [host(fs[0].data).size]}
            continue
        step = 128 if name == "lut3d" else 64
        st = [frame_stats(f.planes, step,
                          name in FILTER_FLOAT_GRAPHS and
                          i in FILTER_SAMPLE_FRAMES)
              for i, f in enumerate(fs)]
        res[name] = {"n": len(fs), "pts": [f.pts for f in fs],
                     "md5": [a for a, _, _ in st],
                     "sums": [b for _, b, _ in st],
                     "rows": [c for _, _, c in st if c is not None],
                     "numel": [host(p).size for p in fs[0].planes]}
    res["_scaled"] = (frames, scaled)
    return res


def filters_paths(dev: str, td: str) -> dict:
    """F1-F4 once each on `dev` through cli_run, with what the checks
    read: each video path's encoder input (digest, plane sums, sampled
    rows of FILTER_SAMPLE_FRAMES), in-loop recon PSNR and packets; F2's
    block searches (each MV field's digest, the first search's inputs);
    the biquad launches of F3 and F4's audio (inputs and outputs, for the
    replay); each audio path's encoder input and AAC stream."""
    import numpy as np

    from librempeg_tpu_torch.kernels import biquad as KB
    from librempeg_tpu_torch.ops.pallas import mesearch as MS

    wav = os.path.join(td, "in.wav")
    x = write_audio_wav(wav, AUDIO_SECONDS)
    cmd = filters_commands(td, wav)
    out = {"wav": x}
    for name in ("F1", "F2", "F4v"):
        ins, mvs, search, enc = [], [], [], []

        def on_input(frame, ins=ins):
            ins.append(frame_stats(frame.planes, 64,
                                   len(ins) in FILTER_SAMPLE_FRAMES))

        def prepare(tc, enc=enc):
            tc.chains[0].encoder.recon_psnr = []
            enc.append(tc.chains[0].encoder)

        search_fn = MS.full_search_mc

        def recorded(cur, ref, r, *tile, mvs=mvs, search=search):
            res = search_fn(cur, ref, r, *tile)
            mvs.append(digest(res[0]))
            if not search:
                search.append((cur.clone(), ref.clone(), r))
            return res

        MS.full_search_mc = recorded
        try:
            run = cli_run(cmd[name], dev, on_input=on_input, prepare=prepare)
        finally:
            MS.full_search_mc = search_fn
        run.update(inputs=ins, mvs=mvs, search=search,
                   recon_psnr=list(enc[0].recon_psnr))
        out[name] = run
    for name in ("F3", "F4a"):
        ins, calls = [], []

        def on_input(frame, ins=ins):
            ins.append(host(frame.data))

        launch = KB.launch

        def recorded(xx, coefs, z, fmt, calls=calls):
            y, zo = launch(xx, coefs, z, fmt)
            calls.append(((xx, tuple(map(tuple, coefs)), z, fmt), (y, zo)))
            return y, zo

        KB.launch = recorded
        try:
            run = cli_run(cmd[name], dev, on_input=on_input)
        finally:
            KB.launch = launch
        data = np.concatenate(ins, 1)
        run.update(inputs=data, calls=calls, path=cmd[name][-1])
        out[name] = run
    return out


def aac_snr(dev: str, path: str, ref_s16) -> float:
    """SNR (dB) of the port's decode (on `dev`) of an ADTS file against
    the encoder's input in s16 units."""
    import numpy as np
    import torch

    from librempeg_tpu_torch.codecs.aac.decoder import AacDecoder
    from librempeg_tpu_torch.formats.api import open_input

    demux = open_input(path)
    dec = AacDecoder(demux.streams[0].codecpar, device=dev)
    y = torch.cat([dec.decode(p)[0].data for p in demux.packets()], 1)
    demux.close()
    y = y.cpu().numpy()
    check(np.isfinite(y).all() and y.shape[0] == ref_s16.shape[0], y.shape)
    return snr_db(ref_s16, y)


def _rows_diff(got, want):
    """(share of samples that differ, largest |difference|) of sampled
    rows."""
    import numpy as np

    d = np.abs(np.concatenate(got).astype(np.int32)
               - np.concatenate(want).astype(np.int32))
    return float(np.count_nonzero(d) / max(1, d.size)), int(d.max(initial=0))


def _sums_gap(got, want, numel) -> float:
    """The largest |plane sum difference| per sample of the plane."""
    import numpy as np

    g, w = np.asarray(got, np.int64), np.asarray(want, np.int64)
    check(g.shape == w.shape, (g.shape, w.shape))
    return float((np.abs(g - w) / np.asarray(numel)).max(initial=0.0))


def filters_checks(dev: str, run: dict, gold, graphs: dict | None = None,
                   limits: bool = True) -> dict:
    """The filter phase's checks against bench_1080p_filters.npz (also
    run on the CPU by tools/torch_port_goldens.py --filters
    --check-port). limits=False reads the numbers without the limits."""
    import numpy as np

    def lim(ok, what):
        if limits:
            check(ok, what)

    res, verdicts = {}, []
    luma, chroma = 1920 * 1088, 960 * 544
    for name, key in (("F1", "f1"), ("F2", "f2"), ("F4v", "f4v")):
        r = run[name]
        types = "".join(vop_type(d) for _, d, _ in r["packets"])
        pts = [p for p, _, _ in r["packets"]]
        nbytes = sum(len(d) for _, d, _ in r["packets"])
        gbytes = int(gold[f"{key}_sizes"].sum())
        ps = r["recon_psnr"]
        md5 = [a for a, _, _ in r["inputs"]]
        same = sum(a == bytes(b) for a, b in zip(md5, gold[f"{key}_md5"]))
        share, dmax = _rows_diff([c for _, _, c in r["inputs"]
                                  if c is not None], list(gold[f"{key}_rows"]))
        # a frame the recon reproduces exactly reads inf (the decoder's
        # integer picture of a flat or exactly predicted frame): those
        # frames must be the JAX package's, and the means take the rest
        exact = [i for i, p in enumerate(ps) if math.isinf(p)]
        gps = gold[f"{key}_psnr"]
        res[key] = {
            "types": types, "bytes": nbytes, "golden_bytes": gbytes,
            "bytes_rel": abs(nbytes - gbytes) / gbytes,
            "exact_frames": exact,
            "recon_psnr": float(np.mean([p for p in ps
                                         if not math.isinf(p)])),
            "psnr_gap": float(np.mean([p for p in ps if not math.isinf(p)])
                              - gps[np.isfinite(gps)].mean()),
            "inputs_equal": same, "inputs": len(md5),
            "sums_gap": _sums_gap([b for _, b, _ in r["inputs"]],
                                  gold[f"{key}_sums"], [luma, chroma, chroma]),
            "rows_share": share, "rows_max": dmax}
        if name == "F2":
            res[key]["mv_equal"] = sum(
                a == bytes(b) for a, b in zip(r["mvs"], gold["f2_mv"]))
        log(f"filters {name}: " + json.dumps(res[key]))
        x = res[key]
        verdicts += [
            (check, types == str(gold[f"{key}_types"]) and
             pts == gold[f"{key}_pts"].tolist() and len(ps) == len(pts) and
             len(md5) == len(gold[f"{key}_md5"]),
             f"{name}: VOP types, pts or frame count differ from the JAX "
             f"package's"),
            (check, exact == np.flatnonzero(np.isinf(gps)).tolist(),
             f"{name}: the frames the recon reproduces exactly "
             f"{exact} are not the JAX package's"),
            (lim, x["bytes_rel"] <= FILT_BYTES_REL, f"{name}: bytes"),
            (lim, abs(x["psnr_gap"]) <= FILT_PSNR_TOL_DB,
             f"{name}: recon PSNR mean")]
        if name == "F1":
            # colorspace's transfer functions raise to float32 powers,
            # which XLA's CPU code approximates: a sample may move by 1
            verdicts.append((lim, same >= FILT_F1_EQUAL and
                             x["sums_gap"] <= FILT_SUM_TOL and
                             share <= FILT_SHARE and dmax <= 1,
                             "F1: encoder input against the JAX package's"))
        else:
            verdicts.append((check, same == len(md5),
                             f"{name}: encoder input frames differ from the "
                             f"JAX package's"))
        if name == "F2":
            verdicts.append((check, len(r["mvs"]) == len(gold["f2_mv"]) ==
                             x["mv_equal"], "F2: MV fields differ from the "
                             "JAX package's"))
    for name, key, rate_idx, ch in (("F3", "f3", 4, 2), ("F4a", "f4a", 4, 1)):
        r = run[name]
        x = r["inputs"]
        data = open(r["path"], "rb").read()
        lens = adts_lengths(data, rate_idx, ch)
        pts = [p for p, _, _ in r["packets"]]
        gbytes = int(gold[f"{key}_sizes"].sum())
        ref = x if x.dtype == np.int16 else x.astype(np.float64) * 32768.0
        snr = aac_snr(dev, r["path"], ref)
        res[key] = {"input_equal": digest(x) == bytes(gold[f"{key}_in_md5"]),
                    "bytes": len(data), "golden_bytes": gbytes,
                    "bytes_rel": abs(len(data) - gbytes) / gbytes,
                    "snr_db": snr, "snr_gap": snr - float(gold[f"{key}_snr"]),
                    "packets": len(pts)}
        log(f"filters {name}: " + json.dumps(res[key]))
        verdicts += [
            (check, res[key]["input_equal"], f"{name}: the encoder's input "
             f"differs from the JAX package's"),
            (check, pts == gold[f"{key}_pts"].tolist() and
             len(lens) == len(pts), f"{name}: packets or pts differ from the "
             f"JAX package's"),
            (lim, res[key]["bytes_rel"] <= AUDIO_BYTES_TOL, f"{name}: bytes"),
            (lim, abs(res[key]["snr_gap"]) <= AUDIO_SNR_TOL_DB,
             f"{name}: decoded SNR")]
    # every path read (and logged) before any verdict, so that a failing
    # run prints them all
    for fn, ok, what in verdicts:
        fn(ok, what)
    if graphs is not None:
        res["graphs"] = graph_checks(graphs, gold, lim)
    return res


def scale_exact(planes, gold) -> list:
    """planes scaled by scale=960:544 exactly: float64 GEMMs, on the
    planes' device, through the JAX package's resize matrices (gold's
    scale_m<source size>; the scale halves every plane). Per plane, the
    samples rounded (floor(x + 0.5), clipped) and the mask of the ties
    (within FILT_TIE of k + 0.5)."""
    import torch

    out = []
    for p in planes:
        p = torch.as_tensor(p)
        mv, mh = (torch.from_numpy(gold[f"scale_m{n}"]).to(p.device,
                                                           torch.float64)
                  for n in p.shape)
        y = mv @ p.to(torch.float64) @ mh.T
        out.append((torch.floor(y + 0.5).clamp(0, 255),
                    (y - torch.floor(y) - 0.5).abs() <= FILT_TIE))
    return out


def scaled_graph_checks(graphs: dict, gold) -> dict:
    """The scaler in front of the stacks and tile, and the graphs
    (FILTER_SCALED_GRAPHS). graphs["_scaled"] (taken out here) holds the
    scaler's input and output frames. Each output of a graph must equal
    the port's scaled frames stacked or tiled. Read: the scaled samples
    that differ from the exact scale (scale_exact) off a tie; against the
    JAX package's outputs, the sampled samples that differ, how many of
    them are off a tie, and each plane sum's gap beyond its count of
    ties (`over` when any is read)."""
    import numpy as np
    import torch

    frames, scaled = graphs.pop("_scaled")
    differ = off = 0
    for f, s in zip(frames, scaled):
        for (r, tie), q in zip(scale_exact(f.planes, gold), s.planes):
            d = torch.as_tensor(q).to(r) != r
            differ += int(d.sum())
            off += int((d & ~tie).sum())
    res = {"scale": {"frames": len(scaled), "differ": differ,
                     "off_tie": off, "over": off > 0}}
    sc = [[host(p) for p in f.planes] for f in scaled]
    for name in FILTER_SCALED_GRAPHS:
        g, k = graphs[name], f"g_{name}"
        n = len(sc) // 4 if name == "tile" else len(sc)
        wrong = [i for i in range(n)
                 if g["md5"][i] != digest(*scaled_graph_planes(name, sc, i))]
        check(g["n"] == n and not wrong, f"graph {name}: outputs {wrong} "
              f"of {g['n']} are not the port's scaled frames joined")
        d = np.abs(np.concatenate(g["rows"]).astype(np.int32)
                   - np.concatenate(gold[f"{k}_rows"]).astype(np.int32))
        off_tie = int(np.count_nonzero(d[~np.concatenate(
            gold[f"{k}_tie_rows"])]))
        gap = np.abs(np.asarray(g["sums"], np.int64) - gold[f"{k}_sums"])
        beyond = int(np.maximum(gap - gold[f"{k}_ties"], 0).sum())
        res[name] = {"n": g["n"], "equal": sum(
                         a == bytes(b) for a, b in zip(g["md5"],
                                                       gold[f"{k}_md5"])),
                     "rows_share": float(np.count_nonzero(d) / d.size),
                     "rows_max": int(d.max(initial=0)),
                     "rows_off_tie": off_tie, "sums_beyond_ties": beyond,
                     "sums_gap": _sums_gap(g["sums"], gold[f"{k}_sums"],
                                           gold[f"{k}_numel"])}
        res[name]["over"] = bool(off_tie or beyond or d.max(initial=0) > 1)
    return res


def graph_checks(graphs: dict, gold, lim) -> dict:
    """The graph-API outputs against the JAX package's: exact graphs by
    md5 and pts, lut3d by plane sums and sampled rows, the stacks and
    tile by scaled_graph_checks."""
    import numpy as np

    scaled = scaled_graph_checks(graphs, gold)
    res, bad, over = {"scale": scaled["scale"]}, [], []
    if res["scale"].pop("over"):
        over.append("scale")
    for name in FILTER_GRAPHS:
        g, k = graphs[name], f"g_{name}"
        check(g["n"] == len(gold[f"{k}_pts"]) and
              g["pts"] == gold[f"{k}_pts"].tolist(),
              f"graph {name}: {g['n']} outputs, pts {g['pts'][:8]}...")
        if name in scaled:
            res[name] = scaled[name]
            if res[name].pop("over"):
                over.append(name)
            continue
        same = sum(a == bytes(b) for a, b in zip(g["md5"], gold[f"{k}_md5"]))
        res[name] = {"n": g["n"], "equal": same}
        if name not in FILTER_FLOAT_GRAPHS:
            if same != g["n"]:
                bad.append(name)
            continue
        sums_gap = _sums_gap(g["sums"], gold[f"{k}_sums"],
                             gold[f"{k}_numel"])
        share, dmax = _rows_diff(g["rows"], list(gold[f"{k}_rows"]))
        if not (sums_gap <= FILT_SUM_TOL and share <= FILT_SHARE
                and dmax <= FILT_LUT_MAX):
            over.append(name)
        res[name].update(sums_gap=sums_gap, rows_share=share, rows_max=dmax)
    log("filters graphs: " + json.dumps(res))
    check(not bad, f"graphs whose outputs differ from the JAX package's: "
          f"{ {n: res[n] for n in bad} }")
    lim(not over, f"float graphs over their limits: "
        f"{ {n: res[n] for n in over} }")
    return res


def port_graph_pkg(dev: str) -> dict:
    """The port's pieces filters_graphs takes."""
    import numpy as np
    import torch

    from librempeg_tpu_torch.core.frame import AudioFrame, VideoFrame
    from librempeg_tpu_torch.core.rational import Rational
    from librempeg_tpu_torch.core.samplefmt import ChannelLayout
    from librempeg_tpu_torch.filters import GraphRunner, StreamProps

    return {"GraphRunner": GraphRunner, "StreamProps": StreamProps,
            "Rational": Rational, "VideoFrame": VideoFrame,
            "AudioFrame": AudioFrame, "ChannelLayout": ChannelLayout,
            "to_data": lambda a: torch.from_numpy(
                np.ascontiguousarray(a)).to(dev)}


def decoded_frames(dev: str) -> list:
    """The asset's 48 frames decoded on `dev`, at pts 0..47 in 1/25."""
    from librempeg_tpu_torch.codecs.h264.codec import H264Decoder
    from librempeg_tpu_torch.core.rational import Rational
    from librempeg_tpu_torch.formats.api import open_input

    demux = open_input(ASSET)
    dec = H264Decoder(demux.streams[0].codecpar, device=dev)
    frames = [f for p in demux.packets() for f in dec.decode(p)]
    frames += dec.flush()
    demux.close()
    return [f.replace(pts=i, time_base=Rational(1, 25))
            for i, f in enumerate(frames)]


def single_biquad_calls(dev: str, audio) -> list:
    """SINGLE_BIQUAD, a graph of one biquad, over the WAV's [2, n] int16
    samples in AUDIO_CHUNK packets on `dev` through the port's
    GraphRunner: its kernel launches (inputs and outputs, as
    filters_paths records F3's)."""
    from librempeg_tpu_torch.kernels import biquad as KB

    pkg = port_graph_pkg(dev)
    SP, R, CL = pkg["StreamProps"], pkg["Rational"], pkg["ChannelLayout"]
    props = SP(media="audio", sample_rate=AUDIO_IN_RATE, sample_fmt="s16p",
               layout=CL.default(2), time_base=R(1, AUDIO_IN_RATE))
    g = pkg["GraphRunner"](SINGLE_BIQUAD, props)
    calls, launch = [], KB.launch

    def recorded(xx, coefs, z, fmt):
        y, zo = launch(xx, coefs, z, fmt)
        calls.append(((xx, tuple(map(tuple, coefs)), z, fmt), (y, zo)))
        return y, zo

    KB.launch = recorded
    try:
        for s in range(0, audio.shape[1], AUDIO_CHUNK):
            g.push(pkg["AudioFrame"](
                data=pkg["to_data"](audio[:, s:s + AUDIO_CHUNK]),
                sample_rate=AUDIO_IN_RATE, sample_fmt="s16p",
                layout=CL.default(2), pts=s, time_base=R(1, AUDIO_IN_RATE)))
        g.finish()
    finally:
        KB.launch = launch
    return calls


def biquad_replay(calls, dev: str) -> tuple:
    """Replay recorded biquad launches through the plain cascade, the
    calls of one run and length stacked along the channels; each must be
    equal by value -> (largest error, replays)."""
    import torch

    from librempeg_tpu_torch.kernels import biquad as KB

    err, groups = 0.0, {}
    for args, outs in calls:
        groups.setdefault((args[1], args[3], args[0].shape[1]), []).append(
            (args, outs))
    for (coefs, fmt, n), group in groups.items():
        want = KB.biquad_cascade_plain(
            torch.cat([g[0][0] for g in group]), coefs,
            torch.cat([g[0][2] for g in group], 1), fmt)
        got = (torch.cat([g[1][0] for g in group]),
               torch.cat([g[1][1] for g in group], 1))
        sync(dev)
        e = max_abs_err(got, want)
        check(e == 0, f"biquad ({len(coefs)} stages, {len(group)} calls of "
              f"{n} samples, {fmt}) differs from its plain version: {e}")
        err = max(err, e)
    return err, len(groups)


def quant_phase(dev) -> dict:
    """The MPEG-4 quantisers on the card against the CPU (ROADMAP
    section 3, the scalar divisions): the spec DCT coefficients of the
    asset's first two frames scaled to 1280x720 (intra: frame 0's
    planes; inter: frame 1 minus frame 0, plane by plane), computed once
    on the CPU and copied to the card. At each of QUANT_QSCALES,
    _quant_intra's DC and AC levels, _quant_inter's levels and the
    trellis's first levels must equal the CPU's; the levels of
    trunc(c / 2q) with 2q a Python scalar (the form before the repair)
    are counted beside them."""
    import torch

    from librempeg_tpu_torch.codecs.mpeg4 import encoder as ME
    from librempeg_tpu_torch.codecs.mpeg4 import tables as MT
    from librempeg_tpu_torch.codecs.mpeg4 import trellis as MTR
    from librempeg_tpu_torch.ops import dct8x8
    from librempeg_tpu_torch.scale import get_scaler

    _, frames = capture_p_frame(dev)
    sc = get_scaler("yuv420p", frames[0].width, frames[0].height, "yuv420p",
                    1280, 720)
    planes = [sc.scale_planes(tuple(p.cpu() for p in f.planes), device="cpu")
              for f in frames[:2]]

    def coeffs(ps):
        return torch.cat([ME._fdct_spec(dct8x8.to_blocks(p))
                          for p in ps]).contiguous()

    intra = coeffs([p.to(torch.float32) for p in planes[0]])
    inter = coeffs([a.to(torch.float32) - b.to(torch.float32)
                    for a, b in zip(planes[1], planes[0])])
    res = {"blocks": intra.shape[0], "differ": {}, "old_form_differ": {}}
    for q in QUANT_QSCALES:
        levels = {}
        for d in ("cpu", dev):
            ci, cn = intra.to(d), inter.to(d)
            dc, ac, _ = ME._quant_intra(ci, q, MT.dc_scaler(q, False))
            lv, _ = ME._quant_inter(cn, q)
            levels[d] = [t.cpu() for t in (
                dc, ac, lv, MTR._base_levels(ci.abs(), q),
                torch.trunc(ci / (2.0 * q)))]
        n = [int((a != b).sum()) for a, b in zip(levels["cpu"], levels[dev])]
        check(n[:4] == [0, 0, 0, 0], f"MPEG-4 levels at qscale {q} differ "
              f"between the card and the CPU (intra DC, AC, inter, trellis "
              f"first levels): {n[:4]}")
        res["differ"][q], res["old_form_differ"][q] = n[:4], n[4]
    return res


def filters_phase(dev: str) -> dict:
    """The filter slice on the card: F1-F4 and the graph-API graphs
    held to the goldens, the biquad kernel replayed through its plain
    version on every launch of F3, the full search against its plain
    version on minterpolate's inputs at r = 8 and r = 16, and the
    kernels' times on the path's shapes."""
    import numpy as np
    import torch

    from librempeg_tpu_torch.kernels import biquad as KB
    from librempeg_tpu_torch.ops import motion
    from librempeg_tpu_torch.ops.pallas import mesearch as MS

    gold = np.load(os.path.join(GOLD, FILTERS_GOLD))
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        run = filters_paths(dev, td)
        t_graphs = time.perf_counter()
        frames = decoded_frames(dev)
        graphs = filters_graphs(frames, run["wav"], td, port_graph_pkg(dev))
        graphs_s = time.perf_counter() - t_graphs
        res = filters_checks(dev, run, gold, graphs)

    # launches on each path
    counts = {k: run[k]["launches"] for k in ("F1", "F2", "F3", "F4v",
                                                "F4a")}
    for k in ("F1", "F2"):
        c, n_p = counts[k], res[k.lower()]["types"].count("P")
        check(c["mc"] == c["intra"] == c["deblock"] == 44 and c["hpel"] == n_p,
              f"{k}: launches {c} for {n_p} P-VOPs")
    check(counts["F2"]["fsearch"] == len(run["F2"]["mvs"]) == 47,
          f"F2: fsearch launches {counts['F2']['fsearch']}, "
          f"{len(run['F2']['mvs'])} searches")
    calls = run["F3"]["calls"]
    n_wav = -(-AUDIO_SECONDS * AUDIO_IN_RATE // AUDIO_CHUNK)
    check(counts["F3"]["biquad"] == len(calls) == n_wav
          and all(len(c[0][1]) == 4 for c in calls),
          f"F3: biquad launches {counts['F3']['biquad']}, {len(calls)} "
          f"calls, for a run of 4 filters over {n_wav} WAV packets")
    check(counts["F4v"]["hpel"] == res["f4v"]["types"].count("P"),
          f"F4: launches {counts['F4v']}")

    # every biquad launch of F3, and of the one-biquad graph, replayed
    # through the plain cascade
    single = single_biquad_calls(dev, run["wav"])
    check(len(single) == n_wav and all(len(c[0][1]) == 1 for c in single),
          f"{SINGLE_BIQUAD}: {len(single)} launches for {n_wav} packets")
    replay_err = biquad_replay(calls, dev)
    replays = biquad_replay(single, dev)
    args = calls[len(calls) // 2][0]
    c, n = args[0].shape
    stages, fmt = len(args[1]), args[3]
    hz = sm_clock_hz()
    chain_ms = n * BIQUAD_CHAIN_OPS * DEP_OP_CYCLES / hz * 1e3
    trip = BIQUAD_TRIP_OPS[fmt.rstrip("p")]
    hand_ms = (stages - 1) * (1 + trip) * DEP_OP_CYCLES / hz * 1e3
    byte_ms = nbytes(args[0], args[2], args[0], args[2]) / HBM_BYTES_S * 1e3
    lat_ms = chain_ms + hand_ms
    biquad = {
        "max_abs_err": max(replay_err[0], replays[0]), "launches": len(calls),
        **timed(lambda: KB.launch(*args)),
        "plain_ms": median_ms(lambda: KB.biquad_cascade_plain(*args),
                              runs=3, warm=1),
        "bound_ms": max(lat_ms, byte_ms),
        "bound_by": "operations" if lat_ms >= byte_ms else "bytes",
        "bound_chain_ms": chain_ms, "bound_handoff_ms": hand_ms,
        "bound_note": f"a serial chain: {n} steps of {BIQUAD_CHAIN_OPS} "
                      f"dependent operations ({chain_ms:.6f} ms) and "
                      f"{stages - 1} handoffs of {1 + trip} "
                      f"({hand_ms:.6f} ms), at {DEP_OP_CYCLES} cycles "
                      f"each and the highest SM clock; the bytes take "
                      f"{byte_ms:.6f} ms",
        "library_ms": None,
        "library_note": "no single PyTorch call computes a recursive "
                        "(IIR) filter",
        "single_launches": len(single),
        "shape": f"a run of {stages} stages, {c} channels x {n} samples "
                 f"({fmt}, a WAV packet of F3); equal by value on all "
                 f"{len(calls)} launches of F3 in {replay_err[1]} stacked "
                 f"replays and on all {len(single)} one-stage launches of "
                 f"{SINGLE_BIQUAD} in {replays[1]}"}

    # the full search on minterpolate's first search inputs, at the
    # path's r and at 16
    cur, ref, r = run["F2"]["search"][0]
    fs = {}
    for rr in (r, 16):
        e = max_abs_err(MS.full_search_mc(cur, ref, rr, *cur.shape[1:]),
                        motion.full_search_mc_xla(cur, ref, rr, 16, 1))
        check(e == 0, f"fsearch on minterpolate's inputs, r={rr}: {e}")
        fs[rr] = e
    nmb = cur.shape[1] // 16 * (cur.shape[2] // 16)
    side = 2 * r + 1
    fsearch = {"r": r, "max_abs_err": max(fs.values()),
               **timed(lambda: MS.full_search_mc(cur, ref, r,
                                                 *cur.shape[1:])),
               "plain_ms": median_ms(lambda: motion.full_search_mc_xla(
                   cur, ref, r, 16, 1), runs=3, warm=1),
               **bound(nbytes(cur, ref, cur), nmb * side * side * 256 * 3),
               "shape": f"1x{cur.shape[1]}x{cur.shape[2]}, r={r}, {nmb} MBs "
                        f"(minterpolate; equal to the plain search at r={r} "
                        f"and r=16)"}
    res.update({
        "biquad": biquad, "fsearch_minterpolate": fsearch,
        "launches": {k: sum(c[k] for c in counts.values())
                     for k in counts["F1"]},
        "path_launches": counts, "graphs_s": graphs_s,
        "wall_s": {k: run[k]["wall_s"] for k in counts},
        "split_s": {k: run[k]["split_s"] for k in counts},
        "phase_s": time.perf_counter() - t_phase})
    return res


# ---------------------------------------------------------------------------
# containers: remux, decode through each container, seek, transcode into
# containers, checkpoint/resume, the profiler's trace
# ---------------------------------------------------------------------------

CONT_GOLD = "bench_1080p_containers.json"
CONT_SOURCES = ("264", "mp4", "mkv", "ts")
CONT_SEEK = (13, 38)       # -ss 0.5 -t 1.0: frames 13-37 of the decode
CONT_CUT = 24              # packets before the video snapshot (an IDR)
CONT_DITHER_CUT = 200      # WAV packets before the dithered snapshot
CONT_READBACK = 12         # VOPs of the MPEG-4 MP4 the vendored decoder reads
CONT_TRACE_KERNELS = {"mc": "mc_kernel", "intra": "intra_kernel",
                      "deblock": "deblock_rows_kernel"}
# the repaired fields of an H.264 stream in MPEG-TS (the JAX package's
# demuxer leaves them 0; ROADMAP section 3b)
CONT_TS_REPAIRED = {"width": 1920, "height": 1088}


def containers_commands(td: str, wav: str) -> dict:
    """The containers phase's command lines (cli.ffmpeg; the JAX
    package's CLI takes the same), with outputs in td: R_* stream-copy
    the asset into MP4, Matroska and MPEG-TS; D_* decode each source to
    framemd5, S_* the same after -ss 0.5 -t 1.0; V the Matroska copy to
    1280x720 MPEG-4 -q:v 5 in MP4; A_* the WAV to 48 kHz AAC in MP4 and
    Matroska; DITHER the WAV through the noise shaper to s16 PCM."""
    j = os.path.join
    src = {"264": ASSET, **{e: j(td, f"bench.{e}") for e in CONT_SOURCES[1:]}}
    cmd = {f"R_{e}": ["-i", ASSET, "-c:v", "copy", "-y", src[e]]
           for e in CONT_SOURCES[1:]}
    for s, path in src.items():
        cmd[f"D_{s}"] = ["-i", path, "-f", "framemd5", "-y",
                         j(td, f"d_{s}.md5")]
        cmd[f"S_{s}"] = ["-ss", "0.5", "-i", path, "-t", "1.0", "-f",
                         "framemd5", "-y", j(td, f"s_{s}.md5")]
    cmd["V"] = ["-i", src["mkv"], "-s", "1280x720", "-c:v", "mpeg4", "-q:v",
                "5", "-y", j(td, "v.mp4")]
    for e in ("mp4", "mkv"):
        cmd[f"A_{e}"] = ["-i", wav, "-ar", "48000", "-c:a", "aac", "-b:a",
                         "128k", "-y", j(td, f"a.{e}")]
    cmd["DITHER"] = ["-i", wav, "-af",
                     "aresample=48000:dither_method=lipshitz", "-c:a",
                     "pcm_s16le", "-y", j(td, "dither.wav")]
    return cmd


def probe_json(ffprobe, path: str) -> dict:
    """`ffprobe -show_streams -show_format -show_packets -of json` of
    path by the given package's cli.ffprobe, the file's name made its
    base name."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(ffprobe.main(["-show_streams", "-show_format",
                            "-show_packets", "-of", "json", path]) == 0,
              f"ffprobe {path}")
    info = json.loads(buf.getvalue())
    info["format"]["filename"] = os.path.basename(path)
    return info


def md5_lines(text: str) -> tuple[list, list]:
    """A framemd5 text's header lines and frame lines."""
    lines = text.splitlines()
    return ([ln for ln in lines if ln.startswith("#")],
            [ln for ln in lines if not ln.startswith("#")])


def demuxed(path: str) -> list:
    """(pts, bytes) of every packet of a file, by the port's demuxer."""
    from librempeg_tpu_torch.formats.api import open_input

    d = open_input(path)
    out = [(p.pts, bytes(p.data)) for p in d.packets()]
    d.close()
    return out


def resumed_run(argv: list[str], out: str, dev: str, cut: int) -> dict:
    """argv (its output replaced by out) through Transcoder: `cut`
    packets, a snapshot, and the rest in a fresh Transcoder restored from
    it. Returns the restored run's packets (pts, bytes, key) as the muxer
    receives them and the kernels' launches before and after the cut."""
    from librempeg_tpu_torch import kernels
    from librempeg_tpu_torch.cli.ffmpeg import parse_args
    from librempeg_tpu_torch.core.packet import PktFlags
    from librempeg_tpu_torch.sched import checkpoint
    from librempeg_tpu_torch.sched.pipeline import Transcoder

    root, ext = os.path.splitext(out)
    spec, _ = parse_args(argv[:-1] + [root + ".head" + ext, "-device", dev])
    head = Transcoder(spec)
    kernels.reset_counts()
    t0 = time.perf_counter()
    for i, pkt in enumerate(head.demux.packets()):
        head.chains[pkt.stream_index].send_packet(pkt, head.mux)
        if i + 1 == cut:
            break
    blob = checkpoint.snapshot(head)
    before = kernels.counts()
    for chain in head.chains.values():
        if hasattr(chain, "_join_encodes"):
            chain._join_encodes()
    head.demux.close()
    spec, _ = parse_args(argv[:-1] + [out, "-device", dev])
    tc = Transcoder(spec)
    checkpoint.restore(tc, blob)
    pk, write = [], tc.mux.write

    def rec(p):
        pk.append((p.pts, bytes(p.data), bool(p.flags & PktFlags.KEY)))
        write(p)

    tc.mux.write = rec
    kernels.reset_counts()
    tc.run()
    sync(dev)
    return {"packets": pk, "before": before, "after": kernels.counts(),
            "blob_bytes": len(blob), "wall_s": time.perf_counter() - t0}


def trace_child(argv_json: str, trace: str, dev: str) -> None:
    """Run one command line under profiler.device_trace in this process
    (a fresh one: a second torch.profiler window in a process may record
    no device events) and print the kernels' launch counts as JSON."""
    import torch

    from librempeg_tpu_torch import kernels
    from librempeg_tpu_torch.utils import profiler

    argv = json.loads(argv_json)
    cli_run(argv, dev)                     # warm: the kernels load
    kernels.reset_counts()
    with profiler.device_trace(trace):
        # a window's first device event can go unrecorded: open it with a
        # short sleep kernel, dropped from the counts
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        run = cli_run(argv, dev)
    print(json.dumps({"launches": run["launches"], "wall_s": run["wall_s"]}))


def trace_stats(trace: str) -> dict:
    """From a Chrome trace: each traced kernel's launches, and the card's
    busy time (the union of its kernel and copy intervals) and idle share
    over the window from the first to the last event of the trace."""
    ev = [e for e in json.load(open(trace))["traceEvents"]
          if e.get("ph") == "X" and "dur" in e]
    dev_ev = [e for e in ev if e.get("cat") in ("kernel", "gpu_memcpy",
                                                "gpu_memset")
              and "spin_kernel" not in e.get("name", "")]
    counts = {k: sum(name in e["name"] for e in dev_ev
                     if e.get("cat") == "kernel")
              for k, name in CONT_TRACE_KERNELS.items()}
    busy, end = 0.0, -math.inf
    for e in sorted(dev_ev, key=lambda e: e["ts"]):
        s, t = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    t0 = min(e["ts"] for e in ev)
    t1 = max(e["ts"] + e["dur"] for e in ev)
    return {"launches": counts, "busy_ms": busy / 1e3,
            "window_ms": (t1 - t0) / 1e3,
            "idle_share": 1 - busy / (t1 - t0),
            "device_events": len(dev_ev)}


def containers_phase(dev: str) -> dict:
    """Remux, framemd5 through each container, -ss/-t, transcodes into
    MP4 and Matroska, checkpoint/resume and the profiler's trace, held to
    tests/data/torch_port/bench_1080p_containers.json (the JAX package's
    runs of the same command lines on the CPU)."""
    import numpy as np

    from librempeg_tpu_torch import kernels
    from librempeg_tpu_torch.cli import ffprobe
    from librempeg_tpu_torch.codecs.mpeg4._decoder import Mpeg4Decoder
    from librempeg_tpu_torch.core.packet import Packet

    gold = json.load(open(os.path.join(GOLD, CONT_GOLD)))
    frames_md5 = open(os.path.join(GOLD, "bench_1080p_frames.md5")).read(
        ).split()
    t_phase = time.perf_counter()
    res = {"wall_s": {}, "rate": {}, "split_s": {}, "launches": {}}
    total = dict.fromkeys(KERNELS, 0)

    def run(name, argv, **kw):
        r = cli_run(argv, dev, **kw)
        res["wall_s"][name] = r["wall_s"]
        res["split_s"][name] = {k: round(v, 4) for k, v in
                                r["split_s"].items()}
        res["launches"][name] = {k: v for k, v in r["launches"].items()
                                 if v}
        for k, v in r["launches"].items():
            total[k] += v
        return r

    with tempfile.TemporaryDirectory() as td:
        wav = os.path.join(td, "in.wav")
        write_audio_wav(wav, AUDIO_SECONDS)
        cmd = containers_commands(td, wav)

        # 1. remux, ffprobe
        for e in CONT_SOURCES[1:]:
            run(f"R_{e}", cmd[f"R_{e}"])
            path = cmd[f"R_{e}"][-1]
            md5 = hashlib.md5(open(path, "rb").read()).hexdigest()
            check(md5 == gold["remux_md5"][e],
                  f"remux {e}: md5 {md5} is not the JAX package's")
            info = probe_json(ffprobe, path)
            if e == "ts":
                for s in info["streams"]:
                    check({k: s[k] for k in CONT_TS_REPAIRED} ==
                          CONT_TS_REPAIRED, f"ffprobe ts: {s}")
                    s.update(dict.fromkeys(CONT_TS_REPAIRED, 0))
            check(info == gold["ffprobe"][e],
                  f"ffprobe {e}: differs from the JAX package's")
        log(f"containers remux: md5 and ffprobe JSON (streams, format, "
            f"{len(gold['ffprobe']['mp4']['packets'])} packets) equal the "
            f"JAX package's for {list(CONT_SOURCES[1:])}")

        # 2. decode through each container to framemd5
        full = {}
        for s in CONT_SOURCES:
            r = run(f"D_{s}", cmd[f"D_{s}"])
            text = open(cmd[f"D_{s}"][-1]).read()
            full[s] = md5_lines(text)
            res["rate"][f"D_{s}"] = 48 / r["wall_s"]
            want = gold["framemd5"][s]
            if s == "ts":
                # the JAX package's MPEG-TS demuxer leaves the size 0x0
                text = text.replace(
                    "#dimensions 0: {width}x{height}\n".format(
                        **CONT_TS_REPAIRED), "#dimensions 0: 0x0\n", 1)
            check(text == want,
                  f"framemd5 of {s}: differs from the JAX package's")
            hashes = [ln.split(", ")[-1] for ln in full[s][1]]
            check(hashes == frames_md5, f"framemd5 of {s}: the 48 hashes "
                  f"are not bench_1080p_frames.md5")
            check(all(r["launches"][k] == 44 for k in E2E_KERNELS[:3]),
                  f"decode of {s}: launches {r['launches']}")
        log(f"containers decode: framemd5 equal to the JAX package's from "
            f"{list(CONT_SOURCES)}; the 48 hashes are "
            f"bench_1080p_frames.md5; mc, intra, deblock 44 a run")

        # 3. -ss 0.5 -t 1.0
        a, b = CONT_SEEK
        for s in CONT_SOURCES:
            r = run(f"S_{s}", cmd[f"S_{s}"])
            text = open(cmd[f"S_{s}"][-1]).read()
            res["rate"][f"S_{s}"] = (b - a) / r["wall_s"]
            head, lines = md5_lines(text)
            check(head == full[s][0] and lines == full[s][1][a:b],
                  f"seek {s}: not frames {a}-{b - 1} of its decode")
            if gold["seek"][s] is None:
                # the JAX package refuses this seek (section 3b)
                check("SPS/PPS" in gold["seek_error"][s], gold["seek_error"])
            else:
                check(text == gold["seek"][s],
                      f"seek {s}: differs from the JAX package's")
        seek_launches = {s: res["launches"][f"S_{s}"] for s in CONT_SOURCES}
        check(len({json.dumps(v, sort_keys=True)
                   for v in seek_launches.values()}) == 1,
              f"seek launches differ by source: {seek_launches}")
        seekable = [s for s in CONT_SOURCES if gold["seek"][s] is not None]
        log(f"containers seek: frames {a}-{b - 1} from every source, equal "
            f"to the JAX package's from {seekable} (its MPEG-TS seek "
            f"fails: {gold['seek_error']['ts']!r}); launches "
            f"{seek_launches['264']}")

        # 4. transcodes into containers: MPEG-4 in MP4
        inputs, enc, refs = [], [], {}

        def on_input(frame):
            if len(inputs) < CONT_READBACK:
                inputs.append(tuple(host(p) for p in frame.planes))

        def prepare(tc):
            tc.chains[0].encoder.recon_psnr = []
            enc.append(tc.chains[0].encoder)
            keep_references(enc[0], refs, CONT_READBACK)

        v = run("V", cmd["V"], on_input=on_input, prepare=prepare)
        res["rate"]["V"] = 48 / v["wall_s"]
        gv = gold["v"]
        types = "".join(vop_type(d) for _, d, _ in v["packets"])
        nbytes = sum(len(d) for _, d, _ in v["packets"])
        ps = enc[0].recon_psnr
        dem = demuxed(cmd["V"][-1])
        dec = Mpeg4Decoder(device=None)  # host numpy planes
        back = [f for p, d in dem[:CONT_READBACK]
                for f in dec.decode(Packet(data=d, pts=p))] + dec.flush()
        check(len(back) == CONT_READBACK and back[0].planes[0].shape ==
              (720, 1280), f"V: read back {len(back)} frames")
        bad = same_pictures(back, refs)
        check(len(refs) == CONT_READBACK and bad == [], "V: the decoder's "
              f"pictures are not the encoder's references: {bad}")
        dpsnr = statistics.fmean(planes_psnr_db(x, f.planes)
                                 for x, f in zip(inputs, back))
        res["v"] = {"types": types, "bytes": nbytes,
                    "bytes_rel": abs(nbytes - sum(gv["sizes"]))
                    / sum(gv["sizes"]),
                    "recon_psnr": statistics.fmean(ps),
                    "psnr_gap": statistics.fmean(ps)
                    - statistics.fmean(gv["recon_psnr"]),
                    "readback_psnr": dpsnr,
                    "readback_gap": dpsnr - gv["readback_psnr"]}
        log("containers V: " + json.dumps(res["v"]))
        check(types == gv["types"] and [p for p, _, _ in v["packets"]] ==
              gv["pts"] and [p for p, _ in dem] == gv["file_pts"],
              "V: VOP types or pts differ from the JAX package's")
        check([d for _, d in dem] == [d for _, d, _ in v["packets"]],
              "V: the MP4's packets are not the encoder's")
        check(res["v"]["bytes_rel"] <= FILT_BYTES_REL, "V: bytes")
        check(abs(res["v"]["psnr_gap"]) <= FILT_PSNR_TOL_DB,
              "V: recon PSNR mean")
        check(v["launches"]["hpel"] == types.count("P") and all(
            v["launches"][k] == 44 for k in E2E_KERNELS[:3]),
            f"V: launches {v['launches']}")

        # AAC in MP4 and Matroska
        for e in ("mp4", "mkv"):
            ins = []
            r = run(f"A_{e}", cmd[f"A_{e}"],
                    on_input=lambda f, ins=ins: ins.append(host(f.data)))
            res["rate"][f"A_{e}"] = AUDIO_SECONDS / r["wall_s"]
            ga = gold["aac"][e]
            dem = demuxed(cmd[f"A_{e}"][-1])
            adts = os.path.join(td, f"a_{e}.aac")
            with open(adts, "wb") as f:
                f.write(b"".join(d for _, d in dem))
            x = np.concatenate(ins, 1)
            snr = aac_snr(dev, adts, x if x.dtype == np.int16
                          else x.astype(np.float64) * 32768.0)
            nb = sum(len(d) for _, d, _ in r["packets"])
            res[f"a_{e}"] = {"bytes": nb, "bytes_rel": abs(
                nb - sum(ga["sizes"])) / sum(ga["sizes"]), "snr_db": snr,
                "snr_gap": snr - ga["snr_db"]}
            log(f"containers A_{e}: " + json.dumps(res[f"a_{e}"]))
            check([p for p, _, _ in r["packets"]] == ga["pts"] and
                  [p for p, _ in dem] == ga["file_pts"],
                  f"A_{e}: pts differ from the JAX package's")
            check(res[f"a_{e}"]["bytes_rel"] <= AUDIO_BYTES_TOL,
                  f"A_{e}: bytes")
            check(abs(res[f"a_{e}"]["snr_gap"]) <= AUDIO_SNR_TOL_DB,
                  f"A_{e}: decoded SNR")

        # 5. checkpoint on the card: MPEG-4 from Matroska and MP4, cut at
        # the IDR of packet 24; the dithered WAV after 200 packets
        want = [(d, k) for _, d, k in v["packets"][CONT_CUT:]]
        for s in ("mkv", "mp4"):
            argv = ["-i", cmd[f"D_{s}"][1]] + cmd["V"][2:]
            ck = resumed_run(argv, os.path.join(td, f"ck_{s}.mp4"), dev,
                             CONT_CUT)
            res[f"ck_{s}"] = {"packets": len(ck["packets"]),
                              "snapshot_bytes": ck["blob_bytes"],
                              "wall_s": ck["wall_s"],
                              "before": {k: n for k, n in
                                         ck["before"].items() if n},
                              "after": {k: n for k, n in
                                        ck["after"].items() if n}}
            log(f"containers checkpoint {s}: " + json.dumps(res[f"ck_{s}"]))
            check([(d, k) for _, d, k in ck["packets"]] == want,
                  f"checkpoint {s}: the resumed packets differ from the "
                  f"uninterrupted run's")
            check(all(ck["before"][k] + ck["after"][k] == v["launches"][k]
                      for k in E2E_KERNELS), f"checkpoint {s}: launches")
        d = run("DITHER", cmd["DITHER"])
        ck = resumed_run(cmd["DITHER"], os.path.join(td, "ck_d.wav"), dev,
                         CONT_DITHER_CUT)
        _, x_full = read_wav(cmd["DITHER"][-1])
        _, x_tail = read_wav(os.path.join(td, "ck_d.wav"))
        res["ck_dither"] = {"samples": int(x_tail.shape[1]),
                            "before": ck["before"]["shape_scan"],
                            "after": ck["after"]["shape_scan"],
                            "uninterrupted": d["launches"]["shape_scan"],
                            "wall_s": ck["wall_s"]}
        log("containers checkpoint dither: " + json.dumps(res["ck_dither"]))
        check(x_tail.shape[1] > 0 and np.array_equal(
            x_full[:, x_full.shape[1] - x_tail.shape[1]:], x_tail),
            "checkpoint dither: the resumed samples differ from the "
            "uninterrupted run's")
        check(ck["before"]["shape_scan"] == CONT_DITHER_CUT and
              ck["before"]["shape_scan"] + ck["after"]["shape_scan"] ==
              d["launches"]["shape_scan"], "checkpoint dither: launches")

        # 6. the profiler's trace, in a fresh process
        trace = os.path.join(td, "trace.json")
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.trace_child(*sys.argv[1:])",
             json.dumps(cmd["D_mp4"]), trace, dev],
            capture_output=True, text=True, cwd=ROOT, timeout=600)
        check(child.returncode == 0, child.stderr[-3000:])
        counted = json.loads(child.stdout.strip().splitlines()[-1])
        ts = trace_stats(trace)
        ts["counters"] = {k: counted["launches"][k]
                          for k in CONT_TRACE_KERNELS}
        ts["run_wall_s"] = counted["wall_s"]
        ts["child_s"] = time.perf_counter() - t0
        res["trace"] = ts
        log("containers trace: " + json.dumps(ts))
        check(ts["launches"] == ts["counters"] and
              all(n == 44 for n in ts["counters"].values()),
              f"trace: kernels {ts['launches']} against the launch counters "
              f"{ts['counters']}")
    res["phase_s"] = time.perf_counter() - t_phase
    res["total_launches"] = total
    return res


ENC_GOLD = "bench_1080p_encoders.json"
ENC_E1_FRAMES = 4          # E1: I0 P2 B1 P3 in coding order
ENC_E1_P = 2               # E1's P frames: mc, intra, deblock once each
ENC_E3_FRAMES = 6          # E3: I P P P P P
# E3's rule, set before its first card run: MPEG-2's DCT is float64
# (D @ b @ D.T, then np.round), so a BLAS that sums in another order may
# round a .5 tie the other way. E3 passes with every packet identical to
# the JAX package's; or else with each packet's size within
# FILT_BYTES_REL and each frame's decoded PSNR (against the encoder's
# input) within FILT_PSNR_TOL_DB of the JAX package's, the count of
# identical packets printed. The card's decode of E3 equals the port's
# own recon exactly either way.


def encoders_commands(td: str) -> dict:
    """The encoders phase's command lines (cli.ffmpeg), outputs in td:
    E1 the asset's first frames to H.264 in MP4 (one B frame between
    references), E3 to MPEG-2 video in MPEG-TS."""
    j = os.path.join
    return {
        "E1": ["-i", ASSET, "-frames:v", str(ENC_E1_FRAMES), "-c:v", "h264",
               "-qp", "26", "-sr", "4", "-bf", "1", "-y", j(td, "e1.mp4")],
        "E3": ["-i", ASSET, "-frames:v", str(ENC_E3_FRAMES), "-c:v",
               "mpeg2video", "-q:v", "5", "-f", "mpegts", "-y",
               j(td, "e3.ts")],
    }


def ts_stream_types(path: str) -> list[int]:
    """The stream_type of every elementary stream in an MPEG-TS file's
    first PMT (ISO 13818-1 2.4.4.8)."""
    data = open(path, "rb").read()
    pmt_pids = set()
    for off in range(0, len(data) - 187, 188):
        pid = ((data[off + 1] & 0x1F) << 8) | data[off + 2]
        if not data[off + 1] & 0x40:
            continue
        q = off + 4
        if (data[off + 3] >> 4) & 2:          # adaptation field
            q += 1 + data[q]
        q += 1 + data[q]                       # pointer field
        if pid == 0 and data[q] == 0x00:       # PAT
            slen = ((data[q + 1] & 0x0F) << 8) | data[q + 2]
            for i in range(q + 8, q + 3 + slen - 4, 4):
                if (data[i] << 8) | data[i + 1]:
                    pmt_pids.add(((data[i + 2] & 0x1F) << 8) | data[i + 3])
        elif pid in pmt_pids and data[q] == 0x02:
            slen = ((data[q + 1] & 0x0F) << 8) | data[q + 2]
            r = q + 12 + (((data[q + 10] & 0x0F) << 8) | data[q + 11])
            types = []
            while r + 5 <= q + 3 + slen - 4:
                types.append(data[r])
                r += 5 + (((data[r + 3] & 0x0F) << 8) | data[r + 4])
            return types
    raise AssertionError(f"{path}: no PMT")


def packet_record(p) -> list:
    """A packet's [md5, size, pts, dts, key] (the goldens' form)."""
    return [hashlib.md5(bytes(p.data)).hexdigest(), len(p.data), int(p.pts),
            int(p.dts), bool(p.flags & 1)]


def encoders_phase(dev: str) -> dict:
    """E1-E3 through cli.ffmpeg's parser and Transcoder at 1920x1088,
    held to tests/data/torch_port/bench_1080p_encoders.json (the JAX
    package's runs on the CPU)."""
    import numpy as np

    from librempeg_tpu_torch import kernels
    from librempeg_tpu_torch.cli import ffprobe
    from librempeg_tpu_torch.codecs.bsf import find_bsf
    from librempeg_tpu_torch.codecs.h264.codec import H264Decoder
    from librempeg_tpu_torch.codecs.mpeg12.decoder import Mpeg12Decoder
    from librempeg_tpu_torch.core.packet import Packet
    from librempeg_tpu_torch.formats.api import CodecParameters, open_input

    gold = json.load(open(os.path.join(GOLD, ENC_GOLD)))
    t_phase = time.perf_counter()
    res = {"wall_s": {}, "fps": {}, "split_s": {}, "launches": {}}
    total = dict.fromkeys(KERNELS, 0)

    def count(name, launches):
        res["launches"][name] = {k: v for k, v in launches.items() if v}
        for k, v in launches.items():
            total[k] += v

    def encode(name, argv, frames, recon):
        """argv through cli_run; the packets as the muxer gets them and
        the encoder's recon after each frame it codes as a reference
        (recon(encoder, hook) wraps the encoder's reference step)."""
        got = {"pkts": [], "refs": {}}

        def prepare(tc):
            enc = tc.chains[0].encoder
            got["par"] = enc.codec_parameters()
            recon(enc, got["refs"])
            write = tc.mux.write

            def rec(p):
                got["pkts"].append(p)
                write(p)

            tc.mux.write = rec

        r = cli_run(argv, dev, keep_input=True, prepare=prepare)
        res["wall_s"][name] = r["wall_s"]
        res["fps"][name] = frames / r["wall_s"]
        split = {k: round(v, 4) for k, v in r["split_s"].items()}
        split["video.enc_per_packet"] = round(
            r["split_s"].get("video.enc", 0.0) / max(1, len(got["pkts"])), 4)
        res["split_s"][name] = split
        count(name, r["launches"])
        check(len(r["inputs"]) == frames, f"{name}: {len(r['inputs'])} "
              f"frames reached the encoder")
        return got, r

    def decode(name, dec, packets):
        """Every frame of `packets` through `dec`, on the card, with the
        launches of the decode."""
        kernels.reset_counts()
        sync(dev)
        t0 = time.perf_counter()
        out = [f for p in packets for f in dec.decode(p)] + dec.flush()
        sync(dev)
        res["wall_s"][name] = time.perf_counter() - t0
        count(name, kernels.counts())
        if hasattr(dec, "close"):
            dec.close()
        return out

    def hook_h264(enc, refs):
        code_ref = enc._code_ref

        def step(y, u, v, disp, pts, is_idr):
            pkt = code_ref(y, u, v, disp, pts, is_idr)
            refs[disp] = [p.copy() for p in enc._ref]
            return pkt

        enc._code_ref = step

    def hook_mpeg2(enc, refs):
        enc_frame = enc.encode

        def step(frame):
            pkts = enc_frame(frame)
            refs[enc._idx - 1] = [p.copy() for p in enc._ref]
            return pkts

        enc.encode = step

    with tempfile.TemporaryDirectory() as td:
        cmd = encoders_commands(td)

        # E1: H.264 (I0 P2 B1 P3) into MP4
        e1, r1 = encode("E1", cmd["E1"], ENC_E1_FRAMES, hook_h264)
        g1 = gold["e1"]
        recs = [packet_record(p) for p in e1["pkts"]]
        res["e1_bytes"] = sum(n for _, n, *_ in recs)
        check(hashlib.md5(e1["par"].extradata).hexdigest() ==
              g1["extradata_md5"], "E1: the SPS/PPS differ from the JAX "
              "package's")
        check(recs == g1["packets"], f"E1: packets {recs} are not the JAX "
              f"package's {g1['packets']}")
        check(sorted(e1["refs"]) == [0, 2, 3], f"E1: references coded "
              f"{sorted(e1['refs'])}")
        info = probe_json(ffprobe, cmd["E1"][-1])
        check(info == g1["ffprobe"], "E1: ffprobe JSON of e1.mp4 differs "
              "from the JAX package's")
        d = open_input(cmd["E1"][-1])
        dec = H264Decoder(d.streams[0].codecpar, device=dev)
        frames = decode("E1_decode", dec, list(d.packets()))
        d.close()
        md5s = [frame_md5(f.planes) for f in frames]
        check(md5s == g1["decoded_md5"], f"E1: decoded md5s {md5s} are not "
              f"the JAX decode's")
        for i, ref in e1["refs"].items():
            check(all(np.array_equal(host(a), b)
                      for a, b in zip(frames[i].planes, ref)),
                  f"E1: decoded frame {i} is not the encoder's recon")
        ld = res["launches"]["E1_decode"]
        check(all(ld.get(k, 0) == ENC_E1_P for k in E2E_KERNELS[:3]),
              f"E1 decode: launches {ld} (mc, intra and deblock once per "
              f"P frame)")
        check(all(res["launches"]["E1"].get(k, 0) > 0
                  for k in E2E_KERNELS[:3]),
              f"E1: the asset's decode launched {res['launches']['E1']}")
        # the display-pts repair on the card: E1 copied to a raw .264,
        # whose demuxer stamps packets 0, 1, 2, 3 in decode order
        raw = os.path.join(td, "e1.264")
        cli_run(["-i", cmd["E1"][-1], "-c:v", "copy", "-y", raw], dev)
        d = open_input(raw)
        dec = H264Decoder(d.streams[0].codecpar, device=dev)
        frames_raw = decode("E1_raw_decode", dec, list(d.packets()))
        d.close()
        res["e1_raw_pts"] = [f.pts for f in frames_raw]
        check(res["e1_raw_pts"] == list(range(ENC_E1_FRAMES))
              and [frame_md5(f.planes) for f in frames_raw] == md5s,
              f"E1 raw .264: pts {res['e1_raw_pts']}, or frames not E1's")

        # E2: E1's packets through h264_cavlc2cabac, decoded on the card
        par = CodecParameters(codec_type="video", codec_id="h264",
                              width=e1["par"].width,
                              height=e1["par"].height,
                              extradata=e1["par"].extradata)
        bsf = find_bsf("h264_cavlc2cabac")(par)
        t0 = time.perf_counter()
        cabac = [q for p in e1["pkts"] for q in bsf.filter(p)]
        res["wall_s"]["E2_bsf"] = time.perf_counter() - t0
        g2 = gold["e2"]
        res["e2_bytes"] = sum(len(p.data) for p in cabac)
        check(hashlib.md5(par.extradata).hexdigest() == g2["extradata_md5"]
              and [packet_record(p) for p in cabac] == g2["packets"],
              "E2: the CABAC stream is not the JAX bsf's")
        dec = H264Decoder(par, device=dev)
        frames2 = decode("E2_decode", dec, cabac)
        check([frame_md5(f.planes) for f in frames2] == md5s,
              "E2: the CABAC stream does not decode to E1's frames")

        # E3: MPEG-2 video into MPEG-TS
        e3, r3 = encode("E3", cmd["E3"], ENC_E3_FRAMES, hook_mpeg2)
        g3 = gold["e3"]
        recs = [packet_record(p) for p in e3["pkts"]]
        res["e3_bytes"] = sum(n for _, n, *_ in recs)
        types = ts_stream_types(cmd["E3"][-1])
        check(types == [0x02], f"E3: PMT stream types {types}")
        d = open_input(cmd["E3"][-1])
        tb, etb = d.streams[0].time_base, e3["pkts"][0].time_base

        def rescale(t):                 # 90 kHz -> the encoder's clock
            return t * tb.num * etb.den // (tb.den * etb.num)

        back = [(rescale(p.pts), rescale(p.dts), bytes(p.data),
                 bool(p.flags & 1)) for p in d.packets()]
        d.close()
        check(back == [(p.pts, p.dts, bytes(p.data), bool(p.flags & 1))
                       for p in e3["pkts"]],
              "E3: the MPEG-TS does not read back to the encoder's packets")
        dec = Mpeg12Decoder(device=dev)
        frames3 = decode("E3_decode", dec, [
            Packet(data=d, pts=pts, dts=dts) for pts, dts, d, _ in back])
        check(len(frames3) == ENC_E3_FRAMES, f"E3: {len(frames3)} frames")
        for i, f in enumerate(frames3):
            check(all(np.array_equal(host(a), b[:a.shape[0], :a.shape[1]])
                      for a, b in zip(f.planes, e3["refs"][i])),
                  f"E3: decoded frame {i} is not the encoder's recon")
        same = sum(a == b for a, b in zip(recs, g3["packets"]))
        res["e3_identical"] = same
        psnrs = [planes_psnr_db([host(p) for p in x.planes],
                                [host(p) for p in f.planes])
                 for x, f in zip(r3["inputs"], frames3)]
        res["e3_psnr"] = psnrs
        md5s3 = [frame_md5(f.planes) for f in frames3]
        check([(p[2], p[3], p[4]) for p in recs] ==
              [(p[2], p[3], p[4]) for p in g3["packets"]],
              "E3: pts, dts or flags differ from the JAX package's")
        if same == len(g3["packets"]) == len(recs):
            check(md5s3 == g3["decoded_md5"], "E3: decoded md5s differ "
                  "from the JAX decode's of identical packets")
        else:
            rel = max(abs(a[1] - b[1]) / b[1]
                      for a, b in zip(recs, g3["packets"]))
            gap = max(abs(a - b) for a, b in zip(psnrs, g3["psnr"]))
            res["e3_size_rel_max"], res["e3_psnr_gap_max"] = rel, gap
            check(len(recs) == len(g3["packets"]) and
                  rel <= FILT_BYTES_REL and gap <= FILT_PSNR_TOL_DB,
                  f"E3: {same} of {len(recs)} packets identical; sizes "
                  f"{rel:.6f} and PSNR {gap:.5f} dB off the JAX package's")
    res["phase_s"] = time.perf_counter() - t_phase
    res["total_launches"] = total
    return res


HEVC_GOLD = "bench_1080p_hevc.json"
# H0: the port's own conformance generator at full width; decode order
# I0 P2 B1, two slice segments a picture, 33.75 rows of 32x32 CTBs
HEVC_STREAM = dict(width=1920, height=1080, n_frames=3, b_frames=True,
                   deblock=True, sao=True, slices=2, seed=14)
HEVC_CONTAINERS = ("mp4", "mkv", "ts")
IMG_FRAMES = 4             # P1 and G1: the asset's first frames
# P1 and G1's rule, set from the CPU before their first card run: the
# scaler converts yuv420p to rgb24 in float32, so a sample whose exact
# value lies within FILT_TIE of k + 0.5 may round either way (the JAX
# package and the port on the CPU each flip 9-88 of the 12-14 thousand
# such samples of a frame, and part on 3 of frame 3's). Every rgb24
# sample must equal the exact conversion (rgb24_exact) off those ties.
# A frame equal to the JAX package's must give the JAX package's PNG
# file, and four such frames its GIF; a frame that differs at a tie must
# read back from its PNG and its GIF exactly as it was encoded.

# the repaired fields of an HEVC stream in MPEG-TS (the JAX package's
# demuxer leaves them 0, as for H.264: CONT_TS_REPAIRED)
HEVC_TS_REPAIRED = {"width": 1920, "height": 1080}


def hevc_commands(td: str) -> dict:
    """The hevc phase's command lines (cli.ffmpeg; the JAX package's CLI
    takes the same), outputs in td: H1 the raw HEVC stream h.265 to
    framemd5; H2_* its stream copy into MP4, Matroska and MPEG-TS, H2P_*
    each copy's packets hashed (-c:v copy -f framemd5), H2D_mkv the
    Matroska copy decoded to framemd5; H3 the MP4 copy to 1280x720
    MPEG-4 -q:v 5; P1 the asset's first frames as rgb24 PNG files (no
    -c:v: image2 takes the extension's codec), P1D those files read
    back; G1 the same frames to an animated GIF, G1D the GIF read
    back."""
    j = os.path.join
    h265 = j(td, "h.265")
    cmd = {"H1": ["-i", h265, "-f", "framemd5", "-y", j(td, "h1.md5")]}
    for e in HEVC_CONTAINERS:
        cmd[f"H2_{e}"] = ["-i", h265, "-c:v", "copy", "-y", j(td, f"h.{e}")]
        cmd[f"H2P_{e}"] = ["-i", j(td, f"h.{e}"), "-c:v", "copy", "-f",
                           "framemd5", "-y", j(td, f"h2p_{e}.md5")]
    cmd["H2D_mkv"] = ["-i", j(td, "h.mkv"), "-f", "framemd5", "-y",
                      j(td, "h2d_mkv.md5")]
    cmd["H3"] = ["-i", j(td, "h.mp4"), "-vf", "scale=1280:720", "-c:v",
                 "mpeg4", "-q:v", "5", "-y", j(td, "h3.avi")]
    cmd["P1"] = ["-i", ASSET, "-frames:v", str(IMG_FRAMES), "-pix_fmt",
                 "rgb24", "-y", j(td, "thumb_%03d.png")]
    cmd["P1D"] = ["-i", j(td, "thumb_%03d.png"), "-f", "framemd5", "-y",
                  j(td, "p1.md5")]
    cmd["G1"] = ["-i", ASSET, "-frames:v", str(IMG_FRAMES), "-c:v",
                 "rawvideo", "-pix_fmt", "rgb24", "-y", j(td, "out.gif")]
    cmd["G1D"] = ["-i", j(td, "out.gif"), "-f", "framemd5", "-y",
                  j(td, "g1.md5")]
    return cmd


def rgb24_exact(planes) -> tuple:
    """yuv420p planes converted to rgb24 as the scaler does (bilinear
    chroma upsampling through resize_matrix, then the BT.601 limited-range
    matrix as float32 constants), in float64 on the planes' device: the
    samples rounded (floor(x + 0.5), clipped) and the mask of the ties
    (within FILT_TIE of k + 0.5), where a float32 computation may round
    either way."""
    import numpy as np
    import torch

    from librempeg_tpu_torch.ops import colorspace as cs
    from librempeg_tpu_torch.ops.fir import resize_matrix

    y, u, v = (torch.as_tensor(p).to(torch.float64) for p in planes)

    def mat(src, dst):
        return torch.from_numpy(resize_matrix(src, dst, "bilinear")).to(
            y.device, torch.float64)

    mv, mh = mat(u.shape[0], y.shape[0]), mat(u.shape[1], y.shape[1])
    u, v = (mv @ c @ mh.T for c in (u, v))
    m, off = cs.yuv_to_rgb_matrix("bt601", False)
    mt = torch.from_numpy(m.T.astype(np.float32).astype(np.float64)).to(
        y.device)
    x = torch.stack([y + float(off[0]), u + float(off[1]),
                     v + float(off[2])], -1) @ mt
    return (torch.floor(x + 0.5).clamp(0, 255),
            (x - torch.floor(x) - 0.5).abs() <= FILT_TIE)


def keep_decoded(frames: list):
    """A cli_run prepare() that keeps a copy of each frame the video
    chain's decoder gives out."""
    def prepare(tc):
        dec = tc.chains[0].decoder
        for name in ("decode", "flush"):
            fn = getattr(dec, name)

            def rec(*a, fn=fn):
                out = fn(*a)
                frames.extend(f.replace(planes=tuple(
                    p.clone() for p in f.planes)) for f in out)
                return out

            setattr(dec, name, rec)
    return prepare


def framemd5_rows(path: str) -> list[tuple[int, str]]:
    """(pts, hash) of each frame or packet line of a framemd5 file."""
    _, lines = md5_lines(open(path).read())
    return [(int(r[2]), r[5].strip()) for r in
            (ln.split(",") for ln in lines)]


def hevc_phase(dev: str) -> dict:
    """H0-H3, P1 and G1 through cli.ffmpeg's parser and Transcoder,
    held to tests/data/torch_port/bench_1080p_hevc.json (the JAX
    package's runs on the CPU, given whole access units)."""
    import glob

    import torch

    from librempeg_tpu_torch.cli import ffprobe
    from librempeg_tpu_torch.codecs.gif import make_palette, quantize
    from librempeg_tpu_torch.codecs.hevc.decoder import generate_stream
    from librempeg_tpu_torch.codecs.mpeg4._decoder import Mpeg4Decoder
    from librempeg_tpu_torch.core.packet import Packet

    gold = json.load(open(os.path.join(GOLD, HEVC_GOLD)))
    t_phase = time.perf_counter()
    res = {"wall_s": {}, "split_s": {}, "launches": {}}
    total = dict.fromkeys(KERNELS, 0)

    def run(name, argv, **kw):
        r = cli_run(argv, dev, **kw)
        res["wall_s"][name] = r["wall_s"]
        res["split_s"][name] = {k: round(v, 4) for k, v in
                                r["split_s"].items()}
        res["launches"][name] = {k: v for k, v in r["launches"].items()
                                 if v}
        for k, v in r["launches"].items():
            total[k] += v
        return r

    def ranks(pts):
        order = sorted(pts)
        return [order.index(p) for p in pts]

    with tempfile.TemporaryDirectory() as td:
        cmd = hevc_commands(td)

        # H0: the port's generator, byte for byte the JAX generator's
        t0 = time.perf_counter()
        stream = generate_stream(**HEVC_STREAM)
        res["wall_s"]["H0"] = time.perf_counter() - t0
        with open(os.path.join(td, "h.265"), "wb") as f:
            f.write(stream)
        res["h0_bytes"] = len(stream)
        check(hashlib.md5(stream).hexdigest() == gold["h0"]["md5"] and
              len(stream) == gold["h0"]["bytes"],
              "H0: the stream is not the JAX generator's")
        aus = [d for _, d in demuxed(cmd["H1"][1])]
        au_md5 = [hashlib.md5(a).hexdigest() for a in aus]
        check(au_md5 == gold["au_md5"] and b"".join(aus) == stream,
              f"H0: {len(aus)} access units, not the golden's 3")

        # H1: raw .265 to framemd5, frames on the card before the hash
        places = set()
        run("H1", cmd["H1"], on_input=lambda f: places.update(
            p.device.type for p in f.planes))
        h1 = framemd5_rows(cmd["H1"][-1])
        check([m for _, m in h1] == gold["decoded_md5"],
              f"H1: hashes {h1} are not the JAX decoder's")
        check([p for p, _ in h1] == [0, 1, 2], f"H1: pts {h1}")
        check(places == {dev},
              f"H1: the decoded frames lay on {places}")

        # H2: copies into MP4, Matroska and MPEG-TS
        for e in HEVC_CONTAINERS:
            run(f"H2_{e}", cmd[f"H2_{e}"])
            path = cmd[f"H2_{e}"][-1]
            check(hashlib.md5(open(path, "rb").read()).hexdigest() ==
                  gold["remux_md5"][e], f"H2 {e}: the file is not the JAX "
                  f"package's")
            check(len(demuxed(path)) == 3, f"H2 {e}: packets")
            info = probe_json(ffprobe, path)
            st = info["streams"][0]
            check((st["codec_name"], st["width"], st["height"],
                   st["pix_fmt"]) == ("hevc", 1920, 1080, "yuv420p"),
                  f"H2 {e}: ffprobe stream {st}")
            if e == "ts":
                st.update(dict.fromkeys(HEVC_TS_REPAIRED, 0))
            check(info == gold["ffprobe"][e],
                  f"H2 {e}: ffprobe JSON differs from the JAX package's")
            run(f"H2P_{e}", cmd[f"H2P_{e}"])
            hashed = [m for _, m in framemd5_rows(cmd[f"H2P_{e}"][-1])]
            # MP4 and Matroska keep the parameter sets in hvcC
            check(hashed == gold["packet_md5"][e] and
                  hashed[1:] == au_md5[1:] and
                  (e != "ts" or hashed == au_md5),
                  f"H2 {e}: packet hashes {hashed}")
        run("H2D_mkv", cmd["H2D_mkv"])
        h2 = framemd5_rows(cmd["H2D_mkv"][-1])
        check([m for _, m in h2] == gold["decoded_md5"] and
              ranks([p for p, _ in h2]) == [0, 1, 2],
              f"H2 mkv: framemd5 {h2}")

        # H3: the MP4 copy to 1280x720 MPEG-4. A P-VOP whose levels
        # overflow the sparse fetch layout is re-packed in the next
        # larger one (slim -> fat -> full, Mpeg4Encoder.encode_finish),
        # not coded again: hpel launches once per P-VOP
        inputs = []
        h3 = run("H3", cmd["H3"], on_input=lambda f: inputs.append(
            tuple(host(p) for p in f.planes)))
        g3 = gold["h3"]
        types = "".join(vop_type(d) for _, d, _ in h3["packets"])
        sizes = [len(d) for _, d, _ in h3["packets"]]
        dem = demuxed(cmd["H3"][-1])
        dec = Mpeg4Decoder(device=None)  # host numpy planes
        back = [f for p, d in dem
                for f in dec.decode(Packet(data=d, pts=p))] + dec.flush()
        psnrs = [planes_psnr_db(x, f.planes) for x, f in zip(inputs, back)]
        res["h3"] = {"types": types, "bytes": sum(sizes),
                     "bytes_rel": abs(sum(sizes) - sum(g3["sizes"]))
                     / sum(g3["sizes"]), "psnr": psnrs,
                     "psnr_gap": statistics.fmean(psnrs)
                     - statistics.fmean(g3["psnr"])}
        log("hevc H3: " + json.dumps(res["h3"]))
        # the JAX run's frames carry their packets' decode-order pts
        # (the fault ROADMAP section 3b names); the port's are sorted
        check(types == g3["types"] and len(back) == len(sizes) == 3 and
              [p for p, _, _ in h3["packets"]] == sorted(g3["pts"]),
              f"H3: VOP types {types} or pts differ from the JAX "
              f"package's")
        check(res["h3"]["bytes_rel"] <= FILT_BYTES_REL, "H3: bytes")
        check(abs(res["h3"]["psnr_gap"]) <= FILT_PSNR_TOL_DB,
              "H3: decoded PSNR mean")
        check(res["launches"]["H3"].get("hpel", 0) == types.count("P"),
              f"H3: launches {res['launches']['H3']} for "
              f"{types.count('P')} P-VOPs")

        # P1: PNG files with no -c:v, read back. The rgb24 frames come
        # from the scaler's float32 conversion: each is held to the
        # exact conversion off its ties (the rule beside IMG_FRAMES) and
        # to the JAX
        # package's frame (the exact one with the JAX run's flips at
        # ties, from the golden); a frame equal to the JAX package's
        # must give its PNG file byte for byte
        yuv, rgb = [], []
        run("P1", cmd["P1"], on_input=lambda f: rgb.append(f.planes[0]),
            prepare=keep_decoded(yuv))
        check(len(rgb) == IMG_FRAMES and len(yuv) >= IMG_FRAMES,
              f"P1: {len(rgb)} frames encoded, {len(yuv)} decoded")
        rgb_md5 = [frame_md5([p]) for p in rgb]
        files = sorted(glob.glob(os.path.join(td, "thumb_*.png")))
        data = [open(f, "rb").read() for f in files]
        png_md5 = [hashlib.md5(d).hexdigest() for d in data]
        res["p1_bytes"] = [len(d) for d in data]
        flips, ties = [], []
        for i, (f, p) in enumerate(zip(yuv, rgb)):
            exact, tie = rgb24_exact(f.planes)
            jax = exact.flatten()
            idx, val = gold["p1"]["jax_flips"][i]
            jax[torch.as_tensor(idx, dtype=torch.long, device=jax.device)] \
                = torch.as_tensor(val, dtype=jax.dtype, device=jax.device)
            jax = jax.view_as(exact)
            check(frame_md5([jax.to(p.dtype)]) == gold["p1"]["rgb_md5"][i],
                  f"P1 frame {i}: the golden's flips do not rebuild the "
                  f"JAX package's frame")
            got = p.to(exact.dtype)
            check(not bool(((got != exact) & ~tie).any()),
                  f"P1 frame {i}: off the exact conversion away from a tie")
            flips.append(int((got != jax).sum()))
            ties.append(int(tie.sum()))
            if not flips[-1]:
                check(png_md5[i] == gold["p1"]["png_md5"][i],
                      f"P1 frame {i}: the frame is the JAX package's and "
                      f"its PNG file is not")
        res["p1_flips"], res["p1_ties"] = flips, ties
        res["p1_identical"] = sum(a == b for a, b in
                                  zip(png_md5, gold["p1"]["png_md5"]))
        check(len(data) == IMG_FRAMES and
              all(d.startswith(b"\x89PNG\r\n\x1a\n") for d in data),
              f"P1: {len(data)} files, not all PNG")
        check(all(res["launches"]["P1"].get(k, 0) > 0
                  for k in E2E_KERNELS[:3]),
              f"P1: the asset's decode launched {res['launches']['P1']}")
        run("P1D", cmd["P1D"])
        check([m for _, m in framemd5_rows(cmd["P1D"][-1])] == rgb_md5,
              "P1: the PNG files do not read back to the rgb24 frames")

        # G1: an animated GIF of the same frames, read back; with frames
        # equal to the JAX package's it is the JAX package's file, and
        # either way it reads back to the palette colours of the frames'
        # quantised indices
        grgb = []
        run("G1", cmd["G1"], on_input=lambda f: grgb.append(
            host(f.planes[0])))
        check([hashlib.md5(g.tobytes()).hexdigest() for g in grgb] ==
              rgb_md5, "G1: the rgb24 frames are not P1's")
        gif = open(cmd["G1"][-1], "rb").read()
        res["g1_bytes"] = len(gif)
        res["g1_identical"] = hashlib.md5(gif).hexdigest() == \
            gold["g1"]["gif_md5"]
        if not any(flips):
            check(res["g1_identical"], "G1: the frames are the JAX "
                  "package's and the GIF is not")
        check(all(res["launches"]["G1"].get(k, 0) > 0
                  for k in E2E_KERNELS[:3]),
              f"G1: the asset's decode launched {res['launches']['G1']}")
        run("G1D", cmd["G1D"])
        pal = make_palette()
        want = [hashlib.md5(pal[quantize(g)].tobytes()).hexdigest()
                for g in grgb]
        got = [m for _, m in framemd5_rows(cmd["G1D"][-1])]
        check(got == want, "G1: the GIF does not read back to its frames' "
              "palette colours")
        check(any(flips) or got == gold["g1"]["frame_md5"],
              "G1: the GIF does not read back to the JAX GIF demuxer's "
              "frames")
    res["phase_s"] = time.perf_counter() - t_phase
    res["total_launches"] = total
    return res


# -- the audio codecs (acodecs phase) -----------------------------------------

ACODECS_GOLD = "bench_acodecs.json"
# committed streams (tools/torch_port_audio_fixtures.py): Opus, Vorbis,
# MP3 and MP2 at the rates and channel counts users meet, 5 s at most
ACODECS_FX = os.path.join(GOLD, "acodecs")
ACODECS_AC3_T = "2"        # K2: -t 2 (the host AC-3 encoder, about 5.6 s
#                            a second of stereo on an 8-core CPU)
ACODECS_ADPCM_T = "5"      # K7: -t 5
ACODECS_FLAC_BLOCK = 4096  # K1: the FLAC encoder's block size
ACODECS_WINDOWS, ACODECS_WIN = 8, 256   # stored windows of a decoded s16
ACODECS_COPIES = ("ogg", "mkv")         # K1's stream copies
# The float decodes' s16 (AC-3, Opus, Vorbis, MP2) and K3's dithered
# resample are held exactly: the md5 of all of a stream's samples equals
# the golden's, as it does on the CPU and on the H100 (PERF.md section
# 6). The stored windows only say, on a mismatch, how far the samples
# moved (a rounding step of another host's BLAS or FFT code moves a few
# by 1; a fault moves many, or by more).


def acodecs_commands(td: str, wav: str) -> dict:
    """The acodecs phase's command lines (cli.ffmpeg), outputs in td:
    K1 FLAC, K2 AC-3, K3 Opus, K4 Vorbis, K5 MP3 to AAC, K6 MP2, K7
    ADPCM, each with the decodes and copies that read it back."""
    def j(name):
        return os.path.join(td, name)

    def fx(name):
        return os.path.join(ACODECS_FX, name)

    cmd = {
        "K1": ["-i", wav, "-c:a", "flac", "-y", j("k1.flac")],
        "K1D": ["-i", j("k1.flac"), "-f", "framemd5", "-y", j("k1.md5")],
        "K1P_flac": ["-i", j("k1.flac"), "-c:a", "copy", "-f", "framemd5",
                     "-y", j("k1p_flac.md5")],
        "K2": ["-i", wav, "-t", ACODECS_AC3_T, "-c:a", "ac3", "-b:a", "192k",
               "-y", j("k2.ac3")],
        "K2_mkv": ["-i", j("k2.ac3"), "-c:a", "copy", "-y", j("k2.mkv")],
        "K2D": ["-i", j("k2.mkv"), "-c:a", "pcm_s16le", "-y", j("k2.wav")],
        # the FLAC encoder's s16 is negotiated onto the dithering
        # aresample, whose input is converted to it first
        "K3": ["-i", fx("opus_celt.ogg"), "-af",
               "aresample=44100:dither_method=lipshitz", "-c:a", "flac",
               "-y", j("k3.flac")],
        "K3H": ["-i", fx("opus_hybrid.ogg"), "-f", "framemd5", "-y",
                j("k3h.md5")],
        "K4": ["-i", fx("vorbis.ogg"), "-af",
               "highpass=f=80,lowpass=f=12000", "-c:a", "pcm_s16le", "-y",
               j("k4.wav")],
        "K5": ["-i", fx("mp3.mp3"), "-c:a", "aac", "-b:a", "128k", "-y",
               j("k5.m4a")],
        "K6": ["-i", fx("mp2.mp2"), "-c:a", "copy", "-y", j("k6.mkv")],
        "K6D": ["-i", j("k6.mkv"), "-c:a", "pcm_s16le", "-y", j("k6.wav")],
    }
    for e in ACODECS_COPIES:
        cmd[f"K1_{e}"] = ["-i", j("k1.flac"), "-c:a", "copy", "-y",
                          j(f"k1.{e}")]
        cmd[f"K1P_{e}"] = ["-i", j(f"k1.{e}"), "-c:a", "copy", "-f",
                           "framemd5", "-y", j(f"k1p_{e}.md5")]
    for k, codec in (("K7i", "adpcm_ima_wav"), ("K7m", "adpcm_ms")):
        cmd[k] = ["-i", wav, "-t", ACODECS_ADPCM_T, "-c:a", codec, "-y",
                  j(f"{k.lower()}.wav")]
        cmd[k + "D"] = ["-i", j(f"{k.lower()}.wav"), "-f", "framemd5", "-y",
                        j(f"{k.lower()}.md5")]
    return cmd


def s16_digest(x, windows: int = None) -> dict:
    """A decoded [channels, n] s16 stream as the goldens keep it: the md5
    of its planar bytes, its shape, and `windows` (ACODECS_WINDOWS)
    windows of ACODECS_WIN samples spread over it."""
    import numpy as np

    x = np.ascontiguousarray(host(x), np.int16)
    starts = np.linspace(0, max(0, x.shape[1] - ACODECS_WIN),
                         windows or ACODECS_WINDOWS).astype(int).tolist()
    return {"md5": hashlib.md5(x.tobytes()).hexdigest(),
            "shape": list(x.shape), "starts": starts,
            "windows": [x[:, s:s + ACODECS_WIN].tolist() for s in starts]}


def held_s16(name: str, x, g: dict) -> None:
    """Hold a decoded s16 stream to its golden (s16_digest) exactly: its
    shape and the md5 of all its samples. A mismatch reports how the
    stored windows moved."""
    import numpy as np

    got = s16_digest(x)
    check(got["shape"] == g["shape"], f"{name}: decoded shape "
          f"{got['shape']}, golden {g['shape']}")
    if got["md5"] != g["md5"]:
        d = np.abs(np.array(got["windows"], np.int32)
                   - np.array(g["windows"], np.int32))
        check(False, f"{name}: the decoded s16 differ from the JAX "
              f"package's ({np.count_nonzero(d) / d.size} of the stored "
              f"windows' samples differ, max |d| {d.max()})")


def packets_s16(packets, channels: int):
    """[channels, n] int16 of pcm_s16le packets (pts, bytes, key)."""
    import numpy as np

    raw = b"".join(b for _, b, _ in packets)
    return np.frombuffer(raw, "<i2").reshape(-1, channels).T


def keep_audio(frames: list):
    """A cli_run prepare() that keeps each frame the audio chain's
    decoder gives out."""
    def prepare(tc):
        dec = tc.chains[0].decoder
        for name in ("decode", "flush"):
            fn = getattr(dec, name)

            def rec(*a, fn=fn):
                out = fn(*a)
                frames.extend(out)
                return out

            setattr(dec, name, rec)
    return prepare


def shape_scan_replay(calls, dev) -> float:
    """Replay recorded shape_scan calls through the plain scan, the
    calls of one length stacked along the channels; each must be equal
    by value -> the largest error."""
    import torch

    from librempeg_tpu_torch.resample import dither as RD

    err = 0.0
    for n in sorted({a[0].shape[1] for a, _ in calls}):
        group = [(a, o) for a, o in calls if a[0].shape[1] == n]
        want = RD.shape_scan_plain(torch.cat([a[0] for a, _ in group]),
                                   torch.cat([a[1] for a, _ in group]),
                                   group[0][0][2],
                                   torch.cat([a[3] for a, _ in group], 1))
        got = (torch.cat([o[0] for _, o in group], 0),
               torch.cat([o[1] for _, o in group], 1))
        sync(dev)
        e = max_abs_err(got, want)
        check(e == 0, f"shape_scan on the path ({len(group)} calls of "
              f"{n} samples) differs from its plain version: {e}")
        err = max(err, e)
    return err


def acodecs_phase(dev: str) -> dict:
    """K1-K7 through cli.ffmpeg's parser and Transcoder, held to
    tests/data/torch_port/bench_acodecs.json (the JAX package's runs on
    the CPU, with the FLAC repairs applied; tools/torch_port_goldens.py
    --acodecs). The codecs are host numpy; the shaper kernel runs on K3
    and the biquad kernel on K4, each launch replayed through its plain
    version."""
    import numpy as np
    import torch

    from librempeg_tpu_torch.cli import ffprobe
    from librempeg_tpu_torch.codecs.aac.decoder import AacDecoder
    from librempeg_tpu_torch.formats.api import open_input
    from librempeg_tpu_torch.kernels import biquad as KB
    from librempeg_tpu_torch.resample import dither as RD

    gold = json.load(open(os.path.join(GOLD, ACODECS_GOLD)))
    t_phase = time.perf_counter()
    res = {"wall_s": {}, "split_s": {}, "launches": {}}
    total = dict.fromkeys(KERNELS, 0)

    def run(name, argv, **kw):
        r = cli_run(argv, dev, **kw)
        res["wall_s"][name] = r["wall_s"]
        res["split_s"][name] = {k: round(v, 4)
                                for k, v in r["split_s"].items()}
        res["launches"][name] = {k: v for k, v in r["launches"].items()
                                 if v}
        for k, v in r["launches"].items():
            total[k] += v
        return r

    def md5(path):
        return hashlib.md5(open(path, "rb").read()).hexdigest()

    with tempfile.TemporaryDirectory() as td:
        wav = os.path.join(td, "in.wav")
        x = write_audio_wav(wav, AUDIO_SECONDS)
        check(md5(wav) == gold["wav_md5"], "acodecs: input WAV md5")
        cmd = acodecs_commands(td, wav)

        # K1 FLAC: the encoder's bytes, a decode on the card, two copies
        g = gold["k1"]
        run("K1", cmd["K1"])
        check(md5(cmd["K1"][-1]) == g["md5"], "K1: the FLAC file is not "
              "the JAX encoder's with the final STREAMINFO")
        frames = []
        run("K1D", cmd["K1D"], prepare=keep_audio(frames))
        rows = framemd5_rows(cmd["K1D"][-1])
        check([h for _, h in rows] == g["hashes"], "K1: decoded hashes "
              "differ from the JAX decoder's")
        check([p for p, _ in rows] == g["pts"]
              and g["pts"] == list(range(0, len(rows) * ACODECS_FLAC_BLOCK,
                                         ACODECS_FLAC_BLOCK)),
              f"K1: pts {[p for p, _ in rows][-3:]} (last three)")
        kind = torch.device(dev).type
        check(all(isinstance(f.data, torch.Tensor)
                  and f.data.device.type == kind for f in frames),
              f"K1: decoded frames not on {dev}")
        y = torch.cat([f.data for f in frames], 1).cpu().numpy()
        check(np.array_equal(y, x), "K1: decoded samples are not the WAV's")
        res["k1"] = {"frames": len(rows), "bytes": os.path.getsize(
            cmd["K1"][-1])}
        run("K1P_flac", cmd["K1P_flac"])
        want = [h for _, h in framemd5_rows(cmd["K1P_flac"][-1])]
        check(len(want) == len(rows), f"K1: {len(want)} FLAC packets")
        for e in ACODECS_COPIES:
            run(f"K1_{e}", cmd[f"K1_{e}"])
            run(f"K1P_{e}", cmd[f"K1P_{e}"])
            got = [h for _, h in framemd5_rows(cmd[f"K1P_{e}"][-1])]
            check(got == want, f"K1: the {e} copy's packet hashes are not "
                  "the FLAC file's")

        # K2 AC-3: the encoder's bytes, Matroska copy, decode, ffprobe
        g = gold["k2"]
        run("K2", cmd["K2"])
        size = os.path.getsize(cmd["K2"][-1])
        res["k2"] = {"bytes": size, "identical": md5(cmd["K2"][-1]) ==
                     g["md5"]}
        check(res["k2"]["identical"] or abs(size - g["bytes"])
              <= FILT_BYTES_REL * g["bytes"], f"K2: {size} AC-3 bytes, "
              f"golden {g['bytes']}")
        run("K2_mkv", cmd["K2_mkv"])
        r = run("K2D", cmd["K2D"])
        check([p for p, _, _ in r["packets"]] == g["pts"],
              "K2: decoded pts differ from the JAX package's")
        _, y = read_wav(cmd["K2D"][-1])
        held_s16("K2", y, g["s16"])
        for e, path in (("ac3", cmd["K2"][-1]), ("mkv", cmd["K2_mkv"][-1])):
            check(probe_json(ffprobe, path) == g["ffprobe"][e],
                  f"K2: ffprobe JSON of k2.{e} differs from the JAX "
                  "package's")

        # K3 Opus: CELT decode, dithered resample (shape_scan), FLAC
        g = gold["k3"]
        calls, kernel = [], RD.shape_scan

        def recorded(*a):
            out = kernel(*a)
            calls.append((a, out))
            return out

        RD.shape_scan = recorded
        try:
            r = run("K3", cmd["K3"], keep_input=True)
        finally:
            RD.shape_scan = kernel
        n = r["launches"].get("shape_scan", 0)
        dithered = sum(1 for f in r["inputs"] if f.nb_samples) - 1
        res["k3"] = {"packets": len(r["packets"]), "frames":
                     len(r["inputs"]), "shape_scan": n}
        check(n == len(calls) == dithered, f"K3: shape_scan launches {n}, "
              f"{len(calls)} calls, {dithered} dithered frames")
        res["k3"]["replay_err"] = shape_scan_replay(calls, dev)
        y = torch.cat([f.data for f in r["inputs"]], 1)
        held_s16("K3", y, g["s16"])
        r = run("K3H", cmd["K3H"])
        rows = framemd5_rows(cmd["K3H"][-1])
        check([p for p, _ in rows] == g["hybrid_pts"],
              "K3H: pts differ from the JAX package's")
        bad = [i for i, ((_, a), b) in enumerate(zip(rows,
                                                      g["hybrid_hashes"]))
               if a != b]
        check(len(rows) == len(g["hybrid_hashes"]) and not bad,
              f"K3H: {len(rows)} frames, {len(g['hybrid_hashes'])} golden; "
              f"hashes differ at frames {bad[:8]}")
        res["k3"]["hybrid_frames"] = len(rows)
        held_s16("K3H", packets_s16(r["packets"], 2), g["hybrid_s16"])

        # K4 Vorbis through a run of two biquads (one launch a frame)
        g = gold["k4"]
        calls4, launch = [], KB.launch

        def recorded4(xx, coefs, z, fmt):
            y, zo = launch(xx, coefs, z, fmt)
            calls4.append(((xx, tuple(map(tuple, coefs)), z, fmt),
                           (y, zo)))
            return y, zo

        KB.launch = recorded4
        try:
            r = run("K4", cmd["K4"], keep_input=True)
        finally:
            KB.launch = launch
        n = r["launches"].get("biquad", 0)
        frames4 = sum(1 for f in r["inputs"] if f.nb_samples)
        check(n == len(calls4) == frames4, f"K4: biquad launches {n}, "
              f"{len(calls4)} calls, {frames4} frames")
        err4, _ = biquad_replay(calls4, dev)
        res["k4"] = {"frames": frames4, "biquad": n, "replay_err": err4}
        _, y = read_wav(cmd["K4"][-1])
        held_s16("K4", y, g["s16"])

        # K5 MP3 to AAC in MP4
        g = gold["k5"]
        r = run("K5", cmd["K5"], keep_input=True)
        pts = [p for p, _, _ in r["packets"]]
        nbytes = sum(len(b) for _, b, _ in r["packets"])
        check(pts == g["pts"], f"K5: {len(pts)} packets, pts differ from "
              f"the JAX package's ({len(g['pts'])})")
        check(abs(nbytes - g["bytes"]) <= AUDIO_BYTES_TOL * g["bytes"],
              f"K5: {nbytes} AAC bytes, golden {g['bytes']}")
        ref = torch.cat([f.data for f in r["inputs"]], 1).double()
        d = open_input(cmd["K5"][-1])
        dec = AacDecoder(d.streams[0].codecpar, device=dev)
        decoded = torch.cat([f.data for p in d.packets()
                             for f in dec.decode(p)], 1)
        d.close()
        snr = snr_db(host(ref) * 32768.0, host(decoded))
        check(abs(snr - g["snr_db"]) <= AUDIO_SNR_TOL_DB,
              f"K5: decoded SNR {snr} dB, golden {g['snr_db']}")
        res["k5"] = {"packets": len(pts), "bytes": nbytes,
                     "golden_bytes": g["bytes"], "snr_db": snr,
                     "golden_snr_db": g["snr_db"],
                     "first_frame": r["inputs"][0].nb_samples}

        # K6 MP2 copied into Matroska and decoded
        g = gold["k6"]
        run("K6", cmd["K6"])
        check(md5(cmd["K6"][-1]) == g["md5"], "K6: the Matroska copy is "
              "not the JAX package's")
        run("K6D", cmd["K6D"])
        _, y = read_wav(cmd["K6D"][-1])
        held_s16("K6", y, g["s16"])

        # K7 ADPCM: IMA and MS, each decoded to framemd5
        for k in ("K7i", "K7m"):
            g = gold[k.lower()]
            run(k, cmd[k])
            check(md5(cmd[k][-1]) == g["md5"], f"{k}: the WAV is not the "
                  "JAX encoder's")
            run(k + "D", cmd[k + "D"])
            check(framemd5_rows(cmd[k + "D"][-1]) ==
                  [tuple(r) for r in g["rows"]], f"{k}: decoded framemd5 "
                  "differs from the JAX package's")
    res["total_launches"] = total
    res["phase_s"] = time.perf_counter() - t_phase
    return res


DELIVERY_GOLD = "bench_delivery.json"
DELIVERY_FONT = os.path.join(GOLD, "fonts", "DejaVuSansMono.ttf")
DELIVERY_CUES = os.path.join(GOLD, "delivery", "cues.srt")
DELIVERY_FRAMES = 24       # D2: -frames:v
#: D2's VOPs that the vendored decoder reads back (host numpy, seconds
#: a 1080p VOP); each must equal the encoder's reference
DELIVERY_READBACK = 4
DELIVERY_RTSP_AUS = 12     # D6: the asset's first access units pushed
DELIVERY_RTP_MTU = 1400
DELIVERY_HLS_TIME = "0.5"  # HLS and DASH segment target, seconds
DELIVERY_TIMEOUT = 15.0    # every socket wait and thread join of D5, D6
#: D3's limits against the JAX package's measurement, whose resampler to
#: 48 kHz runs in XLA where the port's runs on the card (test_torch_
#: resample.py: within 2e-6): integrated loudness and loudness range in
#: LU, the sample peak. Set between the clean gap and a planted fault
#: (tools/torch_port_goldens.py --delivery --calibrate prints both: on
#: the CPU 3.2e-7 LU, 4.9e-7 LU and 0 clean; the K-weighting shelf 0.01
#: dB off moves I by 9.96e-3 LU).
LOUD_I_TOL = 1e-3
LOUD_LRA_TOL = 1e-3
LOUD_PEAK_TOL = 1e-5
#: loudnorm's s16 output: its gain comes from the measured I, so a gap of
#: 3e-7 LU moves a sample across a rounding boundary now and then (3.3e-4
#: of the samples, by 1, on the CPU; a shelf 0.01 dB off moves 0.91 of
#: them, by up to 13). Held on LOUD_WINDOWS stored windows: the md5, or
#: at most LOUD_S16_SHARE of their samples off, by 1.
LOUD_WINDOWS = 32
LOUD_S16_SHARE = 2e-3


def delivery_commands(td: str, wav: str) -> dict:
    """The delivery phase's command lines (cli.ffmpeg; the JAX package's
    CLI takes the same), with outputs in td, whose hls/ and dash/ the
    caller makes: D1 the asset into FLV (-c copy) and D1a the WAV to AAC
    in FLV, D1D the FLV decoded to framemd5; D2 the FLV's first 24
    frames with the committed cues burned in and a %{n} drawtext box,
    to framemd5 (D2) and to MPEG-4 -q:v 3 (D2E), D2S the cues through
    the subtitle stream; D3M ebur128, D3N loudnorm to s16; D4 the FLV's
    video copied to Matroska under -map, -progress, -stats_period, -v,
    -benchmark and -threads; D5 and D5M the asset into HLS and DASH."""
    j = os.path.join
    vf = (f"subtitles={DELIVERY_CUES}:fontfile={DELIVERY_FONT},drawtext="
          f"fontfile={DELIVERY_FONT}:text='%{{n}}':x=16:y=16:box=1")
    flv = j(td, "d1.flv")
    seg = ["-metadata", f"hls_time={DELIVERY_HLS_TIME}"]
    return {
        "D1": ["-i", ASSET, "-c", "copy", "-y", flv],
        "D1a": ["-i", wav, "-c:a", "aac", "-b:a", "128k", "-y",
                j(td, "d1a.flv")],
        "D1D": ["-i", flv, "-f", "framemd5", "-y", j(td, "d1.md5")],
        "D2": ["-i", flv, "-frames:v", str(DELIVERY_FRAMES), "-vf", vf,
               "-f", "framemd5", "-y", j(td, "d2.md5")],
        "D2E": ["-i", flv, "-frames:v", str(DELIVERY_FRAMES), "-vf", vf,
                "-c:v", "mpeg4", "-q:v", "3", "-y", j(td, "d2.avi")],
        "D2S": ["-i", DELIVERY_CUES, "-y", j(td, "d2.srt")],
        "D3M": ["-i", wav, "-af", "ebur128", "-f", "null", "-y",
                j(td, "d3m.null")],
        "D3N": ["-i", wav, "-af", "loudnorm=I=-16:TP=-1.5", "-c:a",
                "pcm_s16le", "-y", j(td, "d3.wav")],
        "D4": ["-i", flv, "-map", "0:v", "-c", "copy", "-progress",
               j(td, "d4.progress"), "-stats_period", "0.5", "-v", "error",
               "-benchmark", "-threads", "2", "-y", j(td, "d4.mkv")],
        "D5": ["-i", ASSET, "-c", "copy"] + seg + [
            "-f", "hls", "-y", j(td, "hls", "index.m3u8")],
        "D5M": ["-i", ASSET, "-c", "copy"] + seg + [
            "-f", "dash", "-y", j(td, "dash", "manifest.mpd")],
    }


def loudness_of(tc) -> dict:
    """I, LRA and peak of the ebur128 filter's stats, or of the loudnorm
    filter's measurement, in a Transcoder's audio graph after its run."""
    for chain in tc.chains.values():
        for node in chain.graph.graph.nodes:
            f = node.filter
            if f.NAME in ("ebur128", "loudnorm"):
                m = f.stats if f.NAME == "ebur128" else f.measured
                return {k: float(m[k]) for k in ("I", "LRA", "peak")}
    raise KeyError("no loudness filter in the graph")


def dir_md5s(path: str) -> dict:
    """{file name: md5} of the files of a directory."""
    return {n: hashlib.md5(open(os.path.join(path, n), "rb").read())
            .hexdigest() for n in sorted(os.listdir(path))}


def rtp_h264(aus: list[bytes], mtu: int = DELIVERY_RTP_MTU) -> list[bytes]:
    """RFC 6184 RTP packets of annex-B access units: a NAL unit that fits
    in one packet alone, a larger one as FU-A fragments; one timestamp
    per access unit at 25 fps, the marker on its last packet."""
    from librempeg_tpu_torch.codecs.h264.parse import split_annexb

    out, seq = [], 1
    for i, au in enumerate(aus):
        nals = split_annexb(au)
        for k, nal in enumerate(nals):
            if len(nal) <= mtu:
                parts = [nal]
            else:
                body = nal[1:]
                parts = [bytes([(nal[0] & 0xE0) | 28,
                                (off == 0) << 7
                                | (off + mtu >= len(body)) << 6
                                | (nal[0] & 0x1F)]) + body[off:off + mtu]
                         for off in range(0, len(body), mtu)]
            for n, payload in enumerate(parts):
                marker = k == len(nals) - 1 and n == len(parts) - 1
                out.append(struct.pack(">BBHII", 0x80, marker << 7 | 96,
                                       seq & 0xFFFF, 90000 * i // 25,
                                       0x1234) + payload)
                seq += 1
    return out


def rtsp_push(port: int, packets: list[bytes], errors: list) -> None:
    """A scripted RTSP peer on 127.0.0.1: ANNOUNCE an H.264 session,
    SETUP interleaved TCP, RECORD, then the RTP packets on channel 0.
    It retries the connection until the listening demuxer accepts, for
    at most DELIVERY_TIMEOUT; a failure is appended to `errors`."""
    import socket

    try:
        t_end = time.perf_counter() + DELIVERY_TIMEOUT
        while True:
            try:
                sock = socket.create_connection(("127.0.0.1", port),
                                                timeout=DELIVERY_TIMEOUT)
                break
            except ConnectionRefusedError:
                if time.perf_counter() > t_end:
                    raise
                time.sleep(0.05)
        with sock, sock.makefile("rwb") as f:
            base = f"rtsp://127.0.0.1:{port}/x"
            sdp = ("v=0\r\no=- 0 0 IN IP4 127.0.0.1\r\ns=x\r\nc=IN IP4 "
                   "127.0.0.1\r\nt=0 0\r\nm=video 0 RTP/AVP 96\r\n"
                   "a=rtpmap:96 H264/90000\r\na=control:streamid=0\r\n") \
                .encode()
            for n, (method, url, hdrs, body) in enumerate((
                    ("ANNOUNCE", base, {"Content-Type": "application/sdp",
                                        "Content-Length": len(sdp)}, sdp),
                    ("SETUP", base + "/streamid=0", {
                        "Transport": "RTP/AVP/TCP;unicast;interleaved=0-1"},
                     b""),
                    ("RECORD", base, {"Session": "d6"}, b""))):
                lines = [f"{method} {url} RTSP/1.0", f"CSeq: {n + 1}"]
                lines += [f"{k}: {v}" for k, v in hdrs.items()]
                f.write(("\r\n".join(lines) + "\r\n\r\n").encode() + body)
                f.flush()
                status = f.readline()
                if b"200" not in status:
                    raise OSError(f"RTSP {method}: {status!r}")
                while f.readline() not in (b"\r\n", b"\n", b""):
                    pass
            for p in packets:
                f.write(b"$\x00" + struct.pack(">H", len(p)) + p)
            f.flush()
    except Exception as e:          # reported by the phase
        errors.append(f"{type(e).__name__}: {e}")


def free_port() -> int:
    """A TCP port of 127.0.0.1 that was free a moment ago (bound as
    port 0, then released)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_dir(directory: str):
    """A ThreadingHTTPServer on 127.0.0.1, port 0, serving `directory`
    from a thread, without a request log: (its base URL, a function
    that stops it)."""
    import functools
    import http.server
    import threading

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(Quiet, directory=directory))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()

    def stop():
        srv.shutdown()
        srv.server_close()
        t.join(timeout=DELIVERY_TIMEOUT)
        check(not t.is_alive(), "the HTTP server's thread did not stop")

    return f"http://127.0.0.1:{srv.server_address[1]}", stop


def delivery_phase(dev: str) -> dict:
    """D1-D6 through cli.ffmpeg's parser and Transcoder (D4 through its
    main), held to tests/data/torch_port/bench_delivery.json (the JAX
    package's runs on the CPU; tools/torch_port_goldens.py --delivery)
    and to the asset's frame md5s: FLV, subtitles and drawtext (the
    committed font through the port's TrueType reader), loudness, the
    CLI's stream options, HLS and DASH read back over a loopback HTTP
    server, and an RTSP push on loopback. The H.264 decodes launch mc,
    intra and deblock; D2E's MPEG-4 encode launches hpel on the
    encoder's integer reference, which the vendored decoder must
    rebuild exactly."""
    import threading

    import numpy as np
    import torch

    from librempeg_tpu_torch.cli import ffmpeg as cli
    from librempeg_tpu_torch.cli import ffprobe
    from librempeg_tpu_torch.codecs.aac.decoder import AacDecoder
    from librempeg_tpu_torch.codecs.mpeg4._decoder import Mpeg4Decoder
    from librempeg_tpu_torch.core import log as plog
    from librempeg_tpu_torch.core.packet import Packet
    from librempeg_tpu_torch.formats.api import open_input

    gold = json.load(open(os.path.join(GOLD, DELIVERY_GOLD)))
    frames_md5 = open(os.path.join(GOLD, "bench_1080p_frames.md5")).read() \
        .split()
    t_phase = time.perf_counter()
    res = {"wall_s": {}, "split_s": {}, "launches": {}}
    total = dict.fromkeys(KERNELS, 0)

    def run(name, argv, **kw):
        r = cli_run(argv, dev, **kw)
        res["wall_s"][name] = r["wall_s"]
        res["split_s"][name] = {k: round(v, 4)
                                for k, v in r["split_s"].items()}
        res["launches"][name] = {k: v for k, v in r["launches"].items()
                                 if v}
        for k, v in r["launches"].items():
            total[k] += v
        return r

    def md5(path):
        return hashlib.md5(open(path, "rb").read()).hexdigest()

    def frame_rows(path):
        return [ln.split(",")[-1].strip()
                for ln in md5_lines(open(path).read())[1]]

    def decoded(name, argv, want, exact=True):
        """argv to framemd5: its frames' md5s must be `want`, with mc,
        intra and deblock launched once per P frame among them (or, when
        -frames:v cuts the decode, at least that often: the decoder
        works ahead of the chain)."""
        run(name, argv)
        check(frame_rows(argv[-1]) == want,
              f"{name}: the decoded frames differ from the asset's")
        n_p = len(want) - sum(gold["idr"][:len(want)])
        lc = [res["launches"][name].get(k, 0) for k in E2E_KERNELS[:3]]
        check(len(set(lc)) == 1 and (lc[0] == n_p if exact
                                     else lc[0] >= n_p),
              f"{name}: mc, intra, deblock launches {lc} for {n_p} P "
              "frames")

    with tempfile.TemporaryDirectory() as td:
        wav = os.path.join(td, "in.wav")
        x = write_audio_wav(wav, AUDIO_SECONDS)
        check(md5(wav) == gold["wav_md5"], "delivery: input WAV md5")
        for d in ("hls", "dash"):
            os.makedirs(os.path.join(td, d))
        cmd = delivery_commands(td, wav)

        # D1: the asset into FLV, its probe and its decode on the card
        run("D1", cmd["D1"])
        flv = cmd["D1"][-1]
        check(md5(flv) == gold["d1"]["md5"], "D1: the FLV is not the JAX "
              "package's")
        check(probe_json(ffprobe, flv) == gold["d1"]["ffprobe"],
              "D1: ffprobe JSON differs from the JAX package's")
        decoded("D1D", cmd["D1D"], frames_md5)

        # D1a: AAC into FLV, with the AudioSpecificConfig the JAX muxer
        # leaves out (its file has no stream), decoded on the card
        g = gold["d1a"]
        run("D1a", cmd["D1a"])
        d = open_input(cmd["D1a"][-1])
        par = d.streams[0].codecpar
        apk = list(d.packets())
        d.close()
        check((par.codec_id, par.sample_rate, par.nb_channels) ==
              ("aac", AUDIO_IN_RATE, 2), f"D1a: stream {par.codec_id} "
              f"{par.sample_rate} {par.nb_channels}")
        check([p.pts for p in apk] == g["pts_ms"],
              "D1a: tag pts differ from the JAX encoder's packets")
        nbytes = sum(len(p.data) for p in apk)
        dec = AacDecoder(par, device=dev)
        y = torch.cat([f.data for p in apk for f in dec.decode(p)], 1)
        res["d1a"] = {"packets": len(apk), "bytes": nbytes,
                      "golden_bytes": g["raw_bytes"],
                      "snr_db": snr_db(x, host(y)),
                      "golden_snr_db": g["snr_db"]}
        check(abs(nbytes - g["raw_bytes"]) <= AUDIO_BYTES_TOL
              * g["raw_bytes"], f"D1a: {res['d1a']}")
        check(abs(res["d1a"]["snr_db"] - g["snr_db"]) <= AUDIO_SNR_TOL_DB,
              f"D1a: {res['d1a']}")

        # D2: the cues and a drawtext box burned in on the card, to
        # framemd5 and to MPEG-4, whose reference the decoder rebuilds
        g = gold["d2"]
        decoded("D2", cmd["D2"], g["frames"], exact=False)
        inputs, refs, enc = [], {}, []

        def prepare(tc):
            enc.append(tc.chains[0].encoder)
            enc[0].recon_psnr = []
            keep_references(enc[0], refs, DELIVERY_READBACK)

        def on_input(frame):
            if len(inputs) < DELIVERY_READBACK:
                inputs.append(tuple(host(p) for p in frame.planes))

        r = run("D2E", cmd["D2E"], prepare=prepare, on_input=on_input)
        types = "".join(vop_type(d) for _, d, _ in r["packets"])
        nbytes = sum(len(d) for _, d, _ in r["packets"])
        ps = enc[0].recon_psnr
        res["d2"] = {"types": types, "bytes": nbytes,
                     "bytes_rel": abs(nbytes - sum(g["sizes"]))
                     / sum(g["sizes"]),
                     "recon_psnr": statistics.fmean(ps),
                     "psnr_gap": statistics.fmean(ps)
                     - statistics.fmean(g["recon_psnr"])}
        check(types == g["types"] and [p for p, _, _ in r["packets"]] ==
              g["pts"], "D2E: VOP types or pts differ from the JAX "
              "package's")
        check(res["d2"]["bytes_rel"] <= FILT_BYTES_REL, f"D2E: {res['d2']}")
        check(abs(res["d2"]["psnr_gap"]) <= FILT_PSNR_TOL_DB,
              f"D2E: {res['d2']}")
        check(r["launches"]["hpel"] == types.count("P") and
              r["launches"]["mc"] == res["launches"]["D2"].get("mc", 0),
              f"D2E: launches {r['launches']} (D2 {res['launches']['D2']})")
        t0 = time.perf_counter()
        dec = Mpeg4Decoder(device=None)  # host numpy planes
        back = []
        for p in avi_payloads(cmd["D2E"][-1])[:DELIVERY_READBACK]:
            back += dec.decode(Packet(data=p))
        res["wall_s"]["D2E_readback"] = time.perf_counter() - t0
        bad = same_pictures(back, refs)
        check(len(back) == len(refs) == DELIVERY_READBACK and bad == [],
              f"D2E: {len(back)} VOPs read back; not the encoder's "
              f"references: {bad}")
        res["d2"]["readback_psnr"] = statistics.fmean(
            planes_psnr_db(a, f.planes) for a, f in zip(inputs, back))
        run("D2S", cmd["D2S"])
        check(md5(cmd["D2S"][-1]) == g["srt_md5"],
              "D2S: the SubRip file differs from the JAX package's")

        # D3: loudness metering and normalisation
        g = gold["d3"]
        tcs = []
        run("D3M", cmd["D3M"], prepare=tcs.append)
        run("D3N", cmd["D3N"], prepare=tcs.append)
        m, n = (loudness_of(tc) for tc in tcs)
        res["d3"] = {"ebur128": m, "gaps": {
            k: abs(m[k] - g["ebur128"][k]) for k in m}}
        check(res["d3"]["gaps"]["I"] <= LOUD_I_TOL
              and res["d3"]["gaps"]["LRA"] <= LOUD_LRA_TOL
              and res["d3"]["gaps"]["peak"] <= LOUD_PEAK_TOL and n == m,
              f"D3: measured {m}, loudnorm's {n} (JAX {g['ebur128']})")
        d = open_input(cmd["D3N"][-1])
        got = s16_digest(packets_s16([(0, bytes(p.data), 0)
                                      for p in d.packets()], 2),
                         LOUD_WINDOWS)
        d.close()
        diff = np.abs(np.array(got["windows"], np.int32)
                      - np.array(g["s16"]["windows"], np.int32))
        res["d3"]["s16"] = {"md5_equal": got["md5"] == g["s16"]["md5"],
                            "share": float(np.count_nonzero(diff)
                                           / diff.size),
                            "max": int(diff.max())}
        check(got["shape"] == g["s16"]["shape"] and (
            res["d3"]["s16"]["md5_equal"] or (
                res["d3"]["s16"]["share"] <= LOUD_S16_SHARE
                and res["d3"]["s16"]["max"] <= 1)),
              f"D3N: loudnorm's s16 {res['d3']['s16']}")

        # D4: the CLI's stream and run options, through its main (which
        # sets the torch threads and the log level: both restored)
        threads, level = torch.get_num_threads(), plog.get_level()
        t0 = time.perf_counter()
        try:
            check(cli.main(cmd["D4"] + ["-device", dev]) == 0, "D4: rc")
        finally:
            torch.set_num_threads(threads)
            plog.set_level(level)
        res["wall_s"]["D4"] = time.perf_counter() - t0
        check([b for _, b in demuxed(cmd["D4"][-1])] ==
              [b for _, b in demuxed(flv)],
              "D4: the Matroska's packets are not the FLV's")
        prog = open(cmd["D4"][cmd["D4"].index("-progress") + 1]).read() \
            .splitlines()
        check([ln.split("=")[0] for ln in prog[-6:]] ==
              gold["d4"]["progress_keys"] and prog[-1] == "progress=end",
              f"D4: the progress feed ends {prog[-6:]}")

        # D5: HLS and DASH, each read back over HTTP on the card
        for name, sub in (("D5", "hls"), ("D5M", "dash")):
            g = gold[name.lower()]
            run(name, cmd[name])
            out = os.path.join(td, sub)
            check(dir_md5s(out) == g["md5s"], f"{name}: the playlist or "
                  "segments differ from the JAX package's")
            base, stop = serve_dir(out)
            try:
                decoded(f"{name}D", ["-i", f"{base}/"
                                     f"{os.path.basename(cmd[name][-1])}",
                                     "-f", "framemd5", "-y",
                                     os.path.join(td, f"{sub}.md5")],
                        frames_md5)
            finally:
                stop()

        # D6: an RTSP push of the first access units to the listening
        # demuxer, decoded on the card
        d = open_input(ASSET)
        aus = [bytes(p.data) for _, p in zip(range(DELIVERY_RTSP_AUS),
                                              d.packets())]
        d.close()
        port, errors = free_port(), []
        peer = threading.Thread(target=rtsp_push,
                                args=(port, rtp_h264(aus), errors))
        peer.start()
        try:
            decoded("D6", ["-f", "rtsp", "-timeout", str(DELIVERY_TIMEOUT),
                           "-i", f"rtsp://127.0.0.1:{port}/x?listen=1",
                           "-f", "framemd5", "-y",
                           os.path.join(td, "d6.md5")],
                    frames_md5[:DELIVERY_RTSP_AUS])
        finally:
            peer.join(timeout=DELIVERY_TIMEOUT)
        check(not peer.is_alive() and not errors, f"D6: the peer: {errors}")
    res["total_launches"] = total
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch "
                                 "port on one NVIDIA card.")
    ap.add_argument("--profile", metavar="DIR", dest="profile_dir",
                    help="profile 8 e2e frames and one kernel-leg pass; "
                    "write their tables into DIR")
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

    from concurrent.futures import ThreadPoolExecutor

    from librempeg_tpu_torch import kernels
    from librempeg_tpu_torch.kernels import _build
    from librempeg_tpu_torch.native import build as native

    def build(name):
        t0 = time.perf_counter()
        _build.load(name)
        return name, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels.sources())) as pool:
        builds = [pool.submit(build, n) for n in kernels.sources()]
        check(native.get() is not None, "native host library did not build")
        log(f"build native: {time.perf_counter() - t0:.2f} s")
        for fut in builds:
            name, dt = fut.result()
            log(f"build {name}: {dt:.2f} s")
    log(f"build all: {time.perf_counter() - t0:.2f} s")

    fl = floor_ms()
    log(f"device floor: an empty kernel takes {fl['device_ms']:.4f} ms by "
        f"device_ms, {fl['device_ms_b2b']:.4f} ms by device_ms_b2b")
    kres = kernel_phases(dev)
    leg = leg_inputs(dev)
    kres["fsearch"] = fsearch_phase(dev, leg)
    for name, r in kres.items():
        exact = "bit-exact" if name != "fsearch" else (
            f"bit-exact on integer inputs; float inputs: MVs equal on "
            f"{r['float_mv_equal']:.6f}, cost rel err "
            f"{r['float_cost_rel_err']:.2e}")
        log(f"kernel {name}: {exact}, device {r['device_ms']:.4f} ms, back "
            f"to back {r['device_ms_b2b']:.4f} ms, wall "
            f"{r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['shape']})")
    for name in ("deblock", "intra", "mc", "hpel", "residual"):
        log(f"{name} on the card: {kres[name]['launch_check']} "
            f"(torch.profiler, one call)")
    qr = quant_phase(dev)
    log(f"quant: MPEG-4 levels on the card equal the CPU's at qscale "
        f"{list(QUANT_QSCALES)} on {qr['blocks']} blocks a form (intra DC, "
        f"AC, inter, trellis first levels differ: {qr['differ']}); the "
        f"division by a Python scalar would move "
        f"{qr['old_form_differ']} intra AC levels")

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
        o = options_phase(dev, os.path.join(td, "options.avi"))
    log(f"options: {o['frames']} frames, {o['vop_types']}, md5 ok, "
        f"launches {o['launches']}")
    log(f"options: first yuvj420p frame {o['range_share_differ']:.6f} of "
        f"sampled rows differ from the JAX package's, PSNR "
        f"{o['range_psnr_db']:.2f} dB (floor {RANGE_PSNR_FLOOR_DB})")
    log(f"options: decoded PSNR I/P mean {o['decoded_psnr_ip_db'][0]:.4f} dB "
        f"(JAX {o['decoded_psnr_ip_db'][1]:.4f}), B mean "
        f"{o['decoded_psnr_b_db'][0]:.4f} dB (JAX "
        f"{o['decoded_psnr_b_db'][1]:.4f}); first VOP whose quantiser "
        f"differs from the JAX package's: {o['first_q_diff']}")
    log(f"options: {o['fps']:.3f} fps ({o['wall_s']:.3f} s for 48 frames, "
        f"unhooked run; checked run {o['checked_wall_s']:.3f} s), B-VOP "
        f"device pass {o['b_pass_ms']:.3f} ms median of {o['b_passes']}, "
        f"trellis {o['trellis_frame_ms']:.3f} ms per frame median of "
        f"{o['trellis_frames']}; vendored decode of the AVI "
        f"{o['decode_check_s']:.2f} s")
    log("options split: " + json.dumps(o["split_s"]))

    a = audio_phase(dev)
    kres["shape_scan"] = a["kernel"]
    kr = a["kernel"]
    log(f"audio: {a['packets']} AAC packets, pts and ADTS headers ok, "
        f"{a['aac_bytes']} bytes (JAX {a['golden_aac_bytes']}), decoded SNR "
        f"{a['snr_db']:.4f} dB (JAX {a['golden_snr_db']:.4f}); resampler "
        f"alone: {a['rs_share_differ']:.6f} of the sampled s16 windows "
        f"differ from the JAX package's; -ac 1 within "
        f"{a['ac_max_err_lsb']:.3f} LSB")
    log(f"audio: transcode {a['wall_s']:.3f} s for {AUDIO_SECONDS} s, "
        f"realtime factor {a['realtime_factor']:.2f}; resampler alone "
        f"{a['rs_wall_s']:.3f} s; decode check {a['decode_check_s']:.3f} s")
    log("audio split: " + json.dumps(a["split_s"]))
    log(f"audio: MDCT [2, 2048] device {a['mdct_device_ms']:.4f} ms; per "
        f"frame aac.mdct stage (launch and fetch) "
        f"{a['mdct_stage_ms_per_frame']:.3f} ms, host quantiser "
        f"{a['quant_ms_per_frame']:.3f} ms")
    log(f"kernel shape_scan: equal by value, device {kr['device_ms']:.4f} ms, "
        f"back to back {kr['device_ms_b2b']:.4f} ms, wall {kr['ms']:.3f} ms vs plain {kr['plain_ms']:.3f} ms, bound "
        f"{kr['bound_ms']:.4f} ms by {kr['bound_by']} ({kr['bound_note']}; "
        f"{kr['shape']}); {kr['launches']} launches over the dithered "
        f"path ({a['dither_path_s']:.3f} s, SNR {a['dither_snr_db']:.2f} dB "
        f"against the undithered path)")
    log(f"audio phase: {a['phase_s']:.1f} s")

    j = jpeg_phase(dev)
    log(f"jpeg A: 48 key packets, pts exact, {j['a_bytes']} bytes, "
        f"largest size gap {j['a_size_rel_max']:.6f} of the JAX package's, "
        f"{j['a_identical']} of 48 packets byte-identical; decode on the "
        f"card equal to the CPU's; decoded PSNR per plane "
        f"{[round(x, 4) for x in j['a_psnr_mean']]} dB (gap "
        f"{[round(x, 5) for x in j['a_psnr_gap']]})")
    for name in ("psnr", "ssim"):
        log(f"jpeg {name} graph: means "
            f"{[round(x, 6) for x in j[name + '_mean']]}, gap to the JAX "
            f"package's {[float(f'{x:.3g}') for x in j[name + '_gap']]}, "
            f"card against CPU {j[name + '_dev_err']:.3g}")
    log(f"jpeg B: {j['b_types']}, decoded mean {j['b_psnr_mean']:.4f} dB "
        f"(gap {j['b_psnr_gap']:+.5f}); C: sizes {j['c_bytes']} (largest "
        f"gap {j['c_size_rel_max']:.6f}), C2 splits into the files")
    log(f"jpeg: frames/s A {j['fps']['A']:.3f}, B {j['fps']['B']:.3f}, C "
        f"{j['fps']['C']:.3f} (48 input frames each); C2 "
        f"{j['C2_wall_s']:.3f} s; launches {j['launches']}; phase "
        f"{j['phase_s']:.1f} s")
    for path in ("A", "B", "C"):
        log(f"jpeg {path} split: " + json.dumps(j[f"{path}_split_s"]))

    fl = filters_phase(dev)
    kres["biquad"] = fl["biquad"]
    log("filters path launches: " + json.dumps(fl["path_launches"]))
    walls = {k: round(v, 3) for k, v in fl["wall_s"].items()}
    log(f"filters: wall s {json.dumps(walls)}; graph API "
        f"{fl['graphs_s']:.1f} s; phase {fl['phase_s']:.1f} s")
    for path in ("F1", "F2", "F3", "F4v", "F4a"):
        log(f"filters {path} split: " + json.dumps(fl["split_s"][path]))
    kb, kf = fl["biquad"], fl["fsearch_minterpolate"]
    log(f"kernel biquad: equal by value, device {kb['device_ms']:.4f} ms, "
        f"back to back {kb['device_ms_b2b']:.4f} ms, wall {kb['ms']:.3f} ms "
        f"vs plain {kb['plain_ms']:.3f} ms, bound {kb['bound_ms']:.4f} ms by "
        f"{kb['bound_by']} ({kb['bound_note']}; {kb['shape']}); "
        f"{kb['launches']} launches on F3, {kb['single_launches']} on "
        f"{SINGLE_BIQUAD}")
    log(f"kernel fsearch (minterpolate): bit-exact, device "
        f"{kf['device_ms']:.4f} ms, back to back {kf['device_ms_b2b']:.4f} "
        f"ms, wall {kf['ms']:.3f} ms vs plain {kf['plain_ms']:.3f} ms, bound "
        f"{kf['bound_ms']:.4f} ms by {kf['bound_by']} ({kf['shape']})")

    c = containers_phase(dev)
    log(f"containers: wall s "
        f"{json.dumps({k: round(v, 3) for k, v in c['wall_s'].items()})}")
    log(f"containers: frames/s (audio: realtime factor) "
        f"{json.dumps({k: round(v, 3) for k, v in c['rate'].items()})}")
    for name, split in c["split_s"].items():
        log(f"containers {name} split: " + json.dumps(split))
    log(f"containers launches: {json.dumps(c['launches'])}")
    tr = c["trace"]
    log(f"containers trace of D_mp4 (profiler.device_trace, a fresh "
        f"process): kernels {tr['launches']} equal the launch counters; "
        f"device busy {tr['busy_ms']:.3f} ms of {tr['window_ms']:.3f} ms, "
        f"idle share {tr['idle_share']:.4f}")
    log(f"containers phase: {c['phase_s']:.1f} s")

    e = encoders_phase(dev)
    card = smi.splitlines()[0]
    for name in ("E1", "E3"):
        log(f"encoders {name} ({card}): {e['wall_s'][name]:.3f} s, "
            f"{e['fps'][name]:.3f} frames/s; split "
            + json.dumps(e["split_s"][name]))
    log(f"encoders ({card}): E1 {e['e1_bytes']} bytes, packets, pts, dts, "
        f"flags, SPS/PPS and ffprobe JSON the JAX package's, decode on the "
        f"card {e['wall_s']['E1_decode']:.3f} s equal to the JAX decode and "
        f"each reference to the encoder's recon; E2 (h264_cavlc2cabac) "
        f"{e['e2_bytes']} bytes the JAX bsf's, bsf {e['wall_s']['E2_bsf']:.3f}"
        f" s, decode {e['wall_s']['E2_decode']:.3f} s to E1's frames; E3 "
        f"{e['e3_bytes']} bytes, PMT type 0x02, {e['e3_identical']} of "
        f"{ENC_E3_FRAMES} packets identical to the JAX package's, decode "
        f"{e['wall_s']['E3_decode']:.3f} s equal to the recon, PSNR "
        f"{[round(x, 4) for x in e['e3_psnr']]} dB")
    log(f"encoders ({card}): E1 copied to a raw .264 decodes on the card "
        f"to E1's frames with pts {e['e1_raw_pts']} in "
        f"{e['wall_s']['E1_raw_decode']:.3f} s")
    log(f"encoders launches: {json.dumps(e['launches'])}; phase "
        f"{e['phase_s']:.1f} s")

    hv = hevc_phase(dev)
    for name, wall in hv["wall_s"].items():
        log(f"hevc {name} ({card}): {wall:.3f} s; launches "
            f"{json.dumps(hv['launches'].get(name, {}))}; split "
            + json.dumps(hv["split_s"].get(name, {})))
    log(f"hevc ({card}): H0 {hv['h0_bytes']} bytes, the JAX generator's; "
        f"H1 3 frames on the card, the JAX decoder's hashes, pts 0 1 2; H2 "
        f"{list(HEVC_CONTAINERS)} files, ffprobe JSON and packet hashes the "
        f"JAX package's, the Matroska copy decoded to H1's hashes; H3 "
        f"{hv['h3']['types']} {hv['h3']['bytes']} bytes (gap "
        f"{hv['h3']['bytes_rel']:.6f}), decoded PSNR "
        f"{[round(x, 4) for x in hv['h3']['psnr']]} dB (gap "
        f"{hv['h3']['psnr_gap']:+.5f}), hpel once a P-VOP; P1 PNG files "
        f"{hv['p1_bytes']} bytes, "
        f"{hv['p1_identical']} of {IMG_FRAMES} the JAX package's, rgb24 "
        f"flips at ties against the JAX frames {hv['p1_flips']} of "
        f"{hv['p1_ties']} ties, none off the exact conversion elsewhere; G1 "
        f"{hv['g1_bytes']} bytes, the JAX package's file: "
        f"{hv['g1_identical']}; phase {hv['phase_s']:.1f} s")

    ac = acodecs_phase(dev)
    for name, wall in ac["wall_s"].items():
        log(f"acodecs {name} ({card}): {wall:.3f} s; launches "
            f"{json.dumps(ac['launches'].get(name, {}))}; split "
            + json.dumps(ac["split_s"].get(name, {})))
    log(f"acodecs ({card}): K1 {ac['k1']['frames']} FLAC frames "
        f"{ac['k1']['bytes']} bytes, the JAX encoder's with the final "
        f"STREAMINFO, decoded on the card to the WAV, pts repaired, the Ogg "
        f"and Matroska copies' packet hashes the FLAC file's; K2 "
        f"{ac['k2']['bytes']} AC-3 bytes, identical to the JAX package's: "
        f"{ac['k2']['identical']}; K3 {ac['k3']['packets']} FLAC packets "
        f"from {ac['k3']['frames']} frames, shape_scan "
        f"{ac['k3']['shape_scan']} launches equal to the plain scan, "
        f"the hybrid decode's {ac['k3']['hybrid_frames']} hashes the JAX "
        f"package's; "
        f"K4 biquad {ac['k4']['biquad']} launches for "
        f"{ac['k4']['frames']} frames, equal to the plain cascade; K5 "
        f"{ac['k5']['packets']} AAC packets {ac['k5']['bytes']} bytes (JAX "
        f"{ac['k5']['golden_bytes']}), SNR {ac['k5']['snr_db']:.4f} dB "
        f"(JAX {ac['k5']['golden_snr_db']:.4f}), first frame "
        f"{ac['k5']['first_frame']} samples; K6 copy exact; K7 files and "
        f"hashes exact; decoded s16 of K2, K3, K3H, K4 and K6 the JAX "
        f"package's (md5 of every sample)")
    log(f"acodecs launches: {json.dumps(ac['total_launches'])}; phase "
        f"{ac['phase_s']:.1f} s")

    dl = delivery_phase(dev)
    for name, wall in dl["wall_s"].items():
        log(f"delivery {name} ({card}): {wall:.3f} s; launches "
            f"{json.dumps(dl['launches'].get(name, {}))}; split "
            + json.dumps(dl["split_s"].get(name, {})))
    log(f"delivery ({card}): D1 the FLV and its ffprobe JSON the JAX "
        f"package's, decoded on the card to the asset's frames; D1a "
        f"{json.dumps(dl['d1a'])}; D2 the burned-in frames the JAX "
        f"package's, D2E {json.dumps(dl['d2'])}, its first "
        f"{DELIVERY_READBACK} VOPs decoded to the encoder's references "
        f"exactly, D2S the JAX package's SubRip; D3 {json.dumps(dl['d3'])},"
        f" loudnorm's s16 within LOUD_S16_SHARE of the JAX package's; D4 "
        f"the FLV's packets in "
        f"Matroska, the progress feed ending progress=end; D5 HLS and "
        f"DASH files the JAX package's, each read back over HTTP to the "
        f"asset's frames; D6 {DELIVERY_RTSP_AUS} access units pushed over "
        f"RTSP decoded to the asset's first frames")
    log(f"delivery launches: {json.dumps(dl['total_launches'])}; phase "
        f"{dl['phase_s']:.1f} s")

    k = kernel_leg_phase(dev, leg, profile_dir)
    log(f"kernel leg: {LEG_BATCH}x{LEG_H}x{LEG_W} -> {LEG_DH}x{LEG_DW}, "
        f"{LEG_ITERS} chained steps; launches {k['launches']}; MVs equal "
        f"the JAX package's on {[round(x, 6) for x in k['mv_equal']]}; "
        f"luma recon PSNR {[round(x, 2) for x in k['psnr_db']]} dB; "
        f"largest cost by which the JAX MV trails the port's "
        f"{k['tie_excess_max']}")
    log(f"kernel leg: {k['fps']:.3f} fps ({LEG_BATCH * LEG_ITERS} frames "
        f"in {k['wall_s'] * 1e3:.3f} ms, one warm pass)")
    if "profile" in k:
        log("kernel leg profile: " + json.dumps(k["profile"]))

    launches = {n: s["launches"][n] for n in E2E_KERNELS}
    launches["fsearch"] = k["launches"]["fsearch"]
    for n in ("hpel_luma", "hpel_chroma", "residual", "shape_scan",
              "biquad"):
        launches[n] = kres[n]["launches"]
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "row": KERNELS[name][2],
         "launches": launches[name], "path": KERNELS[name][3],
         "launches_options": o["launches"][name],
         "launches_jpeg": j["launches"][name],
         "launches_filters": fl["launches"][name],
         "launches_containers": c["total_launches"][name],
         "launches_encoders": e["total_launches"][name],
         "launches_hevc": hv["total_launches"][name],
         "launches_acodecs": ac["total_launches"][name],
         "launches_delivery": dl["total_launches"][name],
         **{k: kres[name][k] for k in (
             "max_abs_err", "ms", "device_ms", "device_ms_b2b", "plain_ms",
             "bound_ms",
             "bound_by", "library_ms", "library_note")}}
        for name in KERNELS]}
    kf = fl["fsearch_minterpolate"]
    next(e for e in record["kernels"] if e["name"] == "fsearch")[
        "minterpolate"] = {k: kf[k] for k in (
            "r", "ms", "device_ms", "device_ms_b2b", "plain_ms", "bound_ms",
            "bound_by")}
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
