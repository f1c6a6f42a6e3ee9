"""Write the E-AC-3 and 5.1 AC-3 test streams of the PyTorch port's tests
and of chip_smoke.py's acodecs phase into tests/data/torch_port/acodecs/,
each beside libavcodec's own float decode of it.

    python tools/torch_port_ac3_fixtures.py [--out DIR]

The streams are written by libavcodec's native `ac3` and `eac3`
encoders (libavcodec 59.37.100, libavutil 57.28.100: Debian 12's
FFmpeg 5.1), through a small C program (`C_SOURCE`) that this tool
compiles with the system `gcc` against the libavcodec headers
(`-lavcodec -lavutil`) and runs once. Only this tool needs libavcodec
and gcc: the tests and chip_smoke.py read the committed files.

The program encodes planar float32 PCM in frames of 1536 samples, writes
the encoder's packets back to back (a valid raw .ac3/.eac3 elementary
stream), and decodes each packet at once with libavcodec's decoder of
the same codec (float planar out, libavcodec's channel order: FL FR FC
LFE SL SR for 5.1). The streams:

- `eac3_stereo.eac3`: E-AC-3 stereo, 48 kHz, 192 kb/s, 1 s;
- `eac3_51.eac3`: E-AC-3 5.1, 48 kHz, 384 kb/s, 1 s;
- `ac3_51.ac3`: AC-3 5.1 (acmod 7 with LFE), 48 kHz, 448 kb/s, 1 s, at
  the encoder's defaults, so that channel coupling is in use;
- `eac3_44k.eac3`: E-AC-3 stereo, 44.1 kHz, 192 kb/s, 1 s.

The signals are the tones of tests/test_eac3.py (stereo: 440 Hz sine,
550 Hz cosine plus 3 kHz; 5.1: 440/660/880/110/1320/1760 Hz in
libavcodec's order). libavcodec's eac3 encoder writes an independent
substream with 6 blocks a frame and no AHT, SPX or enhanced coupling,
which is the scope of the decoders under test.

The oracle `<stream>.npz` holds `pcm`: libavcodec's decode, float32
planar [channels, samples/ORACLE_STEP], every ORACLE_STEP-th sample of
each channel (the whole decode of the four streams would be 3 MB; every
256-sample block of every channel keeps 16 samples), and `step`. The
encoders are deterministic for one library build; against another
build the bytes change, and the goldens (tools/torch_port_goldens.py
--acodecs) must then be rewritten. It prints each file's size and md5.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port", "acodecs")
ORACLE_STEP = 16

C_SOURCE = r"""
#include <stdio.h>
#include <stdlib.h>
#include <libavcodec/avcodec.h>
#include <libavutil/channel_layout.h>

/* ac3fix CODEC RATE CHANNELS BITRATE IN.f32 OUT.stream OUT.f32
   IN.f32: planar float32 [channels][n]; OUT.f32: the decode, one
   planar [channels][nb_samples] block a decoded frame. */
static void die(const char *what, int err) {
    fprintf(stderr, "%s failed (%d)\n", what, err);
    exit(1);
}

static void drain(AVCodecContext *dec, AVFrame *df, FILE *fd) {
    int r;
    while ((r = avcodec_receive_frame(dec, df)) >= 0) {
        for (int c = 0; c < df->ch_layout.nb_channels; c++)
            fwrite(df->extended_data[c], 4, df->nb_samples, fd);
        av_frame_unref(df);
    }
    if (r != AVERROR(EAGAIN) && r != AVERROR_EOF) die("receive_frame", r);
}

static void put(AVCodecContext *enc, AVCodecContext *dec, AVPacket *pkt,
                AVFrame *df, FILE *fs, FILE *fd) {
    int r;
    while ((r = avcodec_receive_packet(enc, pkt)) >= 0) {
        fwrite(pkt->data, 1, pkt->size, fs);
        if ((r = avcodec_send_packet(dec, pkt)) < 0) die("send_packet", r);
        drain(dec, df, fd);
        av_packet_unref(pkt);
    }
    if (r != AVERROR(EAGAIN) && r != AVERROR_EOF) die("receive_packet", r);
}

int main(int argc, char **argv) {
    if (argc != 8) { fprintf(stderr, "usage\n"); return 2; }
    int rate = atoi(argv[2]), ch = atoi(argv[3]);
    FILE *fi = fopen(argv[5], "rb");
    fseek(fi, 0, SEEK_END);
    long n = ftell(fi) / 4 / ch;
    fseek(fi, 0, SEEK_SET);
    float *pcm = malloc(n * ch * 4);
    if (fread(pcm, 4, n * ch, fi) != (size_t)(n * ch)) die("fread", 0);
    fclose(fi);

    const AVCodec *ec = avcodec_find_encoder_by_name(argv[1]);
    const AVCodec *dc = avcodec_find_decoder_by_name(argv[1]);
    if (!ec || !dc) die("find codec", 0);
    AVCodecContext *enc = avcodec_alloc_context3(ec);
    enc->sample_fmt = AV_SAMPLE_FMT_FLTP;
    enc->sample_rate = rate;
    enc->bit_rate = atol(argv[4]);
    av_channel_layout_default(&enc->ch_layout, ch);
    int r;
    if ((r = avcodec_open2(enc, ec, NULL)) < 0) die("open encoder", r);
    AVCodecContext *dec = avcodec_alloc_context3(dc);
    dec->request_sample_fmt = AV_SAMPLE_FMT_FLTP;
    if ((r = avcodec_open2(dec, dc, NULL)) < 0) die("open decoder", r);

    FILE *fs = fopen(argv[6], "wb"), *fd = fopen(argv[7], "wb");
    AVFrame *f = av_frame_alloc(), *df = av_frame_alloc();
    AVPacket *pkt = av_packet_alloc();
    int fsz = enc->frame_size;
    for (long s = 0; s < n; s += fsz) {
        int m = n - s < fsz ? (int)(n - s) : fsz;
        f->nb_samples = m;
        f->format = AV_SAMPLE_FMT_FLTP;
        f->sample_rate = rate;
        av_channel_layout_copy(&f->ch_layout, &enc->ch_layout);
        f->pts = s;
        if ((r = av_frame_get_buffer(f, 0)) < 0) die("get_buffer", r);
        for (int c = 0; c < ch; c++)
            for (int k = 0; k < m; k++)
                ((float *)f->extended_data[c])[k] = pcm[c * n + s + k];
        if ((r = avcodec_send_frame(enc, f)) < 0) die("send_frame", r);
        av_frame_unref(f);
        put(enc, dec, pkt, df, fs, fd);
    }
    avcodec_send_frame(enc, NULL);
    put(enc, dec, pkt, df, fs, fd);
    avcodec_send_packet(dec, NULL);
    drain(dec, df, fd);
    fclose(fs);
    fclose(fd);
    printf("%d %s\n", fsz, LIBAVCODEC_IDENT);
    return 0;
}
"""


def tones(rate: int, channels: int, seconds: float = 1.0) -> np.ndarray:
    """[channels, n] float32: tests/test_eac3.py's tones, in libavcodec's
    channel order."""
    t = np.arange(int(round(seconds * rate))) / rate

    def s(f):
        return np.sin(2 * np.pi * f * t)

    if channels == 2:
        x = [0.4 * s(440), 0.4 * np.cos(2 * np.pi * 550 * t) + 0.1 * s(3000)]
    else:
        x = [0.4 * s(440), 0.4 * s(660), 0.3 * s(880), 0.2 * s(110),
             0.3 * s(1320), 0.3 * s(1760)]
    return np.stack(x).astype(np.float32)


#: file -> (codec, sample rate, channels, bit rate)
STREAMS = {
    "eac3_stereo.eac3": ("eac3", 48000, 2, 192000),
    "eac3_51.eac3": ("eac3", 48000, 6, 384000),
    "ac3_51.ac3": ("ac3", 48000, 6, 448000),
    "eac3_44k.eac3": ("eac3", 44100, 2, 192000),
}


def build(tmp: str) -> str:
    src, exe = os.path.join(tmp, "ac3fix.c"), os.path.join(tmp, "ac3fix")
    with open(src, "w") as f:
        f.write(C_SOURCE)
    subprocess.run(["gcc", "-O1", "-o", exe, src, "-lavcodec", "-lavutil"],
                   check=True)
    return exe


def write(exe: str, tmp: str, out: str, name: str) -> str:
    """Encode and decode one stream; returns libavcodec's ident."""
    codec, rate, ch, bit_rate = STREAMS[name]
    x = tones(rate, ch)
    raw, dec = os.path.join(tmp, "in.f32"), os.path.join(tmp, "dec.f32")
    x.tofile(raw)
    res = subprocess.run([exe, codec, str(rate), str(ch), str(bit_rate), raw,
                          os.path.join(out, name), dec],
                         check=True, capture_output=True, text=True)
    fsz = int(res.stdout.split()[0])
    pcm = np.fromfile(dec, np.float32).reshape(-1, ch, fsz)
    pcm = pcm.transpose(1, 0, 2).reshape(ch, -1)
    np.savez_compressed(os.path.join(out, name + ".npz"),
                        pcm=np.ascontiguousarray(pcm[:, ::ORACLE_STEP]),
                        step=np.int32(ORACLE_STEP))
    return res.stdout.split()[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    total = 0
    with tempfile.TemporaryDirectory() as tmp:
        exe = build(tmp)
        for name in STREAMS:
            ident = write(exe, tmp, args.out, name)
            for f in (name, name + ".npz"):
                data = open(os.path.join(args.out, f), "rb").read()
                total += len(data)
                print(f"{f} {len(data)} {hashlib.md5(data).hexdigest()}")
    print(f"total {total} bytes ({ident})")


if __name__ == "__main__":
    main()
