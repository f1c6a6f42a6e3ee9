"""Write what libavutil, libavcodec and libavformat say about channel
layouts, WAV headers, framemd5 headers and the AC-3 decoder, for the
PyTorch port's tests and chip_smoke.py's acodecs phase.

    python tools/torch_port_libav_fixtures.py [--out DIR]

A small C program (`C_SOURCE`) is compiled with the system `gcc` against
the system FFmpeg headers (`-lavformat -lavcodec -lavutil`) and run a
few times. The committed files were written with libavutil 57.28.100,
libavcodec 59.37.100 and libavformat 59.27.100 (Debian 12's FFmpeg
5.1). Only this tool needs those libraries and gcc: the tests and
chip_smoke.py read the committed files. It writes into
tests/data/torch_port/:

- `libav_layouts.json`:
  - `versions`: the libraries' idents;
  - `channels`: av_channel_name of every channel bit;
  - `layouts`: av_channel_layout_standard's layouts in libavutil's
    order, each with its mask and av_channel_layout_describe's name;
  - `defaults`: av_channel_layout_default for 1-10 channels;
  - `describe`: av_channel_layout_describe of unnamed masks and of
    layouts with no known order;
  - `from_string`: av_channel_layout_from_string of a few strings;
  - `wav`: the WAV files that libavformat's muxer writes with
    AVFMT_FLAG_BITEXACT for the streams of WAV_CASES (all but the
    payload in hex, the payload being zeros);
  - `framemd5`: the header that libavformat's framemd5 muxer writes
    for one audio stream of each of five layouts;
  - `ac3`: for each stream of acodecs/ (tools/torch_port_ac3_fixtures.py),
    the layout that libavformat's raw demuxer and libavcodec's decoder
    report, and what avcodec_flush_buffers does to the decode: the
    samples after a flush compared with a fresh decoder's from the same
    packet and with the decode that went on without the flush.
- `acodecs/eac3_44k.eac3.flush.npz`: libavcodec's decodes of the
  44.1 kHz stream from packet FLUSH_AT on (`at`), every ORACLE_STEP-th
  sample (`step`): `flushed`, by a decoder flushed there, and `fresh`,
  by a decoder opened there (what ffmpeg's -ss gives: it seeks before
  it opens the decoder).

It prints each file's size and md5.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port")
ORACLE_STEP = 16
FLUSH_AT = 10            # packets decoded before avcodec_flush_buffers
WAV_SAMPLES = 1000       # samples a channel of each WAV case but the AC-3
AC3_STREAMS = ("eac3_stereo.eac3", "eac3_51.eac3", "ac3_51.ac3",
               "eac3_44k.eac3")

#: name -> (codec, rate, layout): a layout is a standard name, or
#: "ac3:<stream>" for the layout and length of libavcodec's decode of
#: that stream (the nine cases of the WAV rule, then the s16 decodes of
#: the other three AC-3 streams, which the CLI tests write)
WAV_CASES = {
    "s16_mono_44k": ("pcm_s16le", 44100, "mono"),
    "s16_stereo_48k": ("pcm_s16le", 48000, "stereo"),
    "s16_3ch": ("pcm_s16le", 48000, "3c"),
    "s16_6ch": ("pcm_s16le", 48000, "6c"),
    "s16_ac3_51": ("pcm_s16le", 48000, "ac3:ac3_51.ac3"),
    "s16_mono_96k": ("pcm_s16le", 96000, "mono"),
    "s24_stereo_48k": ("pcm_s24le", 48000, "stereo"),
    "s32_stereo_48k": ("pcm_s32le", 48000, "stereo"),
    "f32_stereo_48k": ("pcm_f32le", 48000, "stereo"),
    "s16_eac3_stereo": ("pcm_s16le", 48000, "ac3:eac3_stereo.eac3"),
    "s16_eac3_51": ("pcm_s16le", 48000, "ac3:eac3_51.eac3"),
    "s16_eac3_44k": ("pcm_s16le", 44100, "ac3:eac3_44k.eac3"),
}
#: framemd5 cases: a layout string for av_channel_layout_from_string
FRAMEMD5_CASES = ("mono", "stereo", "5.1(side)", "5.1", "6C")
#: av_channel_layout_describe of masks with no name and of layouts with
#: no known order ("<n>C")
DESCRIBE_CASES = ("0x13", "0x600", "0x60c", "0x20000000", "1C", "2C",
                  "6C", "9C")
FROM_STRING_CASES = ("mono", "stereo", "5.1", "5.1(side)", "5.0",
                     "5.0(side)", "7.1(wide)", "downmix", "octagonal",
                     "1c", "3c", "6c", "8c", "6C", "6 channels", "6",
                     "FL+FR+LFE", "0x3f", "0x60F")

C_SOURCE = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>

static void die(const char *what, int err) {
    fprintf(stderr, "%s failed (%d)\n", what, err);
    exit(1);
}

static void layout_json(const AVChannelLayout *l) {
    char buf[256];
    av_channel_layout_describe(l, buf, sizeof(buf));
    printf("{\"order\": %d, \"nb_channels\": %d, \"mask\": %llu, "
           "\"name\": \"%s\"}", l->order, l->nb_channels,
           l->order == AV_CHANNEL_ORDER_NATIVE
               ? (unsigned long long)l->u.mask : 0ULL, buf);
}

static void layout_of(AVChannelLayout *l, const char *s) {
    int r = av_channel_layout_from_string(l, s);
    if (r < 0) die(s, r);
}

/* info STRINGS... (after "--" the describe cases) */
static int info(int argc, char **argv) {
    void *it = NULL;
    const AVChannelLayout *std;
    char buf[256];
    printf("{\"versions\": [\"%s\", \"%s\", \"%s\"],\n", LIBAVUTIL_IDENT,
           LIBAVCODEC_IDENT, LIBAVFORMAT_IDENT);
    printf("\"channels\": [");
    for (int c = 0; c < 64; c++) {
        av_channel_name(buf, sizeof(buf), (enum AVChannel)c);
        printf("%s\"%s\"", c ? ", " : "", buf);
    }
    printf("],\n\"layouts\": [");
    for (int i = 0; (std = av_channel_layout_standard(&it)); i++) {
        printf("%s", i ? ",\n  " : "");
        layout_json(std);
    }
    printf("],\n\"defaults\": [");
    for (int n = 1; n <= 10; n++) {
        AVChannelLayout l;
        av_channel_layout_default(&l, n);
        printf("%s", n > 1 ? ",\n  " : "");
        layout_json(&l);
    }
    int i = 0;
    printf("],\n\"from_string\": {");
    for (; i < argc && strcmp(argv[i], "--"); i++) {
        AVChannelLayout l = {0};
        int r = av_channel_layout_from_string(&l, argv[i]);
        printf("%s\"%s\": ", i ? ",\n  " : "", argv[i]);
        if (r < 0) printf("null");
        else layout_json(&l);
    }
    printf("},\n\"describe\": {");
    for (int k = i + 1; k < argc; k++) {
        AVChannelLayout l = {0};
        layout_of(&l, argv[k]);
        printf("%s\"%s\": ", k > i + 1 ? ",\n  " : "", argv[k]);
        layout_json(&l);
    }
    printf("}}\n");
    return 0;
}

static AVFormatContext *open_out(const char *fmt, const char *path) {
    AVFormatContext *oc = NULL;
    int r = avformat_alloc_output_context2(&oc, NULL, fmt, path);
    if (r < 0) die("alloc output", r);
    oc->flags |= AVFMT_FLAG_BITEXACT;
    if ((r = avio_open(&oc->pb, path, AVIO_FLAG_WRITE)) < 0) die("avio", r);
    return oc;
}

static AVStream *audio_stream(AVFormatContext *oc, const char *codec,
                              int rate, const AVChannelLayout *l) {
    AVStream *st = avformat_new_stream(oc, NULL);
    const AVCodecDescriptor *d = avcodec_descriptor_get_by_name(codec);
    if (!d) die(codec, 0);
    st->codecpar->codec_type = AVMEDIA_TYPE_AUDIO;
    st->codecpar->codec_id = d->id;
    st->codecpar->sample_rate = rate;
    av_channel_layout_copy(&st->codecpar->ch_layout, l);
    st->time_base = (AVRational){1, rate};
    return st;
}

/* wav OUT CODEC RATE LAYOUT NSAMPLES: one packet of zeros */
static int wav(char **argv) {
    AVChannelLayout l = {0};
    layout_of(&l, argv[3]);
    AVFormatContext *oc = open_out("wav", argv[0]);
    AVStream *st = audio_stream(oc, argv[1], atoi(argv[2]), &l);
    int r = avformat_write_header(oc, NULL);
    if (r < 0) die("write_header", r);
    int n = atoi(argv[4]);
    int bps = av_get_bits_per_sample(st->codecpar->codec_id) / 8;
    AVPacket *pkt = av_packet_alloc();
    if ((r = av_new_packet(pkt, n * bps * l.nb_channels)) < 0) die("pkt", r);
    memset(pkt->data, 0, pkt->size);
    pkt->pts = pkt->dts = 0;
    pkt->duration = n;
    pkt->stream_index = 0;
    if ((r = av_write_frame(oc, pkt)) < 0) die("write_frame", r);
    if ((r = av_write_trailer(oc)) < 0) die("write_trailer", r);
    avio_closep(&oc->pb);
    return 0;
}

/* framemd5 OUT LAYOUT: the header of one pcm_s16le 48 kHz stream */
static int framemd5(char **argv) {
    AVChannelLayout l = {0};
    layout_of(&l, argv[1]);
    AVFormatContext *oc = open_out("framemd5", argv[0]);
    audio_stream(oc, "pcm_s16le", 48000, &l);
    int r = avformat_write_header(oc, NULL);
    if (r < 0) die("write_header", r);
    if ((r = av_write_trailer(oc)) < 0) die("write_trailer", r);
    avio_closep(&oc->pb);
    return 0;
}

static void put_frames(AVCodecContext *dec, AVFrame *f, FILE *fd,
                       AVChannelLayout *seen) {
    int r;
    while ((r = avcodec_receive_frame(dec, f)) >= 0) {
        if (seen && !seen->nb_channels)
            av_channel_layout_copy(seen, &f->ch_layout);
        if (fd)
            for (int c = 0; c < f->ch_layout.nb_channels; c++)
                fwrite(f->extended_data[c], 4, f->nb_samples, fd);
        av_frame_unref(f);
    }
    if (r != AVERROR(EAGAIN) && r != AVERROR_EOF) die("receive_frame", r);
}

/* decode STREAM AT CONT FLUSHED FRESH: the packets of libavformat's
   demuxer through three decoders: one that decodes them all (CONT),
   one that is flushed after AT packets and goes on (FLUSHED: what it
   decodes after the flush), one opened at packet AT (FRESH). Prints
   the layouts the demuxer and the decoder report. */
static int decode(char **argv) {
    AVFormatContext *ic = NULL;
    int r = avformat_open_input(&ic, argv[0], NULL, NULL);
    if (r < 0) die("open_input", r);
    if ((r = avformat_find_stream_info(ic, NULL)) < 0) die("stream_info", r);
    AVCodecParameters *par = ic->streams[0]->codecpar;
    const AVCodec *dc = avcodec_find_decoder(par->codec_id);
    AVCodecContext *dec[3];
    for (int i = 0; i < 3; i++) {
        dec[i] = avcodec_alloc_context3(dc);
        avcodec_parameters_to_context(dec[i], par);
        dec[i]->request_sample_fmt = AV_SAMPLE_FMT_FLTP;
        if ((r = avcodec_open2(dec[i], dc, NULL)) < 0) die("open", r);
    }
    int at = atoi(argv[1]);
    FILE *fd[3] = {fopen(argv[2], "wb"), fopen(argv[3], "wb"),
                   fopen(argv[4], "wb")};
    AVPacket *pkt = av_packet_alloc();
    AVFrame *f = av_frame_alloc();
    AVChannelLayout seen = {0};
    int n = 0;
    while (av_read_frame(ic, pkt) >= 0) {
        if (n == at) avcodec_flush_buffers(dec[1]);
        for (int i = 0; i < 3; i++) {
            if (i == 2 && n < at) continue;
            if ((r = avcodec_send_packet(dec[i], pkt)) < 0) die("send", r);
            put_frames(dec[i], f, (i == 0 || n >= at) ? fd[i] : NULL,
                       i == 0 ? &seen : NULL);
        }
        av_packet_unref(pkt);
        n++;
    }
    for (int i = 0; i < 3; i++) {
        avcodec_send_packet(dec[i], NULL);
        put_frames(dec[i], f, fd[i], NULL);
        fclose(fd[i]);
    }
    printf("{\"packets\": %d, \"demuxer\": ", n);
    layout_json(&par->ch_layout);
    printf(", \"decoder\": ");
    layout_json(&seen);
    printf("}\n");
    return 0;
}

int main(int argc, char **argv) {
    if (argc < 2) return 2;
    if (!strcmp(argv[1], "info")) return info(argc - 2, argv + 2);
    if (!strcmp(argv[1], "wav") && argc == 7) return wav(argv + 2);
    if (!strcmp(argv[1], "framemd5") && argc == 4) return framemd5(argv + 2);
    if (!strcmp(argv[1], "decode") && argc == 7) return decode(argv + 2);
    fprintf(stderr, "usage\n");
    return 2;
}
"""


def build(tmp: str) -> str:
    src, exe = os.path.join(tmp, "libavfix.c"), os.path.join(tmp, "libavfix")
    with open(src, "w") as f:
        f.write(C_SOURCE)
    subprocess.run(["gcc", "-O1", "-o", exe, src, "-lavformat", "-lavcodec",
                    "-lavutil"], check=True)
    return exe


def run(exe: str, *args) -> str:
    return subprocess.run([exe, *map(str, args)], check=True,
                          capture_output=True, text=True).stdout


def planar(path: str, ch: int, frame: int = 1536) -> np.ndarray:
    """A decode written one planar [ch][frame] block a frame -> [ch, n]."""
    x = np.fromfile(path, np.float32).reshape(-1, ch, frame)
    return x.transpose(1, 0, 2).reshape(ch, -1)


def decodes(exe: str, tmp: str, out: str) -> dict:
    """The layouts and the flush behaviour of each committed AC-3
    stream; writes the 44.1 kHz stream's post-flush oracle into out."""
    res = {}
    for name in AC3_STREAMS:
        files = [os.path.join(tmp, f"{k}.f32") for k in ("c", "f", "n")]
        info = json.loads(run(exe, "decode", os.path.join(
            OUT, "acodecs", name), FLUSH_AT, *files))
        ch = info["decoder"]["nb_channels"]
        cont, flushed, fresh = (planar(f, ch) for f in files)
        tail = cont[:, FLUSH_AT * 1536:]
        assert flushed.shape == fresh.shape == tail.shape
        info["samples"] = cont.shape[1]
        info["flush"] = {
            "at": FLUSH_AT,
            "max_abs_diff_fresh": float(np.abs(flushed - fresh).max()),
            "max_abs_diff_continued": float(np.abs(flushed - tail).max()),
            "equals_fresh": bool(np.array_equal(flushed, fresh)),
            "equals_continued": bool(np.array_equal(flushed, tail))}
        res[name] = info
        if name == "eac3_44k.eac3":
            np.savez_compressed(
                os.path.join(out, "acodecs", name + ".flush.npz"),
                flushed=np.ascontiguousarray(flushed[:, ::ORACLE_STEP]),
                fresh=np.ascontiguousarray(fresh[:, ::ORACLE_STEP]),
                step=np.int32(ORACLE_STEP), at=np.int32(FLUSH_AT))
    return res


def wav_cases(exe: str, tmp: str, ac3: dict) -> dict:
    res = {}
    for case, (codec, rate, layout) in WAV_CASES.items():
        n = WAV_SAMPLES
        if layout.startswith("ac3:"):
            info = ac3[layout[4:]]
            layout, n = hex(info["decoder"]["mask"]), info["samples"]
        path = os.path.join(tmp, case + ".wav")
        run(exe, "wav", path, codec, rate, layout, n)
        raw = open(path, "rb").read()
        start = raw.index(b"data") + 8
        res[case] = {"codec": codec, "rate": rate, "layout": layout,
                     "samples": n, "size": len(raw),
                     "header": raw[:start].hex(),
                     "payload": len(raw) - start,
                     "md5": hashlib.md5(raw).hexdigest()}
        assert raw[start:] == bytes(len(raw) - start)
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    os.makedirs(os.path.join(args.out, "acodecs"), exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        exe = build(tmp)
        doc = json.loads(run(exe, "info", *FROM_STRING_CASES, "--",
                             *DESCRIBE_CASES))
        doc["ac3"] = decodes(exe, tmp, args.out)
        doc["wav"] = wav_cases(exe, tmp, doc["ac3"])
        doc["framemd5"] = {}
        for layout in FRAMEMD5_CASES:
            path = os.path.join(tmp, "h.md5")
            run(exe, "framemd5", path, layout)
            doc["framemd5"][layout] = open(path).read()
    path = os.path.join(args.out, "libav_layouts.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    for p in (path, os.path.join(args.out, "acodecs",
                                 "eac3_44k.eac3.flush.npz")):
        data = open(p, "rb").read()
        print(f"{os.path.relpath(p, ROOT)} {len(data)} "
              f"{hashlib.md5(data).hexdigest()}")
    print(" ".join(doc["versions"]))


if __name__ == "__main__":
    main()
