"""Write what libavformat and libavcodec make of the committed MP2, MP3
and Vorbis streams and of the WAV muxer's non-PCM tags, for the PyTorch
port's tests and chip_smoke.py's acodecs phase.

    python tools/torch_port_libav_audio.py [--out DIR]

A small C program (`C_SOURCE`) is compiled with the system `gcc` against
the system FFmpeg headers (`-lavformat -lavcodec -lavutil`) and run a
few times, as tools/torch_port_libav_fixtures.py does. The committed
files were written with libavutil 57.28.100, libavcodec 59.37.100 and
libavformat 59.27.100 (Debian 12's FFmpeg 5.1). Only this tool needs
those libraries and gcc: the tests and chip_smoke.py read the committed
files. It writes into tests/data/torch_port/:

- `libav_audio.json`:
  - `versions`: the libraries' idents;
  - `decodes`: for each case of DECODES, what libavformat's demuxer and
    libavcodec's default decoder give: the decoder's name and sample
    format, the stream's start_time (in samples), every packet's pts,
    duration and size and the AV_PKT_DATA_SKIP_SAMPLES side data the
    demuxer attaches (start skip, end discard), and every decoded
    frame's pts and sample count (in samples of 1/rate);
  - `lame`: for each MP3, the encoder delay and padding of the LAME tag
    of its Info/Xing frame (bytes 141-143 of the tag), and the frame
    count of the Xing header;
  - `wav`: for each codec of WAV_CODECS, the WAV file that
    libavformat writes with AVFMT_FLAG_BITEXACT for libavcodec's encode
    of `wav_input()` (bit exact, AVCodecContext's default bit rate, as
    ffmpeg's -c:a gives it): the encoder's frame size and block align,
    the packets' sizes and durations, the file's size and md5, its bytes
    up to the data chunk in hex and the payload's md5;
  - `framemd5`: the header libavformat's framemd5 muxer writes for one
    video and one audio stream.
- `libav_wav/<codec>.wav`: those four files;
- `acodecs/<stream>.libav.npz`: each decode of DECODES of a file as it
  is (not seeked, copied or stripped), every
  ORACLE_STEP-th sample (`step`) of every channel as float32 (`pcm`; an
  s16 decode divided by 32768, which float32 holds exactly), and the
  whole of the frames listed in FULL_FRAMES (`full_<k>`, `[ch, n]`).

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
#: every ORACLE_STEP-th sample is kept; 15 is prime to the 32-sample
#: groups of the MPEG audio synthesis, so every phase of them is held
ORACLE_STEP = 15
#: name -> (input under acodecs/, how): "" decodes the file, "seek:S"
#: decodes after avformat_seek_file to S seconds past the start (as
#: ffmpeg's -ss seeks), "copy:FMT" decodes libavformat's stream copy of
#: the file into FMT (every packet with its side data, as ffmpeg's
#: -c:a copy passes them), "strip" decodes the MP3 with its Info frame
#: taken out (an MP3 without a LAME tag)
DECODES = {
    "mp2": ("mp2.mp2", ""),
    "mp3": ("mp3.mp3", ""),
    "mp3_mono32k": ("mp3_mono32k.mp3", ""),
    "vorbis": ("vorbis.ogg", ""),
    "mp3_seek": ("mp3.mp3", "seek:0.5"),
    "mp3_copy_mkv": ("mp3.mp3", "copy:matroska"),
    "mp3_strip": ("mp3.mp3", "strip"),
    "vorbis_copy_mkv": ("vorbis.ogg", "copy:matroska"),
}
#: decodes whose every frame (not only every ORACLE_STEP-th sample) the
#: npz keeps, by frame index: the first frames of each stream (the start
#: skip), MP2's frames past full scale, the MP3 end discard, and the
#: Vorbis packets around the first that the port's decoder missed
FULL_FRAMES = {
    "mp2": (0, 1, 15, 60, 208),
    "mp3": (0, 1, 2, 191),
    "mp3_mono32k": (0, 1, 28),
    "vorbis": (0, 1, 14, 15, 16, 17, 18),
}
#: the WAV muxer's non-PCM tags (wavenc.c writes a `fact` chunk for
#: each, and ff_put_wav_header a cbSize)
WAV_CODECS = ("pcm_alaw", "pcm_mulaw", "adpcm_ima_wav", "adpcm_ms")
WAV_RATE, WAV_CHANNELS, WAV_SAMPLES = 44100, 2, 5000

C_SOURCE = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/intreadwrite.h>
#include <libavutil/mathematics.h>

static void die(const char *what, int err) {
    fprintf(stderr, "%s failed (%d)\n", what, err);
    exit(1);
}

static long long in_samples(int64_t ts, AVRational tb, int rate) {
    if (ts == AV_NOPTS_VALUE) return -1LL << 62;
    return av_rescale_q(ts, tb, (AVRational){1, rate});
}

/* decode IN OUT SEEK: libavformat's packets through the default
   decoder, every frame's samples appended to OUT as float32 planar
   ([ch][n] a frame; s16 divided by 32768). SEEK < 0: no seek. */
static int decode(char **argv) {
    AVFormatContext *ic = NULL;
    int r = avformat_open_input(&ic, argv[0], NULL, NULL);
    if (r < 0) die("open_input", r);
    if ((r = avformat_find_stream_info(ic, NULL)) < 0) die("stream_info", r);
    AVStream *st = ic->streams[0];
    AVCodecParameters *par = st->codecpar;
    const AVCodec *dc = avcodec_find_decoder(par->codec_id);
    AVCodecContext *dec = avcodec_alloc_context3(dc);
    avcodec_parameters_to_context(dec, par);
    dec->pkt_timebase = st->time_base;
    if ((r = avcodec_open2(dec, dc, NULL)) < 0) die("open", r);
    int rate = par->sample_rate;
    double seek = atof(argv[2]);
    if (seek >= 0) {
        int64_t ts = (int64_t)(seek * AV_TIME_BASE);
        if (ic->start_time != AV_NOPTS_VALUE) ts += ic->start_time;
        if ((r = avformat_seek_file(ic, -1, INT64_MIN, ts, ts, 0)) < 0)
            die("seek", r);
    }
    FILE *fd = fopen(argv[1], "wb");
    AVPacket *pkt = av_packet_alloc();
    AVFrame *f = av_frame_alloc();
    printf("{\"decoder\": \"%s\", \"rate\": %d, \"channels\": %d, "
           "\"time_base\": [%d, %d], \"start_time\": %lld,\n\"packets\": [",
           dc->name, rate, par->ch_layout.nb_channels, st->time_base.num,
           st->time_base.den, in_samples(st->start_time, st->time_base,
                                         rate));
    int np = 0, nf = 0, fmt = -1;
    char frames[1 << 16] = "";
    size_t flen = 0;
    for (int eof = 0; !eof;) {
        if (av_read_frame(ic, pkt) < 0) {
            eof = 1;
            avcodec_send_packet(dec, NULL);
        } else {
            size_t n;
            uint8_t *sd = av_packet_get_side_data(
                pkt, AV_PKT_DATA_SKIP_SAMPLES, &n);
            printf("%s[%lld, %lld, %d, %d, %d]", np++ ? ", " : "",
                   in_samples(pkt->pts, st->time_base, rate),
                   in_samples(pkt->duration, st->time_base, rate),
                   pkt->size, sd && n >= 10 ? (int)AV_RL32(sd) : 0,
                   sd && n >= 10 ? (int)AV_RL32(sd + 4) : 0);
            if ((r = avcodec_send_packet(dec, pkt)) < 0) die("send", r);
            av_packet_unref(pkt);
        }
        while ((r = avcodec_receive_frame(dec, f)) >= 0) {
            int ch = f->ch_layout.nb_channels;
            fmt = f->format;
            for (int c = 0; c < ch; c++)
                for (int i = 0; i < f->nb_samples; i++) {
                    float v;
                    if (fmt == AV_SAMPLE_FMT_S16P)
                        v = ((int16_t *)f->extended_data[c])[i] / 32768.0f;
                    else if (fmt == AV_SAMPLE_FMT_FLTP)
                        v = ((float *)f->extended_data[c])[i];
                    else
                        die("sample format", fmt);
                    fwrite(&v, 4, 1, fd);
                }
            flen += snprintf(frames + flen, sizeof(frames) - flen,
                             "%s[%lld, %d]", nf++ ? ", " : "",
                             in_samples(f->pts, st->time_base, rate),
                             f->nb_samples);
            if (flen >= sizeof(frames) - 64) die("frame list", 0);
            av_frame_unref(f);
        }
        if (r != AVERROR(EAGAIN) && r != AVERROR_EOF) die("receive", r);
    }
    fclose(fd);
    printf("],\n\"frames\": [%s],\n\"sample_fmt\": \"%s\"}\n", frames,
           av_get_sample_fmt_name(fmt));
    return 0;
}

/* copy IN FMT OUT: every packet of IN into FMT, side data and all */
static int copy(char **argv) {
    AVFormatContext *ic = NULL, *oc = NULL;
    int r = avformat_open_input(&ic, argv[0], NULL, NULL);
    if (r < 0) die("open_input", r);
    if ((r = avformat_find_stream_info(ic, NULL)) < 0) die("stream_info", r);
    if ((r = avformat_alloc_output_context2(&oc, NULL, argv[1], argv[2])) < 0)
        die("alloc output", r);
    oc->flags |= AVFMT_FLAG_BITEXACT;
    AVStream *st = avformat_new_stream(oc, NULL);
    avcodec_parameters_copy(st->codecpar, ic->streams[0]->codecpar);
    st->codecpar->codec_tag = 0;
    st->time_base = ic->streams[0]->time_base;
    if ((r = avio_open(&oc->pb, argv[2], AVIO_FLAG_WRITE)) < 0) die("avio", r);
    if ((r = avformat_write_header(oc, NULL)) < 0) die("write_header", r);
    AVPacket *pkt = av_packet_alloc();
    while (av_read_frame(ic, pkt) >= 0) {
        av_packet_rescale_ts(pkt, ic->streams[0]->time_base, st->time_base);
        pkt->pos = -1;
        if ((r = av_interleaved_write_frame(oc, pkt)) < 0) die("write", r);
    }
    if ((r = av_write_trailer(oc)) < 0) die("write_trailer", r);
    avio_closep(&oc->pb);
    return 0;
}

/* wav OUT CODEC RATE CH IN: IN's interleaved s16 through libavcodec's
   encoder (frames of its frame_size, the short last one as encode.c
   takes it) into libavformat's WAV muxer; prints each packet's size
   and duration */
static int wav(char **argv) {
    const AVCodec *ec = avcodec_find_encoder_by_name(argv[1]);
    if (!ec) die(argv[1], 0);
    int rate = atoi(argv[2]), ch = atoi(argv[3]), r;
    AVCodecContext *enc = avcodec_alloc_context3(ec);
    enc->sample_rate = rate;
    enc->sample_fmt = ec->sample_fmts[0];
    av_channel_layout_default(&enc->ch_layout, ch);
    enc->time_base = (AVRational){1, rate};
    enc->flags |= AV_CODEC_FLAG_BITEXACT;
    if ((r = avcodec_open2(enc, ec, NULL)) < 0) die("open encoder", r);
    AVFormatContext *oc = NULL;
    if ((r = avformat_alloc_output_context2(&oc, NULL, "wav", argv[0])) < 0)
        die("alloc output", r);
    oc->flags |= AVFMT_FLAG_BITEXACT;
    AVStream *st = avformat_new_stream(oc, NULL);
    avcodec_parameters_from_context(st->codecpar, enc);
    st->time_base = enc->time_base;
    if ((r = avio_open(&oc->pb, argv[0], AVIO_FLAG_WRITE)) < 0) die("avio", r);
    if ((r = avformat_write_header(oc, NULL)) < 0) die("write_header", r);
    FILE *in = fopen(argv[4], "rb");
    fseek(in, 0, SEEK_END);
    long total = ftell(in) / (2 * ch);
    fseek(in, 0, SEEK_SET);
    int fs = enc->frame_size ? enc->frame_size : 1024;
    AVFrame *f = av_frame_alloc();
    AVPacket *pkt = av_packet_alloc();
    long done = 0;
    int np = 0;
    printf("{\"frame_size\": %d, \"block_align\": %d, \"packets\": [",
           enc->frame_size, enc->block_align);
    for (;;) {
        int n = total - done < fs ? (int)(total - done) : fs;
        if (n > 0) {
            f->nb_samples = n;
            f->format = enc->sample_fmt;
            av_channel_layout_copy(&f->ch_layout, &enc->ch_layout);
            if ((r = av_frame_get_buffer(f, 0)) < 0) die("frame", r);
            int16_t *buf = malloc(2 * ch * n);
            if (fread(buf, 2 * ch, n, in) != (size_t)n) die("read", 0);
            for (int i = 0; i < n; i++)
                for (int c = 0; c < ch; c++) {
                    if (av_sample_fmt_is_planar(enc->sample_fmt))
                        ((int16_t *)f->extended_data[c])[i] = buf[i * ch + c];
                    else
                        ((int16_t *)f->data[0])[i * ch + c] = buf[i * ch + c];
                }
            free(buf);
            f->pts = done;
            done += n;
            if ((r = avcodec_send_frame(enc, f)) < 0) die("send_frame", r);
            av_frame_unref(f);
        } else if ((r = avcodec_send_frame(enc, NULL)) < 0) {
            die("flush", r);
        }
        while ((r = avcodec_receive_packet(enc, pkt)) >= 0) {
            printf("%s[%d, %lld]", np++ ? ", " : "", pkt->size,
                   (long long)pkt->duration);
            av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
            if ((r = av_write_frame(oc, pkt)) < 0) die("write_frame", r);
        }
        if (r == AVERROR_EOF) break;
        if (r != AVERROR(EAGAIN)) die("receive_packet", r);
    }
    printf("]}\n");
    if ((r = av_write_trailer(oc)) < 0) die("write_trailer", r);
    avio_closep(&oc->pb);
    return 0;
}

/* framemd5 OUT: the header for a 320x240 video and a stereo s16 stream */
static int framemd5(char **argv) {
    AVFormatContext *oc = NULL;
    int r = avformat_alloc_output_context2(&oc, NULL, "framemd5", argv[0]);
    if (r < 0) die("alloc output", r);
    oc->flags |= AVFMT_FLAG_BITEXACT;
    AVStream *v = avformat_new_stream(oc, NULL);
    v->codecpar->codec_type = AVMEDIA_TYPE_VIDEO;
    v->codecpar->codec_id = AV_CODEC_ID_RAWVIDEO;
    v->codecpar->format = AV_PIX_FMT_YUV420P;
    v->codecpar->width = 320;
    v->codecpar->height = 240;
    v->time_base = (AVRational){1, 25};
    AVStream *a = avformat_new_stream(oc, NULL);
    a->codecpar->codec_type = AVMEDIA_TYPE_AUDIO;
    a->codecpar->codec_id = AV_CODEC_ID_PCM_S16LE;
    a->codecpar->sample_rate = 44100;
    av_channel_layout_default(&a->codecpar->ch_layout, 2);
    a->time_base = (AVRational){1, 44100};
    if ((r = avio_open(&oc->pb, argv[0], AVIO_FLAG_WRITE)) < 0) die("avio", r);
    if ((r = avformat_write_header(oc, NULL)) < 0) die("write_header", r);
    if ((r = av_write_trailer(oc)) < 0) die("write_trailer", r);
    avio_closep(&oc->pb);
    return 0;
}

int main(int argc, char **argv) {
    if (argc < 2) return 2;
    if (!strcmp(argv[1], "versions")) {
        printf("[\"%s\", \"%s\", \"%s\"]\n", LIBAVUTIL_IDENT,
               LIBAVCODEC_IDENT, LIBAVFORMAT_IDENT);
        return 0;
    }
    if (!strcmp(argv[1], "decode") && argc == 5) return decode(argv + 2);
    if (!strcmp(argv[1], "copy") && argc == 5) return copy(argv + 2);
    if (!strcmp(argv[1], "wav") && argc == 7) return wav(argv + 2);
    if (!strcmp(argv[1], "framemd5") && argc == 3) return framemd5(argv + 2);
    fprintf(stderr, "usage\n");
    return 2;
}
"""


def build(tmp: str) -> str:
    src, exe = os.path.join(tmp, "libavaudio.c"), os.path.join(tmp,
                                                               "libavaudio")
    with open(src, "w") as f:
        f.write(C_SOURCE)
    subprocess.run(["gcc", "-O1", "-o", exe, src, "-lavformat", "-lavcodec",
                    "-lavutil"], check=True)
    return exe


def run(exe: str, *args) -> str:
    return subprocess.run([exe, *map(str, args)], check=True,
                          capture_output=True, text=True).stdout


def wav_input() -> np.ndarray:
    """The WAV cases' input: [WAV_SAMPLES, WAV_CHANNELS] int16, two
    tones and a linear congruential noise, made with integer arithmetic
    only (the same on every numpy)."""
    n = np.arange(WAV_SAMPLES, dtype=np.int64)
    lcg = (n * 1103515245 + 12345) % (1 << 31)
    noise = (lcg >> 16) % 4001 - 2000
    tone = np.round(12000 * np.sin(2 * np.pi * 440 * n / WAV_RATE))
    left = tone.astype(np.int64) + noise
    right = np.round(9000 * np.sin(2 * np.pi * 1250 * n / WAV_RATE)
                     ).astype(np.int64) - noise
    return np.stack([left, right], 1).astype(np.int16)


def lame_tag(path: str) -> dict:
    """The Xing frame count and the LAME tag's encoder delay and padding
    (12 bits each, bytes 141-143 after the Xing/Info tag), as
    libavformat's mp3_parse_info_tag reads them."""
    data = open(path, "rb").read()
    for tag in (b"Xing", b"Info"):
        k = data.find(tag, 0, 4096)
        if k < 0:
            continue
        flags = int.from_bytes(data[k + 4:k + 8], "big")
        frames = int.from_bytes(data[k + 8:k + 12], "big") if flags & 1 \
            else None
        v = int.from_bytes(data[k + 141:k + 144], "big")
        return {"tag": tag.decode(), "encoder": data[k + 120:k + 124]
                .decode("latin-1"), "frames": frames, "delay": v >> 12,
                "padding": v & 4095}
    return {}


def strip_info_frame(src: str, dst: str) -> None:
    """Write the MP3 with its first frame (the Info/Xing frame) taken
    out."""
    data = open(src, "rb").read()
    k = data.find(b"Info", 0, 4096)
    if k < 0:
        k = data.find(b"Xing", 0, 4096)
    start = data.rfind(b"\xff", 0, k)
    while data[start + 1] & 0xE0 != 0xE0:
        start = data.rfind(b"\xff", 0, start)
    b = data[start:start + 4]
    rates = {3: (44100, 48000, 32000)}[(b[1] >> 3) & 3]
    kbps = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
            320)[b[2] >> 4]
    size = 144 * kbps * 1000 // rates[(b[2] >> 2) & 3] + ((b[2] >> 1) & 1)
    with open(dst, "wb") as f:
        f.write(data[:start] + data[start + size:])


def decodes(exe: str, tmp: str, out: str) -> dict:
    res = {}
    for name, (src, how) in DECODES.items():
        path, seek = os.path.join(OUT, "acodecs", src), -1
        if how.startswith("seek:"):
            seek = float(how[5:])
        elif how.startswith("copy:"):
            copied = os.path.join(tmp, name + ".mkv")
            run(exe, "copy", path, how[5:], copied)
            path = copied
        elif how == "strip":
            stripped = os.path.join(tmp, name + ".mp3")
            strip_info_frame(path, stripped)
            path = stripped
        pcm_path = os.path.join(tmp, name + ".f32")
        info = json.loads(run(exe, "decode", path, pcm_path, seek))
        ch = info["channels"]
        raw = np.fromfile(pcm_path, np.float32)
        blocks, pos = [], 0
        for _, n in info["frames"]:
            blocks.append(raw[pos:pos + ch * n].reshape(ch, n))
            pos += ch * n
        assert pos == raw.size
        pcm = np.concatenate(blocks, 1)
        info.update(src=src, how=how, samples=int(pcm.shape[1]))
        res[name] = info
        keep = {"pcm": np.ascontiguousarray(pcm[:, ::ORACLE_STEP]),
                "step": np.int32(ORACLE_STEP)}
        for k in FULL_FRAMES.get(name, ()):
            keep[f"full_{k}"] = blocks[k]
        if not how:
            np.savez_compressed(os.path.join(out, "acodecs",
                                             name + ".libav.npz"), **keep)
    return res


def wav_cases(exe: str, tmp: str, out: str) -> dict:
    src = os.path.join(tmp, "in.s16")
    wav_input().tofile(src)
    res = {}
    os.makedirs(os.path.join(out, "libav_wav"), exist_ok=True)
    for codec in WAV_CODECS:
        path = os.path.join(out, "libav_wav", codec + ".wav")
        info = json.loads(run(exe, "wav", path, codec, WAV_RATE,
                              WAV_CHANNELS, src))
        raw = open(path, "rb").read()
        start = raw.index(b"data") + 8
        info.update(size=len(raw), header=raw[:start].hex(),
                    payload_md5=hashlib.md5(raw[start:]).hexdigest(),
                    md5=hashlib.md5(raw).hexdigest())
        res[codec] = info
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    os.makedirs(os.path.join(args.out, "acodecs"), exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        exe = build(tmp)
        doc = {"versions": json.loads(run(exe, "versions")),
               "decodes": decodes(exe, tmp, args.out),
               "lame": {src: lame_tag(os.path.join(OUT, "acodecs", src))
                        for src in ("mp3.mp3", "mp3_mono32k.mp3")},
               "wav": wav_cases(exe, tmp, args.out),
               "wav_input": {"rate": WAV_RATE, "channels": WAV_CHANNELS,
                             "samples": WAV_SAMPLES},
               "step": ORACLE_STEP}
        path = os.path.join(tmp, "h.md5")
        run(exe, "framemd5", path)
        doc["framemd5"] = open(path).read()
    path = os.path.join(args.out, "libav_audio.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    names = [path] + sorted(
        os.path.join(args.out, "acodecs", n) for n in os.listdir(
            os.path.join(args.out, "acodecs")) if n.endswith(".libav.npz")) \
        + [os.path.join(args.out, "libav_wav", c + ".wav")
           for c in WAV_CODECS]
    for p in names:
        data = open(p, "rb").read()
        print(f"{os.path.relpath(p, args.out)} {len(data)} "
              f"{hashlib.md5(data).hexdigest()}")
    print(" ".join(doc["versions"]))


if __name__ == "__main__":
    main()
