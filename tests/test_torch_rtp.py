"""The port's RTP depacketisers and SDP demuxer (librempeg_tpu_torch/
formats/rtp.py) and its RTSP listen demuxer (formats/rtsp.py) against
the JAX package's, on loopback (127.0.0.1) only.

The same hand-built RTP packets (RFC 6184 single NAL and FU-A, mildly
reordered; RFC 6416 MPEG-4 fragments; RFC 3640 AAC AU headers; static
G.711 and L16) go through both packages' RtpStreamCtx: the packets out
are equal (pts, dts, flags, data), and the H.264 ones decode in the port
to the source stream's frames exactly. The SDP demuxer receives them as
UDP datagrams sent to 127.0.0.1, the RTSP demuxer (?listen=1) from a
scripted pushing peer (ANNOUNCE, SETUP, RECORD, interleaved RTP over
TCP); each gives the packets of the direct depacketisation. Ports come
from binding port 0; every socket wait and join has a timeout of at
most 15 s.
"""
import socket
import struct
import threading
import time

import numpy as np
import pytest

from librempeg_tpu.codecs.h264.codec import H264Encoder
from librempeg_tpu.core.frame import VideoFrame
from librempeg_tpu.core.rational import Rational
from librempeg_tpu.formats import rtp as JR
from librempeg_tpu_torch.codecs.api import find_decoder
from librempeg_tpu_torch.formats import rtp as TRtp
from librempeg_tpu_torch.formats.api import open_input

TIMEOUT = 15.0


def free_port(kind=socket.SOCK_STREAM) -> int:
    s = socket.socket(socket.AF_INET, kind)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def h264_stream(n=10, w=96, h=64):
    rng = np.random.default_rng(0)
    enc = H264Encoder(width=w, height=h, qp=28, g=8)
    base = rng.integers(0, 256, (h * 2, w * 2)).astype(np.uint8)
    pkts = []
    for i in range(n):
        y = base[i:h + i, i * 2:w + i * 2]
        u = np.full((h // 2, w // 2), 128, np.uint8)
        v = np.full((h // 2, w // 2), 100, np.uint8)
        pkts += enc.encode(VideoFrame(planes=(y.copy(), u, v),
                                      format="yuv420p", width=w, height=h,
                                      pts=i, time_base=Rational(1, 25)))
    return enc, [bytes(p.data) for p in pkts]


def rtp(pt, seq, ts, payload, marker=0):
    return struct.pack(">BBHII", 0x80, (marker << 7) | pt, seq & 0xFFFF,
                       ts & 0xFFFFFFFF, 0x1234) + payload


def packetize_h264(aus, mtu=600, reorder=False):
    """RFC 6184 single NAL units and FU-A, one timestamp per access
    unit; with reorder, adjacent pairs are swapped every 4 packets."""
    from librempeg_tpu_torch.codecs.h264.parse import split_annexb

    out, seq = [], 100
    for fi, au in enumerate(aus):
        ts = 90000 * fi // 25
        nals = split_annexb(au)
        for ni, nal in enumerate(nals):
            last = ni == len(nals) - 1
            if len(nal) <= mtu:
                out.append(rtp(96, seq, ts, nal, marker=last))
                seq += 1
                continue
            hdr, body = nal[0], nal[1:]
            for off in range(0, len(body), mtu):
                s, e = off == 0, off + mtu >= len(body)
                fu = bytes([(hdr & 0xE0) | 28,
                            (s << 7) | (e << 6) | (hdr & 0x1F)])
                out.append(rtp(96, seq, ts, fu + body[off:off + mtu],
                               marker=last and e))
                seq += 1
    if reorder:
        for i in range(0, len(out) - 1, 4):
            out[i], out[i + 1] = out[i + 1], out[i]
    return out


def media(pt, rtpmap, fmtp=None, port=0):
    return {"type": "video" if rtpmap and rtpmap[0] in ("h264", "mp4v-es")
            else "audio", "port": port, "proto": "RTP/AVP", "pt": pt,
            "rtpmap": rtpmap, "fmtp": fmtp or {}, "conn": "",
            "control": ""}


def depay(mod, m, raws):
    ctx = mod.RtpStreamCtx(m, 0)
    out = []
    for raw in raws:
        out += ctx.push(raw)
    out += ctx.flush()
    par = ctx.codecpar()
    return ((par.codec_id, par.sample_rate, par.nb_channels,
             bytes(par.extradata or b"")),
            [(p.pts, p.dts, int(p.flags), bytes(p.data)) for p in out])


def decode(par, pkts):
    from librempeg_tpu_torch.core.packet import Packet
    from librempeg_tpu_torch.formats.api import CodecParameters

    dec = find_decoder("h264")(CodecParameters(
        codec_type="video", codec_id="h264", width=par.width,
        height=par.height, extradata=par.extradata), device="cpu")
    frames = []
    for d in pkts:
        frames += [np.asarray(f.planes[0]) for f in dec.decode(
            Packet(data=d))]
    return frames + [np.asarray(f.planes[0]) for f in dec.flush()]


CASES = {
    "h264": (96, ("h264", 90000, 1), {}),
    "mp4v": (97, ("mp4v-es", 90000, 1), {"config": "000001b0f5"}),
    "aac": (98, ("mpeg4-generic", 48000, 2),
            {"sizelength": "13", "indexlength": "3",
             "indexdeltalength": "3", "config": "1190"}),
    "pcmu": (0, None, {}),
    "l16": (99, ("l16", 44100, 2), {}),
}


def payloads(kind):
    if kind == "h264":
        return packetize_h264(h264_stream()[1], reorder=True)
    if kind == "mp4v":
        frames = [bytes([0, 0, 1, 0xb6, i]) * (300 + 50 * i)
                  for i in range(5)]
        out, seq = [], 1
        for i, f in enumerate(frames):
            for off in range(0, len(f), 500):
                out.append(rtp(97, seq, 3600 * i, f[off:off + 500],
                               marker=off + 500 >= len(f)))
                seq += 1
        return out
    if kind == "aac":
        aus = [bytes(range(3 + k, 9 + 2 * k)) for k in range(6)]
        out = []
        for i in range(0, 6, 2):
            a, b = aus[i], aus[i + 1]
            hdr = struct.pack(">HHH", 32, len(a) << 3, len(b) << 3)
            out.append(rtp(98, i, 1024 * i, hdr + a + b, marker=1))
        return out
    pt = CASES[kind][0]
    return [rtp(pt, i, 160 * i, bytes((j + i) & 255 for j in range(160)))
            for i in range(4)]


@pytest.mark.parametrize("kind", sorted(CASES))
def test_depacketisers_match_jax(kind):
    pt, rtpmap, fmtp = CASES[kind]
    raws = payloads(kind)
    j = depay(JR, media(pt, rtpmap, fmtp), raws)
    t = depay(TRtp, media(pt, rtpmap, fmtp), raws)
    assert j == t and t[1]


def test_sdp_parse_matches_jax():
    sdp = ("v=0\no=- 0 0 IN IP4 127.0.0.1\ns=t\nc=IN IP4 127.0.0.1\n"
           "m=audio 4000 RTP/AVP 97\na=rtpmap:97 mpeg4-generic/48000/2\n"
           "a=fmtp:97 sizelength=13;indexlength=3;config=1190\n"
           "m=video 4002 RTP/AVP 96\na=rtpmap:96 H264/90000\n"
           "a=control:streamid=1\n")
    assert JR.parse_sdp(sdp) == TRtp.parse_sdp(sdp)


def test_h264_over_rtp_decodes_to_the_stream():
    enc, aus = h264_stream()
    _, pk = depay(TRtp, media(96, ("h264", 90000, 1)),
                  packetize_h264(aus, reorder=True))
    par = enc.codec_parameters()
    got, want = decode(par, [p[3] for p in pk]), decode(par, aus)
    assert len(got) == len(want) == 10
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_sdp_demuxer_over_udp(tmp_path):
    enc, aus = h264_stream(n=6)
    raws = packetize_h264(aus)
    port = free_port(socket.SOCK_DGRAM)
    sdp = tmp_path / "s.sdp"
    sdp.write_text(f"v=0\no=- 0 0 IN IP4 127.0.0.1\ns=t\n"
                   f"c=IN IP4 127.0.0.1\nt=0 0\nm=video {port} RTP/AVP 96\n"
                   f"a=rtpmap:96 H264/90000\n")
    result = {}

    def pull():
        d = open_input(str(sdp))
        result["pk"] = [(p.pts, p.dts, int(p.flags), bytes(p.data))
                        for p in d.packets()]
        d.close()

    t = threading.Thread(target=pull)
    t.start()
    time.sleep(0.5)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for raw in raws:
        s.sendto(raw, ("127.0.0.1", port))
        time.sleep(0.001)
    s.close()
    t.join(timeout=TIMEOUT)
    assert not t.is_alive()
    assert result["pk"] == depay(TRtp, media(96, ("h264", 90000, 1)),
                                 raws)[1]


def push_rtsp(port, raws, path="x"):
    """A scripted RTSP peer: ANNOUNCE, SETUP, RECORD, then the RTP
    packets interleaved on channel 0 of the TCP connection."""
    sdp = ("v=0\r\no=- 0 0 IN IP4 127.0.0.1\r\ns=x\r\n"
           "c=IN IP4 127.0.0.1\r\nt=0 0\r\n"
           "m=video 0 RTP/AVP 96\r\na=rtpmap:96 H264/90000\r\n"
           "a=control:streamid=0\r\n")
    for _ in range(int(TIMEOUT / 0.1)):
        try:
            sock = socket.create_connection(("127.0.0.1", port),
                                            timeout=TIMEOUT)
            break
        except ConnectionRefusedError:
            time.sleep(0.1)
    f = sock.makefile("rwb")

    def req(method, url, hdrs, body=b""):
        lines = [f"{method} {url} RTSP/1.0", "CSeq: 1"]
        lines += [f"{k}: {v}" for k, v in hdrs.items()]
        if body:
            lines.append(f"Content-Length: {len(body)}")
        f.write(("\r\n".join(lines) + "\r\n\r\n").encode() + body)
        f.flush()
        assert b"200" in f.readline()
        while f.readline() not in (b"\r\n", b"\n", b""):
            pass

    base = f"rtsp://127.0.0.1:{port}/{path}"
    req("ANNOUNCE", base, {"Content-Type": "application/sdp"}, sdp.encode())
    req("SETUP", base + "/streamid=0",
        {"Transport": "RTP/AVP/TCP;unicast;interleaved=0-1"})
    req("RECORD", base, {"Session": "s"})
    for raw in raws:
        f.write(b"$\x00" + struct.pack(">H", len(raw)) + raw)
    f.flush()
    sock.close()


def test_rtsp_listen_receives_a_push():
    enc, aus = h264_stream(n=8)
    raws = packetize_h264(aus)
    port = free_port()
    result = {}

    def pull():
        d = open_input(f"rtsp://127.0.0.1:{port}/x?listen=1",
                       format="rtsp", timeout=TIMEOUT)
        result["codec"] = d.streams[0].codecpar.codec_id
        result["pk"] = [(p.pts, p.dts, int(p.flags), bytes(p.data))
                        for p in d.packets()]
        d.close()

    t = threading.Thread(target=pull)
    t.start()
    push_rtsp(port, raws)
    t.join(timeout=TIMEOUT)
    assert not t.is_alive()
    assert result["codec"] == "h264"
    assert result["pk"] == depay(TRtp, media(96, ("h264", 90000, 1)),
                                 raws)[1]
    got = decode(enc.codec_parameters(), [p[3] for p in result["pk"]])
    want = decode(enc.codec_parameters(), aus)
    assert len(got) == 8 and all(np.array_equal(a, b)
                                 for a, b in zip(got, want))
