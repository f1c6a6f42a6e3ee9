"""Vorbis I audio decoder.

Analog of libavcodec/vorbisdec.c: LSB-first bitstream,
setup-header codebooks (spec §3.2.1 canonical code assignment + VQ
lookup types 1/2), floor type 1 (piecewise-linear dB curve with the
spec's sorted-post neighbor interpolation and inverse-dB table), residue
types 0/1/2 (partitioned VQ with interleaved type-2 de-interleave),
mapping type 0 with square-polar channel coupling, and the lapped MDCT
synthesis with the Vorbis window sin(pi/2 sin^2(...)) and long/short
block transitions.

Headers arrive either in-band (Ogg) or as xiph-laced extradata
(Matroska CodecPrivate convention). Validated against reference-encoded
streams in tests/test_vorbis.py.

Each decoder decodes on the host, as the JAX module does, and uploads
each output frame once to its `device` (default "cuda").

A copy of librempeg_tpu/codecs/vorbis/decoder.py (host code, no JAX), imports
rewritten; floor 1 marks a nonzero point's neighbours as the spec says,
and a packet's end trim (SkipSamples) is dropped, both held to
libavcodec in tests/test_torch_libav_audio.py.
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.codecs.api import CodecInfo, Decoder, register_decoder
from librempeg_tpu_torch.core.errors import InvalidData, Unsupported
from librempeg_tpu_torch.core.frame import AudioFrame
from librempeg_tpu_torch.core.packet import Packet
from librempeg_tpu_torch.core.rational import NOPTS, Rational
from librempeg_tpu_torch.core.samplefmt import ChannelLayout
from librempeg_tpu_torch.core.sidedata import skip_side_data, trim
from librempeg_tpu_torch.device import resolve


class BitsLSB:
    """Vorbis LSB-first bit reader."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> int:
        v = 0
        p = self.pos
        d = self.data
        for i in range(n):
            byte = p >> 3
            if byte >= len(d):
                raise InvalidData("vorbis: bitstream exhausted")
            v |= ((d[byte] >> (p & 7)) & 1) << i
            p += 1
        self.pos = p
        return v

    def read1(self) -> int:
        p = self.pos
        byte = p >> 3
        if byte >= len(self.data):
            raise InvalidData("vorbis: bitstream exhausted")
        self.pos = p + 1
        return (self.data[byte] >> (p & 7)) & 1

    def eof(self) -> bool:
        return self.pos >= len(self.data) * 8


def ilog(x: int) -> int:
    return int(x).bit_length()


def float32_unpack(x: int) -> float:
    mant = x & 0x1FFFFF
    if x & 0x80000000:
        mant = -mant
    exp = (x & 0x7FE00000) >> 21
    return float(mant) * 2.0 ** (exp - 788)


def _assign_codewords(lengths):
    """Spec §3.2.1: entries get the lowest available code of their
    length, in entry order. Returns dict {(len, code): entry}."""
    table = {}
    avail = [(0, 0)]           # free subtrees: (depth, path-code)
    for entry, ln in enumerate(lengths):
        if ln <= 0:
            continue
        # lowest-valued free subtree whose depth <= ln; avail kept
        # sorted by left-justified code
        best = None
        for i, (d, code) in enumerate(avail):
            if d <= ln:
                best = i
                break
        if best is None:
            raise InvalidData("vorbis: over-subscribed codebook")
        d, code = avail.pop(best)
        # descend to depth ln along the 0 branch, freeing 1-siblings
        while d < ln:
            code <<= 1
            d += 1
            avail.append((d, code | 1))
        table[(ln, code)] = entry
        avail.sort(key=lambda t: (t[1] << (32 - t[0])))
    return table


class Codebook:
    __slots__ = ("dims", "entries", "table", "maxlen", "lut", "vq")

    def __init__(self, br: BitsLSB):
        if br.read(24) != 0x564342:
            raise InvalidData("vorbis: bad codebook sync")
        self.dims = br.read(16)
        self.entries = br.read(24)
        lengths = [0] * self.entries
        if br.read1():                       # ordered
            cur_len = br.read(5) + 1
            i = 0
            while i < self.entries:
                num = br.read(ilog(self.entries - i))
                for _ in range(num):
                    lengths[i] = cur_len
                    i += 1
                cur_len += 1
        else:
            sparse = br.read1()
            for i in range(self.entries):
                if sparse:
                    if br.read1():
                        lengths[i] = br.read(5) + 1
                else:
                    lengths[i] = br.read(5) + 1
        self.table = _assign_codewords(lengths)
        self.maxlen = max((ln for ln in lengths if ln > 0), default=0)
        # prefix LUT for fast decode (code accumulated MSB-first)
        self.lut = {}
        for (ln, code), entry in self.table.items():
            self.lut[(ln, code)] = entry

        lookup = br.read(4)
        self.vq = None
        if lookup == 0:
            return
        if lookup not in (1, 2):
            raise InvalidData("vorbis: bad lookup type")
        minv = float32_unpack(br.read(32))
        delta = float32_unpack(br.read(32))
        vbits = br.read(4) + 1
        seq_p = br.read1()
        if lookup == 1:
            # lookup1_values: largest v with v^dims <= entries
            lv = 0
            while (lv + 1) ** self.dims <= self.entries:
                lv += 1
            n_vals = lv
        else:
            n_vals = self.entries * self.dims
        mults = [br.read(vbits) for _ in range(n_vals)]
        vq = np.zeros((self.entries, self.dims))
        if lookup == 1:
            for e in range(self.entries):
                last = 0.0
                idx_div = 1
                for d in range(self.dims):
                    off = (e // idx_div) % n_vals
                    vq[e, d] = mults[off] * delta + minv + last
                    if seq_p:
                        last = vq[e, d]
                    idx_div *= n_vals
        else:
            for e in range(self.entries):
                last = 0.0
                for d in range(self.dims):
                    vq[e, d] = mults[e * self.dims + d] * delta + minv \
                        + last
                    if seq_p:
                        last = vq[e, d]
        self.vq = vq

    def decode(self, br: BitsLSB) -> int:
        code = 0
        ln = 0
        lut = self.lut
        for _ in range(self.maxlen):
            code = (code << 1) | br.read1()
            ln += 1
            e = lut.get((ln, code))
            if e is not None:
                return e
        raise InvalidData("vorbis: bad codeword")


class Floor1:
    __slots__ = ("partitions", "part_class", "class_dims", "class_subs",
                 "class_books", "subclass_books", "mult", "xlist",
                 "sorted_idx", "neigh")

    def __init__(self, br: BitsLSB, ncb: int):
        self.partitions = br.read(5)
        self.part_class = [br.read(4) for _ in range(self.partitions)]
        maxc = max(self.part_class) + 1 if self.partitions else 0
        self.class_dims = []
        self.class_subs = []
        self.class_books = []
        self.subclass_books = []
        for c in range(maxc):
            self.class_dims.append(br.read(3) + 1)
            subs = br.read(2)
            self.class_subs.append(subs)
            self.class_books.append(br.read(8) if subs else -1)
            books = []
            for _ in range(1 << subs):
                books.append(br.read(8) - 1)
            self.subclass_books.append(books)
        self.mult = br.read(2) + 1
        rangebits = br.read(4)
        xlist = [0, 1 << rangebits]
        for p in range(self.partitions):
            cd = self.class_dims[self.part_class[p]]
            for _ in range(cd):
                xlist.append(br.read(rangebits))
        self.xlist = xlist
        self.sorted_idx = sorted(range(len(xlist)),
                                 key=lambda i: xlist[i])
        # low/high neighbors (spec: nearest smaller/greater x among
        # positions with index < i)
        self.neigh = []
        for i in range(2, len(xlist)):
            lo = 0
            hi = 1
            for j in range(i):
                if xlist[lo] < xlist[j] < xlist[i]:
                    lo = j
                if xlist[i] < xlist[j] < xlist[hi]:
                    hi = j
            self.neigh.append((lo, hi))


_RANGES = (256, 128, 86, 64)

# floor1_inverse_dB_table (spec §10.5.1): 2^((x-255)/256 * ... ) --
# exactly exp((x - 255) * 0.11512925)
# floor1_inverse_dB_table (spec): geometric from 1.0649863e-07 to 1.0
_INV_DB = np.exp((np.arange(256) - 255) * 0.0629613011)


class Residue:
    __slots__ = ("rtype", "begin", "end", "psize", "classifications",
                 "classbook", "books")

    def __init__(self, br: BitsLSB, rtype: int):
        self.rtype = rtype
        self.begin = br.read(24)
        self.end = br.read(24)
        self.psize = br.read(24) + 1
        self.classifications = br.read(6) + 1
        self.classbook = br.read(8)
        cascades = []
        for _ in range(self.classifications):
            high = 0
            low = br.read(3)
            if br.read1():
                high = br.read(5)
            cascades.append(high * 8 + low)
        self.books = []
        for c in range(self.classifications):
            row = []
            for b in range(8):
                row.append(br.read(8) if cascades[c] & (1 << b) else -1)
            self.books.append(row)


class Mapping:
    __slots__ = ("submaps", "coupling", "mux", "submap_floor",
                 "submap_residue")


class VorbisDecoder:
    def __init__(self):
        self.channels = 0
        self.sample_rate = 0
        self.blocksize = [0, 0]
        self.codebooks = []
        self.floors = []
        self.residues = []
        self.mappings = []
        self.modes = []
        self._prev = None        # right half of previous window (per ch)
        self._prev_flag = 0
        self._have_setup = False
        self._win = {}
        self._imdct = {}

    # -- headers ------------------------------------------------------
    def header(self, pkt: bytes):
        if len(pkt) < 7 or pkt[1:7] != b"vorbis":
            raise InvalidData("vorbis: bad header packet")
        t = pkt[0]
        br = BitsLSB(pkt[7:])
        if t == 1:
            if br.read(32) != 0:
                raise InvalidData("vorbis: bad version")
            self.channels = br.read(8)
            self.sample_rate = br.read(32)
            br.read(96)                       # bitrate fields
            b0 = br.read(4)
            b1 = br.read(4)
            self.blocksize = [1 << b0, 1 << b1]
        elif t == 3:
            pass                              # comments: ignored
        elif t == 5:
            self._setup(br)
            self._have_setup = True
        else:
            raise InvalidData(f"vorbis: header type {t}")

    def _setup(self, br: BitsLSB):
        ncb = br.read(8) + 1
        self.codebooks = [Codebook(br) for _ in range(ncb)]
        for _ in range(br.read(6) + 1):       # time domain transforms
            if br.read(16) != 0:
                raise InvalidData("vorbis: bad time transform")
        self.floors = []
        for _ in range(br.read(6) + 1):
            ft = br.read(16)
            if ft == 1:
                self.floors.append(Floor1(br, ncb))
            elif ft == 0:
                raise Unsupported("vorbis: floor type 0 (LSP)")
            else:
                raise InvalidData("vorbis: bad floor type")
        self.residues = []
        for _ in range(br.read(6) + 1):
            rt = br.read(16)
            if rt > 2:
                raise InvalidData("vorbis: bad residue type")
            self.residues.append(Residue(br, rt))
        self.mappings = []
        for _ in range(br.read(6) + 1):
            if br.read(16) != 0:
                raise InvalidData("vorbis: bad mapping type")
            m = Mapping()
            m.submaps = br.read(4) + 1 if br.read1() else 1
            m.coupling = []
            if br.read1():
                steps = br.read(8) + 1
                bits = ilog(self.channels - 1)
                for _ in range(steps):
                    m.coupling.append((br.read(bits), br.read(bits)))
            if br.read(2) != 0:
                raise InvalidData("vorbis: reserved mapping bits")
            if m.submaps > 1:
                m.mux = [br.read(4) for _ in range(self.channels)]
            else:
                m.mux = [0] * self.channels
            m.submap_floor = []
            m.submap_residue = []
            for _ in range(m.submaps):
                br.read(8)                    # unused time config
                m.submap_floor.append(br.read(8))
                m.submap_residue.append(br.read(8))
            self.mappings.append(m)
        self.modes = []
        for _ in range(br.read(6) + 1):
            blockflag = br.read1()
            if br.read(16) or br.read(16):
                raise InvalidData("vorbis: bad mode window/transform")
            self.modes.append((blockflag, br.read(8)))
        if not br.read1():
            raise InvalidData("vorbis: framing error in setup")

    # -- floor1 decode -----------------------------------------------
    def _floor1_decode(self, br: BitsLSB, fl: Floor1):
        if not br.read1():
            return None                       # unused channel
        rng = _RANGES[fl.mult - 1]
        ys = [br.read(ilog(rng - 1)), br.read(ilog(rng - 1))]
        for p in range(fl.partitions):
            cls = fl.part_class[p]
            cdim = fl.class_dims[cls]
            cbits = fl.class_subs[cls]
            csub = (1 << cbits) - 1
            cval = 0
            if cbits:
                cval = self.codebooks[fl.class_books[cls]].decode(br)
            for _ in range(cdim):
                book = fl.subclass_books[cls][cval & csub]
                cval >>= cbits
                if book >= 0:
                    ys.append(self.codebooks[book].decode(br))
                else:
                    ys.append(0)
        return ys

    def _floor1_synth(self, fl: Floor1, ys, n: int) -> np.ndarray:
        rng = _RANGES[fl.mult - 1]
        npost = len(fl.xlist)
        step2 = [False] * npost
        final = [0] * npost
        step2[0] = step2[1] = True
        final[0], final[1] = ys[0], ys[1]
        for i in range(2, npost):
            lo, hi = fl.neigh[i - 2]
            pred = _render_point(fl.xlist[lo], final[lo],
                                 fl.xlist[hi], final[hi], fl.xlist[i])
            val = ys[i]
            high_room = rng - pred
            low_room = pred
            room = 2 * min(high_room, low_room)
            if val:
                # a nonzero point makes both its neighbours curve points
                # too (spec 7.2.4 step 1; the JAX decoder marks only the
                # point itself, and so leaves out a neighbour whose own
                # value was predicted)
                step2[lo] = step2[hi] = step2[i] = True
                if val >= room:
                    if high_room > low_room:
                        final[i] = val - low_room + pred
                    else:
                        final[i] = pred - val + high_room - 1
                elif val & 1:
                    final[i] = pred - ((val + 1) >> 1)
                else:
                    final[i] = pred + (val >> 1)
            else:
                step2[i] = False
                final[i] = pred
        # render curve over sorted positions
        out = np.zeros(n)
        si = fl.sorted_idx
        lx, ly = 0, final[si[0]] * fl.mult
        for k in si[1:]:
            if not step2[k]:
                continue
            hx = fl.xlist[k]
            hy = final[k] * fl.mult
            if hx > lx:
                _render_line(lx, ly, hx, hy, out, n)
            lx, ly = hx, hy
        if lx < n:
            out[lx:] = _INV_DB[min(int(ly), 255)]
        return out

    # -- residue ------------------------------------------------------
    def _residue_decode(self, br: BitsLSB, res: Residue, ch_vectors,
                        do_not_decode, n: int):
        """Decode one residue into ch_vectors (list of np arrays len n).
        Type 2 interleaves all channels into one vector."""
        rtype = res.rtype
        ch = len(ch_vectors)
        if rtype == 2:
            vecs = [np.zeros(n * ch)]
            active = [not all(do_not_decode)]
        else:
            vecs = ch_vectors
            active = [not d for d in do_not_decode]
        tn = len(vecs[0])
        begin = min(res.begin, tn)
        end = min(res.end, tn)
        psize = res.psize
        classbook = self.codebooks[res.classbook]
        cdim = classbook.dims
        n_to_read = end - begin
        if n_to_read == 0:
            return self._residue_post(rtype, vecs, ch_vectors, n)
        parts = n_to_read // psize
        classifs = np.zeros((len(vecs), parts + cdim), np.int64)
        for p8 in range(8):
            part = 0
            while part < parts:
                if p8 == 0:
                    for j, v in enumerate(vecs):
                        if not active[j]:
                            continue
                        temp = classbook.decode(br)
                        for k in range(cdim - 1, -1, -1):
                            classifs[j, part + k] = \
                                temp % res.classifications
                            temp //= res.classifications
                for k in range(cdim):
                    if part >= parts:
                        break
                    for j, v in enumerate(vecs):
                        if not active[j]:
                            continue
                        cls = int(classifs[j, part])
                        book = res.books[cls][p8]
                        if book < 0:
                            continue
                        cb = self.codebooks[book]
                        offset = begin + part * psize
                        if rtype == 0:
                            step = psize // cb.dims
                            for i in range(step):
                                e = cb.decode(br)
                                v[offset + i:offset + i
                                  + step * cb.dims:step] += cb.vq[e]
                        else:            # types 1 and 2 (flat packing)
                            i = 0
                            while i < psize:
                                e = cb.decode(br)
                                v[offset + i:offset + i + cb.dims] += \
                                    cb.vq[e]
                                i += cb.dims
                    part += 1
        return self._residue_post(rtype, vecs, ch_vectors, n)

    def _residue_post(self, rtype, vecs, ch_vectors, n):
        if rtype == 2:
            ch = len(ch_vectors)
            inter = vecs[0].reshape(n, ch)
            for j in range(ch):
                ch_vectors[j][:] = inter[:, j]

    # -- audio packet -------------------------------------------------
    def _window(self, size):
        w = self._win.get(size)
        if w is None:
            i = np.arange(size)
            w = np.sin(0.5 * np.pi
                       * np.sin(np.pi / size * (i + 0.5)) ** 2)
            self._win[size] = w
        return w

    def _imdct_mat(self, n):
        m = self._imdct.get(n)
        if m is None:
            i = np.arange(n)[:, None]
            k = np.arange(n // 2)[None, :]
            m = np.cos(2 * np.pi / n * (i + 0.5 + n / 4) * (k + 0.5))
            self._imdct[n] = m
        return m

    def decode_audio(self, data: bytes):
        br = BitsLSB(data)
        if br.read1() != 0:
            raise InvalidData("vorbis: not an audio packet")
        mode_idx = br.read(max(1, ilog(len(self.modes) - 1)))
        blockflag, map_idx = self.modes[mode_idx]
        n = self.blocksize[blockflag]
        prev_window_flag = next_window_flag = 1
        if blockflag:
            prev_window_flag = br.read1()
            next_window_flag = br.read1()
        m = self.mappings[map_idx]
        ch = self.channels
        half = n // 2

        # floors
        floor_out = []
        no_residue = []
        for c in range(ch):
            fl = self.floors[m.submap_floor[m.mux[c]]]
            ys = self._floor1_decode(br, fl)
            floor_out.append((fl, ys))
            no_residue.append(ys is None)
        # coupling can reactivate channels
        for (mag, ang) in m.coupling:
            if not (no_residue[mag] and no_residue[ang]):
                no_residue[mag] = no_residue[ang] = False

        # residues per submap
        resid = [np.zeros(half) for _ in range(ch)]
        for sm in range(m.submaps):
            vecs = []
            dnd = []
            for c in range(ch):
                if m.mux[c] == sm:
                    vecs.append(resid[c])
                    dnd.append(no_residue[c])
            res = self.residues[m.submap_residue[sm]]
            self._residue_decode(br, res, vecs, dnd, half)

        # inverse coupling (square polar, spec §4.3.5.2):
        #   M>0: A>0 -> (M, M-A) else (M+A, M)
        #   M<=0: A>0 -> (M, M+A) else (M-A, M)
        for (mag_c, ang_c) in reversed(m.coupling):
            M = resid[mag_c]
            A = resid[ang_c]
            nm = np.where(A > 0, M, np.where(M > 0, M + A, M - A))
            na = np.where(A > 0, np.where(M > 0, M - A, M + A), M)
            resid[mag_c] = nm
            resid[ang_c] = na

        # floor curve * residue, IMDCT, windowing
        prev_n = self.blocksize[self._prev_flag]
        outs = []
        win = self._window(n)
        for c in range(ch):
            fl, ys = floor_out[c]
            if ys is None:
                spec = np.zeros(half)
            else:
                curve = self._floor1_synth(fl, ys, half)
                spec = resid[c] * curve
            t = self._imdct_mat(n) @ spec      # [n]
            # window shape: long blocks lapping short neighbors use the
            # hybrid window halves
            wl = win
            if blockflag:
                s0 = self.blocksize[0]
                left = wl[:half].copy()
                right = wl[half:].copy()
                if not prev_window_flag:
                    left = np.zeros(half)
                    off = (n - s0) // 4
                    ws = self._window(s0)
                    left[off:off + s0 // 2] = ws[:s0 // 2]
                    left[off + s0 // 2:] = 1.0
                if not next_window_flag:
                    right = np.zeros(half)
                    off = (n - s0) // 4
                    ws = self._window(s0)
                    right[:half - off - s0 // 2] = 1.0
                    right[half - off - s0 // 2:half - off] = ws[s0 // 2:]
                t = t * np.concatenate([left, right])
            else:
                t = t * wl
            outs.append(t)

        # overlap-add: emit prev_n/4 + n/4 samples per block. The
        # current left half starts prev_n/4 - n/4 relative to the
        # previous right half (negative offsets carry only zeros from
        # the hybrid window, so they are dropped).
        ret = None
        if self._prev is not None:
            out_len = prev_n // 4 + n // 4
            ret = np.zeros((ch, out_len), np.float32)
            cur_start = prev_n // 4 - n // 4
            for c in range(ch):
                buf = np.zeros(out_len)
                ptail = self._prev[c]
                lp = min(len(ptail), out_len)
                buf[:lp] += ptail[:lp]
                src0 = max(0, -cur_start)
                dst0 = max(0, cur_start)
                ln = min(half - src0, out_len - dst0)
                buf[dst0:dst0 + ln] += outs[c][src0:src0 + ln]
                ret[c] = buf
        self._prev = [outs[c][half:] for c in range(ch)]
        self._prev_flag = blockflag
        return ret


def _render_point(x0, y0, x1, y1, x):
    dy = y1 - y0
    adx = x1 - x0
    ady = abs(dy)
    err = ady * (x - x0)
    off = err // adx
    return y0 - off if dy < 0 else y0 + off


def _render_line(x0, y0, x1, y1, out, n):
    """Spec §10.5.2 Bresenham line into the floor curve."""
    dy = y1 - y0
    adx = x1 - x0
    base = dy // adx
    ady = abs(dy) - abs(base) * adx
    sy = 1 if dy >= 0 else -1
    k = np.arange(0, min(x1, n) - x0)
    y = y0 + base * k + sy * ((ady * k) // adx)
    yy = np.clip(y, 0, 255).astype(np.int64)
    out[x0:x0 + len(k)] = _INV_DB[yy]


@register_decoder
class VorbisCodec(Decoder):
    INFO = CodecInfo(name="vorbis", long_name="Vorbis",
                     codec_type="audio")
    #: the sample format of the frames it returns
    sample_fmt = "fltp"

    def __init__(self, params=None, device="cuda", **opts):
        self.device = resolve(device)
        self._dec = VorbisDecoder()
        self._pts = 0
        super().__init__(params, **opts)

    def configure(self, params):
        ed = bytes(params.extradata or b"")
        if ed[:1] == b"\x02":                 # xiph lacing
            sizes = []
            pos = 1
            for _ in range(2):
                v = 0
                while True:
                    b = ed[pos]
                    pos += 1
                    v += b
                    if b != 255:
                        break
                sizes.append(v)
            for sz in sizes:
                self._dec.header(ed[pos:pos + sz])
                pos += sz
            self._dec.header(ed[pos:])

    def decode(self, pkt: Packet):
        data = bytes(pkt.data)
        if not data:
            return []
        if data[0] & 1:                       # header packet
            self._dec.header(data)
            return []
        if not self._dec._have_setup:
            raise InvalidData("vorbis: audio before setup")
        pcm = self._dec.decode_audio(data)
        if pcm is not None:
            # the end trim of the stream's last packet (SkipSamples
            # side data from the Ogg demuxer, as libavformat sets it)
            pcm = trim(pcm, 0, skip_side_data(pkt, 0)[1])[0]
        if pcm is None or pcm.shape[1] == 0:
            return []
        pts = pkt.pts if pkt.pts != NOPTS else self._pts
        self._pts = pts + pcm.shape[1]
        sr = self._dec.sample_rate
        return [AudioFrame(
            data=torch.from_numpy(pcm.astype(np.float32)).to(self.device),
            sample_rate=sr,
            sample_fmt="fltp",
            layout=ChannelLayout.default(pcm.shape[0]), pts=pts,
            time_base=pkt.time_base
            if pkt.time_base.valid and pkt.time_base.num
            else Rational(1, sr))]
