"""H.264 encoder (host) and decoder: host entropy + tensor P-frame
reconstruction.

H264Encoder is a copy of the JAX package's (librempeg_tpu/codecs/h264/
codec.py; host code, numpy and the native library), imports rewritten;
it fetches each plane of a frame once, from whatever device it is on.
The decoder is a port of the H264Decoder there. The host
logic (slice decode, DPB, POC, reference lists, output reorder and the
decode-ahead entropy thread) is carried over unchanged; the device seam
is rewritten: P frames the tensor path can express run through
decode_step.decode_p_step on the decoder's device (the CUDA kernels on
a card, their plain versions on the CPU), every other frame through the
native host reconstruction. There are no shape buckets: PyTorch runs
eagerly, so nothing is padded to avoid recompiles. One repair of the
JAX decoder: a frame is stamped as it leaves the decoder, with the least
pts of the pictures decoded and not yet output (the HEVC decoder's
rule), so a raw stream's decode-order packet pts 0, 1, 2, ... come out
0, 1, 2, ... in display order where the JAX decoder gives each frame
its own packet's pts (0, 2, 1, 4, 3 on B frames); display-order pts
(MP4 ctts, MPEG-TS PES pts) come out as they were.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from librempeg_tpu_torch.codecs.api import (
    CodecInfo,
    Decoder,
    Encoder,
    register_decoder,
    register_encoder,
)
from librempeg_tpu_torch.codecs.h264 import intra as I
from librempeg_tpu_torch.codecs.h264.parse import (
    NalUnit,
    parse_pps,
    parse_slice_header,
    parse_sps,
    split_annexb,
)
from librempeg_tpu_torch.core.errors import InvalidData, Unsupported
from librempeg_tpu_torch.core.frame import VideoFrame
from librempeg_tpu_torch.core.options import Option, OptionTable
from librempeg_tpu_torch.core.packet import Packet, PktFlags
from librempeg_tpu_torch.core.rational import NOPTS, Rational
from librempeg_tpu_torch.device import resolve
from librempeg_tpu_torch.ops.conceal import conceal_blocks

# frames with more intra MBs than this (IDR refreshes) take the host
# path -- the sequential intra pass stops paying off
_INTRA_CAP_MAX = 1024


@register_encoder
class H264Encoder(Encoder):
    """Baseline-profile encoder: IDR I_16x16 frames + P frames
    (P_L0_16x16 / P_SKIP / intra-in-P) with full-search + quarter-pel
    motion estimation, CAVLC, in-loop deblocking. The reconstruction
    loop shares the decoder's integer primitives, so encoder recon ==
    decoder output == reference-decoder output (asserted in tests)."""

    INFO = CodecInfo(name="h264", long_name="H.264 / AVC",
                     codec_type="video")
    OPTIONS = OptionTable(
        Option("qp", int, 26, min=0, max=51),
        Option("g", int, 12, min=1, max=300,
               help="GOP size (IDR interval)"),
        Option("sr", int, 8, min=1, max=16, help="ME search range (pels)"),
        Option("bf", int, 0, min=0, max=4,
               help="B frames between references (-bf analog; "
                    "non-reference B_16x16/B_Bi prediction)"),
        Option("variety", int, 0, min=0, max=1,
               help="cycle all partition/intra shapes (conformance "
                    "torture streams)"),
        Option("pcm", int, 1, min=0, max=1,
               help="allow I_PCM macroblocks in variety streams "
                    "(lossless escape; CABAC recode cannot carry them)"),
        Option("cabac", int, 0, min=0, max=1,
               help="CABAC entropy coding (-coder 1 analog): the CAVLC "
                    "frame is entropy-recoded through the native CABAC "
                    "engine"),
    )

    def __init__(self, width=0, height=0, pix_fmt="yuv420p",
                 framerate: Rational = Rational(25, 1), device=None,
                 **opts):
        # a host encoder: `device` is where the frames come from, and
        # each plane is fetched once per frame (encode)
        super().__init__(**opts)
        if width % 2 or height % 2:
            raise Unsupported("h264: 4:2:0 dimensions must be even "
                              "(SPS crop units are 2 luma samples)")
        self.width, self.height = width, height
        # coded size is the next MB multiple; the SPS crops back
        self._cw = (width + 15) // 16 * 16
        self._ch = (height + 15) // 16 * 16
        self.framerate = framerate
        self.time_base = Rational(framerate.den, framerate.num)
        self._idx = 0
        self._next_pts = 0
        self._ref = None          # deblocked recon of last ref frame
        self._frame_num = 0
        self._etc = None          # CABAC entropy recoder (coder=cabac)
        self._gop_start = 0       # display idx of the current IDR
        self._pending = []        # buffered (planes, disp_idx, pts) for B
        self._pts_hist = []       # display pts by display index
        self._coded = 0           # packets emitted (coding order)

    def codec_parameters(self):
        from librempeg_tpu_torch.formats.api import CodecParameters

        extradata = self._headers()
        if self.opts["cabac"]:
            from librempeg_tpu_torch.codecs.h264.entropy_transcode import (
                EntropyTranscoder,
            )

            extradata = EntropyTranscoder().feed(extradata)
        return CodecParameters(
            codec_type="video", codec_id="h264",
            width=self.width, height=self.height, pix_fmt="yuv420p",
            framerate=self.framerate, extradata=extradata)

    def _headers(self) -> bytes:
        reorder = 1 if self.opts["bf"] else 0
        return I.build_sps(self._cw // 16, self._ch // 16,
                           reorder=reorder,
                           crop_r=self._cw - self.width,
                           crop_b=self._ch - self.height) + I.build_pps()

    def _mk_packet(self, data: bytes, pts, is_idr: bool) -> Packet:
        """dts: with B frames the k-th coded packet gets the (k-1)-th
        display pts (1-frame reorder delay; dts <= pts, monotonic)."""
        if self.opts["bf"]:
            k = self._coded
            dts = self._pts_hist[k - 1] if k >= 1 \
                else self._pts_hist[0] - 1
        else:
            dts = pts
        self._coded += 1
        if self.opts["cabac"]:
            if self._etc is None:
                from librempeg_tpu_torch.codecs.h264.entropy_transcode import (
                    EntropyTranscoder,
                )

                self._etc = EntropyTranscoder()
            data = self._etc.feed(data)
        return Packet(data=data, pts=pts, dts=dts, duration=1,
                      flags=PktFlags.KEY if is_idr else 0,
                      time_base=self.time_base)

    def _code_ref(self, y, u, v, disp, pts, is_idr: bool) -> Packet:
        """Encode a reference frame (IDR I or P), update the recon ref."""
        from librempeg_tpu_torch.codecs.h264.inter_enc import FrameEncoder
        from librempeg_tpu_torch.native import build as native

        mb_w, mb_h = self._cw // 16, self._ch // 16
        fe = FrameEncoder(mb_w, mb_h, self.opts["qp"],
                          search_range=self.opts["sr"],
                          variety=bool(self.opts["variety"]),
                          variety_pcm=bool(self.opts["pcm"])
                          and not self.opts["cabac"])
        data = b""
        if is_idr:
            if self._coded == 0:
                data += self._headers()
            self._gop_start = disp
            self._frame_num = 0
            nal, recon = fe.encode(y, u, v, None, 0, idr_pic_id=disp,
                                   poc_lsb=0)
        else:
            poc = 2 * (disp - self._gop_start)
            nal, recon = fe.encode(y, u, v, self._ref, self._frame_num,
                                   poc_lsb=poc)
        data += nal
        # in-loop deblock of the recon -> reference for later frames
        dy = np.ascontiguousarray(recon[0])
        du = np.ascontiguousarray(recon[1])
        dv = np.ascontiguousarray(recon[2])
        native.h264_deblock_frame(dy, du, dv, fe.kind, fe.qp_arr,
                                  fe.mv_arr, fe.ref_arr, fe.ncoef,
                                  mb_w, mb_h)
        self._ref = (dy, du, dv)
        self._frame_num = (self._frame_num + 1) % 16
        return self._mk_packet(data, pts, is_idr)

    def _code_b(self, y, u, v, disp, pts, ref0, ref1) -> Packet:
        """Encode a non-reference B frame between two decoded refs."""
        from librempeg_tpu_torch.codecs.h264.inter_enc import BFrameEncoder

        mb_w, mb_h = self._cw // 16, self._ch // 16
        fe = BFrameEncoder(mb_w, mb_h, self.opts["qp"],
                           search_range=self.opts["sr"])
        poc = 2 * (disp - self._gop_start)
        nal = fe.encode_b(y, u, v, ref0, ref1, self._frame_num, poc)
        return self._mk_packet(nal, pts, False)

    def encode(self, frame: VideoFrame):
        if frame.format not in ("yuv420p", "yuvj420p"):
            raise Unsupported("h264: input must be yuv420p")
        y, u, v = frame.to_host().planes
        if self._cw != self.width or self._ch != self.height:
            py, px = self._ch - self.height, self._cw - self.width
            y = np.pad(y, ((0, py), (0, px)), mode="edge")
            u = np.pad(u, ((0, py // 2), (0, px // 2)), mode="edge")
            v = np.pad(v, ((0, py // 2), (0, px // 2)), mode="edge")
        disp = self._idx
        self._idx += 1
        pts = frame.pts if frame.pts != NOPTS else self._next_pts
        self._next_pts = pts + 1
        self._pts_hist.append(pts)
        is_idr = disp % self.opts["g"] == 0
        bf = self.opts["bf"]
        if not bf:
            return [self._code_ref(y, u, v, disp, pts, is_idr)]

        pkts = []
        if is_idr:
            # close the GOP: trailing buffered frames become P refs
            for (py_, pu_, pv_), pd, ppts in self._pending:
                pkts.append(self._code_ref(py_, pu_, pv_, pd, ppts,
                                           False))
            self._pending.clear()
            pkts.append(self._code_ref(y, u, v, disp, pts, True))
        elif len(self._pending) >= bf:
            ref0 = self._ref
            pkts.append(self._code_ref(y, u, v, disp, pts, False))
            ref1 = self._ref
            for (by_, bu_, bv_), bd, bpts in self._pending:
                pkts.append(self._code_b(by_, bu_, bv_, bd, bpts,
                                         ref0, ref1))
            self._pending.clear()
        else:
            self._pending.append(((y, u, v), disp, pts))
        return pkts

    def flush(self):
        """Drain buffered frames at EOF as a trailing P chain."""
        pkts = [self._code_ref(py_, pu_, pv_, pd, ppts, False)
                for (py_, pu_, pv_), pd, ppts in self._pending]
        self._pending.clear()
        return pkts


class _DecodeAhead:
    """Decode-side entropy front end (the r1-promised decode_batch
    analog of the reference's frame-threading submit_packet,
    pthread_frame.c:490): a worker thread runs slice-header parsing,
    native CAVLC/CABAC entropy decode and the sparse-coefficient scan
    for queued packets strictly in order, overlapping the serial host
    entropy of packet n+k with device reconstruction of packet n.
    The native calls go through ctypes, which releases the GIL, so the
    overlap is real on a single-core host.  Results are consumed in
    submission order by the main thread, which keeps all DPB/POC/ref
    bookkeeping single-threaded."""

    def __init__(self, opts, sps, pps, depth: int):
        import queue
        import threading

        self.depth = depth
        self.inflight = 0              # main-thread view only
        self._sps, self._pps = sps, pps    # worker-local parse state
        self._conceal = opts["err_detect"] != "explode"
        self._sp_bufn = 1 << 17
        self._in: "queue.Queue" = queue.Queue()
        self._out: "queue.Queue" = queue.Queue()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def submit(self, pkt) -> None:
        self.inflight += 1
        self._in.put(pkt)

    def close(self) -> None:
        """Stop the worker (it exits on the None sentinel) and join, so
        long-running multi-transcode processes don't accumulate daemon
        threads (one per decoder instance)."""
        self._in.put(None)
        self._t.join(timeout=5.0)

    def next_result(self):
        self.inflight -= 1
        pkt, items, err = self._out.get()
        if err is not None:
            raise err
        return pkt, items

    def _run(self) -> None:
        while True:
            pkt = self._in.get()
            if pkt is None:
                return
            items: list = []
            err = None
            try:
                for raw in split_annexb(bytes(pkt.data)):
                    nal = NalUnit.parse(raw)
                    pre = None
                    if nal.type == 7:
                        self._sps = parse_sps(nal.rbsp)
                    elif nal.type == 8:
                        self._pps = parse_pps(nal.rbsp, self._sps)
                    elif nal.type in (1, 5) and self._sps is not None \
                            and self._pps is not None:
                        pre = self._entropy(nal)
                    items.append((nal, pre))
            except Exception as e:  # noqa: BLE001 — re-raised in order
                err = e
            self._out.put((pkt, items, err))

    def _entropy(self, nal):
        from librempeg_tpu_torch.native import build as native

        sps, pps = self._sps, self._pps
        sh = parse_slice_header(nal.rbsp, sps, pps, nal.type,
                                nal.ref_idc)
        if sh.slice_type not in ("I", "P", "B"):
            return (sh, None)
        mb_w = sps.pic_width_in_mbs
        mb_h = sps.pic_height_in_map_units
        st_code = {"P": 0, "B": 1, "I": 2}[sh.slice_type]
        if pps.entropy_coding_mode:
            res = native.h264_decode_slice_cabac(
                nal.rbsp, sh.data_bit_pos, mb_w, mb_h, sh.first_mb,
                st_code, sh.qp, sh.num_ref_idx_l0, sh.cabac_init_idc,
                sh.num_ref_idx_l1,
                transform_8x8_mode=pps.transform_8x8_mode,
                partial=self._conceal)
        else:
            res = native.h264_decode_slice_cavlc(
                nal.rbsp, sh.data_bit_pos, mb_w, mb_h, sh.first_mb,
                st_code, sh.qp, sh.num_ref_idx_l0, sh.num_ref_idx_l1,
                transform_8x8_mode=pps.transform_8x8_mode,
                partial=self._conceal)
        # sparse scan off the critical path too (single-slice frames
        # only: multi-slice merges invalidate per-slice sparsity)
        if sh.first_mb == 0 and res["last_mb"] == mb_w * mb_h:
            while True:
                nzi = np.empty(self._sp_bufn, np.int32)
                nzv = np.empty(self._sp_bufn, np.int16)
                k = native.h264_sparse_coeffs(res["coeffs"],
                                              res["ncoef"], nzi, nzv)
                if k >= 0:
                    break
                self._sp_bufn *= 4
            res["_sparse"] = (k, nzi, nzv)
        return (sh, res)


@register_decoder
class H264Decoder(Decoder):
    """Baseline-profile decoder: I (I_4x4 / I_16x16) + P slices (all
    partition shapes incl. sub-8x8, P_SKIP, multi-ref), CAVLC, quarter-pel
    MC, in-loop deblocking. Entropy runs in native/h264.cpp (serial host
    work); pixel reconstruction is array-at-a-time (codecs/h264/recon.py).

    Behavioral parity target: libavcodec/h264dec.c for
    this feature set (validated bit-exact in tests via cross-decode).
    """

    INFO = CodecInfo(name="h264", long_name="H.264 / AVC",
                     codec_type="video")
    OPTIONS = OptionTable(
        Option("err_detect", str, "conceal",
               help="bitstream-error policy: 'conceal' repairs damaged "
                    "regions and keeps decoding (error_resilience.c "
                    "role), 'explode' raises on the first error"),
        Option("prefetch", int, -1, min=-1, max=8,
               help="decode-ahead depth: entropy of packet n+k runs in "
                    "a worker thread while packet n reconstructs on "
                    "device (pthread_frame.c analog); -1 = auto (2 on "
                    "CUDA, 0 on CPU)"),
    )

    def __init__(self, params=None, device="cuda", **opts):
        self.device = resolve(device)
        self.sps = None
        self.pps = None
        # DPB entries: [frame_num, host_planes|None, host_pack|None,
        #               dev_planes|None, dev_refpack|None, poc, lt_idx],
        # newest first (== RefPicList0 init order for P slices)
        self._dpb = []
        self._cur = None        # in-progress frame slice arrays
        self._poc_state = (0, 0)   # prev ref (msb, lsb), §8.2.1.1
        self._dec_count = 0        # decoded-frame counter (poc fallback)
        self._reorder = []         # output queue [(poc, frame)]
        self._pts = []             # heap: pts of the pending pictures
        self._reorder_depth = 0    # dynamic floor (see _effective_depth)
        self._last_out_poc = None  # highest POC already emitted this GOP
        self._seen_b_slices = False
        self._max_lt_idx = -1       # MaxLongTermFrameIdx (-1 = none)
        self._qmul = None           # cached (qmul4, qmul8) per PPS
        super().__init__(params, **opts)
        self._da = None             # decode-ahead worker (lazy)
        self._da_resolved = False

    def configure(self, params):
        if params.extradata and params.extradata[:1] == b"\x00":
            for nal in split_annexb(bytes(params.extradata)):
                self._handle_nal(NalUnit.parse(nal))

    def _handle_nal(self, nal: NalUnit):
        if nal.type == 7:
            self.sps = parse_sps(nal.rbsp)
        elif nal.type == 8:
            self.pps = parse_pps(nal.rbsp, self.sps)
            self._qmul = None

    def _da_active(self):
        """Lazily start the decode-ahead worker (needs SPS/PPS from
        configure() so the worker's parse state starts in sync)."""
        if not self._da_resolved:
            self._da_resolved = True
            from librempeg_tpu_torch.native import build as native

            depth = self.opts["prefetch"]
            if depth < 0:
                depth = 2 if self.device.type == "cuda" else 0
            if depth > 0 and native.available():
                self._da = _DecodeAhead(self.opts, self.sps, self.pps,
                                        depth)
        return self._da

    def decode(self, pkt: Packet):
        da = self._da_active()
        if da is not None:
            da.submit(pkt)
            frames = []
            while da.inflight > da.depth:
                frames.extend(self._consume(*da.next_result()))
            return frames
        items = [(NalUnit.parse(raw), None)
                 for raw in split_annexb(bytes(pkt.data))]
        return self._consume(pkt, items)

    def _consume(self, pkt: Packet, items):
        frames = []
        for nal, pre in items:
            if nal.type in (7, 8):
                self._handle_nal(nal)
            elif nal.type in (1, 5):
                if nal.type == 5 and self._cur is None:
                    frames.extend(self._drain_reorder())
                r = self._decode_slice(nal, pkt, pre=pre)
                if r is not None:
                    f, poc = r
                    if (self._last_out_poc is not None
                            and poc < self._last_out_poc):
                        # a frame that should precede already-emitted
                        # output arrived: the declared reorder window is
                        # too small (third-party stream without VUI
                        # bitstream_restriction) -- grow it so further
                        # frames come out in display order, like the
                        # reference's has_b_frames re-estimation
                        self._reorder_depth += 1
                    if f.pts != NOPTS:
                        heapq.heappush(self._pts, f.pts)
                    self._reorder.append((poc, f))
                    self._reorder.sort(key=lambda t: t[0])
                    maxr = self._effective_depth()
                    while len(self._reorder) > maxr:
                        poc0, f0 = self._reorder.pop(0)
                        self._last_out_poc = poc0
                        frames.append(self._output(f0))
        return frames

    def _output(self, frame):
        """`frame` as it leaves the decoder: stamped with the least
        pending pts."""
        if frame.pts != NOPTS:
            frame = frame.replace(pts=heapq.heappop(self._pts))
        return frame

    def _effective_depth(self) -> int:
        """Output reorder window.

        The VUI bitstream_restriction depth when the stream declares
        one; otherwise a conservative default for streams that can
        carry B slices (reference h264_ps.c: absent restriction =>
        sps->num_reorder_frames defaults from the DPB bound, surfaced
        as has_b_frames), further grown dynamically whenever an
        out-of-order POC is actually observed.
        """
        if self.sps is None:
            return 0
        if self.sps.bitstream_restriction:
            base = self.sps.num_reorder_frames
        elif self._seen_b_slices:
            base = max(1, min(self.sps.max_num_ref_frames, 16))
        else:
            base = 0
        return max(base, self._reorder_depth)

    def drain(self):
        """The frames of every packet submitted so far, the stream kept
        open: the decode-ahead queue is emptied and its worker keeps
        running. Frames held for display reordering stay held. A
        checkpoint calls this so that its snapshot covers every packet
        the demuxer has given out."""
        frames = []
        if self._da is not None:
            while self._da.inflight > 0:
                frames.extend(self._consume(*self._da.next_result()))
        return frames

    def flush(self):
        frames = []
        if self._da is not None:
            while self._da.inflight > 0:
                frames.extend(self._consume(*self._da.next_result()))
            self._da.close()           # flush is terminal: reap worker
            self._da = None
            self._da_resolved = False  # a reused decoder restarts it
        frames.extend(self._drain_reorder())
        return frames

    def close(self) -> None:
        if self._da is not None:
            self._da.close()
            self._da = None
            self._da_resolved = False

    def _drain_reorder(self):
        out = [self._output(f)
               for _, f in sorted(self._reorder, key=lambda t: t[0])]
        self._reorder.clear()
        self._last_out_poc = None   # POC restarts at the IDR boundary
        return out

    def _conceal_damaged(self, res, sh, have_refs: bool) -> None:
        """Fill never-decoded MBs (kind < 0) so reconstruction covers
        the whole frame: with references, a zero-MV co-located copy
        (the guess_mv class of error_resilience.c:1369); intra-only
        frames get a spatial fill after recon (ops/conceal.py)."""
        und = res["kind"] < 0
        n = int(und.sum())
        if not n:
            return
        import sys

        print(f"h264: concealing {n} damaged macroblocks",
              file=sys.stderr)
        res.pop("_sparse", None)          # concealment edits invalidate
        res["coeffs"][und] = 0
        res["ncoef"][und] = 0
        res["info"][und] = 2              # imode16 = DC
        res["qp"][und] = sh.qp
        if have_refs:
            res["kind"][und] = 0          # P_SKIP: co-located copy
            res["ref"][und] = 0
            res["mv"][und] = 0
            if "ref1" in res:
                res["ref1"][und] = -1
        else:
            # intra frame: reconstruct what decoded, then diffuse into
            # the damaged blocks from valid neighbors
            res["kind"][und] = 3          # I_16x16 DC placeholder
            res["i4modes"][und] = 0
            res["_spatial_conceal"] = und.copy()

    def _qmul_tables(self):
        """ff-form dequant multiplier tables for the active PPS
        (h264_ps.c:596-647): qmul4 [6][52][16], qmul8 [2][52][64],
        raster positions; (None, None) for flat-16 streams."""
        if self._qmul is None:
            if self.pps.scaling_matrix4 is None:
                self._qmul = (None, None)
            else:
                from librempeg_tpu_torch.codecs.h264 import high_tables as HT

                qp = np.arange(52)
                cls4 = (np.arange(16) & 1) + ((np.arange(16) >> 2) & 1)
                i4 = np.array(HT.DEQUANT4_INIT)[qp % 6][:, cls4]
                m4 = np.array(self.pps.scaling_matrix4)     # [6][16]
                q4 = (m4[:, None, :] * i4[None])
                q4 = (q4 << (qp // 6 + 2)[None, :, None]).astype(np.int32)
                r8, c8 = np.arange(64) >> 3, np.arange(64) & 7
                cls8 = np.array(HT.DEQUANT8_CLASS_SCAN)[
                    4 * (r8 & 3) + (c8 & 3)]
                i8 = np.array(HT.DEQUANT8_INIT)[qp % 6][:, cls8]
                m8 = np.array(self.pps.scaling_matrix8)     # [2][64]
                q8 = (m8[:, None, :] * i8[None])
                q8 = (q8 << (qp // 6)[None, :, None]).astype(np.int32)
                self._qmul = (q4, q8)
        return self._qmul

    def _pic_num(self, ent, cur_fn: int) -> int:
        """Short-term PicNum (§8.2.4.1): FrameNumWrap for frame coding."""
        max_fn = 1 << self.sps.log2_max_frame_num
        fn = ent[0]
        return fn - max_fn if fn > cur_fn else fn

    def _init_ref_lists(self, sh, poc: int, is_b: bool):
        """RefPicList initialization (§8.2.4.2) + modification
        (§8.2.4.3). DPB entries are [frame_num, ..., poc, lt_idx]."""
        st = [e for e in self._dpb if e[6] is None]
        lt = sorted((e for e in self._dpb if e[6] is not None),
                    key=lambda e: e[6])
        if not is_b:
            l0 = sorted(st, key=lambda e: -self._pic_num(e, sh.frame_num))
            l0 += lt
            lists = [l0, None]
        else:
            past = sorted((e for e in st if e[5] <= poc),
                          key=lambda e: -e[5])
            futr = sorted((e for e in st if e[5] > poc),
                          key=lambda e: e[5])
            l0, l1 = past + futr + lt, futr + past + lt
            # §8.2.4.2.4: if l1 == l0 with >1 entries, swap its first two
            if len(l1) > 1 and l1 == l0:
                l1 = [l1[1], l1[0]] + l1[2:]
            lists = [l0, l1]
        max_pn = 1 << self.sps.log2_max_frame_num
        for li, mods in enumerate(sh.ref_list_mods):
            if not mods or lists[li] is None:
                continue
            num = sh.num_ref_idx_l0 if li == 0 else sh.num_ref_idx_l1
            cur = list(lists[li])[:num]
            while len(cur) < num and lists[li]:
                cur.append(lists[li][-1])     # padding, never referenced
            pred = sh.frame_num
            idx = 0
            for idc, val in mods:
                if idc in (0, 1):
                    ad = val + 1
                    nowrap = pred - ad if idc == 0 else pred + ad
                    if idc == 0 and nowrap < 0:
                        nowrap += max_pn
                    if idc == 1 and nowrap >= max_pn:
                        nowrap -= max_pn
                    pred = nowrap
                    pn = nowrap - max_pn if nowrap > sh.frame_num \
                        else nowrap
                    pic = next((e for e in st
                                if self._pic_num(e, sh.frame_num) == pn),
                               None)
                else:
                    pic = next((e for e in lt if e[6] == val), None)
                if pic is None:
                    raise InvalidData("h264: ref list mod target absent")
                # §8.2.4.3.1 shuffle: insert at idx, drop a later dup
                cur.insert(idx, pic)
                for j in range(idx + 1, len(cur)):
                    if cur[j] is pic:
                        del cur[j]
                        break
                cur = cur[:num]
                idx += 1
            lists[li] = cur
        return lists[0], lists[1]

    def _mark_references(self, sh, nal) -> None:
        """dec_ref_pic_marking (§8.2.5): MMCO ops or sliding window.
        Runs BEFORE the current frame is inserted; op 6 / IDR long-term
        is applied by the caller at insert time."""
        if not sh.mmco:
            # sliding window (§8.2.5.3): only short-term entries count
            st = [e for e in self._dpb if e[6] is None]
            lt_n = len(self._dpb) - len(st)
            cap = max(1, self.sps.max_num_ref_frames - lt_n)
            if len(st) >= cap:
                st.sort(key=lambda e: self._pic_num(e, sh.frame_num))
                for e in st[:len(st) - cap + 1]:
                    self._dpb.remove(e)
            return
        for op, v1, v2 in sh.mmco:
            if op == 1:
                pn = sh.frame_num - (v1 + 1)
                for e in list(self._dpb):
                    if e[6] is None and \
                            self._pic_num(e, sh.frame_num) == pn:
                        self._dpb.remove(e)
                        break
            elif op == 2:
                for e in list(self._dpb):
                    if e[6] == v1:
                        self._dpb.remove(e)
                        break
            elif op == 3:
                pn = sh.frame_num - (v1 + 1)
                for e in list(self._dpb):
                    if e[6] == v2:
                        self._dpb.remove(e)
                for e in self._dpb:
                    if e[6] is None and \
                            self._pic_num(e, sh.frame_num) == pn:
                        e[6] = v2
                        break
            elif op == 4:
                self._max_lt_idx = v1 - 1
                for e in list(self._dpb):
                    if e[6] is not None and e[6] > self._max_lt_idx:
                        self._dpb.remove(e)
            elif op == 5:
                self._dpb.clear()
                self._max_lt_idx = -1
            # op 6 handled at insert

    def _pred_weight_tables(self, sh):
        """(weights, impw) for the native recon: explicit weights as
        (luma_ld, chroma_ld, int32 [2][32][6]), or the implicit-bipred
        (w0, 64-w0) table per (ref0, ref1) (h264_slice.c
        implicit_weight_table)."""
        if sh.pred_weights is not None:
            lld, cld, lists = sh.pred_weights
            wpx = np.zeros((2, 32, 6), np.int32)
            wpx[:, :, 0] = 1 << lld
            wpx[:, :, 2] = 1 << cld
            wpx[:, :, 4] = 1 << cld
            for li, ws in enumerate(lists):
                for ri, w in enumerate(ws[:32]):
                    wpx[li, ri] = w
            return (lld, cld, wpx), None
        return None, None

    def _implicit_weights(self, l0, l1, poc: int):
        """Implicit bi-prediction weights (§8.4.2.3.1 frame coding)."""
        if len(l0) == 1 and len(l1) == 1 and \
                l0[0][5] + l1[0][5] == 2 * poc:
            return None                       # unweighted early-out
        impw = np.full((32, 32, 2), 32, np.int16)
        clip8 = lambda v: max(-128, min(127, v))
        for i0, e0 in enumerate(l0[:32]):
            for i1, e1 in enumerate(l1[:32]):
                if e0[6] is not None or e1[6] is not None:
                    continue                  # long-term: 32/32
                td = clip8(e1[5] - e0[5])
                if not td:
                    continue
                tb = clip8(poc - e0[5])
                tx = (16384 + (abs(td) >> 1)) // td if td > 0 else \
                    -((16384 + (abs(td) >> 1)) // -td)
                dsf = (tb * tx + 32) >> 8
                if -64 <= dsf <= 128:
                    w0 = 64 - dsf
                    impw[i0, i1] = (w0, 64 - w0)
        return impw

    def _compute_poc(self, sh, nal) -> int:
        """Picture order count (display order key), §8.2.1."""
        if self.sps.pic_order_cnt_type != 0:
            # type 1/2: coding order == display order for the streams
            # this decoder accepts (no B reorder without type 0)
            return 2 * self._dec_count
        max_lsb = 1 << self.sps.log2_max_poc_lsb
        prev_msb, prev_lsb = (0, 0) if sh.idr else self._poc_state
        lsb = sh.poc_lsb
        if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
            msb = prev_msb + max_lsb
        elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
            msb = prev_msb - max_lsb
        else:
            msb = prev_msb
        if nal.ref_idc:
            self._poc_state = (msb, lsb)
        return msb + lsb

    def _decode_slice(self, nal: NalUnit, pkt: Packet, pre=None):
        from librempeg_tpu_torch.codecs.h264 import recon as R
        from librempeg_tpu_torch.native import build as native
        from librempeg_tpu_torch.utils.stagetimer import stage

        if self.sps is None or self.pps is None:
            raise InvalidData("h264: slice before SPS/PPS")
        if not native.available():
            raise Unsupported("h264: native extension required")
        sh = pre[0] if pre is not None else \
            parse_slice_header(nal.rbsp, self.sps, self.pps, nal.type,
                               nal.ref_idc)
        if sh.slice_type not in ("I", "P", "B"):
            raise Unsupported(f"h264: {sh.slice_type} slices")
        if self.pps.constrained_intra_pred:
            raise Unsupported("h264: constrained intra prediction")
        is_b = sh.slice_type == "B"
        if is_b:
            self._seen_b_slices = True

        mb_w = self.sps.pic_width_in_mbs
        mb_h = self.sps.pic_height_in_map_units
        nmb = mb_w * mb_h
        if sh.idr:
            self._dpb.clear()
        st_code = {"P": 0, "B": 1, "I": 2}[sh.slice_type]
        conceal = self.opts["err_detect"] != "explode"
        if pre is not None and pre[1] is not None:
            res = pre[1]
        else:
            with stage("h264.entropy"):
                if self.pps.entropy_coding_mode:
                    res = native.h264_decode_slice_cabac(
                        nal.rbsp, sh.data_bit_pos, mb_w, mb_h,
                        sh.first_mb, st_code, sh.qp,
                        sh.num_ref_idx_l0, sh.cabac_init_idc,
                        sh.num_ref_idx_l1,
                        transform_8x8_mode=self.pps.transform_8x8_mode,
                        partial=conceal)
                else:
                    res = native.h264_decode_slice_cavlc(
                        nal.rbsp, sh.data_bit_pos, mb_w, mb_h,
                        sh.first_mb, st_code, sh.qp,
                        sh.num_ref_idx_l0, sh.num_ref_idx_l1,
                        transform_8x8_mode=self.pps.transform_8x8_mode,
                        partial=conceal)

        # accumulate slices into the current frame. slice_id feeds the
        # §6.4.9 neighbor-availability rule (intra prediction must not
        # cross slice boundaries); each slice's ref lists and weight
        # table may differ, so per-slice lists are REMAPPED onto a
        # frame-global reference list as they arrive, and the per-slice
        # weight tables are stacked for the native recon.
        if sh.first_mb == 0 or self._cur is None:
            self._cur = res
            self._cur_meta = sh
            res["slice_id"] = np.zeros(nmb, np.int32)
            self._slice_no = 0
            self._cur_poc = self._compute_poc(sh, nal)
            self._cur_l0, self._cur_l1 = [], []
            self._cur_w = []
            merge = False
        else:
            self._slice_no += 1
            merge = True
        poc = self._cur_poc
        l0s, l1s = self._init_ref_lists(sh, poc, is_b)
        if is_b and (not l0s or not l1s):
            raise InvalidData("h264: B slice without both temporal "
                              "directions in DPB")
        # remap this slice's local ref indices onto the global lists
        for lst, glob, key in ((l0s, self._cur_l0, "ref"),
                               (l1s if is_b else None, self._cur_l1,
                                "ref1")):
            if lst is None:
                continue
            lut = np.zeros(max(len(lst), 1), np.int8)
            for i, e in enumerate(lst):
                for gi, ge in enumerate(glob):
                    if ge is e:
                        lut[i] = gi
                        break
                else:
                    glob.append(e)
                    lut[i] = len(glob) - 1
            rr = res[key]
            sel = rr >= 0
            if np.any(sel):
                rr[sel] = lut[rr[sel]]
        # this slice's weight mode (0 none / 1 explicit / 2 implicit)
        sw, _ = self._pred_weight_tables(sh)
        if sw is not None:
            self._cur_w.append((1, sw[0], sw[1], sw[2]))
        elif is_b and self.pps.weighted_bipred_idc == 2 and \
                not (sh.num_ref_idx_l0 == 1 and sh.num_ref_idx_l1 == 1
                     and l0s[0][5] + l1s[0][5] == 2 * poc):
            self._cur_w.append((2, 5, 5, None))
        else:
            self._cur_w.append((0, 0, 0, None))
        if merge:
            done = res["kind"] >= 0
            for k in ("kind", "info", "i4modes", "mv", "ref", "qp",
                      "coeffs", "ncoef", "mv1", "ref1"):
                self._cur[k][done] = res[k][done]
            self._cur["slice_id"][done] = self._slice_no
            self._cur.pop("_sparse", None)   # merged: rescan needed
        had_error = bool(res.get("error")) or \
            bool(self._cur.get("error"))
        if had_error:
            self._cur["error"] = 1
        if res["last_mb"] < nmb and not had_error:
            return None                       # frame incomplete, more slices

        res = self._cur
        if had_error:
            self._conceal_damaged(res, sh, bool(l0s))
        self._cur = None
        self._dec_count += 1
        do_deblock = (not self.pps.deblocking_filter_control_present
                      or sh.disable_deblock != 1)
        cqo = self.pps.chroma_qp_index_offset
        cqo2 = self.pps.second_chroma_qp_index_offset
        if cqo2 is None:
            cqo2 = cqo
        qmul4, qmul8 = self._qmul_tables()
        l0, l1 = self._cur_l0, (self._cur_l1 if is_b else None)
        # stack per-slice weight tables for the native recon
        weights = impw = None
        if any(m for m, *_ in self._cur_w):
            nsl = len(self._cur_w)
            wmode = np.zeros(nsl, np.int32)
            wld = np.zeros((nsl, 2), np.int32)
            wpx = np.zeros((nsl, 2, 32, 6), np.int32)
            for i, (m, lld, cld, w) in enumerate(self._cur_w):
                wmode[i] = m
                wld[i] = (lld, cld)
                if w is not None:
                    wpx[i] = w
            weights = (wmode, wld, wpx)
            if np.any(wmode == 2):
                impw = self._implicit_weights(l0, l1, poc)
                if impw is None:
                    impw = np.full((32, 32, 2), 32, np.int16)
        has_t8 = bool(np.any(res["info"]
                             & (1 << 14)))    # INFO_T8 (native/h264.cpp)
        n_intra = int(np.count_nonzero(res["kind"] >= 2))
        # every P frame the tensor path can express goes through it, on
        # any device; the rest (I/B frames, I_PCM/I_8x8, weighted
        # prediction, scaling lists, ...) takes the native host path
        dev_ok = (not is_b and l0
                  and n_intra <= _INTRA_CAP_MAX
                  and not np.any(res["kind"] >= 4)  # I_PCM/I_8x8: host
                  and not has_t8 and weights is None
                  and qmul4 is None and cqo2 == cqo
                  and not (self._slice_no and n_intra)
                  and not had_error)
        if dev_ok:
            with stage("h264.device"):
                y, u, v, pack = self._decode_device(
                    res, mb_w, mb_h, sh, do_deblock, l0,
                    make_ref=bool(nal.ref_idc))
            if nal.ref_idc:
                self._mark_references(sh, nal)
                lt = next((v2 for op, v1, v2 in sh.mmco if op == 6),
                          None)
                self._dpb.insert(0, [sh.frame_num, None, None,
                                     (y, u, v), pack, poc, lt])
        else:
            # host path needs host planes for every reference: device-
            # decoded frames are fetched once (intra frames are rare)
            with stage("h264.host_fetch_refs"):
                for ent in self._dpb:
                    if ent[1] is None:
                        ent[1] = tuple(p.cpu().numpy() for p in ent[3])
                    if ent[2] is None:
                        ent[2] = R.RefPack(*ent[1])
            with stage("h264.host_recon"):
                y, u, v = R.reconstruct_frame_native(
                    res, mb_w, mb_h, cqo,
                    [e[2] for e in l0],
                    [e[2] for e in l1] if is_b else None,
                    qmul4=qmul4, qmul8=qmul8, cqp_off2=cqo2,
                    weights=weights, impw=impw)
            if do_deblock:
                y = np.ascontiguousarray(y)
                u = np.ascontiguousarray(u)
                v = np.ascontiguousarray(v)
                _sdb = stage("h264.host_deblock")
                _sdb.__enter__()
                native.h264_deblock_frame(
                    y, u, v, res["kind"], res["qp"], res["mv"],
                    res["ref"], res["ncoef"], mb_w, mb_h, sh.alpha_off,
                    sh.beta_off, cqo,
                    mv1=res["mv1"] if is_b else None,
                    ref1=res["ref1"] if is_b else None,
                    l0pic=np.asarray([e[5] for e in l0], np.int32)
                    if is_b else None,
                    l1pic=np.asarray([e[5] for e in l1], np.int32)
                    if is_b else None,
                    info=res["info"], cqp_off2=cqo2)
                _sdb.__exit__()
            if nal.ref_idc:
                self._mark_references(sh, nal)
                lt = next((v2 for op, v1, v2 in sh.mmco if op == 6),
                          None)
                self._dpb.insert(0, [sh.frame_num, (y, u, v), None,
                                     None, None, poc, lt])
            # frames leave the decoder as tensors on its device
            y, u, v = (torch.from_numpy(np.ascontiguousarray(p))
                       .to(self.device) for p in (y, u, v))

        mask = res.get("_spatial_conceal")
        if mask is not None and np.any(mask):
            m2 = torch.from_numpy(mask.reshape(mb_h, mb_w)).to(self.device)
            y, u, v = (conceal_blocks(p.to(torch.float32)[None], m2[None],
                                      block_size=bs)[0]
                       .clamp(0, 255).to(torch.uint8)
                       for p, bs in ((y, 16), (u, 8), (v, 8)))

        w, h = self.sps.width, self.sps.height
        tb = pkt.time_base if pkt.time_base.valid and pkt.time_base.num \
            else Rational(1, 25)
        return VideoFrame(planes=(y[:h, :w], u[:h // 2, :w // 2],
                                  v[:h // 2, :w // 2]),
                          format="yuv420p", width=w, height=h,
                          pts=pkt.pts, time_base=tb), poc

    def _decode_device(self, res, mb_w, mb_h, sh, do_deblock, l0,
                       make_ref=False):
        """P frame on the decoder's device: the sparse coefficients and
        the motion field are uploaded, each with its own dtype; the DPB
        refpacks stay on the device. Returns (y, u, v, refpack or
        None)."""
        from librempeg_tpu_torch.codecs.h264 import decode_step as DS
        from librempeg_tpu_torch.codecs.h264 import device_recon as D
        from librempeg_tpu_torch.native import build as native_b
        from librempeg_tpu_torch.utils.stagetimer import stage

        if np.any(res["ref"] >= len(l0)):
            raise InvalidData("h264: ref idx out of range")
        dev = self.device

        def up(a, dtype):
            return torch.from_numpy(
                np.ascontiguousarray(a, dtype=dtype)).to(dev)

        for ent in l0:
            if ent[4] is None:          # host-decoded frame: upload once
                ent[4] = D.make_refpack(*(up(p, np.uint8)
                                          for p in ent[1]))
        # native compact scan (ncoef-pruned)
        sp = res.pop("_sparse", None)        # decode-ahead precomputed
        if sp is not None:
            k, nzi, nzv16 = sp
        else:
            buf_n = getattr(self, "_sp_bufn", 1 << 17)
            with stage("h264.sparse_scan"):
                while True:
                    nzi = np.empty(buf_n, np.int32)
                    nzv16 = np.empty(buf_n, np.int16)
                    k = native_b.h264_sparse_coeffs(res["coeffs"],
                                                    res["ncoef"],
                                                    nzi, nzv16)
                    if k >= 0:
                        break
                    buf_n *= 4
            self._sp_bufn = buf_n
        intra = np.flatnonzero(res["kind"] >= 2)
        if len(l0) == 1:
            luma4, upad, vpad = (p[None] for p in l0[0][4])
        else:
            luma4, upad, vpad = (torch.stack([e[4][i] for e in l0])
                                 for i in range(3))
        with stage("h264.upload"):
            args = (up(nzi[:k], np.int32), up(nzv16[:k], np.int16),
                    up(res["qp"], np.int32), up(res["kind"], np.int32),
                    up(res["info"], np.int32), up(res["i4modes"], np.int8),
                    up(intra, np.int32), up(res["mv"], np.int16),
                    up(res["ref"], np.int8))
        return DS.decode_p_step(
            *args, luma4, upad, vpad, mb_w, mb_h,
            self.pps.chroma_qp_index_offset, sh.alpha_off, sh.beta_off,
            do_deblock, make_ref)
