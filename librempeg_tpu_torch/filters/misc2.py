"""Utility filters: fade/afade, aecho, reverse/areverse, hstack/vstack,
select/aselect, setsar, asetrate, extractplanes, shuffleplanes, concat,
volumedetect, astats, amerge/join, loop/aloop, tpad, settb/asettb,
showinfo/ashowinfo, tile, thumbnail.

Port of librempeg_tpu/filters/misc2.py (vf_fade.c, af_afade.c,
af_aecho.c, f_reverse.c, vf_stack.c, f_select.c, vf_aspect.c,
af_asetrate.c, vf_extractplanes.c, vf_shuffleplanes.c, f_concat.c,
af_volumedetect.c, af_astats.c, af_amerge.c, vf_loop.c, vf_tpad.c,
f_settb.c, vf_showinfo.c, vf_tile.c, vf_thumbnail.c). The sample and
pixel work (fade, afade, aecho, the stacks, tile, the reversals, the
blank frames) is tensor code on the frame's device, in the float32
operations of the JAX package's eager calls and numpy code; the
timestamp logic is host code carried over; the analyzers (volumedetect,
astats, showinfo, ashowinfo, thumbnail's histograms) read the samples on
the host, as the JAX package does.
"""
from __future__ import annotations

import numpy as np
import torch

from librempeg_tpu_torch.codecs.pcm import from_float, to_float
from librempeg_tpu_torch.core.errors import InvalidData
from librempeg_tpu_torch.core.eval_expr import eval_expr
from librempeg_tpu_torch.core.options import Option, OptionTable
from librempeg_tpu_torch.core.rational import NOPTS, Rational
from librempeg_tpu_torch.filters.filter import Filter, PadDesc, register_filter


def _frame_time(frame) -> float:
    if frame.pts == NOPTS:
        return 0.0
    tb = frame.time_base
    return frame.pts * tb.num / tb.den if tb.valid and tb.den else 0.0


def _samples(frame) -> torch.Tensor:
    """The frame's samples as float32 in [-1, 1), on their device."""
    return to_float(torch.as_tensor(frame.data), frame.sample_fmt)


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _blank_like(frame):
    """A black frame of frame's shape (chroma at 128) on its device."""
    planes = []
    for i, p in enumerate(frame.planes):
        p = torch.as_tensor(p)
        fill = 0 if i == 0 or frame.desc.nb_planes == 1 else 128
        planes.append(torch.full(p.shape, fill, dtype=torch.uint8,
                                 device=p.device))
    return frame.replace(planes=tuple(planes))


@register_filter
class FadeFilter(Filter):
    NAME = "fade"
    DESCRIPTION = "Fade the video in or out (vf_fade.c analog)."
    OPT_ORDER = ("type", "start_frame", "nb_frames")
    OPTIONS = OptionTable(
        Option("type", str, "in", alias="t", choices=("in", "out")),
        Option("start_frame", int, 0, alias="s", min=0, max=1 << 30),
        Option("nb_frames", int, 25, alias="n", min=1, max=1 << 30),
        Option("start_time", float, -1.0, alias="st", min=-1.0, max=1e9),
        Option("duration", float, 0.0, alias="d", min=0.0, max=1e9),
    )

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        self._n = 0
        return self.out_props

    def _factor(self, frame) -> float:
        if self.opts["start_time"] >= 0.0 or self.opts["duration"] > 0.0:
            st = max(self.opts["start_time"], 0.0)
            d = self.opts["duration"] or 1.0
            p = (_frame_time(frame) - st) / d
        else:
            p = (self._n - self.opts["start_frame"]) / self.opts["nb_frames"]
        p = min(max(p, 0.0), 1.0)
        return p if self.opts["type"] == "in" else 1.0 - p

    def filter_frame(self, frame, pad=0):
        f = self._factor(frame)
        self._n += 1
        if f >= 1.0:
            return [(0, frame)]
        f32 = float(np.float32(f))
        planes = []
        for i, p in enumerate(frame.planes):
            x = torch.as_tensor(p).to(torch.float32)
            if i == 0 or frame.desc.nb_planes == 1:
                y = x * f32
            else:                          # chroma fades toward neutral
                y = (x - 128.0) * f32 + 128.0
            planes.append(torch.round(y).clamp(0, 255).to(torch.uint8))
        return [(0, frame.replace(planes=tuple(planes)))]


@register_filter
class AFadeFilter(Filter):
    NAME = "afade"
    DESCRIPTION = "Fade the audio in or out (af_afade.c, linear curve)."
    INPUTS = (PadDesc("default", "audio"),)
    OUTPUTS = (PadDesc("default", "audio"),)
    OPT_ORDER = ("type", "start_sample", "nb_samples")
    OPTIONS = OptionTable(
        Option("type", str, "in", alias="t", choices=("in", "out")),
        Option("start_sample", int, 0, alias="ss", min=0, max=1 << 62),
        Option("nb_samples", int, 44100, alias="ns", min=1, max=1 << 62),
        Option("start_time", float, -1.0, alias="st", min=-1.0, max=1e9),
        Option("duration", float, 0.0, alias="d", min=0.0, max=1e9),
    )

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        self._pos = 0
        return self.out_props

    def filter_frame(self, frame, pad=0):
        sr = frame.sample_rate
        if self.opts["start_time"] >= 0.0 or self.opts["duration"] > 0.0:
            s0 = int(max(self.opts["start_time"], 0.0) * sr)
            ns = int((self.opts["duration"] or 1.0) * sr)
        else:
            s0 = self.opts["start_sample"]
            ns = self.opts["nb_samples"]
        x = _samples(frame)
        n = x.shape[1]
        idx = np.arange(self._pos, self._pos + n, dtype=np.float64)
        self._pos += n
        g = np.clip((idx - s0) / ns, 0.0, 1.0)
        if self.opts["type"] == "out":
            g = 1.0 - g
        gain = torch.from_numpy(g.astype(np.float32)).to(x.device)
        return [(0, frame.replace(
            data=from_float(x * gain[None, :], frame.sample_fmt)))]


@register_filter
class AEchoFilter(Filter):
    NAME = "aecho"
    DESCRIPTION = "Add echoing (af_aecho.c analog: delayed taps)."
    INPUTS = (PadDesc("default", "audio"),)
    OUTPUTS = (PadDesc("default", "audio"),)
    OPT_ORDER = ("in_gain", "out_gain", "delays", "decays")
    OPTIONS = OptionTable(
        Option("in_gain", float, 0.6, min=0.0, max=1.0),
        Option("out_gain", float, 0.3, min=0.0, max=1.0),
        Option("delays", str, "1000"),
        Option("decays", str, "0.5"),
    )

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        self._delays = [float(d) for d in
                        str(self.opts["delays"]).split("|")]
        self._decays = [float(d) for d in
                        str(self.opts["decays"]).split("|")]
        if len(self._delays) != len(self._decays):
            raise InvalidData("aecho: delays/decays length mismatch")
        self._hist = None
        return self.out_props

    def filter_frame(self, frame, pad=0):
        sr = frame.sample_rate
        taps = [max(1, int(round(d * sr / 1000.0))) for d in self._delays]
        maxd = max(taps)
        x = _samples(frame)
        c, n = x.shape
        if self._hist is None:
            self._hist = torch.zeros((c, maxd), dtype=torch.float32,
                                     device=x.device)
        buf = torch.cat([self._hist, x], 1)
        # float32 throughout, each operation rounded (numpy's order)
        y = x * float(np.float32(self.opts["in_gain"]))
        for d, g in zip(taps, self._decays):
            y = y + buf[:, maxd - d:maxd - d + n] * float(np.float32(g))
        y = y * float(np.float32(self.opts["out_gain"]
                                 / max(self.opts["in_gain"], 1e-9)))
        self._hist = buf[:, -maxd:]
        return [(0, frame.replace(
            data=from_float(y.clamp(-1.0, 1.0), frame.sample_fmt)))]


class _ReverseBase(Filter):
    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        self._frames = []
        return self.out_props

    def filter_frame(self, frame, pad=0):
        self._frames.append(frame)
        return []

    def flush(self):
        out = []
        pts_list = [f.pts for f in self._frames]
        for f, pts in zip(reversed(self._frames), pts_list):
            out.append((0, self._flip(f).replace(pts=pts)))
        self._frames = []
        return out

    def _flip(self, frame):
        return frame


@register_filter
class ReverseFilter(_ReverseBase):
    NAME = "reverse"
    DESCRIPTION = "Reverse the video (buffers all frames)."


@register_filter
class AReverseFilter(_ReverseBase):
    NAME = "areverse"
    DESCRIPTION = "Reverse the audio (buffers all frames)."
    INPUTS = (PadDesc("default", "audio"),)
    OUTPUTS = (PadDesc("default", "audio"),)

    def _flip(self, frame):
        return frame.replace(data=torch.as_tensor(frame.data).flip(1))


class _StackBase(Filter):
    OPT_ORDER = ("inputs",)
    OPTIONS = OptionTable(Option("inputs", int, 2, min=2, max=16))
    AXIS = 1  # 0 = vertical (rows), 1 = horizontal (cols)

    def __init__(self, args: str = "", **kwargs):
        super().__init__(args, **kwargs)
        n = self.opts["inputs"]
        self.INPUTS = tuple(PadDesc(f"in{i}", "video") for i in range(n))
        self.OUTPUTS = (PadDesc("default", "video"),)

    def configure(self, in_props):
        self.in_props = in_props
        p0 = in_props[0]
        for p in in_props[1:]:
            if p.pix_fmt != p0.pix_fmt:
                raise InvalidData(f"{self.NAME}: pixel formats must match")
            if self.AXIS == 1 and p.height != p0.height:
                raise InvalidData("hstack: heights must match")
            if self.AXIS == 0 and p.width != p0.width:
                raise InvalidData("vstack: widths must match")
        out = p0.copy()
        if self.AXIS == 1:
            out.width = sum(p.width for p in in_props)
        else:
            out.height = sum(p.height for p in in_props)
        self.out_props = [out]
        self._pending = [[] for _ in in_props]
        return self.out_props

    def filter_frame(self, frame, pad=0):
        self._pending[pad].append(frame)
        if not all(self._pending):
            return []
        frames = [q.pop(0) for q in self._pending]
        dev = torch.as_tensor(frames[0].planes[0]).device
        planes = tuple(
            torch.cat([torch.as_tensor(f.planes[i]).to(dev) for f in frames],
                      self.AXIS)
            for i in range(len(frames[0].planes)))
        return [(0, frames[0].replace(
            planes=planes, width=self.out_props[0].width,
            height=self.out_props[0].height))]


@register_filter
class HStackFilter(_StackBase):
    NAME = "hstack"
    DESCRIPTION = "Stack video inputs horizontally."
    AXIS = 1


@register_filter
class VStackFilter(_StackBase):
    NAME = "vstack"
    DESCRIPTION = "Stack video inputs vertically."
    AXIS = 0


class _SelectBase(Filter):
    OPT_ORDER = ("expr",)
    OPTIONS = OptionTable(Option("expr", str, "1", alias="e"))

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        self._n = 0
        self._prev_pts = float("nan")
        return self.out_props

    def filter_frame(self, frame, pad=0):
        t = _frame_time(frame)
        v = {"n": float(self._n), "t": t,
             "pts": float(frame.pts) if frame.pts != NOPTS else float("nan"),
             "prev_pts": self._prev_pts,
             "key": 1.0 if getattr(frame, "key_frame", True) else 0.0}
        self._n += 1
        self._prev_pts = v["pts"]
        keep = eval_expr(str(self.opts["expr"]), v)
        return [(0, frame)] if keep else []


@register_filter
class SelectFilter(_SelectBase):
    NAME = "select"
    DESCRIPTION = "Select video frames to pass in output (f_select.c)."


@register_filter
class ASelectFilter(_SelectBase):
    NAME = "aselect"
    DESCRIPTION = "Select audio frames to pass in output."
    INPUTS = (PadDesc("default", "audio"),)
    OUTPUTS = (PadDesc("default", "audio"),)


@register_filter
class SetSarFilter(Filter):
    NAME = "setsar"
    DESCRIPTION = "Set the sample aspect ratio (vf_aspect.c analog)."
    OPT_ORDER = ("sar",)
    OPTIONS = OptionTable(Option("sar", str, "1", alias="ratio"))

    def configure(self, in_props):
        self.in_props = in_props
        out = in_props[0].copy()
        s = str(self.opts["sar"]).replace(":", "/")
        if "/" in s:
            num, den = s.split("/")
            self._sar = Rational(int(float(num)), int(float(den)))
        else:
            from fractions import Fraction

            fr = Fraction(float(s)).limit_denominator(1 << 16)
            self._sar = Rational(fr.numerator, fr.denominator)
        out.sample_aspect_ratio = self._sar
        self.out_props = [out]
        return self.out_props

    def filter_frame(self, frame, pad=0):
        return [(0, frame.replace(sample_aspect_ratio=self._sar))]


@register_filter
class ASetRateFilter(Filter):
    NAME = "asetrate"
    DESCRIPTION = "Change the sample rate tag without resampling."
    INPUTS = (PadDesc("default", "audio"),)
    OUTPUTS = (PadDesc("default", "audio"),)
    OPT_ORDER = ("sample_rate",)
    OPTIONS = OptionTable(
        Option("sample_rate", int, 44100, alias="r", min=1, max=2 ** 31))

    def configure(self, in_props):
        self.in_props = in_props
        out = in_props[0].copy()
        out.sample_rate = self.opts["sample_rate"]
        self.out_props = [out]
        return self.out_props

    def filter_frame(self, frame, pad=0):
        return [(0, frame.replace(sample_rate=self.opts["sample_rate"]))]


@register_filter
class ExtractPlanesFilter(Filter):
    NAME = "extractplanes"
    DESCRIPTION = "Extract planes as grayscale streams."
    OPT_ORDER = ("planes",)
    OPTIONS = OptionTable(Option("planes", str, "y"))

    _NAMES = {"y": 0, "u": 1, "v": 2, "r": 0, "g": 1, "b": 2, "a": 3}

    def __init__(self, args: str = "", **kwargs):
        super().__init__(args, **kwargs)
        self._sel = [self._NAMES[p]
                     for p in str(self.opts["planes"]).split("+")]
        self.OUTPUTS = tuple(PadDesc(f"out{i}", "video")
                             for i in range(len(self._sel)))

    def configure(self, in_props):
        from librempeg_tpu_torch.core import pixfmt as pf

        self.in_props = in_props
        self.out_props = []
        desc = pf.get(in_props[0].pix_fmt)
        for idx in self._sel:
            if idx >= desc.nb_planes:
                raise InvalidData("extractplanes: no such plane")
            out = in_props[0].copy()
            out.pix_fmt = "gray"
            out.width = in_props[0].width >> desc.planes[idx].log2_chroma_w
            out.height = in_props[0].height >> desc.planes[idx].log2_chroma_h
            self.out_props.append(out)
        return self.out_props

    def filter_frame(self, frame, pad=0):
        out = []
        for i, idx in enumerate(self._sel):
            p = frame.planes[idx]
            out.append((i, frame.replace(
                planes=(p,), format="gray",
                width=p.shape[1], height=p.shape[0])))
        return out


@register_filter
class ShufflePlanesFilter(Filter):
    NAME = "shuffleplanes"
    DESCRIPTION = "Reorder/duplicate video planes."
    OPT_ORDER = ("map0", "map1", "map2", "map3")
    OPTIONS = OptionTable(
        Option("map0", int, 0, min=0, max=3),
        Option("map1", int, 1, min=0, max=3),
        Option("map2", int, 2, min=0, max=3),
        Option("map3", int, 3, min=0, max=3),
    )

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        return self.out_props

    def filter_frame(self, frame, pad=0):
        n = len(frame.planes)
        m = [self.opts[f"map{i}"] for i in range(n)]
        if any(i >= n for i in m):
            raise InvalidData("shuffleplanes: map index out of range")
        return [(0, frame.replace(
            planes=tuple(frame.planes[i] for i in m)))]


@register_filter
class ConcatFilter(Filter):
    """Concatenate segments (f_concat.c analog).

    Inputs are ordered per segment: segment 0's v video pads then its a
    audio pads, then segment 1's, etc. Frames are buffered per pad and
    emitted at EOF with pts rebased by the cumulative duration of the
    preceding segments (computed as the max stream end-time per
    segment, like the reference's delta tracking).
    """

    NAME = "concat"
    DESCRIPTION = "Concatenate audio and video segments."
    OPT_ORDER = ("n", "v", "a")
    OPTIONS = OptionTable(
        Option("n", int, 2, min=1, max=32),
        Option("v", int, 1, min=0, max=16),
        Option("a", int, 0, min=0, max=16),
    )

    def __init__(self, args: str = "", **kwargs):
        super().__init__(args, **kwargs)
        n, v, a = self.opts["n"], self.opts["v"], self.opts["a"]
        if v + a == 0:
            raise InvalidData("concat: v+a must be > 0")
        pads = []
        for s in range(n):
            pads += [PadDesc(f"in{s}:v{i}", "video") for i in range(v)]
            pads += [PadDesc(f"in{s}:a{i}", "audio") for i in range(a)]
        self.INPUTS = tuple(pads)
        self.OUTPUTS = tuple(
            [PadDesc(f"v{i}", "video") for i in range(v)]
            + [PadDesc(f"a{i}", "audio") for i in range(a)])

    def configure(self, in_props):
        self.in_props = in_props
        nper = self.opts["v"] + self.opts["a"]
        self.out_props = [in_props[i].copy() for i in range(nper)]
        self._q = [[] for _ in self.INPUTS]
        return self.out_props

    def filter_frame(self, frame, pad=0):
        self._q[pad].append(frame)
        return []

    def _end_time(self, frames) -> float:
        end = 0.0
        for f in frames:
            t = _frame_time(f)
            if hasattr(f, "nb_samples"):
                t += f.nb_samples / f.sample_rate
            elif f.duration and f.time_base.valid and f.time_base.den:
                t += f.duration * f.time_base.num / f.time_base.den
            elif getattr(self.in_props[0], "frame_rate", None):
                fr = self.in_props[0].frame_rate
                if fr and fr.num:
                    t += fr.den / fr.num
            end = max(end, t)
        return end

    def flush(self):
        n, nper = self.opts["n"], self.opts["v"] + self.opts["a"]
        out = []
        offset = 0.0
        for s in range(n):
            seg = self._q[s * nper:(s + 1) * nper]
            for stream, frames in enumerate(seg):
                for f in frames:
                    tb = f.time_base
                    shift = int(round(offset * tb.den / tb.num)) \
                        if tb.valid and tb.num else 0
                    pts = f.pts + shift if f.pts != NOPTS else NOPTS
                    out.append((stream, f.replace(pts=pts)))
            offset += self._end_time([f for fr in seg for f in fr])
        self._q = [[] for _ in self.INPUTS]
        return out


class _AudioPassAnalyze(Filter):
    """Base for pass-through audio analyzers that report in `stats` and
    log at EOF (af_volumedetect.c / af_astats.c shape)."""

    INPUTS = (PadDesc("default", "audio"),)
    OUTPUTS = (PadDesc("default", "audio"),)

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        self.stats: dict = {}
        self._reset()
        return self.out_props

    def _reset(self):
        pass


@register_filter
class VolumeDetectFilter(_AudioPassAnalyze):
    NAME = "volumedetect"
    DESCRIPTION = "Detect audio volume (af_volumedetect.c analog)."

    def _reset(self):
        self._sumsq = 0.0
        self._n = 0
        self._peak = 0.0

    def filter_frame(self, frame, pad=0):
        x = _host(_samples(frame))
        self._sumsq += float(np.sum(x.astype(np.float64) ** 2))
        self._n += x.size
        self._peak = max(self._peak, float(np.max(np.abs(x))))
        return [(0, frame)]

    def flush(self):
        if self._n:
            mean = self._sumsq / self._n
            self.stats = {
                "n_samples": self._n,
                "mean_volume": 10.0 * np.log10(max(mean, 1e-20)),
                "max_volume": 20.0 * np.log10(max(self._peak, 1e-10)),
            }
            from librempeg_tpu_torch.core.log import INFO, log

            log("volumedetect", INFO,
                "n_samples: %d mean_volume: %.1f dB max_volume: %.1f dB",
                self._n, self.stats["mean_volume"],
                self.stats["max_volume"])
        return []


@register_filter
class AStatsFilter(_AudioPassAnalyze):
    NAME = "astats"
    DESCRIPTION = "Per-channel time-domain statistics (af_astats.c)."

    def _reset(self):
        self._chunks = []

    def filter_frame(self, frame, pad=0):
        self._chunks.append(_host(_samples(frame)))
        return [(0, frame)]

    def flush(self):
        if self._chunks:
            x = np.concatenate(self._chunks, axis=1).astype(np.float64)
            d = np.diff(x, axis=1)
            per = []
            for c in range(x.shape[0]):
                xc = x[c]
                rms = float(np.sqrt(np.mean(xc ** 2)))
                per.append({
                    "dc_offset": float(np.mean(xc)),
                    "min_level": float(np.min(xc)),
                    "max_level": float(np.max(xc)),
                    "peak_level_db": 20 * np.log10(
                        max(float(np.max(np.abs(xc))), 1e-10)),
                    "rms_level_db": 20 * np.log10(max(rms, 1e-10)),
                    "crest_factor": float(np.max(np.abs(xc)) / max(rms,
                                                                   1e-10)),
                    "zero_crossings": int(np.sum(np.diff(np.signbit(xc)))),
                    "mean_delta": float(np.mean(np.abs(d[c])))
                    if d.size else 0.0,
                    "n_samples": int(xc.size),
                })
            self.stats = {"channels": per}
        return []


@register_filter
class AMergeFilter(Filter):
    """Merge N audio inputs into one multi-channel stream
    (af_amerge.c analog); `join` is registered as an alias class."""

    NAME = "amerge"
    DESCRIPTION = "Merge audio streams into one multi-channel stream."
    OPT_ORDER = ("inputs",)
    OPTIONS = OptionTable(Option("inputs", int, 2, min=1, max=16))

    def __init__(self, args: str = "", **kwargs):
        super().__init__(args, **kwargs)
        n = self.opts["inputs"]
        self.INPUTS = tuple(PadDesc(f"in{i}", "audio") for i in range(n))
        self.OUTPUTS = (PadDesc("default", "audio"),)

    def configure(self, in_props):
        from librempeg_tpu_torch.core.samplefmt import ChannelLayout

        self.in_props = in_props
        out = in_props[0].copy()
        nch = sum(p.layout.nb_channels if p.layout else 1 for p in in_props)
        out.layout = ChannelLayout.default(nch)
        self.out_props = [out]
        self._pending = [[] for _ in in_props]
        return self.out_props

    def filter_frame(self, frame, pad=0):
        self._pending[pad].append(frame)
        if not all(self._pending):
            return []
        frames = [q.pop(0) for q in self._pending]
        n = min(f.nb_samples for f in frames)
        dev = torch.as_tensor(frames[0].data).device
        data = torch.cat([torch.as_tensor(f.data)[:, :n].to(dev)
                          for f in frames], 0)
        return [(0, frames[0].replace(data=data,
                                      layout=self.out_props[0].layout))]


@register_filter
class JoinFilter(AMergeFilter):
    NAME = "join"
    DESCRIPTION = "Join audio streams into one multi-channel stream."


@register_filter
class LoopFilter(Filter):
    """Loop video frames (vf_loop.c analog): buffer `size` frames
    starting at frame `start`, replay them `loop` extra times (-1 not
    supported in the pull-less graph; bounded loops only)."""

    NAME = "loop"
    DESCRIPTION = "Loop video frames."
    OPT_ORDER = ("loop", "size", "start")
    OPTIONS = OptionTable(
        Option("loop", int, 0, min=0, max=1024),
        Option("size", int, 0, min=0, max=32767),
        Option("start", int, 0, min=0, max=1 << 30),
    )

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        self._n = 0
        self._buf = []
        self._frames = []
        return self.out_props

    def filter_frame(self, frame, pad=0):
        st, sz = self.opts["start"], self.opts["size"]
        if sz and st <= self._n < st + sz:
            self._buf.append(frame)
        self._n += 1
        self._frames.append(frame)
        return []

    def flush(self):
        # emit: frames up to end of loop section, the repeats, the rest
        st, sz = self.opts["start"], self.opts["size"]
        out = list(self._frames[:st + sz])
        for _ in range(self.opts["loop"]):
            out.extend(self._buf)
        out.extend(self._frames[st + sz:])
        # renumber pts monotonically in the input's cadence
        res = []
        if out:
            step = out[0].duration or 1
            res = [(0, f.replace(pts=i * step)) for i, f in enumerate(out)]
        self._frames, self._buf = [], []
        return res


@register_filter
class ALoopFilter(LoopFilter):
    NAME = "aloop"
    DESCRIPTION = "Loop audio frames."
    INPUTS = (PadDesc("default", "audio"),)
    OUTPUTS = (PadDesc("default", "audio"),)

    def flush(self):
        st, sz = self.opts["start"], self.opts["size"]
        # start/size are in SAMPLES for aloop; selected at frame
        # granularity: a frame loops if it overlaps [start, start+size)
        loops = []
        acc = 0
        for f in self._frames:
            n = f.nb_samples
            if sz and acc + n > st and acc < st + sz:
                loops.append(f)
            acc += n
        out = list(self._frames)
        for _ in range(self.opts["loop"]):
            out.extend(loops)
        pts = 0
        res = []
        for f in out:
            res.append((0, f.replace(pts=pts)))
            pts += f.nb_samples
        self._frames, self._buf = [], []
        return res


@register_filter
class TPadFilter(Filter):
    """Pad video in time with cloned or black frames (vf_tpad.c)."""

    NAME = "tpad"
    DESCRIPTION = "Temporarily pad video frames."
    OPT_ORDER = ("start", "stop")
    OPTIONS = OptionTable(
        Option("start", int, 0, min=0, max=1 << 20),
        Option("stop", int, 0, min=0, max=1 << 20),
        Option("start_mode", str, "add", choices=("add", "clone")),
        Option("stop_mode", str, "add", choices=("add", "clone")),
    )

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        self._first = None
        self._last = None
        self._count = 0
        return self.out_props

    def filter_frame(self, frame, pad=0):
        out = []
        if self._first is None:
            self._first = frame
            src = frame if self.opts["start_mode"] == "clone" \
                else _blank_like(frame)
            for _ in range(self.opts["start"]):
                out.append((0, src.replace(pts=self._count)))
                self._count += 1
        self._last = frame
        out.append((0, frame.replace(pts=self._count)))
        self._count += 1
        return out

    def flush(self):
        if self._last is None:
            return []
        src = self._last if self.opts["stop_mode"] == "clone" \
            else _blank_like(self._last)
        out = []
        for _ in range(self.opts["stop"]):
            out.append((0, src.replace(pts=self._count)))
            self._count += 1
        return out


class _SetTbBase(Filter):
    OPT_ORDER = ("expr",)
    OPTIONS = OptionTable(Option("expr", str, "intb", alias="tb"))

    def configure(self, in_props):
        self.in_props = in_props
        out = in_props[0].copy()
        e = str(self.opts["expr"])
        intb = in_props[0].time_base or Rational(1, 25)
        if e in ("intb", "AVTB"):
            tb = Rational(1, 1000000) if e == "AVTB" else intb
        elif "/" in e:
            n, d = e.split("/")
            tb = Rational(int(n), int(d))
        else:
            from fractions import Fraction

            fr = Fraction(float(eval_expr(e))).limit_denominator(1 << 20)
            tb = Rational(fr.numerator, fr.denominator)
        self._tb = tb
        out.time_base = tb
        self.out_props = [out]
        return self.out_props

    def filter_frame(self, frame, pad=0):
        if frame.pts != NOPTS and frame.time_base.valid \
                and frame.time_base.num:
            ftb = frame.time_base
            pts = (frame.pts * ftb.num * self._tb.den) \
                // (ftb.den * self._tb.num)
        else:
            pts = frame.pts
        return [(0, frame.replace(pts=pts, time_base=self._tb))]


@register_filter
class SetTbFilter(_SetTbBase):
    NAME = "settb"
    DESCRIPTION = "Set timebase of the video output (f_settb.c analog)."


@register_filter
class ASetTbFilter(_SetTbBase):
    NAME = "asettb"
    DESCRIPTION = "Set timebase of the audio output."
    INPUTS = (PadDesc("default", "audio"),)
    OUTPUTS = (PadDesc("default", "audio"),)


@register_filter
class ShowInfoFilter(Filter):
    """Log per-frame info + plane checksums (vf_showinfo.c analog;
    checksums use av_adler32 init 0, matching the reference's output)."""

    NAME = "showinfo"
    DESCRIPTION = "Show textual information for each video frame."

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        self._n = 0
        self.records = []
        return self.out_props

    def filter_frame(self, frame, pad=0):
        import zlib

        sums = []
        total = 0
        for p in frame.planes:
            b = np.ascontiguousarray(_host(p)).tobytes()
            sums.append(zlib.adler32(b, 0) & 0xFFFFFFFF)
            total = zlib.adler32(b, total) & 0xFFFFFFFF
        rec = {"n": self._n, "pts": frame.pts,
               "t": _frame_time(frame), "fmt": frame.format,
               "size": (frame.width, frame.height),
               "checksum": total, "plane_checksum": sums}
        self.records.append(rec)
        from librempeg_tpu_torch.core.log import INFO, log

        log("showinfo", INFO,
            "n:%4d pts:%7s pts_time:%-7.5g fmt:%s size:%dx%d "
            "checksum:%08X plane_checksum:[%s]",
            rec["n"], frame.pts, rec["t"], frame.format,
            frame.width, frame.height, total,
            " ".join(f"{s:08X}" for s in sums))
        self._n += 1
        return [(0, frame)]


@register_filter
class AShowInfoFilter(Filter):
    """Log per-frame audio info + checksum (af_ashowinfo.c analog)."""

    NAME = "ashowinfo"
    DESCRIPTION = "Show textual information for each audio frame."
    INPUTS = (PadDesc("default", "audio"),)
    OUTPUTS = (PadDesc("default", "audio"),)

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        self._n = 0
        self.records = []
        return self.out_props

    def filter_frame(self, frame, pad=0):
        import zlib

        x = _host(frame.data)
        csum = zlib.adler32(np.ascontiguousarray(x).tobytes(), 0) \
            & 0xFFFFFFFF
        rec = {"n": self._n, "pts": frame.pts, "t": _frame_time(frame),
               "rate": frame.sample_rate, "nb_samples": x.shape[1],
               "channels": x.shape[0], "checksum": csum}
        self.records.append(rec)
        from librempeg_tpu_torch.core.log import INFO, log

        log("ashowinfo", INFO,
            "n:%d pts:%s pts_time:%-7.5g rate:%d nb_samples:%d "
            "channels:%d checksum:%08X",
            rec["n"], frame.pts, rec["t"], frame.sample_rate,
            x.shape[1], x.shape[0], csum)
        self._n += 1
        return [(0, frame)]


@register_filter
class TileFilter(Filter):
    """Tile N successive frames into one grid frame (vf_tile.c)."""

    NAME = "tile"
    DESCRIPTION = "Tile several successive frames together."
    OPT_ORDER = ("layout",)
    OPTIONS = OptionTable(Option("layout", str, "6x5"))

    def configure(self, in_props):
        self.in_props = in_props
        w, h = str(self.opts["layout"]).lower().split("x")
        self._cols, self._rows = int(w), int(h)
        self._n = self._cols * self._rows
        out = in_props[0].copy()
        out.width = in_props[0].width * self._cols
        out.height = in_props[0].height * self._rows
        self.out_props = [out]
        self._buf = []
        return self.out_props

    def _emit(self):
        while len(self._buf) < self._n:      # pad with black (tile pads)
            self._buf.append(_blank_like(self._buf[0]))
        dev = torch.as_tensor(self._buf[0].planes[0]).device
        planes = []
        for i in range(len(self._buf[0].planes)):
            rows = [torch.cat([torch.as_tensor(f.planes[i]).to(dev)
                               for f in self._buf[r * self._cols:
                                                  (r + 1) * self._cols]], 1)
                    for r in range(self._rows)]
            planes.append(torch.cat(rows, 0))
        f0 = self._buf[0]
        self._buf = []
        return f0.replace(planes=tuple(planes),
                          width=self.out_props[0].width,
                          height=self.out_props[0].height)

    def filter_frame(self, frame, pad=0):
        self._buf.append(frame)
        if len(self._buf) == self._n:
            return [(0, self._emit())]
        return []

    def flush(self):
        if self._buf:
            return [(0, self._emit())]
        return []


@register_filter
class ThumbnailFilter(Filter):
    """Pick the most representative frame of every batch of N
    (vf_thumbnail.c: min histogram distance to the batch average)."""

    NAME = "thumbnail"
    DESCRIPTION = "Select the most representative frame per batch."
    OPT_ORDER = ("n",)
    OPTIONS = OptionTable(Option("n", int, 100, min=2, max=1 << 16))

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        self._batch = []
        return self.out_props

    @staticmethod
    def _hist(frame):
        # the 64-bin counts on the frame's device, the rest on the host
        y = torch.as_tensor(frame.planes[0])
        counts = torch.bincount((y >> 2).reshape(-1).long(), minlength=64)
        return _host(counts) / y.numel()

    def _pick(self):
        hists = [self._hist(f) for f in self._batch]
        avg = np.mean(hists, axis=0)
        best = int(np.argmin([np.sum((h - avg) ** 2) for h in hists]))
        out = self._batch[best]
        self._batch = []
        return out

    def filter_frame(self, frame, pad=0):
        self._batch.append(frame)
        if len(self._batch) == self.opts["n"]:
            return [(0, self._pick())]
        return []

    def flush(self):
        if self._batch:
            return [(0, self._pick())]
        return []
