"""IIR biquad audio filters: lowpass, highpass, bandpass, bandreject,
allpass, equalizer, bass, treble, biquad.

Port of librempeg_tpu/filters/biquads.py (af_biquads.c: the RBJ
Audio-EQ-Cookbook coefficients, direct-form-II-transposed evaluation).
The coefficient formulas are host code carried over. The recurrence,
a lax.scan in the JAX package that each filter calls on its own, runs
here a run of filters at a time: mark_runs (FilterGraph.configure calls
it) finds each maximal run of biquad filters linked one to the next,
whose first filter runs every stage, with the sample format's round
trip between stages that the frames between the filters would take, and
whose other filters pass the frame on. That is csrc/biquad.cu on a CUDA
frame (one launch a run and frame) and its plain version on a CPU frame
(kernels/biquad.py, the same float form); a lone biquad is a run of
one. The outputs equal the filters' one by one. Each filter keeps its
own (z1, z2) state, on the frame's device from frame to frame.

One deviation: for a mono call the JAX scan rounds b0 * x before adding
z1, where for two or more channels it fuses them into one multiply-add;
the port takes the fused form at every channel count (ROADMAP section 3).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from librempeg_tpu_torch.codecs.pcm import from_float, to_float
from librempeg_tpu_torch.core.options import Option, OptionTable
from librempeg_tpu_torch.filters.filter import Filter, PadDesc, register_filter
from librempeg_tpu_torch.kernels import biquad as K


def cascade(x: torch.Tensor, coefs, z: torch.Tensor, fmt: str):
    """A run of biquads over x [C, N] float32 from the states z [S, C, 2]:
    coefs, each stage's (b0, b1, b2, a1, a2) float32 values; fmt the
    frames' sample format -> (y [C, N], z'). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return K.biquad_cascade_plain(x, coefs, z, fmt)
    return K.launch(x.contiguous(), coefs, z.contiguous(), fmt)


def mark_runs(nodes) -> None:
    """Among a configured graph's nodes, in topological order, give the
    first filter of each maximal run of biquad filters, each linked to
    the next one's only input, the run (Filter.run: its filters in
    order) and each other filter of the run an empty one."""
    used: set[int] = set()
    for node in nodes:
        if id(node) in used or not isinstance(node.filter, _BiquadBase):
            continue
        run = [node]
        while True:
            ln = run[-1].out_links[0]
            nxt = ln.dst if ln is not None else None
            if (nxt is None or not isinstance(nxt.filter, _BiquadBase)
                    or len(nxt.in_links) != 1):
                break
            run.append(nxt)
        used.update(id(n) for n in run)
        node.filter.run = tuple(n.filter for n in run)
        for n in run[1:]:
            n.filter.run = ()


class _BiquadBase(Filter):
    INPUTS = (PadDesc("default", "audio"),)
    OUTPUTS = (PadDesc("default", "audio"),)

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy()]
        self._z = None
        self._ba = None
        #: the filters whose stages this one runs (mark_runs); empty
        #: where an earlier filter of its run runs its stage
        self.run = (self,)
        self._zrun = None       # the run's last states [S, C, 2] ...
        self._zviews = ()       # ... and the views the filters hold
        return self.out_props

    def _coeffs(self, sample_rate: int):
        raise NotImplementedError

    def _stage(self, sample_rate: int):
        """(b0, b1, b2, a1, a2) as float32 values, from the first frame's
        rate."""
        if self._ba is None:
            b, a = self._coeffs(sample_rate)
            a0 = a[0]
            self._ba = tuple(np.float32(c / a0) for c in b) + (
                np.float32(a[1] / a0), np.float32(a[2] / a0))
        return self._ba

    def _states(self, x: torch.Tensor) -> torch.Tensor:
        """The run's states [S, C, 2]: what the last call left, unless a
        filter's own state was set since (or the first frame: zeros)."""
        zs = [f._z for f in self.run]
        if self._zrun is not None and all(
                a is b for a, b in zip(zs, self._zviews)):
            return self._zrun
        return torch.stack([
            z if z is not None else torch.zeros(
                (x.shape[0], 2), dtype=torch.float32, device=x.device)
            for z in zs])

    def filter_frame(self, frame, pad=0):
        if not self.run:
            return [(0, frame)]
        coefs = [f._stage(frame.sample_rate) for f in self.run]
        x = to_float(torch.as_tensor(frame.data), frame.sample_fmt)
        y, self._zrun = cascade(x, coefs, self._states(x), frame.sample_fmt)
        self._zviews = self._zrun.unbind(0)
        for f, z in zip(self.run, self._zviews):
            f._z = z
        return [(0, frame.replace(data=from_float(y, frame.sample_fmt)))]


def _rbj(kind: str, f: float, sr: int, q: float, gain_db: float = 0.0):
    w0 = 2.0 * math.pi * f / sr
    cw, sw = math.cos(w0), math.sin(w0)
    alpha = sw / (2.0 * q)
    A = 10.0 ** (gain_db / 40.0)
    if kind == "lowpass":
        b = [(1 - cw) / 2, 1 - cw, (1 - cw) / 2]
        a = [1 + alpha, -2 * cw, 1 - alpha]
    elif kind == "highpass":
        b = [(1 + cw) / 2, -(1 + cw), (1 + cw) / 2]
        a = [1 + alpha, -2 * cw, 1 - alpha]
    elif kind == "bandpass":
        b = [alpha, 0.0, -alpha]
        a = [1 + alpha, -2 * cw, 1 - alpha]
    elif kind == "bandreject":
        b = [1.0, -2 * cw, 1.0]
        a = [1 + alpha, -2 * cw, 1 - alpha]
    elif kind == "allpass":
        b = [1 - alpha, -2 * cw, 1 + alpha]
        a = [1 + alpha, -2 * cw, 1 - alpha]
    elif kind == "equalizer":
        b = [1 + alpha * A, -2 * cw, 1 - alpha * A]
        a = [1 + alpha / A, -2 * cw, 1 - alpha / A]
    elif kind == "bass":                      # low shelf
        sq = 2.0 * math.sqrt(A) * alpha
        b = [A * ((A + 1) - (A - 1) * cw + sq),
             2 * A * ((A - 1) - (A + 1) * cw),
             A * ((A + 1) - (A - 1) * cw - sq)]
        a = [(A + 1) + (A - 1) * cw + sq,
             -2 * ((A - 1) + (A + 1) * cw),
             (A + 1) + (A - 1) * cw - sq]
    elif kind == "treble":                    # high shelf
        sq = 2.0 * math.sqrt(A) * alpha
        b = [A * ((A + 1) + (A - 1) * cw + sq),
             -2 * A * ((A - 1) + (A + 1) * cw),
             A * ((A + 1) + (A - 1) * cw - sq)]
        a = [(A + 1) - (A - 1) * cw + sq,
             2 * ((A - 1) - (A + 1) * cw),
             (A + 1) - (A - 1) * cw - sq]
    else:
        raise ValueError(kind)
    return b, a


def _make_rbj_filter(name: str, default_f: float, has_gain: bool,
                     description: str):
    opts = [Option("frequency", float, default_f, alias="f",
                   min=0.1, max=999999.0),
            Option("width", float, 0.707, alias="w", min=0.01, max=1000.0)]
    order = ["frequency", "width"]
    if has_gain:
        opts.append(Option("gain", float, 0.0, alias="g",
                           min=-900.0, max=900.0))
        order = ["frequency", "gain", "width"]

    class _F(_BiquadBase):
        NAME = name
        DESCRIPTION = description
        OPTIONS = OptionTable(*opts)
        OPT_ORDER = tuple(order)

        def _coeffs(self, sr):
            return _rbj(name, self.opts["frequency"], sr,
                        self.opts["width"],
                        self.opts["gain"] if has_gain else 0.0)

    _F.__name__ = f"{name.capitalize()}Filter"
    return register_filter(_F)


LowpassFilter = _make_rbj_filter(
    "lowpass", 500.0, False, "Apply a low-pass filter (2nd-order RBJ).")
HighpassFilter = _make_rbj_filter(
    "highpass", 3000.0, False, "Apply a high-pass filter (2nd-order RBJ).")
BandpassFilter = _make_rbj_filter(
    "bandpass", 3000.0, False, "Apply a band-pass filter (0 dB peak).")
BandrejectFilter = _make_rbj_filter(
    "bandreject", 3000.0, False, "Apply a band-reject (notch) filter.")
AllpassFilter = _make_rbj_filter(
    "allpass", 3000.0, False, "Apply a 2nd-order all-pass filter.")
EqualizerFilter = _make_rbj_filter(
    "equalizer", 1000.0, True, "Apply a peaking equalizer band.")
BassFilter = _make_rbj_filter(
    "bass", 100.0, True, "Boost or cut lower frequencies (low shelf).")
TrebleFilter = _make_rbj_filter(
    "treble", 3000.0, True, "Boost or cut upper frequencies (high shelf).")


@register_filter
class BiquadFilter(_BiquadBase):
    NAME = "biquad"
    DESCRIPTION = "Apply a biquad IIR with user coefficients."
    OPTIONS = OptionTable(
        Option("b0", float, 1.0, min=-1e9, max=1e9),
        Option("b1", float, 0.0, min=-1e9, max=1e9),
        Option("b2", float, 0.0, min=-1e9, max=1e9),
        Option("a0", float, 1.0, min=-1e9, max=1e9),
        Option("a1", float, 0.0, min=-1e9, max=1e9),
        Option("a2", float, 0.0, min=-1e9, max=1e9),
    )

    def _coeffs(self, sr):
        o = self.opts
        return ([o["b0"], o["b1"], o["b2"]], [o["a0"], o["a1"], o["a2"]])
