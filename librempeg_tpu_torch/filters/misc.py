"""Stream fan-out: split.

A copy of the split filter of librempeg_tpu/filters/misc.py (host code,
no JAX; f_split.c analog) with its imports rewritten: each input frame
goes to every output pad unchanged (frames are immutable).
"""
from __future__ import annotations

from librempeg_tpu_torch.core.options import Option, OptionTable
from librempeg_tpu_torch.filters.filter import Filter, PadDesc, register_filter


@register_filter
class SplitFilter(Filter):
    NAME = "split"
    DESCRIPTION = "Pass the input to N video outputs."
    OPT_ORDER = ("outputs",)
    OPTIONS = OptionTable(Option("outputs", int, 2, min=1, max=16))

    def __init__(self, args: str = "", **kwargs):
        super().__init__(args, **kwargs)
        n = self.opts["outputs"]
        self.INPUTS = (PadDesc("default", "video"),)
        self.OUTPUTS = tuple(PadDesc(f"out{i}", "video") for i in range(n))

    def configure(self, in_props):
        self.in_props = in_props
        self.out_props = [in_props[0].copy() for _ in self.OUTPUTS]
        return self.out_props

    def filter_frame(self, frame, pad=0):
        return [(i, frame) for i in range(len(self.OUTPUTS))]
