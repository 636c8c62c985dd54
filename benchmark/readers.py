"""What a per-layer metric's reader (``metrics/<name>.py``) is handed: the
traced slice, the cell's shapes, the window's mean step time, its step
times and its whole cadence periods' times a step (``run.periods_ms``),
the frozen work counts and the published peaks. A reader returns a
number, or None where its layer ran nothing in the slice; a share of a
roofline or of a peak is never returned as 0.
"""
from __future__ import annotations

import glob
import json
import os
import sys

from . import spec

# NVIDIA's data sheet, H100 SXM: HBM3 bandwidth and FP32 outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = 67e12


class Context:
    def __init__(self, trace, shape: dict, step_ms: float,
                 step_times_ms: list, periods_ms: list, base: str,
                 metric: str):
        self.trace, self.shape = trace, shape
        self.step_ms, self.step_times_ms = step_ms, step_times_ms
        self.periods_ms = periods_ms
        self.base, self.metric = base, metric
        self.kmap = spec.kernel_map(metric, base)

    def note(self, line: str) -> None:
        print(f"{self.metric}: {line}", file=sys.stderr)

    def layer_ms(self):
        """ms a step of the kernels this metric's map names; None where
        none ran."""
        ms = self.trace.ms_per_step(self.kmap["kernels"])
        return ms if ms > 0 else None

    def bound_ms(self, layer: str) -> float:
        """The least time a step of ``layer``'s work could take on the
        published peaks; says which of the two bounds it."""
        w = spec.work(layer, self.base)(self.shape)
        by_bytes = w["bytes"] / PEAK_BYTES_PER_S * 1e3
        by_flops = w["flops"] / PEAK_FLOPS_PER_S * 1e3
        which = "bytes" if by_bytes >= by_flops else "operations"
        self.note(f"{layer} bound by {which}: {w['bytes']} B "
                  f"({by_bytes:.6f} ms at 3.35 TB/s), {w['flops']:.6e} "
                  f"operations ({by_flops:.6f} ms at 67 TFLOP/s) a step")
        return max(by_bytes, by_flops)

    def roofline(self, layer: str):
        """The layer's share of its roofline, in percent: its bound over
        its device time a step."""
        ms = self.layer_ms()
        if ms is None:
            return None
        return 100.0 * self.bound_ms(layer) / ms

    def claimed(self) -> list:
        """Every kernel-name pattern of every map in ``metrics/``."""
        out = []
        for path in sorted(glob.glob(os.path.join(self.base, "metrics",
                                                  "*.json"))):
            with open(path) as f:
                out += json.load(f).get("kernels", [])
        return out
