"""Named-region wall-clock timers (counterpart of
``tinman_sandbox_tpu/profiling.py``, pure Python).

Work on the card is asynchronous, so each region stop synchronises the
device first: a region's time is the time its work took to finish, not to
be enqueued.

    timers = Timers(device)
    with timers.region("caar compute"):
        ...
    timers.summary("Timing.dat")
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch

__all__ = ["Timers"]


class Timers:
    """Named nested wall-clock region timers (GPTL API shape)."""

    def __init__(self, device="cpu"):
        self._device = torch.device(device)
        self._stack = []
        self._rec: Dict[str, list] = {}   # name -> [calls, total, min, max, depth]
        self._order = []

    def start(self, name: str) -> None:
        self._stack.append((name, time.perf_counter()))

    def stop(self, name: str) -> None:
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        top, t0 = self._stack.pop()
        if top != name:
            raise RuntimeError(f"mismatched stop({name}); open region {top}")
        dt = time.perf_counter() - t0
        rec = self._rec.get(name)
        if rec is None:
            rec = [0, 0.0, float("inf"), 0.0, len(self._stack)]
            self._rec[name] = rec
            self._order.append(name)
        rec[0] += 1
        rec[1] += dt
        rec[2] = min(rec[2], dt)
        rec[3] = max(rec[3], dt)

    @contextlib.contextmanager
    def region(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def summary(self, path: str) -> None:
        """Write the region table (GPTLpr_summary_file analog)."""
        with open(path, "w") as f:
            f.write(f"{'region':<40} {'calls':>10} {'total_s':>14} "
                    f"{'min_s':>12} {'max_s':>12}\n")
            for name in self._order:
                c, tot, mn, mx, depth = self._rec[name]
                f.write(f"{'  ' * depth + name:<40} {c:>10} {tot:>14.6f} "
                        f"{mn:>12.6f} {mx:>12.6f}\n")
