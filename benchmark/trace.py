"""The traced slice of a ``--trace 1`` run and the arithmetic that turns
its ``torch.profiler`` trace into per-layer numbers.

The slice is ``trace_steps`` steps (a whole number of remap periods) that
follow the timed window in the same chain. Round trips to the device run
first, so that device tracing is recording when the slice starts (on the
H100 it began ~2 ms after the profiler started). The slice and its closing
synchronisation are annotated ``benchmark.trace_window``.

The arithmetic is a frozen copy of ``tinman_sandbox_tpu_torch.profiling.
busy_share``'s: busy time is the union of the kernel, memcpy and memset
intervals inside the window; the window runs from the annotation's start
to the end of the last synchronisation inside it. The window's device
operations are those a host call inside it launched.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
import time

import torch

WINDOW = "benchmark.trace_window"
SPANS = ("cadence.step", "cadence.remap")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
_SYNCS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
          "cudaEventSynchronize")
WARMUP_TRIPS = 10
WARMUP_S = 0.005


def run_slice(run_steps, nsteps: int, device: torch.device) -> list:
    """Profile ``run_steps(nsteps)`` and return the Chrome trace's
    events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(WARMUP_TRIPS):
            torch.ones(1, device=device).add_(1)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            time.sleep(WARMUP_S)
        with record_function(WINDOW):
            run_steps(nsteps)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    return events.get("traceEvents", events) if isinstance(events, dict) \
        else events


@dataclasses.dataclass
class Trace:
    """The device operations and host events of the traced window (times
    in microseconds)."""
    device_ops: list        # (start, end, name) of the window's launches
    host: list              # (start, end, name, cat)
    start: float
    stop: float
    steps: int

    @property
    def window_s(self) -> float:
        return (self.stop - self.start) * 1e-6

    def clipped(self) -> list:
        ops = ((max(t0, self.start), min(t1, self.stop))
               for t0, t1, _ in self.device_ops)
        return [(t0, t1) for t0, t1 in ops if t1 > t0]

    @property
    def busy_s(self) -> float:
        busy, cur0, cur1 = 0.0, None, None
        for t0, t1 in self.clipped():
            if cur1 is None or t0 > cur1:
                if cur1 is not None:
                    busy += cur1 - cur0
                cur0, cur1 = t0, t1
            else:
                cur1 = max(cur1, t1)
        if cur1 is not None:
            busy += cur1 - cur0
        return busy * 1e-6

    def ms_per_step(self, patterns) -> float:
        """The device time a step of the kernels whose name matches one of
        ``patterns`` (regular expressions, searched)."""
        rx = [re.compile(p) for p in patterns]
        tot = sum(t1 - t0 for t0, t1, name in self.device_ops
                  if any(r.search(name) for r in rx))
        return tot * 1e-3 / self.steps

    def idle_gaps(self, top: int = 10) -> list:
        """The longest device-idle gaps inside the window, each named by the
        harness span and the innermost host operation under way at its
        middle: [[name, seconds], ...]."""
        gaps, last = [], self.start
        for t0, t1 in self.clipped():
            if t0 > last:
                gaps.append((last, t0))
            last = max(last, t1)
        if self.stop > last:
            gaps.append((last, self.stop))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for g0, g1 in gaps[:top]:
            mid = 0.5 * (g0 + g1)
            under = [h for h in self.host if h[0] <= mid <= h[1]]
            span = [h[2] for h in under if h[2] in SPANS]
            inner = min(under, key=lambda h: h[1] - h[0])[2] if under \
                else "nothing"
            label = f"{span[0] if span else 'between steps'}: {inner}"
            out.append([label[:160], (g1 - g0) * 1e-6])
        return out

    def top_ops(self, top: int = 10) -> list:
        tot = {}
        for t0, t1, name in self.device_ops:
            tot[name] = tot.get(name, 0.0) + (t1 - t0)
        ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], s * 1e-6] for n, s in ranked]


def read(events: list, steps: int) -> Trace:
    """The window's device operations: those launched by a host call
    inside the window (matched by the trace's correlation ids, so that the
    device clock's offset from the host's drops none)."""
    dev, host, syncs, marks, launched = [], [], [], [], []
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0.0))
        cat, name = e.get("cat", ""), e.get("name", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in _DEVICE_CATS:
            dev.append((t0, t1, name, corr))
        elif cat in _HOST_CATS:
            host.append((t0, t1, name, cat))
            if name in _SYNCS:
                syncs.append(t1)
            if name == WINDOW:
                marks.append((t0, t1))
            if cat == "cuda_runtime" and corr is not None:
                launched.append((t0, corr))
    if not marks:
        raise ValueError("trace: no traced window")
    start, mark_end = marks[-1]
    inside = [t for t in syncs if start <= t <= mark_end]
    stop = max(inside) if inside else mark_end
    ids = {c for t, c in launched if start <= t <= stop}
    ops = sorted((t0, t1, n) for t0, t1, n, c in dev if c in ids)
    host = [h for h in host if h[1] >= start and h[0] <= stop]
    return Trace(device_ops=ops, host=host, start=start, stop=stop,
                 steps=steps)
