"""Named-region timers and the profiler trace (counterpart of
``tinman_sandbox_tpu/profiling.py``).

``Timers`` are GPTL-shaped named nested wall-clock regions. By default they
run on the repository's native timer library (``native/timing/
tinman_timing.cpp``: per-region calls, total, self, min, max and the
thread's usr / sys CPU time, keyed by the full call path), compiled with
``g++`` at first use into ``build/torch_native/`` beside the kernels' build
directory; where no compiler is found they run in pure Python
(``is_native`` says which). Work on the card is asynchronous, so each region
stop synchronises the device first: a region's time is the time its work
took to finish, not to be enqueued.

    timers = Timers(device)
    with timers.region("caar compute"):
        ...
    timers.summary("Timing.dat")

``stage_time(chain, n, device)`` times one stage of a step for the
breakdown tools (``tools/profile_*.py``): ``chain(n)`` runs n chained calls,
timed by CUDA events around the chain, replayed from a CUDA graph (the
device alone) and by the host's time to issue it.

``trace(logdir, device)`` is a ``torch.profiler`` scope (CPU and, on the
card, CUDA activities) that writes a Chrome trace to ``trace_path(logdir)``;
``busy_share(path)`` reads its device events: the busy time (the union of
the kernel, memcpy and memset intervals), the window (the start of the
scope's body to the end of its final synchronisation), their ratio and the
longest device operations.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import time
from typing import Dict, Optional

import torch

from .device import resolve_device

__all__ = ["Timers", "trace", "trace_path", "busy_share", "native_library",
           "TRACE_WINDOW", "stage_time", "GRAPH_MEMORY_SHARE", "STAGE_REPS"]

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_REPO, "native", "timing", "tinman_timing.cpp")
NATIVE_DIR = os.path.join(_REPO, "build", "torch_native")
_CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]


def _library_path() -> str:
    """The library's path in ``NATIVE_DIR``, named by a hash of the source
    and the flags."""
    digest = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    with open(_SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(NATIVE_DIR,
                        f"libtinman_timing_{digest.hexdigest()[:12]}.so")


def native_library() -> Optional[ctypes.CDLL]:
    """The native timer library, compiled at first use (to a temporary name,
    then moved into place, so processes that build at once do not clash);
    None where there is no ``g++`` or the source, or the build fails."""
    cxx = shutil.which("g++")
    if cxx is None or not os.path.exists(_SOURCE):
        return None
    path = _library_path()
    if not os.path.exists(path):
        os.makedirs(NATIVE_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            subprocess.run([cxx, *_CXX_FLAGS, "-o", tmp, _SOURCE],
                           capture_output=True, check=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
        os.replace(tmp, path)
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    for fn in ("tt_initialize", "tt_reset"):
        getattr(lib, fn).argtypes = []
    lib.tt_start.argtypes = [ctypes.c_char_p]
    lib.tt_stop.argtypes = [ctypes.c_char_p]
    lib.tt_get.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_double)]
    lib.tt_pr_summary_file.argtypes = [ctypes.c_char_p]
    for fn in ("tt_initialize", "tt_start", "tt_stop", "tt_get",
               "tt_pr_summary_file", "tt_reset"):
        getattr(lib, fn).restype = ctypes.c_int
    lib.tt_initialize()
    return lib


class Timers:
    """Named nested wall-clock region timers (GPTL API shape). The native
    library keeps one table a thread for the whole process, so native
    ``Timers`` share their regions; ``reset`` clears them. ``device`` is
    the card by default, whose work each region stop waits for; where there
    is no card that default raises, and CPU callers pass ``device="cpu"``."""

    def __init__(self, device="cuda", native: bool = True):
        self._device = resolve_device(device)
        self._lib = native_library() if native else None
        # the pure-Python path's state
        self._stack = []
        self._py: Dict[str, list] = {}   # name -> [calls, total, min, max, depth]
        self._order = []

    @property
    def is_native(self) -> bool:
        return self._lib is not None

    def start(self, name: str) -> None:
        if self._lib is not None:
            self._lib.tt_start(name.encode())
        else:
            self._stack.append((name, time.perf_counter()))

    def stop(self, name: str) -> None:
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        if self._lib is not None:
            if self._lib.tt_stop(name.encode()):
                raise RuntimeError(f"mismatched stop({name})")
            return
        top, t0 = self._stack.pop()
        if top != name:
            raise RuntimeError(f"mismatched stop({name}); open region {top}")
        dt = time.perf_counter() - t0
        rec = self._py.get(name)
        if rec is None:
            rec = [0, 0.0, float("inf"), 0.0, len(self._stack)]
            self._py[name] = rec
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

    def get(self, name: str):
        """(calls, total_s, min_s, max_s) or None, summed over the region's
        parents (and threads, natively)."""
        full = self.get_full(name)
        return full[:4] if full else None

    def get_full(self, name: str):
        """(calls, total_s, min_s, max_s, usr_s, sys_s) or None; usr / sys
        are the thread's CPU times (native only: the Python path gives
        0.0)."""
        if self._lib is not None:
            out = (ctypes.c_double * 6)()
            if self._lib.tt_get(name.encode(), out):
                return None
            return int(out[0]), out[1], out[2], out[3], out[4], out[5]
        rec = self._py.get(name)
        return (rec[0], rec[1], rec[2], rec[3], 0.0, 0.0) if rec else None

    def summary(self, path: str) -> None:
        """Write the region table (GPTLpr_summary_file analog)."""
        if self._lib is not None:
            if self._lib.tt_pr_summary_file(path.encode()):
                raise OSError(f"cannot write {path}")
            return
        with open(path, "w") as f:
            f.write(f"{'region':<40} {'calls':>10} {'total_s':>14} "
                    f"{'min_s':>12} {'max_s':>12}\n")
            for name in self._order:
                c, tot, mn, mx, depth = self._py[name]
                f.write(f"{'  ' * depth + name:<40} {c:>10} {tot:>14.6f} "
                        f"{mn:>12.6f} {mx:>12.6f}\n")

    def reset(self) -> None:
        if self._lib is not None:
            self._lib.tt_reset()
        self._stack.clear()
        self._py.clear()
        self._order.clear()


# a chain is captured into a CUDA graph only where the memory one eager run
# of it took beyond its inputs stays under this share of the free memory
# (the graph's private pool holds the chain's own tensors once more)
GRAPH_MEMORY_SHARE = 0.8
GRAPH_REPLAYS = 2
# timed runs of a chain, the best kept: the first run of a chain may be the
# first to allocate its buffers (at ne120 x qsize 35 a 13.9 GB one)
STAGE_REPS = 2


def _graph_ms(chain, n: int, replays: int, dev: torch.device) -> float:
    """ms a call of ``chain(n)`` captured in a CUDA graph and replayed
    ``replays`` times, by CUDA events: the device's time without the host's
    cost of issuing the launches."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        chain(n)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chain(n)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize(dev)
    ms = start.elapsed_time(end) / (replays * n)
    del graph
    return ms


def stage_time(chain, n: int, device="cuda", reps: int = STAGE_REPS,
               graph: bool = True) -> dict:
    """Times of one stage. ``chain(n)`` runs ``n`` chained calls of the
    stage (each call's output the next call's input), from the same start
    at every run; one call of ``chain(1)`` warms up first (the kernels'
    build included). Returns, in ms a call:

      * ``ms``: the best of ``reps`` (STAGE_REPS) runs of ``chain(n)`` timed
        by CUDA events, with a device sync at the end;
      * ``graph_ms``: ``chain(n)`` captured in a CUDA graph and replayed
        GRAPH_REPLAYS times (the device alone); None without ``graph`` (a
        chain that copies from the host each call cannot be captured) and
        where the chain's own memory would not fit twice (``graph_note``
        says why: the graph's pool holds its tensors beside the eager
        ones);
      * ``host_ms``: the host's time to issue the calls of the best run
        (``time.perf_counter`` before the sync);
      * ``peak_bytes``: the device memory one eager run took beyond what
        was allocated before it;
      * ``clock``: "cuda events" on the card. On the CPU every time is
        wall-clock (``clock`` "wall", ``ms`` = ``host_ms``, no graph)."""
    dev = resolve_device(device)
    if n < 1:
        raise ValueError(f"stage_time: n must be >= 1, got {n}")
    if reps < 1:
        raise ValueError(f"stage_time: reps must be >= 1, got {reps}")
    chain(1)
    if dev.type != "cuda":
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            chain(n)
            best = min(best, time.perf_counter() - t0)
        ms = best * 1e3 / n
        return {"ms": ms, "graph_ms": None, "host_ms": ms, "peak_bytes": None,
                "clock": "wall", "graph_note": "no CUDA graph on the CPU"}
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = best_host = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        start.record()
        chain(n)
        end.record()
        host = time.perf_counter() - t0
        torch.cuda.synchronize(dev)
        ms = start.elapsed_time(end)
        if ms < best:
            best, best_host = ms, host
    peak = torch.cuda.max_memory_allocated(dev) - base
    out = {"ms": best / n, "graph_ms": None, "host_ms": best_host * 1e3 / n,
           "peak_bytes": peak, "clock": "cuda events"}
    if not graph:
        out["graph_note"] = "not measured: the chain cannot be captured"
        return out
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0]
    if peak > GRAPH_MEMORY_SHARE * free:
        out["graph_note"] = (f"not measured: the chain's {peak} B over "
                             f"{GRAPH_MEMORY_SHARE} of the {free} B free")
        return out
    out["graph_ms"] = _graph_ms(chain, n, GRAPH_REPLAYS, dev)
    torch.cuda.empty_cache()
    return out


def trace_path(logdir: str) -> str:
    """The Chrome trace that ``trace(logdir)`` writes."""
    return os.path.join(logdir, "trace.json")


# the host annotation that marks the body of a ``trace`` scope
TRACE_WINDOW = "tinman trace window"
# device round trips, TRACE_WARMUP_S apart, before the body of a ``trace``
# scope: the H100's activity tracing began recording ~2 ms after the
# profiler started, and a body that started at once lost its first kernels
TRACE_WARMUP_TRIPS = 10
TRACE_WARMUP_S = 0.005


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """A ``torch.profiler`` scope (the profiling_resume / pause analog,
    profiling.hpp:20-52) over CPU and, on the card, CUDA activities, that
    writes a Chrome trace to ``trace_path(logdir)``. Device round trips run
    first for ~50 ms (``TRACE_WARMUP_TRIPS``), so that the device tracing
    is running when the body starts; the body and the device
    synchronisation after it are annotated ``TRACE_WINDOW``. Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = resolve_device(device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        for _ in range(TRACE_WARMUP_TRIPS):
            torch.ones(1, device=dev).add_(1)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            time.sleep(TRACE_WARMUP_S)
        with record_function(TRACE_WINDOW):
            yield prof
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    prof.export_chrome_trace(trace_path(logdir))


# the trace's device events, and its host events
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
              "python_function")
_SYNC_NAMES = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
               "cudaEventSynchronize")


def busy_share(path: str, top: int = 5) -> dict:
    """Read a Chrome trace (``trace``'s, or any with ``traceEvents``):
    ``busy_s`` the union of the device events' intervals inside the window,
    ``window_s`` from the start of the ``TRACE_WINDOW`` annotation (else the
    first host event) to the end of the last synchronisation (else of the
    last event), ``busy_share`` their ratio, ``kernels`` the count of each
    device operation inside the window, and ``top`` the ``top`` device
    operations by their total time inside the window as [name, seconds,
    count]."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) \
        else events
    dev, host, syncs, ends, marks = [], [], [], [], []
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in _DEVICE_CATS:
            dev.append((t0, t1, name))
            continue
        ends.append(t1)
        if cat in _HOST_CATS:
            host.append(t0)
            if name in _SYNC_NAMES:
                syncs.append(t1)
            if name == TRACE_WINDOW:
                marks.append((t0, t1))
    if not ends and not dev:
        raise ValueError(f"{path}: no complete events")
    if marks:
        start, mark_end = marks[-1]
        syncs = [t for t in syncs if start <= t <= mark_end]
        stop = max(syncs) if syncs else mark_end
    else:
        start = min(host) if host else min(d[0] for d in dev)
        stop = max(syncs) if syncs else max(ends + [d[1] for d in dev])
    inside = [(max(t0, start), min(t1, stop), name) for t0, t1, name in dev]
    inside = sorted(c for c in inside if c[1] > c[0])
    busy, cur0, cur1 = 0.0, None, None
    for t0, t1, _ in inside:
        if cur1 is None or t0 > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    if cur1 is not None:
        busy += cur1 - cur0
    by_name: Dict[str, list] = {}
    for t0, t1, name in inside:
        rec = by_name.setdefault(name, [0.0, 0])
        rec[0] += t1 - t0
        rec[1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    window = max(stop - start, 0.0)
    return {"busy_s": busy * 1e-6, "window_s": window * 1e-6,
            "busy_share": busy / window if window > 0 else 0.0,
            "kernels": {n: r[1] for n, r in by_name.items()},
            "top": [[n, r[0] * 1e-6, r[1]] for n, r in ranked]}
