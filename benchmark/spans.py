"""The port's own spans and counters (``tinman_sandbox_tpu_torch.profiling.
record_spans``) read in two more slices after a traced run's slice, and the
per-layer numbers they give.

    python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>

runs the cell as ``python3 -m benchmark.run --trace 1`` does (the window,
then slice 1: ``trace_steps`` profiled steps with the port's spans off, which
every metric of ``BENCHMARK.json`` reads) and then, in the same chain,
``trace_steps`` steps twice more:

  * slice 2 (``profile_slice``), profiled under
    ``record_spans(profiler=True)``: every span is a ``record_function``
    annotation in the trace, and ``attribute`` puts each device operation
    down to the port spans around its launch (the correlation id names the
    launching runtime call, and that call's thread and time the spans);
  * slice 3 (``count_slice``), unprofiled, the device synchronised before
    each step outside the spans: steps under ``record_spans(counters=
    True)`` (the spans' host times, the limited stage's counts) in turns of
    a remap period with as many steps with the spans off, each step timed by
    the host clock, for what the spans cost when on; the allocator's
    ``num_device_alloc`` is read before and after.

The last line of standard output is ``benchmark.run``'s result line with
the metrics of ``METRICS`` added (``.dispatch`` after their name in a cell
that reports ``step_ms.dispatch``) and ``breakdown.idle_gaps`` taken from
slice 2, each gap named by the port's span path under way at its middle and
the innermost host operation. ``benchmark.run`` runs neither slice: the
metrics here are read by this command alone.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import re
import sys
import time
from unittest import mock

import torch

from . import run, spec
from . import trace as tracing

# the port's span names (``dist/step_t.py`` and the kernel wrappers)
PORT_SPANS = re.compile(r"^(prim\.|remap(\.|$)|launch\.)")
DSS_PHASES = {"dss_dynamics_ms": "prim.dynamics",
              "dss_hypervis_ms": "prim.hypervis",
              "dss_tracers_ms": "prim.tracers"}
# the profiled slice of ``benchmark.trace`` (``run_cell`` wraps the module's
# name to run slices 2 and 3 after slice 1)
_PROFILED = tracing.run_slice
# the runtime calls that take device memory
ALLOCS = ("cudaMalloc", "cudaMallocAsync", "cudaFree")
# the wrappers whose ``launches`` slice 3 counts
WRAPPERS = (("kernels.caar_t", "caar_t4_cuda"),
            ("kernels.dss", "dss_fixup_cuda"),
            ("kernels.dss", "dss_sweep_cuda"),
            ("kernels.hypervis_t", "vlap_cuda"),
            ("kernels.tracer_t", "tracer_limit_cuda"),
            ("kernels.tracer_t", "tracer_euler_cuda"),
            ("kernels.remap", "remap_packed_cuda"))


@dataclasses.dataclass
class Attributed:
    """Slice 2: the window's device operations, each with the port's span
    path around its launch."""
    trace: tracing.Trace
    ops: list        # (start, end, name, path): path outermost first, () none
    spans: list      # (start, end, name, tid) of the port's annotations
    allocs: list     # (runtime call, path) of the window's device allocations

    def ms_per_step(self, keep) -> float:
        """Device ms a step of the operations for which ``keep(name,
        path)`` holds."""
        tot = sum(t1 - t0 for t0, t1, name, path in self.ops
                  if keep(name, path))
        return tot * 1e-3 / self.trace.steps

    def outside(self) -> list:
        """The operations that no port span encloses."""
        return [(t0, t1, name) for t0, t1, name, path in self.ops
                if not path]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest device-idle gaps of the window, each named by the
        port span path under way at its middle and the innermost host
        operation there: [[name, seconds], ...]."""
        tr = self.trace
        gaps, last = [], tr.start
        for t0, t1 in tr.clipped():
            if t0 > last:
                gaps.append((last, t0))
            last = max(last, t1)
        if tr.stop > last:
            gaps.append((last, tr.stop))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for g0, g1 in gaps[:top]:
            mid = 0.5 * (g0 + g1)
            path = "/".join(s[2] for s in sorted(
                (s for s in self.spans if s[0] <= mid <= s[1]),
                key=lambda s: (s[0], s[0] - s[1])))
            under = [h for h in tr.host if h[0] <= mid <= h[1]]
            inner = min(under, key=lambda h: h[1] - h[0])[2] if under \
                else "nothing"
            out.append([f"{path or 'outside the port'}: {inner}"[:160],
                        (g1 - g0) * 1e-6])
        return out


def attribute(events: list, steps: int) -> Attributed:
    """Put each device operation of the traced window (``trace.read``'s)
    down to the port's spans: the runtime call with its correlation id
    launched it, and the port annotations on that call's thread around its
    start are its path."""
    tr = tracing.read(events, steps)
    launch, spans, dev, calls = {}, [], [], []
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0.0))
        cat, name = e.get("cat", ""), e.get("name", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat == "cuda_runtime" and name in ALLOCS \
                and tr.start <= t0 <= tr.stop:
            calls.append((name, t0, e.get("tid")))
        if cat == "cuda_runtime" and corr is not None:
            launch[corr] = (t0, e.get("tid"))
        elif cat == "user_annotation" and PORT_SPANS.match(name):
            spans.append((t0, t1, name, e.get("tid")))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((t0, t1, name, corr))
    spans.sort()

    def path(at, tid):
        return tuple(s[2] for s in spans if s[3] == tid and s[0] <= at <= s[1])

    ops = []
    for t0, t1, name, corr in dev:
        if corr not in launch or not tr.start <= launch[corr][0] <= tr.stop:
            continue
        ops.append((t0, t1, name, path(*launch[corr])))
    ops.sort()
    return Attributed(trace=tr, ops=ops, spans=spans,
                      allocs=[(name, path(at, tid)) for name, at, tid in calls])


def profile_slice(run_steps, nsteps: int, device) -> Attributed:
    """Slice 2: ``nsteps`` steps profiled with the port's spans as
    annotations."""
    from tinman_sandbox_tpu_torch.profiling import record_spans

    with record_spans(profiler=True):
        events = _PROFILED(run_steps, nsteps, device)
    return attribute(events, nsteps)


@dataclasses.dataclass
class Counted:
    """Slice 3: over the ``steps`` steps with the spans on, the spans' host
    times, the limiter's counts and the wrappers' launches; the host clock
    around each step with the spans on and around as many with them off;
    the allocator's device allocations over all of them (2 x ``steps``)."""
    steps: int
    stats: dict          # span name -> (calls, total_ns, self_ns)
    limiter: dict        # profiling.LIMITER_COUNTS -> count
    device_allocs: int | None
    launches: dict       # wrapper -> launches
    step_on_ms: list
    step_off_ms: list


def _launches() -> dict:
    import importlib

    return {name: getattr(importlib.import_module(
        "tinman_sandbox_tpu_torch." + mod), name).launches
        for mod, name in WRAPPERS}


def _allocs(device):
    if device.type != "cuda":
        return None
    return torch.cuda.memory_stats(device).get("num_device_alloc")


def count_slice(run_steps, nsteps: int, device, block: int = 1) -> Counted:
    """Slice 3: ``nsteps`` steps under ``record_spans(counters=True)`` and
    ``nsteps`` with the spans off, in turns of ``block`` steps (a remap
    period: each turn holds one remap), each step after a device
    synchronisation outside the spans and timed by the host clock."""
    from tinman_sandbox_tpu_torch.profiling import record_spans

    def timed(n):
        out = []
        for _ in range(n):
            run.sync(device)
            t0 = time.perf_counter()
            run_steps(1)
            out.append((time.perf_counter() - t0) * 1e3)
        run.sync(device)
        return out

    on, off, stats, limiter, launched = [], [], {}, {}, {}
    run.sync(device)
    a0 = _allocs(device)
    while len(on) < nsteps:
        before = _launches()
        with record_spans(counters=True) as rec:
            on += timed(min(block, nsteps - len(on)))
            lim = rec.limiter()
        for k, v in _launches().items():
            launched[k] = launched.get(k, 0) + v - before[k]
        for name, got in rec.stats().items():
            stats[name] = tuple(a + b for a, b in
                                zip(stats.get(name, (0, 0, 0)), got))
        for k, v in lim.items():
            limiter[k] = limiter.get(k, 0) + v
        off += timed(min(block, nsteps - len(off)))
    a1 = _allocs(device)
    return Counted(steps=nsteps, stats=stats, limiter=limiter,
                   device_allocs=None if a0 is None else a1 - a0,
                   launches=launched, step_on_ms=on, step_off_ms=off)


# -- the per-layer metrics: read(ctx) with ctx.slice2 (Attributed) and
# ctx.slice3 (Counted); None where the slice or its layer is not there


def _dss(ctx, phase):
    s2 = getattr(ctx, "slice2", None)
    if s2 is None:
        return None
    rx = [re.compile(p) for p in spec.kernel_map("dss_ms", ctx.base)
          ["kernels"]]
    ms = s2.ms_per_step(lambda name, path: phase in path
                        and any(r.search(name) for r in rx))
    return ms if ms > 0 else None


def dss_dynamics_ms(ctx):
    """Device ms a step of the DSS kernels the dynamics stages launch."""
    return _dss(ctx, DSS_PHASES["dss_dynamics_ms"])


def dss_hypervis_ms(ctx):
    """Device ms a step of the DSS kernels the hyperviscosity launches."""
    return _dss(ctx, DSS_PHASES["dss_hypervis_ms"])


def dss_tracers_ms(ctx):
    """Device ms a step of the DSS kernels the tracer stages launch (the
    closers of qsize*nlev rows)."""
    return _dss(ctx, DSS_PHASES["dss_tracers_ms"])


def fixer_ms(ctx):
    """Device ms a step (over all steps) of every operation the dry-mass
    fixer launches."""
    s2 = getattr(ctx, "slice2", None)
    if s2 is None:
        return None
    ms = s2.ms_per_step(lambda name, path: "remap.fixer" in path)
    return ms if ms > 0 else None


def host_issue_ms(ctx):
    """The host's ms a step inside ``prim.step`` and ``remap`` (slice 3:
    the device synchronised before each step, so no launch waits on a
    full queue)."""
    s3 = getattr(ctx, "slice3", None)
    if s3 is None or "prim.step" not in s3.stats:
        return None
    ns = sum(s3.stats[n][1] for n in ("prim.step", "remap")
             if n in s3.stats)
    return ns * 1e-6 / s3.steps


def limiter_useful_share(ctx):
    """Of the limiter passes computed in full, the share in which some
    element of the warp had a deficit, in percent."""
    s3 = getattr(ctx, "slice3", None)
    if s3 is None or not s3.limiter.get("warp_passes"):
        return None
    lim = s3.limiter
    return 100.0 * lim["warp_passes_with_deficit"] / lim["warp_passes"]


def device_allocs_per_step(ctx):
    """The caching allocator's device allocations (``num_device_alloc``) a
    step of slice 3."""
    s3 = getattr(ctx, "slice3", None)
    if s3 is None or s3.device_allocs is None:
        return None
    return s3.device_allocs / (2 * s3.steps)


METRICS = {f.__name__: f for f in (
    dss_dynamics_ms, dss_hypervis_ms, dss_tracers_ms, fixer_ms,
    host_issue_ms, limiter_useful_share, device_allocs_per_step)}
UNITS = {"host_issue_ms": "ms/step", "limiter_useful_share": "%",
         "device_allocs_per_step": "allocs/step"}


def notes(s2: Attributed | None, s3: Counted | None) -> list:
    """The lines the readers print on standard error: each span's calls,
    total and self host ms a step, the wrappers' launches a step and their
    host ms each, the limiter's counts a step, and slice 2's operations
    outside every port span."""
    out = []
    if s3 is not None:
        n = s3.steps
        for name, (calls, tot, own) in s3.stats.items():
            out.append(f"span {name}: {calls / n:.3f} calls, total "
                       f"{tot * 1e-6 / n:.6f} ms, self {own * 1e-6 / n:.6f} "
                       "ms a step")
        launches = sum(s3.launches.values())
        host = sum(s3.stats[k][1] for k in ("prim.step", "remap")
                   if k in s3.stats) * 1e-6 / n
        out.append(f"launches: {launches / n:.3f} a step ("
                   + ", ".join(f"{k} {v / n:.3f}" for k, v in
                               s3.launches.items())
                   + f"); host ms a launch {host * n / max(launches, 1):.6f}")
        out.append("limiter: " + ", ".join(
            f"{k} {v / n:.3f}" for k, v in s3.limiter.items()) + " a step")
        on, off = (sum(v) / len(v) for v in (s3.step_on_ms,
                                             s3.step_off_ms))
        out.append(f"host clock a step: spans on {on:.6f} ms, off "
                   f"{off:.6f} ms (means of {n} each, in turns); device "
                   f"allocations {s3.device_allocs} in {2 * n} steps")
    if s2 is not None:
        for t0, t1, name in s2.outside():
            out.append(f"outside every port span: {name[:120]} "
                       f"{(t1 - t0) * 1e-3:.6f} ms")
        for (name, path), k in sorted(collections.Counter(
                s2.allocs).items()):
            out.append(f"profiled slice: {k} x {name} in "
                       f"{'/'.join(path) or 'no port span'}")
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, device) -> tuple:
    """``benchmark.run.run_cell`` with ``--trace 1``, and slices 2 and 3
    after its slice. Returns (result, the check's lines)."""
    held = {}

    def slices(run_steps, nsteps, dev):
        events = _PROFILED(run_steps, nsteps, dev)
        held["slice2"] = profile_slice(run_steps, nsteps, dev)
        held["slice3"] = count_slice(run_steps, nsteps, dev,
                                     int(cell.traffic["rsplit"]))
        return events

    with mock.patch.object(tracing, "run_slice", slices):
        result, lines = run.run_cell(cell, seed, seconds, True, device)
    suffix = ".dispatch" if "step_ms.dispatch" in {
        m["name"] for m in cell.end_to_end} else ""
    ctx = argparse.Namespace(base=cell.base, **held)
    for name, read in METRICS.items():
        value = read(ctx)
        if value is not None:
            result["metrics"][name + suffix] = {
                "value": float(value), "unit": UNITS.get(name, "ms/step")}
    for line in notes(held.get("slice2"), held.get("slice3")):
        print(line, file=sys.stderr)
    if "slice2" in held:
        result["breakdown"]["idle_gaps"] = held["slice2"].idle_gaps()
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"benchmark.spans: {args.workload} needs {cell.chips} CUDA "
              f"card(s)", file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds,
                             torch.device("cuda", 0))
    print(f"card: {run.card()}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
