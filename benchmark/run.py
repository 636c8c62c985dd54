"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A run makes its inputs from ``--seed``, sets the program up, warms up the
cell's shapes (``warmup_steps`` steps of the cadence, a remap among them),
then runs the cadence for ``--seconds`` of wall time: eager dispatch, one
device synchronisation at each end of the window, a CUDA event after every
step. The window pauses once, around the period the check reads, whose
two steps and host copies count in no time (``run_window``). With
``--trace 1`` the ``trace_steps`` steps after the window run under the
profiler and the per-layer metrics are read from that trace. Then the
program's state is freed and the reference judges what the timed path
produced (``check.py``). The last line of standard output is one JSON
object; the numbers compared, each beside its limit, are the last lines of
standard error and the result's last key.

It exits 2 without a result where the cell's cards are not there, and 3
where ``jax``, ``jaxlib``, ``flax`` or ``tinman_sandbox_tpu`` (by whole
top-level name) was loaded.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

os.environ.setdefault("OMP_NUM_THREADS", "4")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import capture, check, inputs, program, readers, spec  # noqa: E402
from . import trace as tracing  # noqa: E402
from .reference import grid as G  # noqa: E402

_T_IMPORTS = time.perf_counter()

FORBIDDEN = ("jax", "jaxlib", "flax", "tinman_sandbox_tpu")
GIB = 2.0 ** 30


def card() -> str | None:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def sample(seed: int, traffic: dict, rsplit: int) -> int:
    """The checked cadence period, drawn from the seed: a step j among the
    window's first ``sample_within`` steps whose next step remaps."""
    warm = int(traffic["warmup_steps"])
    steps = [n for n in range(warm + 1, warm + int(traffic["sample_within"]))
             if (n + 1) % rsplit == 0]
    return random.Random(seed).choice(steps)


class Clock:
    """The window's clocks: the host's wall clock, sync to sync, and a mark
    after every step, a CUDA event on the card (the host clock on the CPU,
    in tests). The window can close and open again: what runs while it is
    closed counts in neither clock. ``step_times`` reads the gaps, each
    with its step's number, once the window has closed."""

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.wall = 0.0
        self.stretches = []         # [(step number, mark)] of each opening
        self._opened = None

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def open(self, n: int) -> None:
        """Open after step ``n``."""
        sync(self.device)
        self._opened = time.perf_counter()
        self.stretches.append([(n, self._now())])

    def mark(self, n: int) -> None:
        """Step ``n`` has been issued."""
        self.stretches[-1].append((n, self._now()))

    def close(self) -> None:
        sync(self.device)
        self.wall += time.perf_counter() - self._opened
        self._opened = None

    def timed_s(self) -> float:
        """Seconds the window has been open."""
        return self.wall + (time.perf_counter() - self._opened
                            if self._opened is not None else 0.0)

    def step_times(self) -> list:
        """(step number, ms) of every timed step."""
        out = []
        for marks in self.stretches:
            for (_, a), (n, b) in zip(marks, marks[1:]):
                out.append((n, a.elapsed_time(b) if self.cuda
                            else (b - a) * 1e3))
        return out


def periods_ms(step_times: list, rsplit: int) -> list:
    """Each whole cadence period's time over ``rsplit``: a period is
    ``rsplit`` consecutive timed steps that end with a remap step (its
    number a multiple of ``rsplit``), so each holds its remap."""
    ms = dict(step_times)
    return [sum(ms[n - i] for i in range(rsplit)) / rsplit
            for n in sorted(ms) if n % rsplit == 0
            and all(n - i in ms for i in range(rsplit))]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(step, prog, state: list, n: int, j: int, rsplit: int,
               seconds: float, clock: Clock, caps) -> int:
    """The timed window from ``state`` [s, qdp, acc, phi] after step ``n``,
    advanced in place (so that no older state stays referenced): step
    after step, a mark after each, until ``seconds`` of open window have
    passed beyond the checked period. At step ``j`` the window closes, the
    check's copies of the state before step j and after steps j and j + 1
    are taken around those two steps, and the window opens again: those
    two steps count in neither clock. Returns the last step's number."""
    def advance(n):
        state[:] = step(prog, *state[:3], n % rsplit == 0)

    clock.open(n)
    while True:
        n += 1
        if n == j:
            clock.close()
            caps.take("in", capture.state_arrays(*state[:3], None))
            advance(j)
            caps.take("out", capture.state_arrays(*state))
            advance(j + 1)
            caps.take("out2", capture.state_arrays(*state))
            n = j + 1
            clock.open(n)
            continue
        advance(n)
        clock.mark(n)
        if n > j + 1 and clock.timed_s() >= seconds:
            break
    clock.close()
    return n


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t0: float = _T0, step=program.step,
             control: bool = False) -> tuple:
    """Run ``cell`` once. Returns (result dict, the check's lines).
    ``step`` is the cadence's step (a test hands a broken one); with
    ``control`` the result also holds the control's numbers from the same
    inputs (``check.readings(control=True)``) under "control"."""
    cfg, traffic = cell.config, cell.traffic
    ne, nlev, qsize = int(cfg["ne"]), int(cfg["nlev"]), int(cfg["qsize"])
    nelem = 6 * ne * ne
    rsplit = int(traffic["rsplit"])
    warm = int(traffic["warmup_steps"])
    marks = [("imports", _T_IMPORTS), ("cell and card check",
                                         time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    mark("cuda init")
    caps = capture.Captures(capture.layout(nlev, qsize), nelem * 16, device)
    grid = G.build(ne)
    levels = G.eta_levels(nlev)
    mark("sphere")
    program.build_kernels(device)
    mark("kernel build")
    raw = inputs.draw(seed, nelem, nlev, qsize, levels, device)
    mark("draw")
    prog, s, qdp, acc = program.setup(grid, levels, raw, cfg, device)
    sync(device)
    mark("program set-up")
    del raw
    j = sample(seed, traffic, rsplit)
    caps.take("start", capture.state_arrays(s, qdp, acc, None))
    mark("the check's copy of start")
    n = 0
    for _ in range(warm):
        n += 1
        s, qdp, acc, phi = step(prog, s, qdp, acc, n % rsplit == 0)
        if n == 1:
            caps.take("first", capture.state_arrays(s, qdp, acc, phi))
    sync(device)
    mark("warm-up")
    caps.wait()
    mark("the check's mapping of its set-up buffers")
    setup_s = time.perf_counter() - t0
    print("set-up: " + ", ".join(
        f"{name} {b - a:.3f} s" for (_, a), (name, b) in
        zip([("start", t0)] + marks, marks))
        + f" (of which the check's copy of first "
          f"{caps.seconds['first']:.3f} s); the check's host buffers "
          f"{caps.nbytes / 1e9:.3f} GB", file=sys.stderr)

    clock = Clock(device)
    t_window = time.perf_counter()
    state = [s, qdp, acc, phi]
    del s, qdp, acc, phi
    n = run_window(step, prog, state, n, j, rsplit, seconds, clock, caps)
    s, qdp, acc, phi = state
    del state
    paused = time.perf_counter() - t_window - clock.wall
    times = clock.step_times()
    steps = len(times)
    step_ms = clock.wall * 1e3 / steps
    gaps = [ms for _, ms in times]
    periods = periods_ms(times, rsplit)
    # the program's own peak: nothing of the check is on the card
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    # the chain the window left: every value finite (one reduction, after
    # the window's close)
    finite = bool(torch.isfinite(s).all()) and bool(torch.isfinite(qdp).all())
    traced = None
    if trace:
        state = [s, qdp, acc, n]

        def run_steps(k):
            for _ in range(k):
                state[3] += 1
                state[0], state[1], state[2], _ = step(
                    prog, *state[:3], state[3] % rsplit == 0, spans=True)

        k = int(traffic["trace_steps"])
        traced = tracing.read(tracing.run_slice(run_steps, k, device), k)
        del state
    del s, qdp, acc, phi, prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def draw():
        return inputs.draw(seed, nelem, nlev, qsize, levels, device)

    nums = check.readings(grid, levels, cfg, rsplit, draw, caps.buffers,
                          device)
    if control:
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        cnums = check.readings(grid, levels, cfg, rsplit, draw, caps.buffers,
                               device, control=True)
    check_peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    print(f"check: {time.perf_counter() - t_check:.3f} s, device peak "
          f"{check_peak / GIB:.3f} GiB, {check.block_size(nelem, nlev)} "
          f"tracers a block", file=sys.stderr)
    correct = check.verdict(nums, cell.limits) and finite
    failed = sum(1 for part in ("start", "first", "step", "remap")
                 if any(v > cell.limits.get(k, -1.0)
                        for k, v in nums.items() if k.split(".")[0] == part))

    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": steps,
              "failed": failed}
    if trace:
        shape = dict(nelem=nelem, nlev=nlev, qsize=qsize,
                     qsplit=int(cfg["qsplit"]), rsplit=rsplit,
                     subcycle=int(cfg["hypervis_subcycle"])
                     if float(cfg["nu"]) else 0)
        metrics = {}
        for m in cell.per_layer:
            ctx = readers.Context(traced, shape, step_ms, gaps, periods,
                                  cell.base, m["name"])
            value = spec.reader(m["name"], cell.base)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info["busy_s"] = traced.busy_s
        dev_info["window_s"] = traced.window_s
        result["metrics"] = metrics
        result["device"] = dev_info
        result["breakdown"] = {"device_ops": traced.top_ops(),
                               "idle_gaps": traced.idle_gaps()}
    else:
        # by base name: a cell whose steps wait on the host's dispatch
        # reports its step time as step_ms.dispatch, under a bound of its
        # own
        e2e = {"step_ms": step_ms,
               "step_p95_ms": float(np.percentile(gaps, 95)),
               "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        result["metrics"] = {
            m["name"]: {"value": e2e[m["name"].split(".")[0]],
                        "unit": m["unit"]} for m in cell.end_to_end}
        result["device"] = dev_info
    if control:
        result["control"] = cnums
    result["check"] = {k: [v, cell.limits.get(k)] for k, v in nums.items()}
    print(f"window: {steps} steps in {clock.wall:.6f} s, "
          f"{len(periods)} whole cadence periods, period median "
          f"{statistics.median(periods) if periods else float('nan'):.6f} "
          f"ms a step; the checked period "
          f"steps {j} and {j + 1}, paused {paused:.3f} s (the check's copies "
          f"in {caps.seconds['in']:.3f} s, out {caps.seconds['out']:.3f} s, "
          f"out2 {caps.seconds['out2']:.3f} s), every tracer; the last state "
          f"{'finite' if finite else 'NOT finite'}", file=sys.stderr)
    lines = [f"check {k}: {v:.6e} limit {cell.limits.get(k)}"
             for k, v in nums.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
              f"card(s); torch sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0))
    print(f"card: {card()}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
