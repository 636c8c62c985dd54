"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A run makes its inputs from ``--seed``, sets the program up, warms up the
cell's shapes (``warmup_steps`` steps of the cadence, a remap among them),
then runs the cadence for ``--seconds`` of wall time: eager dispatch, one
device synchronisation at each end of the window, a CUDA event after every
step. With ``--trace 1`` the ``trace_steps`` steps after the window run
under the profiler and the per-layer metrics are read from that trace.
Then the program's state is freed and the reference judges what the timed
path produced (``check.py``). The last line of standard output is one JSON
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
    """A mark after every step: CUDA events on the card, the host clock
    on the CPU (tests). ``times_ms`` reads the gaps once the window has
    closed."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def times_ms(self) -> list:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    # the check's copies first, so that the peak is theirs plus the
    # program's
    caps = capture.Captures(device, capture.layout(nlev, qsize), nelem * 16)
    mark("capture buffers")
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
    n = 0
    for _ in range(warm):
        n += 1
        s, qdp, acc, phi = step(prog, s, qdp, acc, n % rsplit == 0)
        if n == 1:
            caps.take("first", capture.state_arrays(s, qdp, acc, phi))
    sync(device)
    mark("warm-up")
    setup_s = time.perf_counter() - t0
    print("set-up: " + ", ".join(
        f"{name} {b - a:.3f} s" for (_, a), (name, b) in
        zip([("start", t0)] + marks, marks)), file=sys.stderr)

    # the window
    clock = Clock(device)
    t_open = time.perf_counter()
    clock.mark()
    while True:
        n += 1
        if n == j:
            caps.take("in", capture.state_arrays(s, qdp, acc, None))
        s, qdp, acc, phi = step(prog, s, qdp, acc, n % rsplit == 0)
        clock.mark()
        if n == j:
            caps.take("out", capture.state_arrays(s, qdp, acc, phi))
        elif n == j + 1:
            caps.take("out2", capture.state_arrays(s, qdp, acc, phi))
        if n > j + 1 and time.perf_counter() - t_open >= seconds:
            break
    sync(device)
    wall = time.perf_counter() - t_open
    steps = n - warm
    times = clock.times_ms()
    step_ms = wall * 1e3 / steps
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    # the program's own peak: the check's buffers lived through all of it
    program_peak = peak - caps.nbytes

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
    taken = caps.taken_buffers()
    del s, qdp, acc, phi, prog, caps
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    raw = inputs.draw(seed, nelem, nlev, qsize, levels, device)
    nums = check.readings(grid, levels, cfg, rsplit, raw, taken, device)
    if control:
        cnums = check.readings(grid, levels, cfg, rsplit, raw, taken,
                               device, control=True)
    del raw, taken
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
            ctx = readers.Context(traced, shape, step_ms, times, cell.base,
                                  m["name"])
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
               "step_p95_ms": float(np.percentile(times, 95)),
               "peak_mem_gib": program_peak / GIB, "setup_s": setup_s}
        result["metrics"] = {
            m["name"]: {"value": e2e[m["name"].split(".")[0]],
                        "unit": m["unit"]} for m in cell.end_to_end}
        result["device"] = dev_info
    if control:
        result["control"] = cnums
    result["check"] = {k: [v, cell.limits.get(k)] for k, v in nums.items()}
    print(f"window: {steps} steps in {wall:.6f} s, the checked period "
          f"steps {j} and {j + 1}, every tracer; the last state "
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
