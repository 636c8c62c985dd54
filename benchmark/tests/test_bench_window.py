"""The window's pause and the blocked check on the CPU: the check judging
the tracers block by block from host captures gives the whole-array
check's numbers bit for bit; the checked period runs while the window is
closed and counts in neither clock; the median over cadence periods
follows the steps and not a few stalls; the ne120 cell loads."""
from __future__ import annotations

import statistics
import types

import pytest
import torch

from benchmark import capture, check, inputs, program, run, spec
from benchmark.reference import grid as G, layout, step as ref
from benchmark.reference.tf32 import TF32
from benchmark.tests import tiny

CPU = torch.device("cpu")
SEED = 2 ** 32 + 123
QSIZE = 5
J = 5                       # the checked step; J + 1 remaps (rsplit 3)


@pytest.fixture(scope="module")
def captured():
    """A tiny run's captures, taken by the window's own code."""
    cell = tiny.cell(qsize=QSIZE)
    cfg = cell.config
    grid, levels = G.build(cfg["ne"]), G.eta_levels(cfg["nlev"])
    nelem, nlev = grid["nelem"], cfg["nlev"]
    raw = inputs.draw(SEED, nelem, nlev, QSIZE, levels, CPU)
    prog, s, qdp, acc = program.setup(grid, levels, raw, cfg, CPU)
    caps = capture.Captures(capture.layout(nlev, QSIZE), nelem * 16, CPU)
    caps.take("start", capture.state_arrays(s, qdp, acc, None))
    s, qdp, acc, phi = program.step(prog, s, qdp, acc, False)
    caps.take("first", capture.state_arrays(s, qdp, acc, phi))
    run.run_window(program.step, prog, [s, qdp, acc, phi], 1, J, 3, 0.0,
                   run.Clock(CPU), caps)
    return grid, levels, cfg, raw, caps.buffers


def _whole(grid, levels, config, raw, caps, control, tracer_block):
    """The check with every capture's tracers converted whole, as it was
    before the blocked check: the numbers the blocked one has to give."""
    nelem, nlev = grid["nelem"], int(config["nlev"])
    S = ref.Sphere(grid, torch.float64, CPU)

    def init(S, raw):
        st = {k: S.project(raw[k].to(S.dtype)) for k in check.FIELDS + ("q",)}
        for k in check.ACC:
            st[k] = torch.zeros_like(st["u"])
        return st

    r0 = init(S, raw)
    consts = dict(phis=raw["phis"].double(), pecnd=torch.zeros_like(r0["u"]))
    target = ref.air_mass(S, r0["dp"])

    def load(key):
        cap = caps[key]

        def f(x):
            return layout.unpack(x, nelem).double()

        st = {k: v.double() for k, v in
              layout.unpack_state(cap["s"], nelem, nlev).items()}
        st["q"] = layout.unpack_tracers(cap["qdp"], nelem, nlev).double()
        for k in check.ACC:
            st[k] = f(cap[k])
        return st, (f(cap["phi"]) if "phi" in cap else None)

    if control:
        S32 = ref.Sphere(grid, torch.float32, CPU)
        consts32 = {k: v.float() for k, v in consts.items()}
        with TF32():
            c0 = init(S32, {k: v.float() for k, v in raw.items()})
            cmass = ref.air_mass(S32, c0["dp"])

        def candidate(key, inp, remap_step):
            st = c0 if inp is None else {k: v.float() for k, v in inp.items()}
            with TF32():
                return ref.model_step(S32, levels, st, consts32, config,
                                      remap_step, cmass, tracer_block)
        start = c0
    else:
        def candidate(key, inp, remap_step):
            return load(key)
        start = load("start")[0]
    nums = {"start": check.start_number(r0, start)}
    for name, key, src in (("first", "first", None), ("step", "out", "in"),
                           ("remap", "out2", "out")):
        inp = r0 if src is None else load(src)[0]
        out, phi = ref.model_step(S, levels, inp, consts, config,
                                  name == "remap", target, tracer_block)
        cand, cphi = candidate(key, None if src is None else inp,
                               name == "remap")
        for k, v in check.step_numbers(inp, out, phi, cand, cphi).items():
            nums[f"{name}.{k}"] = v
    return nums


@pytest.mark.parametrize("control", [False, True])
@pytest.mark.parametrize("block", [1, 3, QSIZE])
def test_the_blocked_check_is_the_whole_array_check_bit_for_bit(
        captured, block, control):
    grid, levels, cfg, raw, caps = captured
    blocked = check.readings(grid, levels, cfg, 3, lambda: raw, caps, CPU,
                             control=control, tracer_block=block)
    whole = _whole(grid, levels, cfg, raw, caps, control, block)
    assert list(blocked) == list(whole) == tiny.NAMES
    assert blocked == whole


def test_the_block_size_bounds_a_block_in_float64():
    assert check.block_size(5400, 72) == check.TRACER_BLOCK
    ne120 = check.block_size(86400, 72)
    assert 1 <= ne120 < check.TRACER_BLOCK
    assert ne120 * 86400 * 72 * 16 * 8 <= check.BLOCK_BYTES


class _Clock(run.Clock):
    """The host clock on the CPU with a log, and a fake time: each step
    takes 1 s of open window."""

    def __init__(self, log):
        super().__init__(CPU)
        self.log = log

    def open(self, n):
        super().open(n)
        self.log.append(("open", n))

    def mark(self, n):
        super().mark(n)
        self.log.append(("mark", n))

    def close(self):
        super().close()
        self.log.append(("close",))

    def timed_s(self):
        return float(sum(1 for e in self.log if e[0] == "mark"))


class _Captures(capture.Captures):
    def __init__(self, log):
        super().__init__(capture.layout(1, 1), 1, CPU)
        self.log = log

    def take(self, key, arrays):
        self.log.append(("take", key))
        super().take(key, arrays)


def test_the_checked_period_runs_while_the_window_is_closed():
    log, chain = [], []

    def step(prog, s, qdp, acc, remap, spans=False):
        n = int(s[0, 0]) + 1
        chain.append((n, remap))
        return s + 1, qdp + 1, acc, torch.full((1, 1), float(n))

    warm, seconds = 3, 20
    state = [torch.full((4, 1), float(warm)), torch.zeros(1, 1),
             tuple(torch.zeros(1, 1) for _ in range(3)), None]
    clock, caps = _Clock(log), _Captures(log)
    n = run.run_window(step, None, state, warm, J + 3, 3, seconds, clock,
                       caps)
    s = state[0]
    j = J + 3
    # the chain: every step once, in order, the remap every third
    assert chain == [(k, k % 3 == 0) for k in range(warm + 1, n + 1)]
    assert int(s[0, 0]) == n
    # no copy while the window is open
    is_open = False
    for e in log:
        if e[0] in ("open", "close"):
            is_open = e[0] == "open"
        assert not (e[0] == "take" and is_open), log
    assert [e for e in log if e[0] == "take"] == [
        ("take", "in"), ("take", "out"), ("take", "out2")]
    # the two checked steps are in neither the count nor the gaps
    timed = [k for k, _ in clock.step_times()]
    assert timed == [e[1] for e in log if e[0] == "mark"]
    assert timed == [k for k in range(warm + 1, n + 1)
                     if k not in (j, j + 1)]
    assert len(timed) == seconds
    # the captured states: before step j, after j and after j + 1
    bufs = caps.buffers
    assert [float(bufs[k]["s"][0, 0]) for k in ("in", "out", "out2")] == \
        [j - 1, j, j + 1]
    assert float(bufs["out"]["phi"][0, 0]) == j
    assert float(bufs["out2"]["qdp"][0, 0]) == j + 1 - warm


def _median(times, rsplit=3):
    ctx = types.SimpleNamespace(periods_ms=run.periods_ms(times, rsplit))
    return spec.reader("step_median_ms.dispatch")(ctx)


def _steps(ms, remap_ms, first=4, last=3004, skip=()):
    return [(n, remap_ms if n % 3 == 0 else ms)
            for n in range(first, last + 1) if n not in skip]


def test_a_period_is_whole_and_holds_its_remap():
    # steps 4 .. 14 with the checked pair 8, 9 left out: whole periods
    # end at 6 (4, 5, 6) and 12, 15 has no step 15
    times = _steps(1.0, 4.0, 4, 14, skip=(8, 9))
    assert run.periods_ms(times, 3) == [2.0, 2.0]


def test_the_period_median_moves_with_every_step():
    base = _median(_steps(1.5, 2.1))
    assert base == pytest.approx((1.5 + 1.5 + 2.1) / 3, rel=1e-12)
    assert _median(_steps(1.5 * 1.2, 2.1 * 1.2)) == \
        pytest.approx(1.2 * base, rel=1e-12)
    # a remap step 0.3 ms slower moves it by its share, 0.1 ms
    assert _median(_steps(1.5, 2.4)) == pytest.approx(base + 0.1, rel=1e-12)


def test_stalls_in_a_tenth_of_the_periods_leave_the_median():
    times = dict(_steps(1.5, 2.1))
    for k, n in enumerate(sorted(times)):
        if n % 3 == 1 and (n // 3) % 10 == 0:
            times[n] += 5.0 + k % 7         # one stalled step in the period
    stalled = sorted(times.items())
    base = _median(_steps(1.5, 2.1))
    assert abs(_median(stalled) / base - 1) <= 0.01
    mean = statistics.mean(ms for _, ms in stalled)
    assert mean / base - 1 > 0.1            # the window mean does move


def test_the_ne120_configuration_and_cell():
    cell = spec.load_cell("ne120_e3sm_q35")
    cfg = {k: v for k, v in cell.config.items() if k != "name"}
    spec.check_config(cfg)
    assert (cfg["ne"], cfg["nelem"], cfg["nlev"], cfg["qsize"]) == \
        (120, 86400, 72, 35)
    assert cfg["qsize"] * cfg["nlev"] * cfg["nelem"] * 16 > 2 ** 31
    assert cell.chips == 1 and cell.traffic["name"] == "cadence_rsplit3"
    q35 = spec.load_cell("ne30_e3sm_q35")
    assert [m["name"] for m in cell.end_to_end] == \
        [m["name"] for m in q35.end_to_end]
    assert [m["name"] for m in cell.per_layer] == \
        [m["name"] for m in q35.per_layer]
    assert sorted(cell.limits) == sorted(tiny.NAMES)
