"""Stage breakdown of the packed full model step on the card (counterpart of
the JAX repository's ``tools/profile_prim.py``).

    python -m tinman_sandbox_tpu_torch.tools.profile_prim [--ne 30] \
        [--nlev 72] [--qsize 35] [--nu 1e15] [--limit] [--nexec 30] \
        [--gate]
    python -m tinman_sandbox_tpu_torch.tools.profile_prim --device cpu \
        --ne 2 --nlev 4 --qsize 2 --nexec 1

Times the stages of ``dist.prim_step_packed_t4`` apart, each a chain of
``--nexec`` calls from one start (each call's output the next one's
input), under the JAX tool's names, one JSON line a stage:

  * ``ssprk3_dynamics``: ``ssprk3_packed_t4`` (3 stage-mode CAAR launches,
    fixups and sweeps);
  * ``hyperviscosity``: ``apply_hypervis_packed_t`` at ``--nu`` (2 weak
    Laplacians, fixups and sweeps), in place on a copy of the state;
  * ``tracers_q{Q}``: one SSPRK3 tracer substep ``ssprk3_tracer_packed_t``
    on the ``--qsize`` stacked tracers, riding the state's winds, limited
    with ``--limit``;
  * the sub-stage split of the tracers: ``tracer_kernel_q{Q}`` (the Euler
    kernel with its slab, ``tracer_euler_cuda``) and ``tracer_dss_q{Q}``
    (fixup and sweep with the stage-2 ``mix``,
    ``dss_structured_t_cuda_pre``); with ``--limit`` also
    ``tracer_limit_kernel_q{Q}`` (the limited kernel with the stage-2
    combination and its slab, ``tracer_limit_cuda``), which the JAX tool
    does not split out;
  * ``prim_step``: one chained ``prim_step_packed_t4`` (dynamics,
    hyperviscosity, one substep), printed with ``sum_us`` (the three
    stages' sum): the gap between the sum and the composed step is
    measured, not assumed.

Each stage line holds the JAX tool's ``us_per_call`` (CUDA events over the
chain, a sync at the end) and ``ggp_per_s``, and ``graph_us_per_call``
(the chain replayed from a CUDA graph: the device alone; null, with the
reason, where the chain's memory would not fit twice), ``host_us_per_call``
(the host's time to issue it), the kernel launches a call and the card's
name and power limit (``bench.card_name_and_power``). The last line holds
the sum, the composed step, the peak device memory and the card
(``profiling.stage_time`` makes every time).

The problem is ``bench.make_prim_problem`` (state seed 7, the n0 state and
the tracers projected onto the continuous space, two-float rspheremp, dt
0.1): from ``bench.DIRECT_NELEM`` elements on it is drawn on the card, and
the unpacked [tl, nelem, nlev, 4, 4] state that the JAX tool builds on the
host is never made. ``--gate`` adds the checks that the plain versions
cannot make at full width (ne120 x qsize 35 is a [2520, 1,382,400] stack,
13.9 GB a copy): one launch each of the Euler and the limited kernels at a
step long enough for the divergence to carry the output, against their
plain versions on the last 8,192 elements' lanes (all of a smaller
sphere's; the kernels are element-local) at 5e-5 a tracer block, the
slabs bit for bit; and one limited
SSPRK3 tracer step with continuity exactly 0, the tracers' relative mass
change (float64 sums) within 4e-6 and min qdp >= -1e-6.
A failed gate raises.

The tool runs on the card; ``--device cpu`` runs the plain versions with
wall-clock times (the CPU tests' mode). Without a card and without
``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import json

import torch

__all__ = ["problem", "dynamics_call", "hypervis_call", "tracers_call",
           "compose", "stages", "gates", "launches_of", "time_stages", "main",
           "DT", "GATE_ELEMS", "GATE_TOL", "MASS_TOL", "QDP_MIN"]

DT = 0.1                 # the JAX tool's step
GATE_ELEMS = 8192        # the gated block: the last elements' lanes
GATE_TOL = 5e-5          # a kernel against its plain version, a tracer block
MASS_TOL = 4e-6          # the limited step's relative tracer-mass change
QDP_MIN = -1e-6          # the limiter's bounds gate on a zero lower bound


def problem(ne: int, nlev: int, qsize: int, device, dt: float = DT):
    """``bench.make_prim_problem`` at ne (seed 7) and the cubed sphere's
    dof map: (const, s0, qdp, acc, plan, rsp, gdof), const = (scal, meta,
    pecnd, dvv)."""
    from ..bench import make_prim_problem
    from ..dist import build_cubed_sphere

    cs = build_cubed_sphere(ne, dtype=torch.float32, device=device)
    return (*make_prim_problem(ne, nlev, device, dt, qsize, cs=cs), cs.gdof)


def dynamics_call(const, s, qdp, acc, plan, rsp):
    """The dynamics stage of ``prim_step_packed_t4``: one
    ``ssprk3_packed_t4`` from s (the accumulators ``acc`` in place).
    Returns (s_np1, phi)."""
    from ..dist.step_t import ssprk3_packed_t4

    scal, meta, pecnd, dvv = const
    s1, phi, *_ = ssprk3_packed_t4(scal, meta, s, qdp[:s.shape[0] // 4],
                                   pecnd, *acc, dvv, plan, rsp)
    return s1, phi


def hypervis_call(const, s, plan, rsp, nu: float, dt: float):
    """The hyperviscosity stage: ``apply_hypervis_packed_t`` in place on
    the whole [4*nlev] state s."""
    from ..dist.step_t import apply_hypervis_packed_t

    _, meta, _, dvv = const
    return apply_hypervis_packed_t(dvv, meta, s, plan, rsp, nu, dt,
                                   s.shape[0] // 4)


def tracers_call(const, s, q, plan, rsp, dt: float, limit: bool):
    """The tracer stage: one ``ssprk3_tracer_packed_t`` substep of q riding
    the winds of the state s (its row blocks 0 and 1)."""
    from ..dist.step_t import ssprk3_tracer_packed_t

    _, meta, _, dvv = const
    return ssprk3_tracer_packed_t(dvv, meta, s, s, q, plan, rsp, dt,
                                  s.shape[0] // 4, limit=limit,
                                  wind_rows=(0, 1))


def compose(const, s0, qdp, acc, plan, rsp, nu: float, dt: float,
            limit: bool):
    """The three stages chained as the step chains them (dynamics, then
    hyperviscosity on its output, then the tracers on the new winds):
    (s_np1, qdp', phi), one ``prim_step_packed_t4`` with qsplit 1 (the
    accumulators ``acc`` in place)."""
    s1, phi = dynamics_call(const, s0, qdp, acc, plan, rsp)
    if nu:
        s1 = hypervis_call(const, s1, plan, rsp, nu, dt)
    return s1, tracers_call(const, s1, qdp, plan, rsp, dt, limit), phi


def stages(const, s0, qdp, acc, plan, rsp, nu: float, dt: float,
           limit: bool):
    """The stages in order, as (name, chain): chain(n) runs n chained calls
    from the problem's start and returns the last output. A generator: a
    stage's own operands (the closer's Euler output, the hyperviscosity's
    copy of the state) are made before it is handed out and let go when
    the next stage is asked for (a chain called later makes them again),
    so that at ne120 x qsize 35 no stage holds a 13.9 GB copy for another.
    The accumulators advance in place on copies; the inputs are not
    modified."""
    import numpy as np

    from ..dist.step_t import prim_step_packed_t4
    from ..kernels.dss import dss_structured_t_cuda_pre, fix_tables
    from ..kernels.tracer_t import tracer_euler_cuda, tracer_limit_cuda

    scal, meta, pecnd, dvv = const
    nlev = s0.shape[0] // 4
    qtag = f"q{qdp.shape[0] // nlev}"
    fix = fix_tables(plan, s0.device)
    kacc = [a.clone() for a in acc]
    f = np.float32 if s0.dtype == torch.float32 else np.float64
    mix = (qdp, f(0.75), f(0.25))

    def dynamics(n):
        s = s0
        for _ in range(n):
            s, _ = dynamics_call(const, s, qdp, kacc, plan, rsp)
        return s

    yield "ssprk3_dynamics", dynamics
    held = {}

    def state_copy():
        if "s" not in held:
            held["s"] = s0.clone()
        return held["s"]

    def hypervis(n):
        s = state_copy()
        for _ in range(n):
            hypervis_call(const, s, plan, rsp, nu, dt)
        return s

    state_copy()
    yield "hyperviscosity", hypervis
    held.clear()

    def tracers(n):
        q = qdp
        for _ in range(n):
            q = tracers_call(const, s0, q, plan, rsp, dt, limit)
        return q

    yield f"tracers_{qtag}", tracers

    def euler(n):
        q = qdp
        for _ in range(n):
            q, _ = tracer_euler_cuda(meta, s0, s0, q, dvv, dt, nlev,
                                     wind_rows=(0, 1), fix=fix)
        return q

    yield f"tracer_kernel_{qtag}", euler

    def limited(n):
        q = qdp
        for _ in range(n):
            q, _ = tracer_limit_cuda(meta, s0, s0, q, dvv, dt, nlev, mix=mix,
                                     wind_rows=(0, 1), fix=fix)
        return q

    if limit:
        yield f"tracer_limit_kernel_{qtag}", limited

    def euler_output():
        """The closer's operands: one Euler stage's output and slab."""
        if "e" not in held:
            held["e"] = tracer_euler_cuda(meta, s0, s0, qdp, dvv, dt, nlev,
                                          wind_rows=(0, 1), fix=fix)
        return held["e"]

    def closer(n):
        q, slab = euler_output()
        for _ in range(n):
            q = dss_structured_t_cuda_pre(q, slab, plan, rsp, mix=mix)
        return q

    euler_output()
    yield f"tracer_dss_{qtag}", closer
    held.clear()

    def prim(n):
        s, q = s0, qdp
        for _ in range(n):
            s, q, _, *_ = prim_step_packed_t4(
                scal, meta, s, q, pecnd, *kacc, dvv, plan, rsp, nu, nlev,
                limit_tracers=limit, dt=dt)
        return q

    yield "prim_step", prim


def _block_err(got, want, nlev: int) -> float:
    """The worst scaled max-abs error of a tracer block."""
    worst = 0.0
    for a, b in zip(got.split(nlev), want.split(nlev)):
        b = b.double()
        worst = max(worst, float((a.double() - b).abs().max())
                    / max(float(b.abs().max()), 1e-300))
    return worst


def gates(const, s0, qdp, plan, rsp, dt: float, gdof,
          elems: int = GATE_ELEMS) -> dict:
    """The full-width checks of ``--gate`` (module docstring); raises
    AssertionError on a failure. Returns what they measured."""
    from ..dist.dss import continuity_error_t
    from ..dist.step_t import ssprk3_tracer_packed_t
    from ..kernels.dss import fix_tables
    from ..kernels.layout import META_COLS
    from ..kernels.tracer_t import (
        tracer_euler_cuda, tracer_euler_plain, tracer_limit_cuda,
        tracer_limit_plain)

    _, meta, _, dvv = const
    nlev = s0.shape[0] // 4
    e16 = qdp.shape[1]
    fix = fix_tables(plan, s0.device)
    lanes = slice(max(e16 - elems * 16, 0), e16)
    blk = lambda x: x[:, lanes].contiguous()
    bq, bs, bm = blk(qdp), blk(s0), blk(meta)
    # a step long enough for dt*div to be ~ half of q (at the run's dt the
    # divergence sits below f32 resolution of q), on the gated block
    div = bq - tracer_euler_plain(bm, bs, bs, bq, dvv, 1.0, nlev,
                                  fold_sph=False, wind_rows=(0, 1))
    dt_long = 0.5 * float(bq.abs().max()) / float(div.abs().max())
    del div
    read = fix.read_lanes.long()
    out = {"dt_long": dt_long, "gate_elems": (e16 - lanes.start) // 16}
    # the limited kernel with the stage-2 combination, its mx the input
    for name, kernel, plain, kw, bkw in (
            ("euler", tracer_euler_cuda, tracer_euler_plain, {}, {}),
            ("limit", tracer_limit_cuda, tracer_limit_plain,
             {"mix": (qdp, 0.75, 0.25)}, {"mix": (bq, 0.75, 0.25)})):
        got, slab = kernel(meta, s0, s0, qdp, dvv, dt_long, nlev,
                           wind_rows=(0, 1), fix=fix, **kw)
        if not torch.equal(slab, got[:, read].T):
            raise AssertionError(f"gate {name}: the slab is not the output "
                                 "at the fix lanes")
        del slab
        got = blk(got)
        want = plain(bm, bs, bs, bq, dvv, dt_long, nlev, wind_rows=(0, 1),
                     **bkw)
        err = _block_err(got, want, nlev)
        del got, want
        out[f"{name}_block_err"] = err
        if not err <= GATE_TOL:
            raise AssertionError(f"gate {name}: {err} > {GATE_TOL}")
    del bq, bs, bm
    q1 = ssprk3_tracer_packed_t(dvv, meta, s0, s0, qdp, plan, rsp, dt, nlev,
                                limit=True, wind_rows=(0, 1))
    sph = meta[META_COLS.index("spheremp")].double()
    worst_mass = 0.0
    for a, b in zip(q1.split(nlev), qdp.split(nlev)):
        m0, m1 = float((b.double() * sph).sum()), float((a.double()
                                                         * sph).sum())
        worst_mass = max(worst_mass, abs(m1 - m0) / abs(m0))
    cont = continuity_error_t(q1, gdof, rows=nlev)
    out.update(continuity=cont, mass_rel_change=worst_mass,
               min_qdp=float(q1.min()),
               finite=bool(torch.isfinite(q1).all()))
    del q1
    if cont != 0.0 or not out["finite"]:
        raise AssertionError(f"gate step: continuity {cont}, finite "
                             f"{out['finite']}")
    if not worst_mass <= MASS_TOL:
        raise AssertionError(f"gate step: mass {worst_mass} > {MASS_TOL}")
    if not out["min_qdp"] >= QDP_MIN:
        raise AssertionError(f"gate step: min qdp {out['min_qdp']}")
    return out


def launches_of(fn) -> dict:
    """Kernel launches of one call of ``fn``, by wrapper."""
    from ..kernels.caar import caar_packed
    from ..kernels.caar_t import caar_t4_cuda
    from ..kernels.dss import dss_extract_cuda, dss_fixup_cuda, dss_sweep_cuda
    from ..kernels.hypervis_t import vlap_cuda
    from ..kernels.tracer_t import tracer_euler_cuda, tracer_limit_cuda

    ws = (caar_t4_cuda, caar_packed, vlap_cuda, tracer_euler_cuda,
          tracer_limit_cuda, dss_extract_cuda, dss_fixup_cuda,
          dss_sweep_cuda)
    before = [w.launches for w in ws]
    fn()
    return {w.__name__: w.launches - b for w, b in zip(ws, before)
            if w.launches - b}


def time_stages(stage_iter, nexec: int, device, card,
                rename=None, gridpoints=None, reps=None, graph=True) -> list:
    """One line a stage of ``stage_iter`` ({name: {...}}, in its order), each
    timed by ``profiling.stage_time`` as its stage comes (the tools' common
    line: us_per_call, graph_us_per_call or its graph_note,
    host_us_per_call, the clock, the launches of one call, the card);
    ``rename`` maps a stage's name to the name it is printed under;
    ``gridpoints(name)`` adds the JAX tools' ggp_per_s; ``reps`` the timed
    runs (``stage_time``'s, STAGE_REPS by default); without ``graph`` no
    stage is captured in a CUDA graph."""
    from ..profiling import STAGE_REPS, stage_time

    lines = []
    for name, chain in stage_iter:
        launches = launches_of(lambda: chain(1))
        t = stage_time(chain, nexec, device, reps or STAGE_REPS, graph)
        line = {"us_per_call": t["ms"] * 1e3}
        if gridpoints is not None:
            line["ggp_per_s"] = gridpoints(name) / (t["ms"] * 1e-3) / 1e9
        line.update(graph_us_per_call=None if t["graph_ms"] is None
                    else t["graph_ms"] * 1e3,
                    host_us_per_call=t["host_ms"] * 1e3, clock=t["clock"],
                    launches=launches, card=card)
        if t["graph_ms"] is None:
            line["graph_note"] = t["graph_note"]
        lines.append({(rename or {}).get(name, name): line})
    return lines


def run(args) -> list:
    """Every line the tool prints, as dicts."""
    from ..bench import card_name_and_power
    from ..device import resolve_device

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    const, s0, qdp, acc, plan, rsp, gdof = problem(args.ne, args.nlev,
                                                   args.qsize, dev, DT)
    card = card_name_and_power() if cuda else None
    gp = 6 * args.ne ** 2 * 16 * args.nlev
    lines = []
    if args.gate:
        lines.append({"gates": gates(const, s0, qdp, plan, rsp, DT, gdof),
                      "card": card})
    timed = time_stages(
        stages(const, s0, qdp, acc, plan, rsp, args.nu, DT, args.limit),
        args.nexec, dev, card,
        gridpoints=lambda name: gp * (args.qsize if "_q" in name else 1))
    lines += timed
    by_name = {k: v for line in timed for k, v in line.items()}
    parts = [by_name[k] for k in ("ssprk3_dynamics", "hyperviscosity",
                                  f"tracers_q{args.qsize}")]
    step = by_name["prim_step"]
    graphs = [t["graph_us_per_call"] for t in parts]
    total = sum(t["us_per_call"] for t in parts)
    lines.append({
        "sum_us": total, "prim_step_us": step["us_per_call"],
        "gap_us": step["us_per_call"] - total,
        "sum_graph_us": None if None in graphs else sum(graphs),
        "prim_step_graph_us": step["graph_us_per_call"],
        "ne": args.ne, "nlev": args.nlev, "qsize": args.qsize,
        "limit": args.limit, "nu": args.nu, "dt": DT, "nexec": args.nexec,
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev) if cuda
        else None,
        "backend": dev.type, "card": card,
        "note": "prim_step is one chained prim_step_packed_t4; gap_us = "
                "prim_step_us - sum_us, measured in the same run"})
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="tinman_sandbox_tpu_torch.tools.profile_prim",
        description="the stages of the packed full model step timed apart")
    ap.add_argument("--ne", type=int, default=30)
    ap.add_argument("--nlev", type=int, default=72)
    ap.add_argument("--qsize", type=int, default=35)
    ap.add_argument("--nexec", type=int, default=30,
                    help="chained calls a timed run")
    ap.add_argument("--nu", type=float, default=1e15)
    ap.add_argument("--limit", action="store_true",
                    help="the monotone limiter in every tracer stage")
    ap.add_argument("--gate", action="store_true",
                    help="the full-width checks (kernels on a block of "
                         "elements, the limited step's invariants)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: the plain versions, wall-clock times")
    args = ap.parse_args(argv)
    if args.qsize < 1 or args.nexec < 1:
        ap.error("--qsize and --nexec must be at least 1")
    lines = run(args)
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
