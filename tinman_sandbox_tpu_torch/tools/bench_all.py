"""The full benchmark sweep on the card: the reference's benchmark matrix
(SURVEY §6), one JSON report (counterpart of the JAX repository's
``tools/bench_all.py``).

    python -m tinman_sandbox_tpu_torch.tools.bench_all [--out PATH]
    python -m tinman_sandbox_tpu_torch.tools.bench_all --device cpu

Five entries, under the JAX tool's names, at its configurations and seeds:

  * ``caar_1024x72`` and ``caar_single_element_26lev`` (8 elements x 26):
    the row-layout CAAR step ``kernels.caar.caar_packed`` chained on its
    accumulators (vn0u, vn0v, omg), the problem of ``bench.make_problem``
    (random state seed 7, random geometry seed 8, analytic hvcoord, dt2 0.1,
    eta_ave_w 1), 150 steps;
  * ``tracer_128x72_q35``: the row tracer step ``kernels.tracer.euler_packed``
    on 128 elements x 72 levels x 35 tracers (state seed 1, geometry seed 2,
    dt 1e-4), the tracers chained, 100 steps;
  * ``ne30_caar_dss_5400elem``: the row CAAR step then the structured DSS
    (``dist.caar_dss_structured_packed``) on the ne30 cubed sphere (state
    seed 3, dt2 1e-3, eta_ave_w 0.01), chained on the accumulators, 10
    steps. The JAX entry assembles with the alias-gather DSS
    (``make_packed_dss``), array code that the structured DSS covers in the
    port (the same sums; ``tests/test_torch_bench_all.py`` holds one step
    against it): the entry says ``"dss": "structured"``;
  * ``saxpby_triad``: ``kernels.saxpby.saxpby_cuda`` on 8192 x 4096 (rng 0
    and 1), x <- 0.999 x + 0.001 y chained, 50 steps.

Each time is ``chain_time``'s: the marginal seconds a step, the slope
between an n-step and a 3n-step chained loop, best of ``reps`` = 4, each
loop ending in ``torch.cuda.synchronize()``. The report keeps the JAX
tool's keys (``us_per_step``, ``gridpoints_per_s``,
``tracer_gridpoints_per_s``, ``gb_per_s``, ``nelem``) and adds the
backend, the card's name and power limit (``nvidia-smi``), and for each
entry its ``bytes_per_step`` (the port's bench counts: 21 fields for the
CAAR step, 29 fields and the rspheremp column for the assembled step; the
tracer step's 2*qsize + 2 fields and 6 meta rows; the triad's 3 arrays),
``bound_us`` (those bytes over 3.35 TB/s) and the kernels it launched.
These are the H100's numbers; ``BENCH_LOCAL.json`` is a TPU's, not
comparable.

With ``--device cpu`` (the CPU tests' mode) the plain versions run at cut
shapes (CAAR 16 x 8 and 8 x 26, the tracer 8 x 8 x 3, the DSS entry at
ne 2, saxpby 128 x 64) with one step and one repetition (the ``bench_*``
functions take ``n`` and ``reps`` as keywords); its times are the CPU's,
and the report says ``"backend": "cpu"``. Without a card and without ``--device
cpu`` the tool raises.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

__all__ = ["chain_time", "caar_problem", "tracer_problem", "ne30_problem",
           "saxpby_problem", "bench_caar", "bench_tracer", "bench_ne30_dss",
           "bench_saxpby", "main", "HBM_BYTES_PER_S"]

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory, NVIDIA data sheet


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def chain_time(fn, init, n: int, reps: int = 4, device="cuda") -> float:
    """Marginal seconds a step of the chain x <- fn(x) from ``init``: the
    slope between the best of ``reps`` n-step and 3n-step loops, which
    cancels the fixed cost of starting and ending a loop. One call warms up
    first; every loop ends in a device synchronisation."""
    dev = torch.device(device)
    fn(init)
    _sync(dev)

    def run(steps):
        x = init
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            x = fn(x)
        _sync(dev)
        return time.perf_counter() - t0

    best_n = best_3n = float("inf")
    for _ in range(reps):
        best_n = min(best_n, run(n))
        best_3n = min(best_3n, run(3 * n))
    return max((best_3n - best_n) / (2 * n), 1e-9)


def _launches(*wrappers) -> dict:
    return {w.__name__: w.launches for w in wrappers}


def _delta(before: dict, *wrappers) -> dict:
    return {w.__name__: w.launches - before[w.__name__] for w in wrappers}


def caar_problem(nelem: int, nlev: int, device):
    """``bench_caar``'s problem on the row layout: (const, acc), const =
    (scal, meta, u0, v0, t0, dp0, um1, vm1, tm1, dpm1, qdp, pecnd, dvv) of
    [E16, nlev] fields and acc the three accumulators (the JAX tool's
    ``pack_problem`` of ``random_state(seed=7)``, ``random_geometry(seed=8)``
    and ``_scalars(0.1, 1.0, hv)``)."""
    from ..bench import make_problem

    return make_problem(nelem, nlev, device, seed=7, layout="row")


def bench_caar(nelem: int, nlev: int, device="cuda", n: int = 150,
               reps: int = 4) -> dict:
    """``caar_packed`` chained on its accumulators."""
    from ..bench import bytes_per_step
    from ..kernels.caar import caar_packed

    dev = torch.device(device)
    const, acc = caar_problem(nelem, nlev, dev)

    def step(a):
        return caar_packed(*const[:-1], *a, const[-1])[5:8]

    before = _launches(caar_packed)
    per = chain_time(step, acc, n, reps, dev)
    nbytes = bytes_per_step(nelem, nlev)
    return {"us_per_step": per * 1e6,
            "gridpoints_per_s": nelem * nlev * 16 / per,
            "bytes_per_step": nbytes,
            "bound_us": nbytes / HBM_BYTES_PER_S * 1e6,
            "kernel_launches": _delta(before, caar_packed),
            "config": f"{nelem}x{nlev}x16 float32 row layout caar_packed "
                      f"chained n={n} reps={reps}"}


def tracer_problem(nelem: int, nlev: int, qsize: int, device):
    """``bench_tracer``'s problem: (meta, vu, vv, q, dvv) on the row
    layout, q [E16, qsize*nlev] tracer-major (the JAX tool's
    ``random_state(seed=1)``, ``random_geometry(seed=2)``, ``pack_meta``
    with zero phis and ``pack_field`` of the n0 winds)."""
    from .. import Config, random_geometry, random_state
    from ..kernels.layout import pack_field, pack_meta

    dev = torch.device(device)
    cfg = Config(nelem=nelem, nlev=nlev, qsize=qsize)
    kw = dict(dtype=torch.float32, device=dev)
    st = random_state(cfg, seed=1, **kw)
    geom = random_geometry(cfg, seed=2, **kw)
    meta = pack_meta(geom, torch.zeros(nelem, 4, 4, **kw), torch.float32)
    q = st.qdp[0].permute(0, 3, 4, 1, 2).reshape(nelem * 16, qsize * nlev)
    return (meta, pack_field(st.u[0]), pack_field(st.v[0]), q.contiguous(),
            geom.dvv.to(torch.float32).contiguous())


def bench_tracer(nelem: int = 128, nlev: int = 72, qsize: int = 35,
                 device="cuda", n: int = 100, reps: int = 4,
                 dt: float = 1e-4) -> dict:
    """``euler_packed`` with the tracers chained."""
    from ..kernels.tracer import euler_packed

    dev = torch.device(device)
    meta, vu, vv, q, dvv = tracer_problem(nelem, nlev, qsize, dev)
    before = _launches(euler_packed)
    per = chain_time(lambda x: euler_packed(meta, vu, vv, x, dvv, dt, nlev),
                     q, n, reps, dev)
    e16 = nelem * 16
    # q read and written, the two winds, 6 meta rows, dvv
    nbytes = (2 * qsize * nlev + 2 * nlev + 6) * e16 * 4 + 16 * 4
    return {"us_per_step": per * 1e6,
            "tracer_gridpoints_per_s": e16 * nlev * qsize / per,
            "bytes_per_step": nbytes,
            "bound_us": nbytes / HBM_BYTES_PER_S * 1e6,
            "kernel_launches": _delta(before, euler_packed),
            "config": f"{nelem}x{nlev}x16 qsize={qsize} float32 row layout "
                      f"euler_packed dt={dt} chained n={n} reps={reps}"}


def ne30_problem(ne: int, nlev: int, device):
    """``bench_ne30_dss``'s problem on the ne cubed sphere, row layout:
    (const, levels, acc, plan, rsp) of ``bench.make_assembled_problem``
    with seed 3 and scal = (1e-3, 0.01, hyai0*ps0, 0), the JAX tool's
    ``_scalars(1e-3, 0.01, hv)``."""
    from ..bench import make_assembled_problem

    const, levels, acc, plan, rsp = make_assembled_problem(
        ne, nlev, device, seed=3, layout="row")
    scal = const[0].clone()
    scal[0, 0], scal[0, 1] = 1e-3, 0.01
    return (scal, *const[1:]), levels, acc, plan, rsp


def bench_ne30_dss(ne: int = 30, nlev: int = 72, device="cuda", n: int = 10,
                   reps: int = 4) -> dict:
    """The row CAAR step and the structured DSS, chained on the
    accumulators (time levels fixed, as the JAX entry)."""
    from ..bench import assembled_bytes_per_step
    from ..dist.step_t import caar_dss_structured_packed
    from ..kernels.caar import caar_packed
    from ..kernels.dss import fix_tables

    dev = torch.device(device)
    (scal, meta, qdp, pecnd, dvv), (s0, sm1), acc, plan, rsp = \
        ne30_problem(ne, nlev, dev)

    def step(a):
        return caar_dss_structured_packed(scal, meta, *s0, *sm1, qdp, pecnd,
                                          *a, dvv, plan, rsp)[5:8]

    before = _launches(caar_packed)
    per = chain_time(step, acc, n, reps, dev)
    nelem = 6 * ne * ne
    nbytes = assembled_bytes_per_step(ne, nlev, fix_tables(plan, dev).nfix,
                                      layout="row")
    return {"nelem": nelem, "us_per_step": per * 1e6,
            "gridpoints_per_s": nelem * nlev * 16 / per,
            "bytes_per_step": nbytes,
            "bound_us": nbytes / HBM_BYTES_PER_S * 1e6,
            "dss": "structured",
            "kernel_launches": _delta(before, caar_packed),
            "config": f"ne{ne} ({nelem} elements) x{nlev}x16 float32 row "
                      f"layout caar_dss_structured_packed chained n={n} "
                      f"reps={reps}"}


def saxpby_problem(rows: int, cols: int, device):
    """``bench_saxpby``'s x and y: standard normals from numpy generators
    seeded 0 and 1, as float32."""
    dev = torch.device(device)
    draw = lambda seed: torch.from_numpy(np.random.default_rng(seed).normal(
        size=(rows, cols)).astype(np.float32)).to(dev)
    return draw(0), draw(1)


def bench_saxpby(rows: int = 8192, cols: int = 4096, device="cuda",
                 n: int = 50, reps: int = 4) -> dict:
    """``saxpby_cuda`` with x chained (in place)."""
    from ..kernels.saxpby import saxpby_cuda

    dev = torch.device(device)
    x, y = saxpby_problem(rows, cols, dev)
    before = _launches(saxpby_cuda)
    per = chain_time(lambda v: saxpby_cuda(0.999, 0.001, v, y), x, n, reps,
                     dev)
    nbytes = 3 * rows * cols * 4
    return {"gb_per_s": nbytes / per / 1e9, "us_per_step": per * 1e6,
            "bytes_per_step": nbytes,
            "bound_us": nbytes / HBM_BYTES_PER_S * 1e6,
            "kernel_launches": _delta(before, saxpby_cuda),
            "config": f"{rows}x{cols} float32 saxpby_cuda (0.999, 0.001) "
                      f"chained n={n} reps={reps}"}


# the entries' shapes on the card (the JAX tool's) and with --device cpu
_CARD = dict(caar=((1024, 72), (8, 26)), tracer=(128, 72, 35), ne=30,
             saxpby=(8192, 4096))
_CPU = dict(caar=((16, 8), (8, 26)), tracer=(8, 8, 3), ne=2,
            saxpby=(128, 64))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="tinman_sandbox_tpu_torch.tools.bench_all",
        description="the reference's benchmark matrix on the card, one "
                    "JSON report")
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: the plain versions at cut shapes (CPU times, "
                         "not the card's; for the tests)")
    args = ap.parse_args(argv)

    from ..bench import card_name_and_power
    from ..device import resolve_device

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    shapes = _CARD if on_card else _CPU
    reps = 4 if on_card else 1
    steps = lambda jax_n: jax_n if on_card else 1
    (c1, c2), (tn, tk, tq) = shapes["caar"], shapes["tracer"]
    report = {
        "backend": dev.type,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "card": card_name_and_power() if on_card else None,
        "caar_1024x72": bench_caar(*c1, dev, steps(150), reps),
        "caar_single_element_26lev": bench_caar(*c2, dev, steps(150), reps),
        "tracer_128x72_q35": bench_tracer(tn, tk, tq, dev, steps(100), reps),
        "ne30_caar_dss_5400elem": bench_ne30_dss(shapes["ne"], 72, dev,
                                                 steps(10), reps),
        "saxpby_triad": bench_saxpby(*shapes["saxpby"], dev, steps(50),
                                     reps),
    }
    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return report


if __name__ == "__main__":
    main()
