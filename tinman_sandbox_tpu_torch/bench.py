"""CAAR benchmarks on the card (counterpart of the raw and the assembled
modes of the repository's ``bench.py``).

    python -m tinman_sandbox_tpu_torch.bench [--nelem 1024] [--nlev 72]
    python -m tinman_sandbox_tpu_torch.bench --ne 30 [--nlev 72] [--ring]
    python -m tinman_sandbox_tpu_torch.bench --layout row [--ne 30]
    python -m tinman_sandbox_tpu_torch.bench --ne 30 --rk [--hypervis-nu 1e15]
    python -m tinman_sandbox_tpu_torch.bench --ne 30 --prim \
        [--hypervis-nu 1e15] [--qsize Q] [--limit] [--qsplit S]

The reference's methodology (kokkos_init.cpp:108-134): random init from a
numpy seed, f32, fixed time levels, one kernel launch per step with the
vn0u/vn0v/omega_p accumulators chained through every step (updated in place
by each launch, read by the next), a warm-up excluded, and
``torch.cuda.synchronize()`` before each clock read. Prints ONE JSON line.
``bytes_per_step`` is the 21-field count of the root bench (13 field reads,
8 writes, meta ignored); ``fraction_of_triad`` divides by the port's own
saxpby kernel, measured in the same process. A measurement of the card:
raises without one.

``--ne N`` is the assembled mode: the CAAR step plus the structured DSS on
the ne x ne x 6 cubed sphere (``dist.caar_dss_structured_packed_t4``, the
CAAR kernel with its fix-lane slab, then the DSS fixup and sweep kernels),
random state on the real geometry, two-float rspheremp. It CHAINS, as the
root bench's ``rotate`` does: each step's assembled s1 becomes the next
step's n0 and the old n0 its nm1, the accumulators run on, and the chain
continues from the warm-up through every timed run. ``bytes_per_step`` adds
to the 21 CAAR rows the DSS's 8 (the stacked s1 read and written), the two
rspheremp rows and twice the slab (written by the CAAR kernel, read by the
fixup).

``--ne N --ring`` runs the assembled mode on the ring-fused step
(``dist.caar_dss_ring_t4``: one ring launch that computes the CAAR step and
the merge-free sweep of its s1, then the fixup and the patch of the fix
lanes), bit for bit the same chain. Its ``bytes_per_step`` is
``ring_bytes_per_step``: s1 is no kernel's input or output, so the 8 rows of
its round trip leave the count and the patch's read of the fix values and
write of the fix lanes join it. Every ``--ne`` JSON line says ``ring``.

``--layout row`` runs the raw and the assembled modes on the row layout
[E16, nlev] (``kernels.caar.caar_packed``, unstacked buffers, meta
[E16, 16]); assembled it is ``dist.caar_dss_structured_packed``: the row
kernel, then the structured DSS over the four fields stacked [E16, 4*nlev]
in plain PyTorch (as the JAX package runs it in XLA), single-f32 rspheremp
as the root bench's row mode. It chains as the t layout does, and its
``bytes_per_step`` counts 21 + 8 rows and one rspheremp column. Every JSON
line names its ``layout``.

``--ne N --rk [--hypervis-nu NU]`` is the dynamics mode: one SSPRK3 step
(``dist.ssprk3_packed_t4``: three single-state CAAR launches with the slab,
each followed by a fixup and a sweep that carries the Shu-Osher combination)
and, with a nonzero NU, one hyperviscosity subcycle in place on the new
state (``dist.apply_hypervis_packed_t``: two weak-Laplacian launches, each
with a fixup and a sweep). It starts from the random state projected onto
the continuous space and CHAINS: each step's s_np1 is the next step's s0,
the accumulators run on. ``bytes_per_step`` is ``dynamics_bytes_per_step``.

``--ne N --prim`` is the full model step (``dist.prim_step_packed_t4``): the
dynamics step above, then ``--qsplit`` SSPRK3 tracer substeps on the
``--qsize`` tracers stacked [qsize*nlev, E16], riding the new winds (per
substep three tracer launches, Euler or with ``--limit`` the fused limited
stage, each with a fixup and a sweep). It starts from the projected state
and projected tracers in [0, 1] and CHAINS: s_np1 becomes s0, qdp' becomes
qdp, the accumulators run on. ``bytes_per_step`` is ``prim_bytes_per_step``;
``min_qdp`` is the least tracer value at the end (with ``--limit`` it stays
>= 0 up to the rounding of the projection).

From ``DIRECT_NELEM`` = 16,384 elements on (the ne120 class: ``--nelem
86400``, ``--ne 120``) the raw and the assembled modes draw their packed
problem on the card (``kernels.caar_t.random_packed_problem_t``, with the
cubed sphere's metric rows in the assembled mode) in place of the host numpy
state, which at ne120 would be ~2.4 GB of f64 a time-levelled field before
packing; every JSON line says ``init`` ("device" or "host"). This direct
path is the t layout in f32 only: ``--layout row`` there raises. ``--rk``
and ``--prim`` start from the assembled problem, so they draw it on the card
at those sizes too.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

__all__ = ["card_name_and_power", "bytes_per_step", "make_problem",
           "run_steps", "assembled_bytes_per_step", "make_assembled_problem",
           "run_assembled", "ring_bytes_per_step", "dynamics_bytes_per_step",
           "make_dynamics_problem", "run_dynamics", "prim_bytes_per_step",
           "make_prim_problem", "run_prim", "main", "DIRECT_NELEM",
           "direct_init"]

# from this element count on the raw and assembled problems are drawn on the
# card (the JAX bench's direct-packed threshold)
DIRECT_NELEM = 16384


def direct_init(nelem: int, layout: str = "t") -> bool:
    """Whether a problem of ``nelem`` elements is drawn on the card
    (``random_packed_problem_t``); raises for the row layout there, which
    the direct path does not have."""
    if nelem < DIRECT_NELEM:
        return False
    if layout != "t":
        raise ValueError(f"{nelem} elements >= {DIRECT_NELEM}: the "
                         "direct-packed init is the t layout in f32; "
                         f"--layout {layout} has none")
    return True


def card_name_and_power():
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, or None
    where nvidia-smi is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def bytes_per_step(nelem: int, nlev: int, itemsize: int = 4) -> int:
    """Minimum device-memory traffic of one step in the root bench's count:
    21 [nlev, E16] fields (13 read, 8 written), meta ignored."""
    return 21 * itemsize * nelem * 16 * nlev


_N0 = ("u0", "v0", "t0", "dp0")
_NM1 = ("um1", "vm1", "tm1", "dpm1")


def make_problem(nelem: int, nlev: int, device, seed: int = 7,
                 layout: str = "t"):
    """The bench problem packed for ``caar_t4_cuda`` (``layout`` "t") or
    ``caar_packed`` ("row"): random state (``seed``), zero accumulators,
    random geometry (``seed + 1``), analytic hvcoord, dt2 = 0.1,
    eta_ave_w = 1 (the root bench's raw mode); from ``DIRECT_NELEM``
    elements on, drawn on the card by ``random_packed_problem_t``. Returns
    (const, acc): const = (scal, meta, s0, sm1, qdp, pecnd, dvv) with s0 and
    sm1 stacked [4*nlev, E16] on "t", and (scal, meta, u0, v0, t0, dp0,
    um1, vm1, tm1, dpm1, qdp, pecnd, dvv) of [E16, nlev] fields on
    "row"."""
    from . import (Config, analytic_hvcoord, random_geometry, random_state,
                   zero_derived)
    from .kernels.caar import pack_problem
    from .kernels.caar_t import (_scalars, pack_problem_t,
                                 random_packed_problem_t)

    cfg = Config(nelem=nelem, nlev=nlev)
    kw = dict(dtype=torch.float32, device=device)
    hv = analytic_hvcoord(cfg, **kw)
    scal = _scalars(0.1, 1.0, hv, torch.float32, device)
    acc_names = ("vn0u", "vn0v", "omg")
    if direct_init(nelem, layout):
        p = random_packed_problem_t(cfg, seed, device=device)
        const = (scal, p["meta"], torch.cat([p.pop(n) for n in _N0]),
                 torch.cat([p.pop(n) for n in _NM1]), p["qdp"], p["pecnd"],
                 p["dvv"])
        return const, tuple(p[n] for n in acc_names)
    state, derived = random_state(cfg, seed=seed, **kw), zero_derived(cfg, **kw)
    geom = random_geometry(cfg, seed=seed + 1, **kw)
    if layout == "row":
        p = pack_problem(state, derived, geom, hv, cfg)
        const = (scal, p["meta"], *(p[n] for n in _N0 + _NM1), p["qdp"],
                 p["pecnd"], p["dvv"])
        return const, tuple(p[n] for n in acc_names)
    p = pack_problem_t(state, derived, geom, hv, cfg)
    s0 = torch.cat([p[n] for n in _N0])
    sm1 = torch.cat([p[n] for n in _NM1])
    const = (scal, p["meta"], s0, sm1, p["qdp"], p["pecnd"], p["dvv"])
    return const, tuple(p[n] for n in acc_names)


def run_steps(const, acc, nsteps: int, layout: str = "t"):
    """``nsteps`` chained steps at fixed time levels of ``caar_t4_cuda``
    (``layout`` "t") or ``caar_packed`` ("row") on ``make_problem``'s
    operands; returns the last step's outputs, the accumulators last."""
    from .kernels.caar import caar_packed
    from .kernels.caar_t import caar_t4_cuda

    step = caar_packed if layout == "row" else caar_t4_cuda
    out = None
    for _ in range(nsteps):
        out = step(*const[:-1], *acc, const[-1])
        acc = out[-3:]
    return out


def assembled_bytes_per_step(ne: int, nlev: int, nfix: int,
                             itemsize: int = 4, layout: str = "t") -> int:
    """Device-memory traffic of one assembled step, meta ignored: 21 CAAR
    rows and 8 DSS rows of nlev levels over E16 lanes, and on the t layout
    2 rspheremp rows and the [nfix, 4*nlev] slab written once and read once;
    on the row layout 1 rspheremp column and no slab."""
    e16 = 6 * ne * ne * 16
    if layout == "row":
        return ((21 + 8) * nlev + 1) * e16 * itemsize
    return (((21 + 8) * nlev + 2) * e16 + 2 * nfix * 4 * nlev) * itemsize


def ring_bytes_per_step(ne: int, nlev: int, nfix: int,
                        itemsize: int = 4) -> int:
    """Device-memory traffic of one ring-fused assembled step, meta
    ignored, each kernel's inputs read once and outputs written once: the
    ring kernel reads the 13 CAAR rows and two rspheremp rows and writes
    the swept 4 rows, phi and the 3 accumulators (21 rows) and the
    [nfix, 4*nlev] slab, which the fixup reads; the patch reads the
    [4*nlev, nfix] fix values and writes as many fix lanes."""
    e16 = 6 * ne * ne * 16
    return ((21 * nlev + 2) * e16 + 4 * nfix * 4 * nlev) * itemsize


def make_assembled_problem(ne: int, nlev: int, device, seed: int = 7,
                           layout: str = "t", cs=None):
    """The assembled bench problem at ne: random state (``seed``) and zero
    accumulators on the cubed sphere's geometry, analytic hvcoord, dt2 = 0.1,
    eta_ave_w = 1, as in the root bench's --ne mode; from ``DIRECT_NELEM``
    elements on the state is drawn on the card by
    ``random_packed_problem_t`` with the sphere's metric rows. Returns
    (const, levels, acc, plan, rsp): const = (scal, meta, qdp, pecnd, dvv).
    On the t layout levels = (s0, sm1) stacked [4*nlev, E16] and rsp the
    two-float rspheremp [2, E16]; on the row layout levels = ((u0, v0, t0,
    dp0), (um1, vm1, tm1, dpm1)) of [E16, nlev] and rsp the f32 rspheremp
    column [E16, 1] (the root bench's row mode). ``cs`` is the f32 cubed
    sphere at ne on ``device`` where the caller has built it."""
    from . import Config, analytic_hvcoord, random_state, zero_derived
    from .dist import build_cubed_sphere, make_structured_plan, rsp_lanes_2f
    from .kernels.caar import pack_problem
    from .kernels.caar_t import (_scalars, pack_problem_t,
                                 random_packed_problem_t)

    kw = dict(dtype=torch.float32, device=device)
    cs = cs or build_cubed_sphere(ne, **kw)
    cfg = Config(nelem=cs.nelem, nlev=nlev)
    hv = analytic_hvcoord(cfg, **kw)
    if direct_init(cs.nelem, layout):
        p = random_packed_problem_t(cfg, seed, geom=cs.geometry,
                                    device=device)
    else:
        pack = pack_problem if layout == "row" else pack_problem_t
        p = pack(random_state(cfg, seed=seed, **kw), zero_derived(cfg, **kw),
                 cs.geometry, hv, cfg)
    const = (_scalars(0.1, 1.0, hv, torch.float32, device), p["meta"],
             p["qdp"], p["pecnd"], p["dvv"])
    if layout == "row":
        levels = (tuple(p[n] for n in _N0), tuple(p[n] for n in _NM1))
        rsp = cs.geometry.rspheremp.reshape(-1, 1).contiguous()
    else:
        levels = (torch.cat([p.pop(n) for n in _N0]),
                  torch.cat([p.pop(n) for n in _NM1]))
        rsp = torch.from_numpy(rsp_lanes_2f(cs.geometry.spheremp, cs.gdof,
                                            cs.ndof)).to(device)
    return (const, levels, (p["vn0u"], p["vn0v"], p["omg"]),
            make_structured_plan(cs.gdof, ne), rsp)


def run_assembled(const, levels, acc, plan, rsp, nsteps: int, step=None,
                  layout: str = "t"):
    """``nsteps`` chained assembled steps (``step`` defaults to
    ``caar_dss_structured_packed_t4``, on the row layout to
    ``caar_dss_structured_packed``): the assembled s1 becomes n0 and the
    old n0 becomes nm1. Returns ((n0, nm1), acc, phi) after the last."""
    from .dist.step_t import (
        caar_dss_structured_packed, caar_dss_structured_packed_t4)

    row = layout == "row"
    step = step or (caar_dss_structured_packed if row
                    else caar_dss_structured_packed_t4)
    scal, meta, qdp, pecnd, dvv = const
    s0, sm1 = levels
    phi = None
    for _ in range(nsteps):
        if row:
            o = step(scal, meta, *s0, *sm1, qdp, pecnd, *acc, dvv, plan, rsp)
            s1, phi, acc = tuple(o[:4]), o[4], o[5:]
        else:
            s1, phi, *acc = step(scal, meta, s0, sm1, qdp, pecnd, *acc, dvv,
                                 plan, rsp)
        s0, sm1 = s1, s0
    return (s0, sm1), tuple(acc), phi


def dynamics_bytes_per_step(ne: int, nlev: int, nfix: int,
                            hypervis: bool = False, itemsize: int = 4) -> int:
    """Device-memory traffic of one dynamics step, meta ignored, each
    kernel's inputs read once and its outputs written once. SSPRK3: per
    stage the CAAR kernel reads 9 [nlev, E16] rows (state, qdp, pecnd, three
    accumulators) and writes 7 (8 with phi, last stage), the sweep reads 4
    and writes 4 and reads the 4 of s0 on stages 2 and 3: 81 rows, plus two
    rspheremp rows per sweep and the [nfix, 4*nlev] slab written and read
    per stage. One hyperviscosity subcycle: two Laplacians (3 read, 3
    written), a sweep (3 + 3) and the mixing sweep (3 + 3 + 3): 27 rows,
    four rspheremp rows and the [nfix, 3*nlev] slab twice written and
    read."""
    e16 = 6 * ne * ne * 16
    n = (81 * nlev + 6) * e16 + 3 * 2 * nfix * 4 * nlev
    if hypervis:
        n += (27 * nlev + 4) * e16 + 2 * 2 * nfix * 3 * nlev
    return n * itemsize


def make_dynamics_problem(ne: int, nlev: int, device, dt: float = 0.1,
                          seed: int = 7):
    """The dynamics bench problem at ne: ``make_assembled_problem`` with dt
    in scal's dt2 slot and the n0 state projected onto the continuous space
    (rspheremp * DSS(spheremp * s0), the whole structured DSS), which
    ``ssprk3_packed_t4`` needs. Returns (const, s0, acc, plan, rsp): const =
    (scal, meta, qdp, pecnd, dvv)."""
    from .kernels.dss import dss_structured_t_cuda
    from .kernels.layout import META_COLS

    (scal, meta, qdp, pecnd, dvv), (s0, _), acc, plan, rsp = \
        make_assembled_problem(ne, nlev, device, seed)
    scal = scal.clone()
    scal[0, 0] = dt
    sph = meta[META_COLS.index("spheremp")]
    s0 = dss_structured_t_cuda((sph * s0).contiguous(), plan, rsp)
    return (scal, meta, qdp, pecnd, dvv), s0, acc, plan, rsp


def run_dynamics(const, s0, acc, plan, rsp, nsteps: int, nu: float = 0.0,
                 dt: float = 0.1):
    """``nsteps`` chained dynamics steps: ``ssprk3_packed_t4``, then with a
    nonzero ``nu`` ``apply_hypervis_packed_t`` on the whole new
    [4*nlev, E16] state; the result is the next step's s0. Returns
    (s0, acc, phi) after the last."""
    from .dist.step_t import apply_hypervis_packed_t, ssprk3_packed_t4

    scal, meta, qdp, pecnd, dvv = const
    nlev = qdp.shape[0]
    phi = None
    for _ in range(nsteps):
        s0, phi, *acc = ssprk3_packed_t4(scal, meta, s0, qdp, pecnd, *acc,
                                         dvv, plan, rsp)
        if nu:
            s0 = apply_hypervis_packed_t(dvv, meta, s0, plan, rsp, nu, dt,
                                         nlev)
    return s0, tuple(acc), phi


def prim_bytes_per_step(ne: int, nlev: int, nfix: int, qsize: int = 1,
                        qsplit: int = 1, hypervis: bool = False,
                        itemsize: int = 4) -> int:
    """Device-memory traffic of one full model step, each kernel's inputs
    read once and its outputs written once: ``dynamics_bytes_per_step`` plus,
    per tracer stage (3 a substep), the tracer kernel's 2 wind blocks and
    qsize tracer blocks read and qsize written, the 7 meta rows it reads,
    the [nfix, qsize*nlev] slab written and read, and the sweep's qsize
    blocks read and written with its two rspheremp rows; stages 2 and 3
    also read the qsize blocks of the substep's input for the Shu-Osher
    combination (in the sweep, or with the limiter in the kernel)."""
    e16 = 6 * ne * ne * 16
    blocks = 3 * (2 + 4 * qsize) + 2 * qsize
    n = (blocks * nlev + 3 * (7 + 2)) * e16 + 3 * 2 * nfix * qsize * nlev
    return dynamics_bytes_per_step(ne, nlev, nfix, hypervis, itemsize) \
        + max(qsplit, 1) * n * itemsize


def make_prim_problem(ne: int, nlev: int, device, dt: float = 0.1,
                      qsize: int = 1, seed: int = 7):
    """The full-step bench problem at ne: ``make_dynamics_problem`` plus the
    stacked tracers [qsize*nlev, E16] in [0, 1], projected onto the
    continuous space (a weighted mean: it keeps the range) as
    ``ssprk3_tracer_packed_t`` needs. Tracer 0 is the dynamics problem's
    moisture tracer; the others are drawn on the device from ``seed``.
    Returns (const, s0, qdp, acc, plan, rsp): const = (scal, meta, pecnd,
    dvv)."""
    from .kernels.dss import dss_structured_t_cuda
    from .kernels.layout import META_COLS

    (scal, meta, q0, pecnd, dvv), s0, acc, plan, rsp = make_dynamics_problem(
        ne, nlev, device, dt, seed)
    if qsize > 1:
        gen = torch.Generator(device=q0.device).manual_seed(seed)
        more = torch.rand((qsize - 1) * nlev, q0.shape[1], generator=gen,
                          dtype=q0.dtype, device=q0.device)
        q0 = torch.cat([q0, more])
    sph = meta[META_COLS.index("spheremp")]
    qdp = dss_structured_t_cuda(q0 * sph, plan, rsp)
    return (scal, meta, pecnd, dvv), s0, qdp, acc, plan, rsp


def run_prim(const, s0, qdp, acc, plan, rsp, nsteps: int, nu: float = 0.0,
             dt: float = 0.1, qsplit: int = 1, limit: bool = False,
             step=None):
    """``nsteps`` chained full model steps (``step`` defaults to
    ``prim_step_packed_t4``): s_np1 becomes the next s0 and qdp' the next
    qdp, the accumulators run on. Returns (s0, qdp, acc, phi) after the
    last."""
    from .dist.step_t import prim_step_packed_t4

    step = step or prim_step_packed_t4
    scal, meta, pecnd, dvv = const
    nlev = s0.shape[0] // 4
    phi = None
    for _ in range(nsteps):
        s0, qdp, phi, *acc = step(scal, meta, s0, qdp, pecnd, *acc, dvv, plan,
                                  rsp, nu, nlev, qsplit=qsplit,
                                  limit_tracers=limit, dt=dt)
    return s0, qdp, tuple(acc), phi


def _main_prim(args, dev) -> dict:
    from .kernels.caar_t import caar_t4_cuda
    from .kernels.dss import dss_fixup_cuda, dss_sweep_cuda, fix_tables
    from .kernels.hypervis_t import vlap_cuda
    from .kernels.saxpby import saxpby_bandwidth_gbs
    from .kernels.tracer_t import tracer_euler_cuda, tracer_limit_cuda

    const, s0, qdp, acc, plan, rsp = make_prim_problem(
        args.ne, args.nlev, dev, args.dt, args.qsize)
    wrappers = (caar_t4_cuda, vlap_cuda, tracer_euler_cuda, tracer_limit_cuda,
                dss_fixup_cuda, dss_sweep_cuda)
    run = lambda s, q, a, n: run_prim(const, s, q, a, plan, rsp, n,
                                      args.hypervis_nu, args.dt, args.qsplit,
                                      args.limit)
    # warm-up (first build), excluded; the chain runs on from it
    s0, qdp, acc, _ = run(s0, qdp, acc, 2)
    torch.cuda.synchronize(dev)
    launches0 = [w.launches for w in wrappers]
    best = float("inf")
    for _ in range(args.reps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        s0, qdp, acc, phi = run(s0, qdp, acc, args.nexec)
        torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    if not all(bool(torch.isfinite(x).all()) for x in (s0, qdp, *acc, phi)):
        raise RuntimeError("bench: non-finite model state")
    per_step = {w.__name__: (w.launches - n0) / (args.reps * args.nexec)
                for w, n0 in zip(wrappers, launches0)}
    triad = saxpby_bandwidth_gbs(device=dev)
    nelem = 6 * args.ne * args.ne
    nbytes = prim_bytes_per_step(args.ne, args.nlev,
                                 fix_tables(plan, dev).nfix, args.qsize,
                                 args.qsplit, bool(args.hypervis_nu))
    gbs = nbytes * args.nexec / best / 1e9
    return {
        "metric": "prim_gridpoint_updates_per_s",
        "config": f"ne{args.ne} ({nelem} elements) x{args.nlev}x16 float32 "
                  f"qsize={args.qsize} qsplit={args.qsplit} "
                  f"limit={'yes' if args.limit else 'no'} nexec={args.nexec} "
                  f"reps={args.reps} chained step=prim_step_packed_t4 "
                  f"dt={args.dt} nu={args.hypervis_nu}",
        "seconds": best,
        "us_per_step": best / args.nexec * 1e6,
        "gridpoints_per_s": nelem * args.nlev * 16 * args.nexec / best,
        "bytes_per_step": nbytes,
        "achieved_gb_per_s": gbs,
        "triad_gb_per_s": triad,
        "fraction_of_triad": gbs / triad,
        "kernel_launches_per_step": per_step,
        "min_dp3d": float(s0[3 * args.nlev:].min()),
        "min_qdp": float(qdp.min()),
        "device": torch.cuda.get_device_name(dev),
        "card": card_name_and_power(),
    }


def _main_dynamics(args, dev) -> dict:
    from .kernels.caar_t import caar_t4_cuda
    from .kernels.dss import dss_fixup_cuda, dss_sweep_cuda, fix_tables
    from .kernels.hypervis_t import vlap_cuda
    from .kernels.saxpby import saxpby_bandwidth_gbs

    const, s0, acc, plan, rsp = make_dynamics_problem(
        args.ne, args.nlev, dev, args.dt)
    wrappers = (caar_t4_cuda, vlap_cuda, dss_fixup_cuda, dss_sweep_cuda)
    run = lambda s, a, n: run_dynamics(const, s, a, plan, rsp, n,
                                       args.hypervis_nu, args.dt)
    # warm-up (first build), excluded; the chain runs on from it
    s0, acc, _ = run(s0, acc, 2)
    torch.cuda.synchronize(dev)
    launches0 = [w.launches for w in wrappers]
    best = float("inf")
    for _ in range(args.reps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        s0, acc, phi = run(s0, acc, args.nexec)
        torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    if not all(bool(torch.isfinite(x).all()) for x in (s0, *acc, phi)):
        raise RuntimeError("bench: non-finite dynamics state")
    dp_min = float(s0[3 * args.nlev:].min())
    per_step = {w.__name__: (w.launches - n0) / (args.reps * args.nexec)
                for w, n0 in zip(wrappers, launches0)}
    triad = saxpby_bandwidth_gbs(device=dev)
    nelem = 6 * args.ne * args.ne
    nbytes = dynamics_bytes_per_step(args.ne, args.nlev,
                                     fix_tables(plan, dev).nfix,
                                     bool(args.hypervis_nu))
    gbs = nbytes * args.nexec / best / 1e9
    return {
        "metric": "dynamics_gridpoint_updates_per_s",
        "config": f"ne{args.ne} ({nelem} elements) x{args.nlev}x16 float32 "
                  f"nexec={args.nexec} reps={args.reps} chained "
                  f"step=ssprk3_packed_t4 dt={args.dt}"
                  + (f" + apply_hypervis_packed_t nu={args.hypervis_nu}"
                     if args.hypervis_nu else ""),
        "seconds": best,
        "us_per_step": best / args.nexec * 1e6,
        "gridpoints_per_s": nelem * args.nlev * 16 * args.nexec / best,
        "bytes_per_step": nbytes,
        "achieved_gb_per_s": gbs,
        "triad_gb_per_s": triad,
        "fraction_of_triad": gbs / triad,
        "kernel_launches_per_step": per_step,
        "min_dp3d": dp_min,
        "device": torch.cuda.get_device_name(dev),
        "card": card_name_and_power(),
    }


def _main_assembled(args, dev) -> dict:
    from .dist.step_t import caar_dss_ring_t4
    from .kernels.caar import caar_packed
    from .kernels.caar_t import caar_t4_cuda
    from .kernels.dss import (
        dss_extract_cuda, dss_fixup_cuda, dss_merge_patch_cuda,
        dss_sweep_cuda, fix_tables)
    from .kernels.ring_fused import caar_ring_packed_t4
    from .kernels.saxpby import saxpby_bandwidth_gbs

    row = args.layout == "row"
    const, levels, acc, plan, rsp = make_assembled_problem(
        args.ne, args.nlev, dev, layout=args.layout)
    if row:
        wrappers = (caar_packed,)
    elif args.ring:
        wrappers = (caar_ring_packed_t4, dss_fixup_cuda, dss_merge_patch_cuda,
                    caar_t4_cuda, dss_sweep_cuda)
    else:
        wrappers = (caar_t4_cuda, dss_extract_cuda, dss_fixup_cuda,
                    dss_sweep_cuda)
    launches0 = [w.launches for w in wrappers]
    step = caar_dss_ring_t4 if args.ring else None
    run = lambda lv, a, n: run_assembled(const, lv, a, plan, rsp, n,
                                         step=step, layout=args.layout)
    # warm-up (first build), excluded; the chain runs on from it
    levels, acc, _ = run(levels, acc, 2)
    torch.cuda.synchronize(dev)
    best = float("inf")
    for _ in range(args.reps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        levels, acc, phi = run(levels, acc, args.nexec)
        torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    flat = (*levels[0], *levels[1]) if row else levels
    if not all(bool(torch.isfinite(x).all()) for x in (*flat, *acc, phi)):
        raise RuntimeError("bench: non-finite assembled state")
    launches = {w.__name__: w.launches - n0
                for w, n0 in zip(wrappers, launches0)}
    triad = saxpby_bandwidth_gbs(device=dev)
    nelem = 6 * args.ne * args.ne
    nfix = fix_tables(plan, dev).nfix
    nbytes = (ring_bytes_per_step(args.ne, args.nlev, nfix) if args.ring
              else assembled_bytes_per_step(args.ne, args.nlev, nfix,
                                            layout=args.layout))
    gbs = nbytes * args.nexec / best / 1e9
    return {
        "metric": "caar_dss_gridpoint_updates_per_s",
        "config": f"ne{args.ne} ({nelem} elements) x{args.nlev}x16 float32 "
                  f"nexec={args.nexec} reps={args.reps} chained step="
                  + ("caar_dss_structured_packed" if row
                     else "caar_dss_ring_t4" if args.ring
                     else "caar_dss_structured_packed_t4"),
        "seconds": best,
        "us_per_step": best / args.nexec * 1e6,
        "gridpoints_per_s": nelem * args.nlev * 16 * args.nexec / best,
        "bytes_per_step": nbytes,
        "achieved_gb_per_s": gbs,
        "triad_gb_per_s": triad,
        "fraction_of_triad": gbs / triad,
        "kernel_launches": launches,
        "device": torch.cuda.get_device_name(dev),
        "card": card_name_and_power(),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="tinman_sandbox_tpu_torch.bench")
    ap.add_argument("--nelem", type=int, default=1024)
    ap.add_argument("--nlev", type=int, default=72)
    ap.add_argument("--nexec", type=int, default=1000,
                    help="steps per timed run")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ne", type=int, default=None,
                    help="assembled mode on the ne x ne x 6 cubed sphere "
                         "(sets the element count; --nelem is ignored)")
    ap.add_argument("--rk", action="store_true",
                    help="with --ne: the chained SSPRK3 dynamics step")
    ap.add_argument("--hypervis-nu", type=float, default=0.0,
                    help="with --rk: hyperviscosity after each step (0 = off)")
    ap.add_argument("--dt", type=float, default=0.1,
                    help="with --rk or --prim: the time step")
    ap.add_argument("--prim", action="store_true",
                    help="with --ne: the chained full model step (dynamics, "
                         "hyperviscosity, tracers)")
    ap.add_argument("--qsize", type=int, default=1,
                    help="with --prim: the number of tracers")
    ap.add_argument("--qsplit", type=int, default=1,
                    help="with --prim: tracer substeps per step")
    ap.add_argument("--limit", action="store_true",
                    help="with --prim: the monotone limiter in every tracer "
                         "stage")
    ap.add_argument("--ring", action="store_true",
                    help="with --ne: the assembled step on the ring-fused "
                         "path (one ring launch, fixup, patch)")
    ap.add_argument("--layout", default="t", choices=("t", "row"),
                    help="packed layout: t = [nlev, E16] (default), row = "
                         "[E16, nlev] (raw and assembled modes only)")
    args = ap.parse_args(argv)
    if (args.rk or args.prim or args.hypervis_nu) and args.ne is None:
        ap.error("--rk, --prim and --hypervis-nu need --ne")
    if args.hypervis_nu and not (args.rk or args.prim):
        ap.error("--hypervis-nu needs --rk or --prim")
    if args.rk and args.prim:
        ap.error("--prim holds the SSPRK3 dynamics already; drop --rk")
    if (args.limit or args.qsize != 1 or args.qsplit != 1) and not args.prim:
        ap.error("--qsize, --qsplit and --limit need --prim")
    if args.qsize < 1 or args.qsplit < 1:
        ap.error("--qsize and --qsplit must be at least 1")
    if args.layout == "row" and (args.rk or args.prim):
        ap.error("--layout row has the raw and the assembled modes only")
    if args.ring and (args.ne is None or args.rk or args.prim
                      or args.layout == "row"):
        ap.error("--ring is a mode of the assembled step: it needs --ne and "
                 "takes neither --rk, --prim nor --layout row")

    from .device import resolve_device
    from .kernels.caar import caar_packed
    from .kernels.caar_t import caar_t4_cuda
    from .kernels.saxpby import saxpby_bandwidth_gbs

    dev = resolve_device("cuda")
    if args.ne is not None:
        result = (_main_prim if args.prim else _main_dynamics if args.rk
                  else _main_assembled)(args, dev)
        result["layout"] = args.layout
        result["init"] = "device" if direct_init(6 * args.ne ** 2,
                                                 args.layout) else "host"
        result["ring"] = args.ring
        print(json.dumps(result))
        return result
    kernel = caar_packed if args.layout == "row" else caar_t4_cuda
    const, acc = make_problem(args.nelem, args.nlev, dev, layout=args.layout)
    launches0 = kernel.launches
    # warm-up (first build), excluded
    run_steps(const, acc, 2, args.layout)
    torch.cuda.synchronize(dev)
    best = float("inf")
    for _ in range(args.reps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = run_steps(const, acc, args.nexec, args.layout)
        torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    if not all(bool(torch.isfinite(x).all()) for x in out):
        raise RuntimeError("bench: non-finite CAAR output")
    launches = kernel.launches - launches0
    triad = saxpby_bandwidth_gbs(device=dev)
    nbytes = bytes_per_step(args.nelem, args.nlev)
    gbs = nbytes * args.nexec / best / 1e9
    result = {
        "metric": "caar_gridpoint_updates_per_s",
        "config": f"{args.nelem}x{args.nlev}x16 float32 nexec={args.nexec} "
                  f"reps={args.reps} kernel={kernel.__name__}",
        "seconds": best,
        "us_per_step": best / args.nexec * 1e6,
        "gridpoints_per_s": args.nelem * args.nlev * 16 * args.nexec / best,
        "bytes_per_step": nbytes,
        "achieved_gb_per_s": gbs,
        "triad_gb_per_s": triad,
        "fraction_of_triad": gbs / triad,
        "kernel_launches": launches,
        "device": torch.cuda.get_device_name(dev),
        "card": card_name_and_power(),
        "layout": args.layout,
        "init": "device" if direct_init(args.nelem, args.layout) else "host",
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
