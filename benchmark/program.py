"""The system under test: ``tinman_sandbox_tpu_torch``'s set-up of a
packed cadence problem from the benchmark's inputs, and the cadence's step.

The step is the production cadence of ``examples/packed_cadence.py``
written here with the configuration's parameters passed explicitly:
``dist.prim_step_packed_t4`` (SSPRK3 dynamics, hyperviscosity, SSPRK3
tracers, limited where the configuration's ``limiter`` says so) and, on
every ``rsplit``-th step, ``dist.remap_packed_t4`` with the configured
scheme and, where ``mass_fixer`` says so, the dry-mass fixer toward the
initial air mass. The configuration's every key is read
(``spec.check_config`` refuses what neither this module nor the reference
carries out). In the traced slice each call runs inside a ``record_function``
span of its own (``cadence.step``, ``cadence.remap``), so that the trace
can say what the host was doing while the device waited.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.profiler import record_function

# tracers projected and packed at a time in set-up
TRACER_BLOCK = 5
DTYPES = {"float32": torch.float32}


@dataclasses.dataclass
class Program:
    cfg: object          # the program's Config
    scal: torch.Tensor
    meta: torch.Tensor
    pecnd: torch.Tensor
    dvv: torch.Tensor
    plan: object
    rsp: torch.Tensor
    hv: object
    sph_lanes: torch.Tensor
    mass_target: torch.Tensor | None     # None: no fixer
    nu: float
    qsplit: int
    subcycle: int
    limit: bool
    limit_iters: int
    remap_scheme: str


def build_kernels(device: torch.device) -> None:
    """Compile every source the step runs at once (one nvcc each, in
    parallel); the first launch would otherwise build them one by one."""
    if device.type == "cuda":
        from tinman_sandbox_tpu_torch.kernels import _build

        _build.build_kernels(["caar", "dss", "hypervis", "remap", "tracer"])


def setup(grid: dict, levels: dict, raw: dict, config: dict,
          device: torch.device, dtype=None):
    """The program's packed problem from the benchmark's arrays: geometry
    and hybrid levels in ``dtype`` (default the configuration's; a CPU
    test may ask for float64), the raw state projected onto the continuous
    space (``dist.dss_project``), packed (``pack_problem_t``,
    ``pack_qdp_t``), zero accumulators. Returns (Program, s, qdp, acc)."""
    from tinman_sandbox_tpu_torch import Config, zero_derived
    from tinman_sandbox_tpu_torch.convert import pack_qdp_t
    from tinman_sandbox_tpu_torch.device import from_arrays
    from tinman_sandbox_tpu_torch.dist import (
        dss_project, make_structured_plan, packed_air_mass, rsp_lanes_2f)
    from tinman_sandbox_tpu_torch.grid import Geometry, HybridVCoord
    from tinman_sandbox_tpu_torch.kernels.caar_t import (
        _scalars, pack_problem_t)
    from tinman_sandbox_tpu_torch.kernels.layout import META_COLS
    from tinman_sandbox_tpu_torch.state import State

    ft = dtype if dtype is not None else DTYPES[config["dtype"]]
    raw = {k: v.to(ft) for k, v in raw.items()}
    nelem, nlev = grid["nelem"], int(config["nlev"])
    qsize, dt = int(config["qsize"]), float(config["dt"])
    geom = from_arrays(Geometry, {k: grid[k] for k in (
        "dvv", "fcor", "metdet", "rmetdet", "spheremp", "rspheremp", "d",
        "dinv", "mp", "metinv", "vec_sph2cart")}, ft, device)
    hv = from_arrays(HybridVCoord, levels, ft, device)
    cfg = Config(nelem=nelem, nlev=nlev, qsize=qsize, dt=dt)

    def proj(x):
        return dss_project(x, grid["gdof"], grid["ndof"], geom.spheremp,
                           geom.rspheremp)

    def levels3(x, n):
        return proj(x).unsqueeze(0).expand(n, *x.shape)

    # the tracers a few at a time, so that set-up holds no more than the
    # step does: a copy of qdp is 0.87 GB at ne30 x 72 x 35
    qdp = torch.empty(qsize * nlev, nelem * 16, dtype=ft, device=device)
    for b in range(0, qsize, TRACER_BLOCK):
        q = raw["q"][:, b:b + TRACER_BLOCK]
        part = State(u=None, v=None, t=None, dp3d=None, ps_v=None, phis=None,
                     qdp=levels3(q, 1))
        qdp[b * nlev:(b + q.shape[1]) * nlev] = pack_qdp_t(part, cfg, ft)
    state = State(
        u=levels3(raw["u"], 3), v=levels3(raw["v"], 3),
        t=levels3(raw["T"], 3), dp3d=levels3(raw["dp"], 3),
        ps_v=torch.zeros(3, nelem, 4, 4, dtype=ft, device=device),
        phis=raw["phis"], qdp=levels3(raw["q"][:, :1], 1))
    pt = pack_problem_t(state, zero_derived(cfg, dtype=ft, device=device),
                        geom, hv, cfg, dtype=ft)
    s = torch.cat([pt["u0"], pt["v0"], pt["t0"], pt["dp0"]])
    del state
    meta = pt["meta"]
    sph_lanes = meta[META_COLS.index("spheremp")][None, :]
    prog = Program(
        cfg=cfg, scal=_scalars(dt, 1.0, hv, ft, device), meta=meta,
        pecnd=pt["pecnd"], dvv=pt["dvv"],
        plan=make_structured_plan(grid["gdof"], int(config["ne"])),
        rsp=torch.from_numpy(rsp_lanes_2f(geom.spheremp, grid["gdof"],
                                          grid["ndof"])).to(device),
        hv=hv, sph_lanes=sph_lanes,
        mass_target=packed_air_mass(s, sph_lanes, nlev)
        if config["mass_fixer"] else None,
        nu=float(config["nu"]), qsplit=int(config["qsplit"]),
        subcycle=int(config["hypervis_subcycle"]),
        limit=bool(config["limiter"]),
        limit_iters=int(config["limiter_iters"]),
        remap_scheme=str(config["remap"]))
    return prog, s, qdp, (pt["vn0u"], pt["vn0v"], pt["omg"])


def step(p: Program, s, qdp, acc, remap: bool, spans: bool = False):
    """One step of the cadence. The accumulators advance in place; s and
    qdp come back new. ``spans`` wraps each call in its span (the traced
    slice; the timed window runs without them). Returns (s, qdp, acc,
    phi)."""
    from tinman_sandbox_tpu_torch.dist import (
        prim_step_packed_t4, remap_packed_t4)

    cfg = p.cfg
    with _span("cadence.step", spans):
        s, qdp, phi, *acc = prim_step_packed_t4(
            p.scal, p.meta, s, qdp, p.pecnd, *acc, p.dvv, p.plan, p.rsp,
            p.nu, cfg.nlev, qsplit=p.qsplit, subcycle=p.subcycle,
            limit_tracers=p.limit, limit_iters=p.limit_iters, dt=cfg.dt)
    if remap:
        with _span("cadence.remap", spans):
            s, qdp = remap_packed_t4(
                s, qdp, p.hv, cfg.nelem, cfg.nlev, cfg.qsize,
                scheme=p.remap_scheme, sph_lanes=p.sph_lanes,
                mass_target=p.mass_target)
    return s, qdp, tuple(acc), phi


def _span(name: str, on: bool):
    return record_function(name) if on else contextlib.nullcontext()
