"""Compiled-kernel equivalence on the card: each kernel path of the port
against an independent form of the same step on the same device, the worst
relative error of each in one JSON report (counterpart of the JAX
repository's ``tools/tpu_equiv_check.py``).

    python -m tinman_sandbox_tpu_torch.tools.equiv_check [--nelem 512] \
        [--nlev 72] [--ne 4] [--out PATH]
    python -m tinman_sandbox_tpu_torch.tools.equiv_check --device cpu ...

The keys are the JAX tool's, each error max|a - b| / max|b| in float64 over
f32 data:

  * ``raw_kernel_relmax``: the row CAAR kernel (``kernels.caar.caar``)
    against the array form ``caar_array`` (random state seed 7, random
    geometry seed 8, dt2 0.1, eta_ave_w 1, ``--nelem`` x ``--nlev``);
    ``raw_kernel_t_relmax``: the t-layout kernel (``caar_t``) against it;
  * ``assembled_step_relmax``, ``_t_``, ``_t4_``: the assembled steps on the
    ``--ne`` cubed sphere (``caar_dss``, row kernel and the stacked
    structured DSS; ``caar_dss_t``; ``caar_dss_structured_packed_t4``, the
    CAAR kernel's slab, fixup and sweep) against ``dist.caar_dss_step``
    (the array form and the segment-sum DSS), state seed 9, the one-float
    rspheremp row;
  * ``fused_extract_slab_relmax``: the slab that the CAAR kernel emits
    against ``dss_extract_cuda`` of its own s1 (must be 0);
    ``compact_extract_slab_relmax`` is not applicable (the report says
    why): the port's one slab form is the compact one;
  * ``sharded_paths_relmax``: the face-sharded step on one shard
    (``caar_dss_sharded_t4`` over ``LocalMesh(1)``) and the band-sharded
    step (``caar_dss_banded_t4``) on the smallest mesh the port admits at
    ``--ne`` (``banded_mesh``: at ne 4 one shard of two bands a face, at
    ne 30 twelve shards of one band chunk each), against ``caar_dss_step``;
  * ``prim_packed_relmax``, ``_q35_``, ``_q35_limit_``: the packed full
    step (``prim_step_packed_t4``: the CAAR, Laplacian, tracer and DSS
    kernels) against the field form ``timeloop.prim.prim_run_step`` from a
    projected (continuous) state, dt 0.02, nu 2.5e-4, qsize 1 and 35, the
    latter also limited, with its tracer-mass drift;
  * ``limiter_iters1``: the limited step with one clip-and-redistribute
    pass against the field form, its mass drift, and one limited stage
    (``tracer_limit_cuda``, iters 1 and 2) against the per-(element, level)
    bounds of its own input (the overshoot, of the bounds' range).

The JAX tool's ``hv_fast_*`` keys are left out: the one-pass bf16
Laplacian dots are a TPU option that the port does not take (they move T's
damping by ~10%, ``TPU_EQUIV.json``).

Pass rule (the JAX tool's): the worst single-step key < 5e-5, each prim
key < 1e-3, the limited q35 key < 5e-3 and its mass drift < 5e-6. The
report holds the card's name and power limit (``nvidia-smi``), is printed
as one JSON line and written to ``--out`` (on the card by default
``H100_EQUIV.json`` at the repository root; with ``--device cpu`` only
where ``--out`` is given). The exit code is 1 when ``pass`` is false.

The tool runs on the card; ``--device cpu`` runs the plain versions (the
CPU tests' mode, their errors the CPU's). Without a card and without
``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

__all__ = ["relmax", "mass_drift", "banded_mesh", "COMPACT_SLAB", "LIMITS",
           "check", "main"]

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIELDS = ("u", "v", "t", "dp3d")
# the pass rule of tools/tpu_equiv_check.py:505-511
LIMITS = {"worst_relmax": 5e-5, "prim_worst_relmax": 1e-3,
          "prim_q35_worst_relmax": 1e-3,
          "prim_q35_limit_worst_relmax": 5e-3,
          "prim_q35_limit_mass_drift": 5e-6}
COMPACT_SLAB = {
    "applicable": False,
    "reason": "the port has one fix-lane slab form, [nfix, k] with a row "
              "per fix lane in ascending lane order (kernels/dss.py "
              "FixTables.read_lanes): the values of the JAX package's "
              "COMPACT slab (fix lanes only, selected exactly) without its "
              "128-lane tile blocks (cM rows a tile, one-hot table cq), "
              "which have no counterpart on the GPU. Its producer-fused form "
              "against the standalone extraction is "
              "fused_extract_slab_relmax; the JAX dense full-tile slab has "
              "no counterpart either."}
DT2, ETA = 0.1, 1.0
PRIM_DT, PRIM_NU = 0.02, 2.5e-4
QSIZE_TALL = 35
TRACERS_SHOWN = (0, 17, 34)


def relmax(a, b) -> float:
    """max|a - b| / (max|b| + 1e-30) in float64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / ((b.abs().max()) + 1e-30))


def mass_drift(spheremp, got, src) -> float:
    """|sum(sph * got) / sum(sph * src) - 1| in float64 for one tracer's
    fields got, src [nelem, nlev, np, np] and spheremp [nelem, np, np]."""
    if got.shape != src.shape or got.shape[0] != spheremp.shape[0] \
            or got.shape[2:] != spheremp.shape[1:]:
        raise ValueError(f"mass_drift: fields {tuple(got.shape)} and "
                         f"{tuple(src.shape)}, spheremp "
                         f"{tuple(spheremp.shape)}")
    sph = spheremp.double()[:, None]
    return abs(float((sph * got.double()).sum()
                     / (sph * src.double()).sum()) - 1.0)


def banded_mesh(ne: int) -> tuple:
    """(shards N, bands a face m) of the smallest mesh on which the port's
    band-sharded step takes the ne sphere (``banded_t4._banded_tables``'
    rule: m >= 2 divides ne, N | 6m, and 128 | the band's lanes unless a
    shard holds one band chunk), the fewest bands among those."""
    for n in range(1, 6 * ne + 1):
        for m in range(2, ne + 1):
            if ne % m or (6 * m) % n:
                continue
            if ((ne // m) * 16 * ne) % 128 == 0 or 6 * m == n:
                return n, m
    raise ValueError(f"no band decomposition of ne={ne}")


def _fields(new, ref, np1, with_phi=True):
    """The raw keys of (state, derived) ``new`` against ``ref``."""
    out = {n: relmax(getattr(new[0], n)[np1], getattr(ref[0], n)[np1])
           for n in FIELDS}
    out["omega_p"] = relmax(new[1].omega_p, ref[1].omega_p)
    if with_phi:
        out["phi"] = relmax(new[1].phi, ref[1].phi)
    return out


def _raw(args, dev, kw):
    from .. import Config, analytic_hvcoord, random_geometry, random_state
    from .. import zero_derived
    from ..kernels.caar import caar
    from ..kernels.caar_array import caar_array
    from ..kernels.caar_t import caar_t

    cfg = Config(nelem=args.nelem, nlev=args.nlev)
    st, dv = random_state(cfg, seed=7, **kw), zero_derived(cfg, **kw)
    geom = random_geometry(cfg, seed=8, **kw)
    hv = analytic_hvcoord(cfg, **kw)
    ref = caar_array(st, dv, geom, hv, cfg, DT2, ETA, device=dev)
    row = caar(st, dv, geom, hv, cfg, DT2, ETA, device=dev)
    t = caar_t(st, dv, geom, hv, cfg, DT2, ETA, device=dev)
    return (_fields(row, ref, cfg.np1),
            _fields(t, ref, cfg.np1, with_phi=False))


def _assembled(args, dev, kw, report):
    """The assembled, slab and sharded keys on the ne sphere; returns what
    the prim keys reuse."""
    from .. import Config, analytic_hvcoord, random_state, zero_derived
    from ..dist import (
        LocalMesh, build_cubed_sphere, caar_dss, caar_dss_banded_t4,
        caar_dss_sharded_t4, caar_dss_step, caar_dss_structured_packed_t4,
        caar_dss_t, make_structured_plan, shard_packed_t4, unshard_packed_t4)
    from ..kernels.caar_t import _scalars, caar_t4_cuda, pack_problem_t
    from ..kernels.dss import dss_extract_cuda, fix_tables
    from ..kernels.layout import unpack_field_t

    cs = build_cubed_sphere(args.ne, **kw)
    cfg = Config(nelem=cs.nelem, nlev=args.nlev)
    st, dv = random_state(cfg, seed=9, **kw), zero_derived(cfg, **kw)
    geom, hv = cs.geometry, analytic_hvcoord(cfg, **kw)
    plan = make_structured_plan(cs.gdof, args.ne)
    ref = caar_dss_step(st, dv, geom, hv, cs.gdof, cs.ndof, cfg, DT2, ETA,
                        device=dev)
    np1, k, nelem = cfg.np1, cfg.nlev, cfg.nelem
    asm = lambda new: {n: relmax(getattr(new, n)[np1], getattr(ref[0], n)[np1])
                       for n in FIELDS}
    report["assembled_step_relmax"] = asm(
        caar_dss(st, dv, geom, hv, plan, cfg, DT2, ETA, device=dev)[0])
    report["assembled_step_t_relmax"] = asm(
        caar_dss_t(st, dv, geom, hv, plan, cfg, DT2, ETA, device=dev)[0])

    p = pack_problem_t(st, dv, geom, hv, cfg)
    scal = _scalars(DT2, ETA, hv, torch.float32, dev)
    rsp = geom.rspheremp.to(torch.float32).reshape(1, -1).contiguous()
    s0 = torch.cat([p["u0"], p["v0"], p["t0"], p["dp0"]])
    sm1 = torch.cat([p["um1"], p["vm1"], p["tm1"], p["dpm1"]])
    acc = lambda: [p[n].clone() for n in ("vn0u", "vn0v", "omg")]
    fields = lambda s1: {n: relmax(unpack_field_t(s1[i * k:(i + 1) * k],
                                                  nelem),
                                   getattr(ref[0], n)[np1])
                         for i, n in enumerate(FIELDS)}
    s1 = caar_dss_structured_packed_t4(scal, p["meta"], s0, sm1, p["qdp"],
                                       p["pecnd"], *acc(), p["dvv"], plan,
                                       rsp)[0]
    report["assembled_step_t4_relmax"] = fields(s1)

    fix = fix_tables(plan, dev)
    out = caar_t4_cuda(scal, p["meta"], s0, sm1, p["qdp"], p["pecnd"],
                       *acc(), p["dvv"], fix=fix)
    report["fused_extract_slab_relmax"] = relmax(
        out[5], dss_extract_cuda(out[0], fix))
    report["compact_extract_slab_relmax"] = dict(COMPACT_SLAB)

    sharded = {}
    n_b, m_b = banded_mesh(args.ne)
    for tag, mesh, step in (
            ("sharded", LocalMesh(1, dev), caar_dss_sharded_t4),
            ("banded", LocalMesh(n_b, dev),
             lambda *a: caar_dss_banded_t4(*a, m_b))):
        sh = shard_packed_t4(mesh, p["meta"], s0, sm1, p["qdp"], p["pecnd"],
                             rsp, *acc())
        got = step(scal, *sh[:5], *sh[6:9], p["dvv"], plan, sh[5], mesh)
        sharded.update({f"{tag}_{n}": v for n, v in fields(
            unshard_packed_t4(mesh, got[0])).items()})
    report["sharded_paths_relmax"] = sharded
    report["sharded_meshes"] = {
        "sharded": {"shards": 1},
        "banded": {"shards": n_b, "bands_per_face": m_b}}
    return cs, cfg, st, dv, hv, plan, rsp


def _prim(args, dev, kw, report, problem):
    """The prim keys (qsize 1, 35, 35 limited) and the limiter's."""
    from .. import random_state
    from ..convert import pack_qdp_t
    from ..dist import dss_project, prim_step_packed_t4
    from ..kernels.caar_t import _scalars, pack_problem_t
    from ..kernels.layout import META_COLS, unpack_field_t
    from ..kernels.tracer_t import tracer_limit_cuda
    from ..timeloop.prim import prim_run_step

    cs, cfg2, st2, dv2, hv, plan, rsp = problem
    geom = cs.geometry
    proj = lambda x: dss_project(x, cs.gdof, cs.ndof, geom.spheremp,
                                 geom.rspheremp)
    n0, qn0, np1 = cfg2.n0, cfg2.qn0, cfg2.np1
    k, nelem = cfg2.nlev, cfg2.nelem

    def projected(st):
        new = {n: getattr(st, n).clone() for n in FIELDS}
        for n in FIELDS:
            new[n][n0] = proj(new[n][n0])
        qdp = st.qdp.clone()
        qdp[qn0] = proj(qdp[qn0])
        return dataclasses.replace(st, qdp=qdp, **new)

    cfg = dataclasses.replace(cfg2, dt=PRIM_DT)
    stc = projected(st2)
    p = pack_problem_t(stc, dv2, geom, hv, cfg)
    scal = _scalars(cfg.dt, 1.0, hv, torch.float32, dev)
    s0 = torch.cat([p["u0"], p["v0"], p["t0"], p["dp0"]])

    def packed(qdp, **kwargs):
        acc = [p[n].clone() for n in ("vn0u", "vn0v", "omg")]
        return prim_step_packed_t4(scal, p["meta"], s0, qdp, p["pecnd"],
                                   *acc, p["dvv"], plan, rsp, PRIM_NU, k,
                                   dt=cfg.dt, **kwargs)

    def state_errs(sp, ref):
        return {n: relmax(unpack_field_t(sp[i * k:(i + 1) * k], nelem),
                          getattr(ref, n)[np1])
                for i, n in enumerate(FIELDS)}

    tracer = lambda qp, q: unpack_field_t(qp[q * k:(q + 1) * k], nelem)
    field = lambda *a, **kwa: prim_run_step(*a, cs.gdof, cs.ndof, nu=PRIM_NU,
                                            device=dev, **kwa)
    rs, rd, _ = field(stc, dv2, geom, hv, cfg)
    sp, qp, phi = packed(pack_qdp_t(stc, cfg))[:3]
    prim = state_errs(sp, rs)
    prim["qdp"] = relmax(tracer(qp, 0), rs.qdp[1 - qn0, :, 0])
    prim["phi"] = relmax(unpack_field_t(phi, nelem), rd.phi)
    report["prim_packed_relmax"] = prim

    # E3SM's 35 tracers, the state of the qsize-1 problem
    cfg35 = dataclasses.replace(cfg, qsize=QSIZE_TALL)
    q35 = random_state(cfg35, seed=9, **kw).qdp.clone()
    q35[qn0] = proj(q35[qn0])
    st35 = dataclasses.replace(stc, qdp=q35)
    qdp35 = pack_qdp_t(st35, cfg35)

    def tracers(qp, ref, suffix=""):
        return {f"qdp{q}{suffix}": relmax(tracer(qp, q), ref.qdp[1 - qn0, :, q])
                for q in TRACERS_SHOWN}

    def drift(qp):
        return max(mass_drift(geom.spheremp, tracer(qp, q), q35[qn0, :, q])
                   for q in TRACERS_SHOWN)

    rs35 = field(st35, dv2, geom, hv, cfg35)[0]
    sp35, qp35 = packed(qdp35)[:2]
    report["prim_packed_q35_relmax"] = {**state_errs(sp35, rs35),
                                        **tracers(qp35, rs35)}
    del rs35, sp35, qp35
    rs35l = field(st35, dv2, geom, hv, cfg35, limit_tracers=True)[0]
    qp35l = packed(qdp35, limit_tracers=True)[1]
    report["prim_packed_q35_limit_relmax"] = {
        **tracers(qp35l, rs35l), "mass_drift": drift(qp35l)}

    qp1 = packed(qdp35, limit_tracers=True, limit_iters=1)[1]
    it1 = {**tracers(qp1, rs35l, "_vs_field"), "mass_drift": drift(qp1)}
    # one limited stage against the per-(element, level) bounds of its own
    # input: the contract that the residual pass can break with iters=1
    sph_l = p["meta"][META_COLS.index("spheremp")].double()
    q3 = qdp35.double().reshape(QSIZE_TALL * k, nelem, 16)
    qmn = q3.amin(2, keepdim=True)
    qmx = q3.amax(2, keepdim=True)
    rng = (qmx - qmn).clamp(min=1e-300)
    for iters in (1, 2):
        y = tracer_limit_cuda(p["meta"], s0, s0, qdp35, p["dvv"], cfg.dt, k,
                              wind_rows=(0, 1), iters=iters)
        y3 = (y.double() / sph_l).reshape(QSIZE_TALL * k, nelem, 16)
        over = torch.maximum(torch.maximum(y3 - qmx, qmn - y3),
                             torch.zeros_like(y3)) / rng
        it1[f"stage_overshoot_iters{iters}"] = float(over.max())
    report["limiter_iters1"] = it1


def check(args) -> dict:
    """The report for parsed ``args`` (nelem, nlev, ne, device)."""
    from ..bench import card_name_and_power
    from ..device import resolve_device

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    kw = dict(dtype=torch.float32, device=dev)
    report = {
        "backend": dev.type,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "card": card_name_and_power() if on_card else None,
        "torch": torch.__version__,
        "config": {"nelem": args.nelem, "nlev": args.nlev, "ne": args.ne,
                   "dtype": "float32", "dt2": DT2, "eta_ave_w": ETA,
                   "prim_dt": PRIM_DT, "prim_nu": PRIM_NU,
                   "qsize_tall": QSIZE_TALL},
    }
    report["raw_kernel_relmax"], report["raw_kernel_t_relmax"] = _raw(
        args, dev, kw)
    problem = _assembled(args, dev, kw, report)
    _prim(args, dev, kw, report, problem)

    single = {}
    for key in ("raw_kernel_relmax", "assembled_step_relmax",
                "raw_kernel_t_relmax", "assembled_step_t_relmax",
                "assembled_step_t4_relmax", "sharded_paths_relmax"):
        single.update({f"{key}.{n}": v for n, v in report[key].items()})
    single["fused_extract_slab_relmax"] = report["fused_extract_slab_relmax"]
    worst_key = max(single, key=single.get)
    report["worst_relmax"] = single[worst_key]
    report["worst_key"] = worst_key
    # the prim step chains ~10 kernels and a nonlinear stage order: a wider
    # envelope than one step's
    report["prim_worst_relmax"] = max(report["prim_packed_relmax"].values())
    report["prim_q35_worst_relmax"] = max(
        report["prim_packed_q35_relmax"].values())
    lim = report["prim_packed_q35_limit_relmax"]
    report["prim_q35_limit_worst_relmax"] = max(
        v for n, v in lim.items() if n != "mass_drift")
    got = dict(report, prim_q35_limit_mass_drift=lim["mass_drift"])
    report["limits"] = dict(LIMITS)
    report["pass"] = all(got[n] < v for n, v in LIMITS.items())
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tinman_sandbox_tpu_torch.tools.equiv_check",
        description="the port's kernel paths against independent forms of "
                    "the same steps on the card, one JSON report")
    ap.add_argument("--nelem", type=int, default=512)
    ap.add_argument("--nlev", type=int, default=72)
    ap.add_argument("--ne", type=int, default=4,
                    help="cubed-sphere size of the assembled, sharded and "
                         "prim checks")
    ap.add_argument("--out", default=None,
                    help="write the report here (default on the card: "
                         "H100_EQUIV.json at the repository root)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: the plain versions (for the tests)")
    args = ap.parse_args(argv)
    report = check(args)
    print(json.dumps(report), flush=True)
    out = args.out
    if out is None and report["backend"] == "cuda":
        out = os.path.join(ROOT, "H100_EQUIV.json")
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
