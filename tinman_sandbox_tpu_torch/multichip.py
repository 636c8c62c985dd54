"""The multi-device dry run (counterpart of ``dryrun_multichip`` of the
JAX package's ``__graft_entry__.py``, :90): one step of each multi-device
tier on an n-shard mesh.

  1-4. the element-sharded tiers on the smallest cubed sphere whose 6ne^2
     elements split over n shards (nlev 8, random state seed 7, f32): the
     CAAR with the psum halo DSS (``caar_halo_step``) and then the tracer
     step (``advance_qdp``); with the ppermute rounds
     (``caar_ppermute_step``); with the segment sum as SPMD partitions it
     (``caar_dss_sharded_step``); the interior / boundary overlap
     (``caar_ppermute_overlap_step``). Each within 1e-4 of the
     single-device ``caar_dss_step`` on t at np1, and tiers 2-4 within
     1e-4 of tier 1, as the JAX dry run holds them;
  5. the face-sharded assembled step (``caar_dss_sharded_t4``) on a face
     mesh of min(n, 6) shards (3 where that does not divide 6), ne 4;
  6. the band-sharded assembled step (``caar_dss_banded_t4``) over n
     shards, m = n / gcd(6, n) bands a face (when m >= 2), on the smallest
     ne that the JAX package picks for it;
  7. the band-sharded full model step (``prim_step_banded_t4``: SSPRK3
     dynamics, hyperviscosity, tracers, qsize 2) at ne 8, m = 4, over n
     shards (when n | 24);
  8. the band-sharded assembled step at the canonical 72 levels, ne 8,
     m = 4 (when n | 24), seed 13, within 1e-4 of the segment-sum
     ``caar_dss_step`` on u, v, t and dp3d at np1.

Tiers 5-7 are held bit for bit to the single-device port's step on the same
inputs, with continuity exactly 0. Run: ``python -c "from
tinman_sandbox_tpu_torch.multichip import dryrun_multichip;
print(dryrun_multichip(8))"`` (on the card), or with ``device="cpu"`` the
plain versions.
"""
from __future__ import annotations

import math

import torch

from .device import resolve_device

__all__ = ["dryrun_multichip", "element_sharded_problem",
           "element_sharded_tiers", "gloo_worker", "gloo_tier_worker",
           "level_problem", "gloo_level_worker"]

NLEV = 8
TIERS = (1, 2, 3, 4, 5, 6, 7, 8)
# the JAX dry run's limit on the tiers' t at np1 (f32, |t| ~ 300)
TIER_TOL = 1e-4


def _same(label, got, want, mesh, gdof):
    from .dist import continuity_error_t, unshard_packed_t4

    for i, (g, w) in enumerate(zip(got, want)):
        g = unshard_packed_t4(mesh, g)
        if not torch.equal(g, w):
            err = float((g - w).abs().max())
            raise AssertionError(f"{label}: output {i} differs from the "
                                 f"single-device step by {err}")
    cont = continuity_error_t(unshard_packed_t4(mesh, got[0]), gdof)
    if cont != 0.0:
        raise AssertionError(f"{label}: continuity {cont}")


def _assembled(ne, device):
    from . import bench
    from .dist import build_cubed_sphere, caar_dss_structured_packed_t4

    const, (s0, sm1), acc, plan, rsp = bench.make_assembled_problem(
        ne, NLEV, device)
    scal, meta, qdp, pecnd, dvv = const
    ref = caar_dss_structured_packed_t4(scal, meta, s0, sm1, qdp, pecnd,
                                        *(a.clone() for a in acc), dvv, plan,
                                        rsp)
    gdof = build_cubed_sphere(ne, device=device).gdof
    return (scal, meta, s0, sm1, qdp, pecnd, acc, dvv, plan, rsp), ref, gdof


def _sharded_args(mesh, args):
    from .dist import shard_packed_t4

    scal, meta, s0, sm1, qdp, pecnd, acc, dvv, plan, rsp = args
    sh = shard_packed_t4(mesh, meta, s0, sm1, qdp, pecnd, *acc, rsp)
    return (scal, *sh[:8], dvv, plan, sh[8])


def element_sharded_problem(n: int, device, nlev: int = NLEV, ne=None,
                            seed: int = 7):
    """The element-sharded tiers' problem: the cubed sphere at ``ne`` (by
    default the smallest whose 6ne^2 elements split over n shards), random
    state (``seed``), zero derived, its geometry and the analytic hvcoord,
    in f32 on ``device``. Returns (cs, cfg, state, derived, geom, hv)."""
    from . import Config, analytic_hvcoord, random_state, zero_derived
    from .dist import build_cubed_sphere

    if ne is None:
        ne = 2
        while (6 * ne * ne) % n:
            ne += 1
    kw = dict(dtype=torch.float32, device=device)
    cs = build_cubed_sphere(ne, **kw)
    cfg = Config(nelem=cs.nelem, nlev=nlev)
    return (cs, cfg, random_state(cfg, seed=seed, **kw),
            zero_derived(cfg, **kw), cs.geometry, analytic_hvcoord(cfg, **kw))


def element_sharded_tiers(mesh, cs, cfg, state, derived, geom, hv,
                          dt2=0.1, eta_ave_w=1.0) -> dict:
    """One step of each element-sharded tier over ``mesh`` from the same
    whole problem: {1: halo, 2: ppermute, 3: segment sum, 4: overlap}, each
    (states, deriveds) as lists of shards."""
    from .dist import (
        caar_dss_sharded_step, caar_halo_step, caar_ppermute_overlap_step,
        caar_ppermute_step, make_dss_plan, make_overlap_plan,
        make_ppermute_plan, shard_problem)

    st, dv, gm = shard_problem(mesh, state, derived, geom)
    pplan = make_ppermute_plan(cs.gdof, mesh.n)
    return {
        1: caar_halo_step(st, dv, gm, hv, make_dss_plan(cs.gdof, mesh.n),
                          mesh, cfg, dt2, eta_ave_w),
        2: caar_ppermute_step(st, dv, gm, hv, pplan, mesh, cfg, dt2,
                              eta_ave_w),
        3: caar_dss_sharded_step(st, dv, gm, hv, cs.gdof, cs.ndof, mesh, cfg,
                                 dt2, eta_ave_w),
        4: caar_ppermute_overlap_step(st, dv, gm, hv, pplan,
                                      make_overlap_plan(cs.gdof, mesh.n),
                                      mesh, cfg, dt2, eta_ave_w),
    }


def _tier8(n: int, dev) -> str:
    """The band-sharded assembled step at nlev 72 against the segment-sum
    step (the JAX dry run's tier 8: ne 8, m 4, seed 13, f32, one-row
    rspheremp)."""
    from .dist import (
        LocalMesh, caar_dss_banded_t4, caar_dss_step, make_structured_plan,
        shard_packed_t4, unshard_packed_t4)
    from .kernels.caar_t import _scalars, pack_problem_t
    from .kernels.layout import unpack_field_t

    ne, m, nlev = 8, 4, 72
    cs, cfg, st, dv, geom, hv = element_sharded_problem(n, dev, nlev, ne, 13)
    p = pack_problem_t(st, dv, geom, hv, cfg)
    s0 = torch.cat([p[k] for k in ("u0", "v0", "t0", "dp0")])
    sm1 = torch.cat([p[k] for k in ("um1", "vm1", "tm1", "dpm1")])
    rsp = geom.rspheremp.reshape(1, -1).contiguous()
    mesh = LocalMesh(n, dev)
    sh = shard_packed_t4(mesh, p["meta"], s0, sm1, p["qdp"], p["pecnd"],
                         p["vn0u"], p["vn0v"], p["omg"], rsp)
    got = caar_dss_banded_t4(_scalars(0.1, 1.0, hv, torch.float32, dev),
                             *sh[:8], p["dvv"], make_structured_plan(
                                 cs.gdof, ne), sh[8], mesh, m)
    s1 = unshard_packed_t4(mesh, got[0])
    ref, _ = caar_dss_step(st, dv, geom, hv, cs.gdof, cs.ndof, cfg, 0.1, 1.0,
                           device=dev)
    for i, name in enumerate(("u", "v", "t", "dp3d")):
        a = unpack_field_t(s1[i * nlev:(i + 1) * nlev], cfg.nelem)
        err = float((a - getattr(ref, name)[cfg.np1]).abs().max())
        if not err < TIER_TOL:
            raise AssertionError(f"tier 8 banded nlev=72 {name} np1 vs the "
                                 f"segment-sum step: {err}")
    return f"banded ne{ne} x {nlev}, m={m}, on {n} shards"


def dryrun_multichip(n: int, device=None, tiers=TIERS) -> dict:
    """Run the multi-device dry run's ``tiers`` on an n-shard ``LocalMesh``
    (on the card unless ``device="cpu"``); raises AssertionError where a
    tier leaves its reference. Returns {tier: description} of what ran."""
    from . import bench
    from .dist import (
        LocalMesh, build_cubed_sphere, caar_dss_banded_t4,
        caar_dss_sharded_t4, caar_dss_step, make_face_mesh,
        prim_step_banded_t4, prim_step_packed_t4, shard_packed_t4,
        shard_problem, unshard)
    from .timeloop.tracer import advance_qdp

    dev = resolve_device("cuda" if device is None else device)
    ran = {}
    if any(t in (1, 2, 3, 4) for t in tiers):
        cs, cfg, st, dv, geom, hv = element_sharded_problem(n, dev)
        mesh = LocalMesh(n, dev)
        out = element_sharded_tiers(mesh, cs, cfg, st, dv, geom, hv)
        # tier 1 goes on with the tracer step on the shards
        out[1] = ([advance_qdp(s, g, cfg, 0.1) for s, g in
                   zip(out[1][0], shard_problem(mesh, geom))], out[1][1])
        ref, _ = caar_dss_step(st, dv, geom, hv, cs.gdof, cs.ndof, cfg, 0.1,
                               1.0, device=dev)
        t_np1 = {t: unshard(mesh, o[0]).t[cfg.np1] for t, o in out.items()}
        for t, x in t_np1.items():
            err = float((x - ref.t[cfg.np1]).abs().max())
            agree = float((x - t_np1[1]).abs().max())
            if not (err < TIER_TOL and agree < TIER_TOL):
                raise AssertionError(f"tier {t}: t at np1 {err} from the "
                                     f"single-device step, {agree} from "
                                     "tier 1")
        names = {1: "halo psum DSS + advance_qdp", 2: "ppermute halo DSS",
                 3: "segment-sum DSS", 4: "ppermute + interior overlap"}
        for t in (1, 2, 3, 4):
            if t in tiers:
                ran[t] = f"{names[t]} ne{cs.ne} x {NLEV} on {n} shards"
    if 5 in tiers:
        nf = min(6, n)
        nf = nf if 6 % nf == 0 else 3
        mesh = make_face_mesh(nf, dev)
        args, ref, gdof = _assembled(4, dev)
        for overlap in (False, True):
            got = caar_dss_sharded_t4(*_sharded_args(mesh, args),
                                      mesh, overlap=overlap)
            _same(f"tier 5 face-sharded (overlap={overlap})", got, ref, mesh,
                  gdof)
        ran[5] = f"face-sharded ne4 x {NLEV} on {nf} shards"
    m = n // math.gcd(6, n)
    if 6 in tiers and m >= 2:
        ne = m if m % 8 == 0 else m * (8 // math.gcd(m, 8))
        mesh = LocalMesh(n, dev)
        args, ref, gdof = _assembled(ne, dev)
        for overlap in (False, True):
            got = caar_dss_banded_t4(*_sharded_args(mesh, args), mesh, m,
                                     overlap=overlap)
            _same(f"tier 6 banded (overlap={overlap})", got, ref, mesh, gdof)
        ran[6] = f"banded ne{ne} x {NLEV}, m={m}, on {n} shards"
    if 7 in tiers and n >= 2 and 24 % n == 0:
        ne, m, dt, nu = 8, 4, 200.0, 1e19
        (scal, meta, pecnd, dvv), s0, qdp, acc, plan, rsp = \
            bench.make_prim_problem(ne, NLEV, dev, dt, qsize=2)
        ref = prim_step_packed_t4(scal, meta, s0, qdp, pecnd,
                                  *(a.clone() for a in acc), dvv, plan, rsp,
                                  nu, NLEV, dt=dt)
        mesh = LocalMesh(n, dev)
        sh = shard_packed_t4(mesh, meta, s0, qdp, pecnd, *acc, rsp)
        got = prim_step_banded_t4(scal, sh[0], sh[1], sh[2], sh[3], *sh[4:7],
                                  dvv, plan, sh[7], mesh, m, nu, NLEV, dt=dt)
        _same("tier 7 banded prim", got, ref, mesh,
              build_cubed_sphere(ne, device=dev).gdof)
        ran[7] = f"banded prim ne{ne} x {NLEV}, qsize 2, m={m}, on {n} shards"
    if 8 in tiers and n >= 2 and 24 % n == 0:
        ran[8] = _tier8(n, dev)
    return ran


def gloo_worker(rank: int, world: int, init_method: str, out_dir: str,
                ne: int = 4, m: int = 2) -> None:
    """One rank of a CPU ``gloo`` group (``init_method``, e.g. a
    ``file://`` path) running the plain band-sharded assembled step over
    ``DistMesh`` on the problem of ``bench.make_assembled_problem(ne, 4)``,
    overlap off and on, and each collective once; saves what it computed
    (the whole steps' outputs, gathered) to ``out_dir/rank<rank>.pt``. A
    module-level function, so that spawned processes can import it."""
    import os

    import torch.distributed as dist

    from . import bench
    from .dist import (
        DistMesh, caar_dss_banded_t4_plain, shard_packed_t4,
        unshard_packed_t4)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world)
    try:
        mesh = DistMesh()
        (scal, meta, qdp, pecnd, dvv), (s0, sm1), acc, plan, rsp = \
            bench.make_assembled_problem(ne, 4, "cpu")
        sh = shard_packed_t4(mesh, meta, s0, sm1, qdp, pecnd, *acc, rsp)
        out = {}
        for overlap in (False, True):
            got = caar_dss_banded_t4_plain(scal, *sh[:8], dvv, plan, sh[8],
                                           mesh, m, overlap=overlap)
            out[overlap] = [unshard_packed_t4(mesh, g) for g in got]
        x = torch.arange(6.0).reshape(2, 3) + 10 * rank
        pairs = [(s, s + 1) for s in range(0, world - 1, 2)]
        out["ppermute"] = mesh.ppermute([x], pairs)[0]
        out["all_gather"] = mesh.all_gather([x])[0]
        out["psum"] = mesh.psum([x])[0]
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def gloo_tier_worker(rank: int, world: int, init_method: str,
                     out_dir: str) -> None:
    """One rank of a CPU ``gloo`` group running the element-sharded tiers
    1-4 over ``DistMesh`` on the dry run's problem for ``world`` shards at
    nlev 4; saves the whole np1 fields of each (gathered) to
    ``out_dir/rank<rank>.pt``."""
    import os

    import torch.distributed as dist

    from .dist import DistMesh, unshard

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world)
    try:
        mesh = DistMesh()
        cs, cfg, st, dv, geom, hv = element_sharded_problem(world, "cpu", 4)
        out = {}
        for t, (states, _) in element_sharded_tiers(
                mesh, cs, cfg, st, dv, geom, hv).items():
            whole = unshard(mesh, states)
            out[t] = {n: getattr(whole, n)[cfg.np1]
                      for n in ("u", "v", "t", "dp3d")}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def level_problem(nelem: int, nlev: int, rsplit: int, device="cpu",
                  dtype=torch.float64, seed: int = 15):
    """The level-sharded CAAR's test problem: (cfg, state, derived, geom,
    hv): random state (``seed``) and geometry (``seed + 1``), the derived
    state zero but random accumulators (so that the in-place sums show),
    analytic hvcoord with a hybi ramp (the analytic hybi is all zeros and
    would hide the rsplit=0 hybi*sdot term)."""
    import dataclasses

    from . import (
        Config, analytic_hvcoord, random_geometry, random_state, zero_derived)

    cfg = Config(nelem=nelem, nlev=nlev, rsplit=rsplit)
    kw = dict(dtype=dtype, device=device)
    dv = zero_derived(cfg, **kw)
    gen = torch.Generator().manual_seed(seed)
    rand = lambda x: torch.rand(x.shape, generator=gen, dtype=dtype).to(
        x.device)
    dv = dataclasses.replace(dv, eta_dot_dpdn=rand(dv.eta_dot_dpdn),
                             omega_p=rand(dv.omega_p), vn0_u=rand(dv.vn0_u))
    hv = analytic_hvcoord(cfg, **kw)
    hv = dataclasses.replace(hv, hybi=torch.linspace(0.0, 1.0, nlev + 1,
                                                     **kw))
    return (cfg, random_state(cfg, seed=seed, **kw), dv,
            random_geometry(cfg, seed=seed + 1, **kw), hv)


def gloo_level_worker(rank: int, world: int, init_method: str,
                      out_dir: str, nelem: int = 4, nlev: int = 8) -> None:
    """One rank of a CPU ``gloo`` group running the level-axis carries over
    ``DistMesh``: ``exclusive_prefix`` forward and reverse of a rank-valued
    tensor, and ``caar_level_sharded`` at rsplit 1 and 0 on
    ``level_problem``; saves the prefixes and the whole steps' outputs
    (gathered) to ``out_dir/rank<rank>.pt``."""
    import os

    import torch.distributed as dist

    from .dist.level_sharded import (
        caar_level_sharded, shard_levels, unshard_levels)
    from .dist.sharding import DistMesh, exclusive_prefix

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world)
    try:
        mesh = DistMesh()
        x = [torch.arange(6.0, dtype=torch.float64).reshape(2, 3)
             + 10.0 * rank]
        out = {"prefix": exclusive_prefix(mesh, x)[0],
               "suffix": exclusive_prefix(mesh, x, reverse=True)[0]}
        for rsplit in (1, 0):
            cfg, st, dv, geom, hv = level_problem(nelem, nlev, rsplit)
            ss, ds = shard_levels(mesh, st, dv)
            got = caar_level_sharded(mesh, ss, ds, geom, hv, cfg, 0.1, 1.0)
            out[rsplit] = unshard_levels(mesh, *got)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
