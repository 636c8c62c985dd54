"""The multi-device dry run (counterpart of ``dryrun_multichip`` of the
JAX package's ``__graft_entry__.py``, :90): one step of each ported
multi-device tier on an n-shard mesh, each held bit for bit to the
single-device port's step on the same inputs, with continuity exactly 0.

  5. the face-sharded assembled step (``caar_dss_sharded_t4``) on a face
     mesh of min(n, 6) shards (3 where that does not divide 6), ne 4;
  6. the band-sharded assembled step (``caar_dss_banded_t4``) over n
     shards, m = n / gcd(6, n) bands a face (when m >= 2), on the smallest
     ne that the JAX package picks for it;
  7. the band-sharded full model step (``prim_step_banded_t4``: SSPRK3
     dynamics, hyperviscosity, tracers, qsize 2) at ne 8, m = 4, over n
     shards (when n | 24).

Tiers 1-4 of the JAX dry run (the element-sharded psum and ppermute halo
DSS, the segment-sum DSS, the interior / boundary overlap) are not ported
yet. Run: ``python -c "from tinman_sandbox_tpu_torch.multichip import
dryrun_multichip; print(dryrun_multichip(8))"`` (on the card), or with
``device="cpu"`` the plain versions.
"""
from __future__ import annotations

import math

import torch

from .device import resolve_device

__all__ = ["dryrun_multichip", "gloo_worker"]

NLEV = 8


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


def dryrun_multichip(n: int, device=None, tiers=(5, 6, 7)) -> dict:
    """Run the ported tiers of the multi-device dry run on an n-shard
    ``LocalMesh`` (on the card unless ``device="cpu"``); raises
    AssertionError where a tier leaves the single-device step's bits, and
    NotImplementedError for tiers 1-4. Returns {tier: description} of what
    ran."""
    from . import bench
    from .dist import (
        LocalMesh, build_cubed_sphere, caar_dss_banded_t4,
        caar_dss_sharded_t4, make_face_mesh, prim_step_banded_t4,
        prim_step_packed_t4, shard_packed_t4)

    if any(t in (1, 2, 3, 4) for t in tiers):
        raise NotImplementedError("not yet ported: A14b (tiers 1-4: the "
                                  "element-sharded halo and segment-sum DSS)")
    dev = resolve_device("cuda" if device is None else device)
    ran = {}
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
