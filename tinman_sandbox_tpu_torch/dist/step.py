"""The assembled timestep in array form: CAAR + DSS of the updated fields
(counterpart of ``tinman_sandbox_tpu/dist/step.py``).

The CAAR apply writes spheremp-weighted updates (routine_mod.F90:182-190);
the assembly then sums shared dofs and multiplies by rspheremp. Here that
is ``caar_array`` followed by the segment-sum ``dss_scaled`` on the np1
prognostics: the f64 oracle of the assembled step. Its element-sharded
tiers take lists of shards (``sharding.shard_problem``) and a mesh: the
CAAR on every shard, then the assembly of the four np1 fields by one psum
of the perimeter (``caar_halo_step``), by ppermute rounds
(``caar_ppermute_step``) or by the partitioned segment sum
(``caar_dss_sharded_step``).
"""
from __future__ import annotations

import dataclasses

from ..config import Config
from ..device import resolve_device
from ..grid import Geometry, HybridVCoord
from ..kernels.caar_array import caar_array
from ..state import Derived, State
from .dss import dss_scaled, dss_scaled_sharded

__all__ = ["caar_dss_step", "caar_halo_step", "caar_ppermute_step",
           "caar_dss_sharded_step"]


def caar_dss_step(state: State, derived: Derived, geom: Geometry,
                  hv: HybridVCoord, gdof, ndof: int, cfg: Config, dt2,
                  eta_ave_w, moist: bool = True, device="cuda"):
    """One CAAR evaluation + DSS assembly of u, v, T, dp3d at np1. Returns
    (new_state, new_derived) on ``device``."""
    dev = resolve_device(device)
    state, derived = caar_array(state, derived, geom, hv, cfg, dt2,
                                eta_ave_w, moist=moist, device=dev)
    rsp = geom.rspheremp.to(dev)
    (state,) = _assemble_np1(
        [state], cfg, lambda xs: [dss_scaled(xs[0], gdof, ndof, rsp)])
    return state, derived


_PROGNOSTICS = ("u", "v", "t", "dp3d")


def _assemble_np1(states, cfg: Config, assemble) -> list:
    """The shards' states with u, v, t and dp3d at np1 replaced by
    ``assemble`` of the shards' np1 fields (a list in, a list out)."""
    np1 = cfg.np1
    new = {}
    for name in _PROGNOSTICS:
        fields = [getattr(s, name) for s in states]
        done = assemble([f[np1] for f in fields])
        new[name] = []
        for f, y in zip(fields, done):
            out = f.clone()
            out[np1] = y
            new[name].append(out)
    return [dataclasses.replace(s, **{n: new[n][i] for n in _PROGNOSTICS})
            for i, s in enumerate(states)]


def _sharded(states, deriveds, geoms, hv, cfg, dt2, eta_ave_w, moist,
             assemble):
    """CAAR on every shard, then ``assemble(fields, rsps)`` of the np1
    prognostics. Returns (states, deriveds), lists of shards."""
    dev = states[0].u.device
    out = [caar_array(s, d, g, hv, cfg, dt2, eta_ave_w, moist=moist,
                      device=dev) for s, d, g in zip(states, deriveds, geoms)]
    rsps = [g.rspheremp.to(dev) for g in geoms]
    new = _assemble_np1([o[0] for o in out], cfg,
                        lambda xs: assemble(xs, rsps))
    return new, [o[1] for o in out]


def caar_halo_step(states, deriveds, geoms, hv: HybridVCoord, plan, mesh,
                   cfg: Config, dt2, eta_ave_w, moist: bool = True):
    """``caar_dss_step`` on element shards with the explicit-collective halo
    DSS (``dist/halo.py``): per-shard assembly and one psum of the
    partition perimeter. ``states``, ``deriveds``, ``geoms``: this
    process's shards, on their device. Returns (states, deriveds)."""
    from .halo import dss_scaled_halo

    return _sharded(states, deriveds, geoms, hv, cfg, dt2, eta_ave_w, moist,
                    lambda xs, rsps: dss_scaled_halo(xs, plan, mesh, rsps))


def caar_ppermute_step(states, deriveds, geoms, hv: HybridVCoord, plan, mesh,
                       cfg: Config, dt2, eta_ave_w, moist: bool = True):
    """``caar_dss_step`` on element shards with the neighbour-wise ppermute
    exchange (``dist/halo_ppermute.py``). Returns (states, deriveds)."""
    from .halo_ppermute import dss_scaled_ppermute

    return _sharded(states, deriveds, geoms, hv, cfg, dt2, eta_ave_w, moist,
                    lambda xs, rsps: dss_scaled_ppermute(xs, plan, mesh,
                                                         rsps))


def caar_dss_sharded_step(states, deriveds, geoms, hv: HybridVCoord, gdof,
                          ndof: int, mesh, cfg: Config, dt2, eta_ave_w,
                          moist: bool = True):
    """``caar_dss_step`` on element shards with the segment-sum DSS as SPMD
    partitions it (``dss.dss_scaled_sharded``: each shard's share of the
    whole dof sum, one psum): the JAX package's ``caar_dss_step`` on a
    sharded problem. Returns (states, deriveds)."""
    return _sharded(states, deriveds, geoms, hv, cfg, dt2, eta_ave_w, moist,
                    lambda xs, rsps: dss_scaled_sharded(xs, gdof, ndof, mesh,
                                                        rsps))
