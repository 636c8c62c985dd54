"""CAAR with the level axis sharded, and the field-form tracer step on the
tracer and element axes (counterpart of the GSPMD axes of the JAX
package's tests/test_sharding_axes.py, where XLA inserts the collectives;
here they are explicit phases on a ``LocalMesh`` or a ``DistMesh``).

``caar_level_sharded`` runs ``kernels.caar_array.caar_array`` with u, v, t,
dp3d, qdp and the level fields of ``Derived`` cut on the level axis into
contiguous shards of nlev / n levels over the whole mesh (``shard_levels``,
back with ``unshard_levels``). It runs ``caar_array``'s own code
(``level_terms``, the ops of ``ops/scans.py``, ``tendencies``,
``leapfrog_update``) on each shard; what is new are the carries of the
vertical recurrences across shards (``sharding.exclusive_prefix``, one
``all_gather`` of the per-shard totals each):

  * ``midpoint_pressure`` (ops/scans.py): the sum of dp of the shards
    above, added to the top pressure;
  * ``preq_hydrostatic``: the sum of its integrand over the shards below,
    added to phis;
  * ``preq_omega_ps``: the sum of divdp of the shards above, taken from
    vgrad_p;
  * at rsplit=0 ``eta_dot_dpdn_rsplit0`` runs on the shard's divdp with
    the shards above and the shards below as one level each around it, so
    that its cumsum carries the shards above and its total is the column's;
    ``preq_vertadv`` runs on the shard's levels with the neighbouring
    level of each side as a one-level halo (one ``ppermute`` each way),
    and the interface below a shard's last level is the next shard's top.

The sums add in another order than the unsharded cumsums (a shard's total,
then its levels): the step agrees with the unsharded one to rounding, not
bit for bit. The interface field ``eta_dot_dpdn`` has nlev + 1 entries,
which do not split evenly: a shard holds the top interface of each of its
levels, and the last shard also the bottom interface of the column (nl + 1
entries).

``euler_step_sharded`` runs the field-form ``timeloop.tracer.euler_step``
on shards of qdp cut on its tracer axis and, on a 2-D mesh, its element
axis too, the winds and the geometry cut on the element axis alike and
``dvv`` replicated. Both are per-element, per-tracer code: each shard's
result is the unsharded step's own values, and ``unshard_tensor`` puts them
back bit for bit.

None of this launches a kernel: ``caar_array`` and ``euler_step`` are the
port's array code (as XLA array code in the JAX package).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..config import Config
from ..constants import CONSTANTS
from ..grid import Geometry, HybridVCoord
from ..kernels.caar_array import leapfrog_update, level_terms, tendencies
from ..ops import (
    eta_dot_dpdn_rsplit0, midpoint_pressure, preq_hydrostatic, preq_omega_ps,
    preq_vertadv)
from ..state import Derived, State
from ..timeloop.tracer import euler_step
from .sharding import (
    exclusive_prefix, shard_tensor, shard_tree, unshard_tensor, unshard_tree)

__all__ = ["LEVEL_DIMS", "shard_levels", "unshard_levels",
           "caar_level_sharded", "euler_step_sharded"]

# the level dimension of each field that has one (interfaces apart)
LEVEL_DIMS = {"u": 2, "v": 2, "t": 2, "dp3d": 2, "qdp": 3,
              "vn0_u": 1, "vn0_v": 1, "phi": 1, "omega_p": 1, "pecnd": 1}
_IFACE_DIM = 1                      # eta_dot_dpdn [nelem, nlev + 1, np, np]
# the level fields cut over the whole mesh (a spec's axis None)
_SPECS = {name: {None: dim} for name, dim in LEVEL_DIMS.items()}


def _level_span(mesh, shard: int, nlev: int):
    """(k0, nl, last): the shard's first level, its level count, and
    whether it is the last."""
    if nlev % mesh.n:
        raise ValueError(f"{nlev} levels do not split over {mesh.n} shards")
    nl = nlev // mesh.n
    return shard * nl, nl, shard == mesh.n - 1


def _split_ifaces(mesh, x: torch.Tensor) -> list:
    """A shard's interfaces of ``x`` [..., nlev + 1 on dim 1, ...]: the top
    interface of each of its levels, and the bottom of the column on the
    last shard."""
    nlev = x.shape[_IFACE_DIM] - 1
    out = []
    for s in mesh.shards:
        k0, nl, last = _level_span(mesh, s, nlev)
        out.append(x.narrow(_IFACE_DIM, k0, nl + last).contiguous()
                   .to(mesh.device))
    return out


def shard_levels(mesh, state: State, derived: Derived):
    """``state`` and ``derived`` cut on the level axis: (state shards,
    derived shards), the lists this process holds; fields without a level
    axis (ps_v, phis) are replicated."""
    ifaces = _split_ifaces(mesh, derived.eta_dot_dpdn)
    return shard_tree(mesh, state, _SPECS), [
        dataclasses.replace(d, eta_dot_dpdn=e)
        for d, e in zip(shard_tree(mesh, dataclasses.replace(
            derived, eta_dot_dpdn=None), _SPECS), ifaces)]


def unshard_levels(mesh, states: list, deriveds: list):
    """The inverse of ``shard_levels``: the whole (state, derived)."""
    # the last shard's extra interface travels on its own: an all_gather
    # takes tensors of one shape
    nl = deriveds[0].phi.shape[1]
    tops = [d.eta_dot_dpdn.narrow(_IFACE_DIM, 0, nl) for d in deriveds]
    eta = unshard_tensor(mesh, [x.contiguous() for x in tops],
                         {None: _IFACE_DIM})
    ends = [d.eta_dot_dpdn.narrow(_IFACE_DIM, nl, 1)
            if _level_span(mesh, s, nl * mesh.n)[2]
            else torch.zeros_like(d.eta_dot_dpdn.narrow(_IFACE_DIM, 0, 1))
            for s, d in zip(mesh.shards, deriveds)]
    bottom = mesh.psum(ends)[0]
    derived = unshard_tree(
        mesh, [dataclasses.replace(d, eta_dot_dpdn=None) for d in deriveds],
        _SPECS)
    return unshard_tree(mesh, states, _SPECS), dataclasses.replace(
        derived, eta_dot_dpdn=torch.cat([eta, bottom], dim=_IFACE_DIM))


def _totals(xs) -> list:
    """Each shard's sum of ``xs`` over its levels, [nelem, 1, np, np]."""
    return [x.sum(dim=1, keepdim=True) for x in xs]


def _neighbours(mesh, xs, first: bool):
    """Each shard's neighbour's edge level of ``xs`` [nelem, nl, ...]: with
    ``first`` the next shard's first level (zeros on the last shard), else
    the previous shard's last (zeros on the first)."""
    n = mesh.n
    if first:
        edge = [x[:, :1] for x in xs]
        pairs = [(i + 1, i) for i in range(n - 1)]
    else:
        edge = [x[:, -1:] for x in xs]
        pairs = [(i, i + 1) for i in range(n - 1)]
    return mesh.ppermute([e.contiguous() for e in edge], pairs)


def caar_level_sharded(mesh, states: list, deriveds: list, geom: Geometry,
                       hv: HybridVCoord, cfg: Config, dt2, eta_ave_w,
                       moist: bool = True):
    """One CAAR evaluation + leapfrog update (``caar_array``'s contract) on
    level shards (``shard_levels``) of ``mesh``; ``geom`` and ``hv`` whole,
    on every shard. Returns (state shards, derived shards); the inputs are
    not modified."""
    c = CONSTANTS
    dev = mesh.device
    geom, hv = geom.to(dev), hv.to(dev)
    n0, qn0 = cfg.n0, cfg.qn0
    spans = [_level_span(mesh, s, cfg.nlev) for s in mesh.shards]
    u, v, t, dp = ([getattr(st, name)[n0] for st in states]
                   for name in ("u", "v", "t", "dp3d"))

    above_dp = exclusive_prefix(mesh, _totals(dp))
    p = [midpoint_pressure(hv.hyai[0] * hv.ps0 + a, x)
         for a, x in zip(above_dp, dp)]
    terms = [level_terms(u[i], v[i], t[i], dp[i],
                         st.qdp[qn0, :, 0] if moist else None, p[i], geom,
                         moist)
             for i, st in enumerate(states)]
    grad_p1, grad_p2, vgrad_p, vdp1, vdp2, divdp, vort, t_v = zip(*terms)

    # phi: preq_hydrostatic's integrand summed up from the bottom;
    # omega_p: divdp summed down from the top
    below_q = exclusive_prefix(mesh, _totals(
        [c.Rgas * tv * (x / pp) for tv, x, pp in zip(t_v, dp, p)]),
        reverse=True)
    tot_div = _totals(divdp)
    above_div = exclusive_prefix(mesh, tot_div)
    phi = [preq_hydrostatic(st.phis + b[:, 0], tv, pp, x, c.Rgas)
           for st, b, tv, pp, x in zip(states, below_q, t_v, p, dp)]
    omega_p = [preq_omega_ps(pp, vg - a, d)
               for pp, vg, a, d in zip(p, vgrad_p, above_div, divdp)]

    if cfg.rsplit > 0:
        vadv, d_eta = [None] * len(states), [0.0] * len(states)
        eta_own = [torch.zeros((x.shape[0], nl + last) + tuple(x.shape[2:]),
                               dtype=x.dtype, device=x.device)
                   for x, (_, nl, last) in zip(t, spans)]
    else:
        below_div = exclusive_prefix(mesh, tot_div, reverse=True)
        hybi = torch.as_tensor(hv.hybi, dtype=t[0].dtype, device=dev)
        eta_top = []
        for (k0, nl, _), a, d, b in zip(spans, above_div, divdp, below_div):
            # the shard's top interfaces k0 .. k0 + nl - 1; 0 at the top
            eta = eta_dot_dpdn_rsplit0(
                torch.cat([a, d, b], dim=1),
                F.pad(hybi[k0:k0 + nl + 1], (1, 1)))[0][:, 1:nl + 1]
            if k0 == 0:
                eta[:, 0] = 0.0
            eta_top.append(eta)
        # the interface below a shard's last level: the next shard's top,
        # 0 at the column's bottom
        lo = _neighbours(mesh, eta_top, first=True)
        halo = [(_neighbours(mesh, xs, first=False),
                 _neighbours(mesh, xs, first=True)) for xs in (t, u, v)]
        vadv, d_eta, eta_own = [], [], []
        for i, (_, nl, last) in enumerate(spans):
            e = torch.cat([eta_top[i], lo[i]], dim=1)
            one, zero = torch.ones_like(dp[i][:, :1]), torch.zeros_like(lo[i])
            ext = [torch.cat([above[i], xs[i], below[i]], dim=1)
                   for xs, (above, below) in zip((t, u, v), halo)]
            vadv.append(tuple(x[:, 1:-1] for x in preq_vertadv(
                *ext, torch.cat([zero, e, zero], dim=1),
                torch.cat([one, 1.0 / dp[i], one], dim=1))))
            d_eta.append(e[:, 1:] - e[:, :-1])
            eta_own.append(e if last else eta_top[i])

    out = [leapfrog_update(
        st, dv,
        tendencies(u[i], v[i], t[i], p[i], phi[i], dv.pecnd, t_v[i],
                   omega_p[i], grad_p1[i], grad_p2[i], vort[i], divdp[i],
                   geom, vadv[i], d_eta[i]),
        dict(vdp1=vdp1[i], vdp2=vdp2[i], phi=phi[i], omega_p=omega_p[i],
             eta_dot_dpdn=eta_own[i]),
        geom, cfg, dt2, eta_ave_w)
        for i, (st, dv) in enumerate(zip(states, deriveds))]
    return [o[0] for o in out], [o[1] for o in out]


def euler_step_sharded(mesh, qdp, vstar_u, vstar_v, geom: Geometry,
                       cfg: Config, dt, tracer_axis="q", elem_axis=None):
    """``euler_step`` (qdp - dt*div(vstar*qdp), qdp [nelem, qsize, nlev,
    np, np]) with qdp cut on its tracer axis over ``tracer_axis`` and, with
    ``elem_axis``, on its element axis too, the winds and the geometry cut
    on the element axis (dimension 0 of every field) and dvv replicated.
    Each shard steps its own block; returns the whole result
    (``unshard_tensor``), bit for bit the unsharded step's."""
    elem = {} if elem_axis is None else {elem_axis: 0}
    spec = {**elem, tracer_axis: 1}
    qs = shard_tensor(mesh, qdp, spec)
    us = shard_tensor(mesh, vstar_u, elem)
    vs = shard_tensor(mesh, vstar_v, elem)
    gs = shard_tree(mesh, geom, {f.name: {} if f.name == "dvv" else elem
                                 for f in dataclasses.fields(geom)})
    out = [euler_step(q, a, b, g, cfg, dt)
           for q, a, b, g in zip(qs, us, vs, gs)]
    return unshard_tensor(mesh, out, spec)
