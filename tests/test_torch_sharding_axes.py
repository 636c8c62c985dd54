"""The GSPMD axes of the JAX package's tests/test_sharding_axes.py on the
port's explicit meshes: the field-form tracer step on the tracer axis
(:19) and on a 2-D element x tracer mesh (:33), and CAAR with the level
axis sharded (:56), whose vertical scans cross shards through explicit
carries (``dist.level_sharded``); the 2-D ``LocalMesh``'s collectives along
one axis, the tensor / dataclass sharding on any axis and dimension and its
inverse, and the carries over a 4-process CPU ``gloo`` ``DistMesh``.

Tolerances: the sharded Euler step is bit for bit the port's unsharded one
in f64 (both are per-element, per-tracer code) and within JAX's rtol 1e-13
of JAX's; the level-sharded CAAR within JAX's rtol = atol = 1e-12 of JAX's
unsharded ``caar_xla`` at rsplit=1 and of the port's ``caar_array`` in f64
at rsplit=0 (its carries add a shard's total before its levels: another
order than the unsharded cumsum); ``DistMesh`` bit for bit ``LocalMesh``.
"""
import dataclasses
import multiprocessing
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu.kernels import caar_xla as j_caar_xla
from tinman_sandbox_tpu.timeloop import euler_step as j_euler_step
from tinman_sandbox_tpu_torch.convert import from_numpy
from tinman_sandbox_tpu_torch.dist.level_sharded import (
    caar_level_sharded, euler_step_sharded, shard_levels, unshard_levels)
from tinman_sandbox_tpu_torch.dist.sharding import (
    LocalMesh, exclusive_prefix, shard_tensor, shard_tree, unshard_tensor,
    unshard_tree)
from tinman_sandbox_tpu_torch.kernels.caar_array import caar_array
from tinman_sandbox_tpu_torch.multichip import gloo_level_worker, level_problem
from tinman_sandbox_tpu_torch.timeloop.tracer import euler_step

torch.set_num_threads(2)
EULER_RTOL = 1e-13        # JAX's test
CAAR_TOL = 1e-12          # JAX's test, rtol and atol
GLOO_WORLD = 4
GLOO_TIMEOUT_S = 120


def _np(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _problem(nelem=8, nlev=4, qsize=8, seed=15):
    """The JAX test's problem, both packages' forms (f64)."""
    cfg = jt.Config(nelem=nelem, nlev=nlev, qsize=qsize)
    st = jt.random_state(cfg, seed=seed)
    geom = jt.random_geometry(cfg, seed=seed + 1)
    dv = jt.zero_derived(cfg)
    hv = jt.analytic_hvcoord(cfg)
    ts, td, tg, th = from_numpy(_np(st), _np(dv), _np(geom), _np(hv),
                                device="cpu")
    return cfg, st, geom, ts, td, tg, th


@pytest.mark.parametrize("case", ["tracer_axis", "e_by_q"])
def test_torch_sharding_axes_euler_step(case):
    """euler_step on qdp sharded on its tracer axis over 4 shards (JAX :19,
    dt 2) and on the (4, 2) element x tracer mesh with the geometry sharded
    on the element axis and dvv replicated (JAX :33, dt 0.3): bit for bit
    the port's unsharded step, within rtol 1e-13 of JAX's."""
    if case == "tracer_axis":
        cfg, st, geom, ts, _, tg, _ = _problem()
        mesh, dt, kw = LocalMesh(4, "cpu", axis_names=("q",)), 2.0, {}
    else:
        cfg, st, geom, ts, _, tg, _ = _problem(nelem=8, qsize=4)
        mesh = LocalMesh((4, 2), "cpu", axis_names=("e", "q"))
        dt, kw = 0.3, {"elem_axis": "e"}
    ref = np.asarray(j_euler_step(jnp.asarray(st.qdp[cfg.qn0]),
                                  jnp.asarray(st.u[cfg.n0]),
                                  jnp.asarray(st.v[cfg.n0]), geom, cfg, dt))
    qdp, vu, vv = ts.qdp[cfg.qn0], ts.u[cfg.n0], ts.v[cfg.n0]
    whole = euler_step(qdp, vu, vv, tg, cfg, dt)
    got = euler_step_sharded(mesh, qdp, vu, vv, tg, cfg, dt,
                             tracer_axis="q", **kw)
    assert torch.equal(got, whole)
    np.testing.assert_allclose(got.numpy(), ref, rtol=EULER_RTOL)
    # the step moved qdp: the comparison holds a tendency
    assert float((got - qdp).abs().max()) > 1e-8


@pytest.mark.parametrize("rsplit", [1, 0])
def test_torch_sharding_axes_level_axis_caar(rsplit):
    """caar_array with u, v, t, dp3d sharded on their level axis and qdp on
    its own over 4 shards (JAX :56: nelem 4, nlev 8, dt2 0.1, eta_ave_w 1):
    t[np1] and phi within 1e-12 of JAX's unsharded caar_xla at rsplit=1, of
    the port's caar_array at rsplit=0 (a hybi ramp, so that the hybi*sdot
    term and the vertical advection cross the shards), every other output
    too; the shards' interface field round-trips."""
    cfg, st, geom, ts, td, tg, th = _problem(nelem=4, nlev=8, qsize=1)
    tcfg_kw = dict(nelem=4, nlev=8, qsize=1, rsplit=rsplit)
    from tinman_sandbox_tpu_torch import Config

    tcfg = Config(**tcfg_kw)
    if rsplit == 0:
        th = dataclasses.replace(th, hybi=torch.linspace(0.0, 1.0, 9,
                                                         dtype=torch.float64))
        td = dataclasses.replace(td, eta_dot_dpdn=torch.rand(
            td.eta_dot_dpdn.shape, generator=torch.Generator().manual_seed(3),
            dtype=torch.float64))
    mesh = LocalMesh(4, "cpu")
    ss, ds = shard_levels(mesh, ts, td)
    assert [s.u.shape[2] for s in ss] == [2] * 4
    assert [d.eta_dot_dpdn.shape[1] for d in ds] == [2, 2, 2, 3]
    back = unshard_levels(mesh, ss, ds)
    for a, b in zip(back, (ts, td)):
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name))
    out_s, out_d = unshard_levels(mesh, *caar_level_sharded(
        mesh, ss, ds, tg, th, tcfg, 0.1, 1.0))
    if rsplit:
        ref_s, ref_d = j_caar_xla(st, jt.zero_derived(cfg), geom,
                                  jt.analytic_hvcoord(cfg), cfg, 0.1, 1.0)
        ref_t, ref_phi = np.asarray(ref_s.t[cfg.np1]), np.asarray(ref_d.phi)
    else:
        ref_s, ref_d = caar_array(ts, td, tg, th, tcfg, 0.1, 1.0,
                                  device="cpu")
        ref_t, ref_phi = ref_s.t[tcfg.np1].numpy(), ref_d.phi.numpy()
        for name in ("u", "v", "dp3d"):
            np.testing.assert_allclose(getattr(out_s, name).numpy(),
                                       getattr(ref_s, name).numpy(),
                                       rtol=CAAR_TOL, atol=CAAR_TOL)
        for name in ("omega_p", "eta_dot_dpdn", "vn0_u", "vn0_v"):
            np.testing.assert_allclose(getattr(out_d, name).numpy(),
                                       getattr(ref_d, name).numpy(),
                                       rtol=CAAR_TOL, atol=CAAR_TOL)
        # the eta path moved the step: rsplit=1 lands elsewhere
        lag, _ = caar_array(ts, td, tg, th, Config(**dict(tcfg_kw, rsplit=1)),
                            0.1, 1.0, device="cpu")
        assert float((lag.t[1] - out_s.t[1]).abs().max()) > 1e-8
    np.testing.assert_allclose(out_s.t[tcfg.np1].numpy(), ref_t,
                               rtol=CAAR_TOL, atol=CAAR_TOL)
    np.testing.assert_allclose(out_d.phi.numpy(), ref_phi, rtol=CAAR_TOL,
                               atol=CAAR_TOL)


def test_torch_sharding_axes_mesh_collectives():
    """A (4, 2) LocalMesh: coordinates row-major; all_gather, psum and
    ppermute along each axis within its lines; exclusive_prefix forward and
    reverse along an axis; refusals of unknown axes and shapes."""
    mesh = LocalMesh((4, 2), "cpu", axis_names=("e", "q"))
    assert mesh.n == 8 and mesh.coords(5) == (2, 1)
    assert mesh.axis_size("e") == 4 and mesh.axis_index(5, "q") == 1
    xs = [torch.full((2,), float(s)) for s in mesh.shards]
    g = mesh.all_gather(xs, "e")
    assert torch.equal(g[5], torch.stack([xs[1], xs[3], xs[5], xs[7]]))
    assert torch.equal(mesh.psum(xs, "q")[4], xs[4] + xs[5])
    assert torch.equal(mesh.psum(xs)[0], sum(xs[1:], xs[0].clone()))
    moved = mesh.ppermute(xs, [(0, 1)], "q")
    assert torch.equal(moved[3], xs[2]) and torch.equal(moved[2],
                                                       torch.zeros(2))
    pre = exclusive_prefix(mesh, xs, "e")
    suf = exclusive_prefix(mesh, xs, "e", reverse=True)
    assert torch.equal(pre[0], torch.zeros(2))
    assert torch.equal(pre[5], xs[1] + xs[3])
    assert torch.equal(suf[3], xs[7] + xs[5])
    assert torch.equal(suf[7], torch.zeros(2))
    with pytest.raises(ValueError, match="axes"):
        mesh.all_gather(xs, "k")
    with pytest.raises(ValueError, match="axis names"):
        LocalMesh((4, 2), "cpu")
    with pytest.raises(ValueError, match="n >= 1"):
        LocalMesh((4, 0), "cpu", axis_names=("a", "b"))


def test_torch_sharding_axes_shard_round_trips():
    """shard_tensor cuts any dimension over any axis (both axes of a 2-D
    mesh at once, replicated over those left out) and unshard_tensor /
    unshard_tree put the whole back; a dimension that does not split is
    refused."""
    mesh = LocalMesh((4, 2), "cpu", axis_names=("e", "q"))
    x = torch.arange(8 * 6 * 3, dtype=torch.float64).reshape(8, 6, 3)
    parts = shard_tensor(mesh, x, {"e": 0, "q": 1})
    assert parts[3].shape == (2, 3, 3) and torch.equal(parts[3], x[2:4, 3:])
    assert torch.equal(unshard_tensor(mesh, parts, {"e": 0, "q": 1}), x)
    rep = shard_tensor(mesh, x, {"q": 2 - 1})
    assert torch.equal(rep[0], rep[6]) and torch.equal(rep[1], x[:, 3:])
    with pytest.raises(ValueError, match="does not split"):
        shard_tensor(mesh, x, {"e": 2})
    _, _, _, ts, _, tg, _ = _problem()
    specs = {f.name: {"e": 0} for f in dataclasses.fields(tg)}
    specs["dvv"] = {}
    shards = shard_tree(mesh, tg, specs)
    assert shards[2].metdet.shape[0] == 2
    assert torch.equal(shards[2].dvv, tg.dvv)
    back = unshard_tree(mesh, shards, specs)
    for f in dataclasses.fields(tg):
        assert torch.equal(getattr(back, f.name), getattr(tg, f.name))


def test_torch_sharding_axes_gloo_carries(tmp_path):
    """The level-axis carries over a 4-process gloo DistMesh on the level
    axis: exclusive_prefix forward and reverse, and the level-sharded CAAR
    at rsplit 1 and 0 (``multichip.level_problem``), bit for bit the same
    over LocalMesh(4)."""
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{tmp_path}/gloo_init"
    procs = [ctx.Process(target=gloo_level_worker,
                         args=(r, GLOO_WORLD, init, str(tmp_path)))
             for r in range(GLOO_WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + GLOO_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
    for p in procs:
        p.join(5)
    assert not hung, f"gloo ranks still running after {GLOO_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * GLOO_WORLD

    mesh = LocalMesh(GLOO_WORLD, "cpu")
    x = [torch.arange(6.0, dtype=torch.float64).reshape(2, 3) + 10.0 * r
         for r in range(GLOO_WORLD)]
    want = {"prefix": exclusive_prefix(mesh, x),
            "suffix": exclusive_prefix(mesh, x, reverse=True)}
    for rsplit in (1, 0):
        cfg, st, dv, geom, hv = level_problem(4, 8, rsplit)
        ss, ds = shard_levels(mesh, st, dv)
        whole = unshard_levels(mesh, *caar_level_sharded(
            mesh, ss, ds, geom, hv, cfg, 0.1, 1.0))
        want[rsplit] = [whole] * GLOO_WORLD
    for r in range(GLOO_WORLD):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        for name in ("prefix", "suffix"):
            assert torch.equal(got[name], want[name][r]), (r, name)
        for rsplit in (1, 0):
            for a, b in zip(got[rsplit], want[rsplit][r]):
                for f in dataclasses.fields(a):
                    assert torch.equal(getattr(a, f.name),
                                       getattr(b, f.name)), (r, rsplit,
                                                             f.name)
