"""The port's element-sharded DSS tiers (``dist/halo.py``,
``dist/halo_ppermute.py``, the plan of ``dist/overlap.py``) and the shard
split of ``dist/sharding.py`` against the JAX package's on the same numpy
inputs, JAX on the 8-device CPU mesh of tests/conftest.py, the port over
``LocalMesh(n, "cpu")`` (the steps: tests/test_torch_halo_steps.py):

  * the three plans equal JAX's arrays bit for bit (n = 2, 4, 8; ne 2-4);
  * ``dss_sum_halo`` / ``dss_sum_ppermute`` (and their scaled forms) equal
    JAX's ``shard_map`` versions to 1e-12 in f64, on 3-D and 2-D fields
    (the ppermute tier on 4 shards, whose rounds hold self-sends);
  * the shard split round-trips;
  * ``DistMesh`` on a CPU ``gloo`` group runs tiers 1-4 as ``LocalMesh``
    does: bit for bit at 2 ranks, and at 3 ranks (self-sends in the
    ppermute rounds) bit for bit for the ppermute tiers and to 1e-6 of
    max|x| in f32 for the psum tiers, whose sums of three shards' partials
    gloo may add in another order. The group starts from a ``file://``
    store under the test's temporary directory and is killed past 120 s.

JAX's psum adds in its own order, the port's ``LocalMesh.psum`` in shard
order, so f64 agreement is to 1e-12, not bitwise."""
import dataclasses
import multiprocessing
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.dist import make_mesh as j_mesh
from tinman_sandbox_tpu.dist.halo import dss_scaled_halo as j_scaled_halo
from tinman_sandbox_tpu.dist.halo import dss_sum_halo as j_halo
from tinman_sandbox_tpu.dist.halo import make_dss_plan as j_plan
from tinman_sandbox_tpu.dist.halo_ppermute import (
    dss_scaled_ppermute as j_scaled_pp,
)
from tinman_sandbox_tpu.dist.halo_ppermute import dss_sum_ppermute as j_pp
from tinman_sandbox_tpu.dist.halo_ppermute import make_ppermute_plan as j_pplan
from tinman_sandbox_tpu.dist.overlap import make_overlap_plan as j_oplan
from tinman_sandbox_tpu_torch.dist import (
    LocalMesh,
    dss_scaled_halo,
    dss_scaled_ppermute,
    dss_sum_halo,
    dss_sum_ppermute,
    make_dss_plan,
    make_overlap_plan,
    make_ppermute_plan,
    replicate,
    shard_problem,
    unshard,
)
from tinman_sandbox_tpu_torch.multichip import (
    element_sharded_problem,
    element_sharded_tiers,
    gloo_tier_worker,
)

F64_TOL = 1e-12
GLOO_F32_TOL = 1e-6           # three partials of a dof in another order
GLOO_TIMEOUT_S = 120
# (ne, n) with 6ne^2 % n == 0 at ne 2-4 and n in (2, 4, 8)
PLAN_CASES = [(2, 2), (2, 4), (2, 8), (3, 2), (4, 2), (4, 4), (4, 8)]


@pytest.mark.parametrize("ne,n", PLAN_CASES)
def test_torch_halo_plans_equal_jax(ne, n):
    gdof = j_build(ne).gdof
    a, b = j_plan(gdof, n), make_dss_plan(gdof, n)
    assert (a.ndev, a.nelem, a.n_local_max, a.n_gshared) == \
        (b.ndev, b.nelem, b.n_local_max, b.n_gshared)
    assert a.perimeter_fraction == b.perimeter_fraction
    for f in ("local_sid", "shared_local", "shared_global"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    a, b = j_pplan(gdof, n), make_ppermute_plan(gdof, n)
    assert (a.rounds, a.pair_len, a.n_local_max) == \
        (b.rounds, b.pair_len, b.n_local_max)
    assert a.perms == b.perms
    for f in ("local_sid", "send_idx"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for perm in b.perms:                      # each round a permutation
        assert sorted(d for _, d in perm) == list(range(n))
    a, b = j_oplan(gdof, n), make_overlap_plan(gdof, n)
    assert (a.nb_max, a.ni_max) == (b.nb_max, b.ni_max)
    for f in ("beid", "bw", "ieid", "iw"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("tier,ne,n,mid", [
    ("halo", 4, 8, (5,)), ("halo", 2, 8, ()),
    ("ppermute", 2, 4, (3,)), ("ppermute", 3, 2, ()),
])
def test_torch_halo_dss_matches_jax(tier, ne, n, mid):
    cs = j_build(ne)
    rng = np.random.default_rng(ne * 10 + n)
    x = rng.normal(size=(cs.nelem, *mid, 4, 4))
    rsp = np.asarray(cs.geometry.rspheremp)
    jm, lm = j_mesh(n), LocalMesh(n, "cpu")
    if tier == "halo":
        jp, tp = j_plan(cs.gdof, n), make_dss_plan(cs.gdof, n)
        jsum, jscaled, tsum, tscaled = (j_halo, j_scaled_halo, dss_sum_halo,
                                        dss_scaled_halo)
    else:
        jp, tp = j_pplan(cs.gdof, n), make_ppermute_plan(cs.gdof, n)
        jsum, jscaled, tsum, tscaled = (j_pp, j_scaled_pp, dss_sum_ppermute,
                                        dss_scaled_ppermute)
    with jm:
        want = np.asarray(jsum(jnp.asarray(x), jp, jm))
        want_s = np.asarray(jscaled(jnp.asarray(x), jp, jm, jnp.asarray(rsp)))
    xs = list(torch.from_numpy(x).chunk(n))
    got = torch.cat(tsum(xs, tp, lm)).numpy()
    got_s = torch.cat(tscaled(xs, tp, lm,
                              list(torch.from_numpy(rsp).chunk(n)))).numpy()
    np.testing.assert_allclose(got, want, rtol=F64_TOL, atol=F64_TOL)
    np.testing.assert_allclose(got_s, want_s, rtol=F64_TOL, atol=F64_TOL)


def test_torch_shard_problem_round_trips():
    mesh = LocalMesh(4, "cpu")
    cs, cfg, st, dv, geom, hv = element_sharded_problem(4, "cpu", nlev=3)
    shards = shard_problem(mesh, st, dv, geom)
    for parts, whole in zip(shards, (st, dv, geom)):
        assert len(parts) == 4
        back = unshard(mesh, parts)
        for f in dataclasses.fields(whole):
            assert torch.equal(getattr(back, f.name), getattr(whole, f.name))
    s1 = shards[0][1]
    assert s1.u.shape[1] == cfg.nelem // 4 and s1.qdp.shape[1] == 6
    assert torch.equal(s1.t, st.t[:, 6:12]) and \
        torch.equal(s1.phis, st.phis[6:12])
    assert shards[2][3].dvv is geom.dvv           # no element axis
    reps = replicate(mesh, hv)
    assert len(reps) == 4 and all(r is reps[0] for r in reps)
    with pytest.raises(ValueError, match="multiple"):
        shard_problem(LocalMesh(5, "cpu"), st)


@pytest.mark.parametrize("world", [2, 3])
def test_torch_distmesh_gloo_runs_element_tiers(tmp_path, world):
    """Tiers 1-4 over a ``gloo`` ``DistMesh`` of ``world`` ranks against
    ``LocalMesh(world)`` on the same problem."""
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{tmp_path}/gloo_init"
    procs = [ctx.Process(target=gloo_tier_worker,
                         args=(r, world, init, str(tmp_path)))
             for r in range(world)]
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
    assert [p.exitcode for p in procs] == [0] * world

    mesh = LocalMesh(world, "cpu")
    cs, cfg, st, dv, geom, hv = element_sharded_problem(world, "cpu", 4)
    want = {t: unshard(mesh, o[0]) for t, o in element_sharded_tiers(
        mesh, cs, cfg, st, dv, geom, hv).items()}
    for r in range(world):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert sorted(got) == [1, 2, 3, 4]
        for t, fields in got.items():
            for name, a in fields.items():
                b = getattr(want[t], name)[cfg.np1]
                if world == 2 or t in (2, 4):
                    assert torch.equal(a, b), (r, t, name)
                else:
                    err = float((a - b).abs().max() / b.abs().max())
                    assert err <= GLOO_F32_TOL, (r, t, name, err)
