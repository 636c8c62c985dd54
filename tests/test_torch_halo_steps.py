"""The port's element-sharded assembled steps (``dist.caar_halo_step``,
``caar_ppermute_step``, ``caar_dss_sharded_step`` and the interior /
boundary overlap ``caar_ppermute_overlap_step``) over ``LocalMesh(n,
"cpu")`` against the JAX package's on the same numpy inputs:

  * ``sharded``: JAX's own tier on its 8-device CPU mesh (``shard_map``),
    in f64 to 1e-12: the psum and ppermute tiers on 2 shards, the overlap
    on ne 2 over 2 shards (every element a boundary one, so the interior
    subset is one pad: an unmasked pad would add element 0 twice);
  * ``single``: JAX's jitted ``caar_dss_step``, the segment-sum step that
    every tier assembles, in f64 to 1e-12 (the partitioned segment sum on 8
    shards; the overlap on ne 4 over 8 shards, where the shards hold 10 or
    12 boundary and 2 or 0 interior elements: pads in both subsets) and in
    f32 to 1e-5 of max|x| (every tier at nlev 8 on 8 shards, ne 2).

JAX's collectives add in their own order, the port's in shard order, so f64
agreement is to 1e-12, not bitwise. Each JAX tier compiles its ``shard_map``
on the CPU mesh anew (tens of seconds), so the sharded cases are few and
small."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.dist import caar_dss_step as j_step
from tinman_sandbox_tpu.dist import make_mesh as j_mesh
from tinman_sandbox_tpu.dist.halo import make_dss_plan as j_plan
from tinman_sandbox_tpu.dist.halo_ppermute import make_ppermute_plan as j_pplan
from tinman_sandbox_tpu.dist.overlap import (
    caar_ppermute_overlap_step as j_overlap,
)
from tinman_sandbox_tpu.dist.overlap import make_overlap_plan as j_oplan
from tinman_sandbox_tpu.dist.step import caar_halo_step as j_halo_step
from tinman_sandbox_tpu.dist.step import caar_ppermute_step as j_pp_step
from tinman_sandbox_tpu_torch.convert import from_numpy
from tinman_sandbox_tpu_torch.dist import (
    LocalMesh,
    caar_dss_sharded_step,
    caar_halo_step,
    caar_ppermute_overlap_step,
    caar_ppermute_step,
    make_dss_plan,
    make_overlap_plan,
    make_ppermute_plan,
    shard_problem,
    unshard,
)

F64_TOL = 1e-12
F32_TOL = 1e-5                # scaled by max|x|, as the f32 CAAR gates
PROGNOSTICS = ("u", "v", "t", "dp3d")
DT2 = 0.3


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _jax_tier(tier, ref, cs, cfg, st, dv, g, hv, n, dtype):
    args = (st, dv, g, hv)
    if ref == "single":
        return j_step(*args, jnp.asarray(cs.gdof), cs.ndof, cfg, dtype(DT2),
                      dtype(1.0))
    mesh = j_mesh(n)
    with mesh:
        if tier == "halo":
            return j_halo_step(*args, j_plan(cs.gdof, n), mesh, cfg, DT2, 1.0)
        if tier == "ppermute":
            return j_pp_step(*args, j_pplan(cs.gdof, n), mesh, cfg, DT2, 1.0)
        return j_overlap(*args, j_pplan(cs.gdof, n), j_oplan(cs.gdof, n),
                         mesh, cfg, DT2, 1.0)


def _port_tier(tier, cs, cfg, S, D, G, H, n):
    mesh = LocalMesh(n, "cpu")
    ts, td, tg = shard_problem(mesh, S, D, G)
    if tier == "halo":
        out = caar_halo_step(ts, td, tg, H, make_dss_plan(cs.gdof, n), mesh,
                             cfg, DT2, 1.0)
    elif tier == "ppermute":
        out = caar_ppermute_step(ts, td, tg, H, make_ppermute_plan(cs.gdof, n),
                                 mesh, cfg, DT2, 1.0)
    elif tier == "segment":
        out = caar_dss_sharded_step(ts, td, tg, H, cs.gdof, cs.ndof, mesh, cfg,
                                    DT2, 1.0)
    else:
        out = caar_ppermute_overlap_step(
            ts, td, tg, H, make_ppermute_plan(cs.gdof, n),
            make_overlap_plan(cs.gdof, n), mesh, cfg, DT2, 1.0)
    return unshard(mesh, *out)


@pytest.mark.parametrize("tier,ref,ne,n,nlev,dtype", [
    ("halo", "sharded", 2, 2, 4, np.float64),
    ("ppermute", "sharded", 2, 2, 4, np.float64),
    ("overlap", "sharded", 2, 2, 5, np.float64),
    ("segment", "single", 2, 8, 4, np.float64),
    ("overlap", "single", 4, 8, 5, np.float64),
    ("halo", "single", 2, 8, 8, np.float32),
    ("ppermute", "single", 2, 8, 8, np.float32),
    ("segment", "single", 2, 8, 8, np.float32),
    ("overlap", "single", 2, 8, 8, np.float32),
])
def test_torch_sharded_steps_match_jax(tier, ref, ne, n, nlev, dtype):
    cs = j_build(ne)
    cfg = jt.Config(nelem=cs.nelem, nlev=nlev)
    cast = lambda o: type(o)(**{k: v.astype(dtype)
                                for k, v in _np(o).items()})
    st, dv = cast(jt.random_state(cfg, seed=21)), cast(jt.zero_derived(cfg))
    g = cast(cs.geometry)
    hv = jt.analytic_hvcoord(cfg).astype(dtype)
    if tier == "overlap":
        op = j_oplan(cs.gdof, n)
        if ne == 4:            # unequal subsets: pads in both
            assert op.bw.min() == 0 and op.iw.min() == 0 and op.iw.max() == 1
        else:                  # the interior subset is all pad
            assert op.iw.max() == 0
    want_s, want_d = _jax_tier(tier, ref, cs, cfg, st, dv, g, hv, n, dtype)
    S, D, G, H = from_numpy(_np(st), _np(dv), _np(g), _np(hv), device="cpu")
    gs, gd = _port_tier(tier, cs, cfg, S, D, G, H, n)
    pairs = [(getattr(gs, k)[cfg.np1], getattr(want_s, k)[cfg.np1])
             for k in PROGNOSTICS]
    pairs += [(getattr(gd, f.name), getattr(want_d, f.name))
              for f in dataclasses.fields(gd)]
    for a, b in pairs:
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype
        if dtype == np.float64:
            np.testing.assert_allclose(a, b, rtol=F64_TOL, atol=F64_TOL)
        else:
            assert np.max(np.abs(a - b)) <= F32_TOL * max(np.max(np.abs(b)),
                                                          1.0)
