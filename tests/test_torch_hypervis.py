"""The port's biharmonic hyperviscosity against the JAX package's on the
same numpy inputs: the field form in f64, the weak-Laplacian kernel's plain
version and the packed step as a whole, at ne = 2 and 3 and a few levels,
the JAX Pallas kernels in interpret mode. Errors are scaled max-abs per
output block, |a - b| / max|b|.

Tolerances: 1e-12 for the f64 field form (same math, only the einsum order
differs); 3e-6 for the f32 Laplacians (two chained 4-term contractions per
output, summed in another order than the Pallas kernel's matrix-unit
products); 2e-5 for the packed step against JAX's; 2e-4 (rtol and atol,
the limit of tests/test_structured_dss.py) for the packed f32 step against
the port's own field form run in f32; 1e-4 for the packed step's increment
x_new - x on its own, scaled by the largest increment (x carries an f32
rounding of 2e-5 of that increment)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.dist.step_pallas import (
    apply_hypervis_packed_t as j_hypervis_packed,
)
from tinman_sandbox_tpu.dist.structured_dss import make_structured_plan as j_plan
from tinman_sandbox_tpu.dist.structured_dss import rsp_lanes_2f as j_rsp_lanes_2f
from tinman_sandbox_tpu.kernels.hypervis_pallas_t import vlap_pallas_packed_t
from tinman_sandbox_tpu.kernels.layout import block_derivative_ops
from tinman_sandbox_tpu.kernels.layout import pack_field_t as j_pack_field
from tinman_sandbox_tpu.kernels.layout import pack_meta_t as j_pack_meta
from tinman_sandbox_tpu.timeloop.hyperviscosity import (
    apply_hyperviscosity as j_apply_hyperviscosity,
    biharmonic_wk as j_biharmonic_wk,
)
from tinman_sandbox_tpu_torch import Config
from tinman_sandbox_tpu_torch.convert import from_numpy, plan_from_fields
from tinman_sandbox_tpu_torch.dist import (
    apply_hypervis_packed_t,
    apply_hypervis_packed_t_plain,
    apply_hypervis_t,
    continuity_error_t,
    dss_project,
    make_structured_plan,
)
from tinman_sandbox_tpu_torch.kernels.dss import fix_tables
from tinman_sandbox_tpu_torch.kernels.hypervis_t import vlap_cuda, vlap_plain
from tinman_sandbox_tpu_torch.timeloop import apply_hyperviscosity, biharmonic_wk

torch.set_num_threads(2)
F64_TOL = 1e-12
LAP_TOL = 3e-6
STEP_TOL = 2e-5
FIELD_TOL = 2e-4
INCR_TOL = 1e-4
# grad^4 on the ne 2-3 sphere is ~1e-22 of the field, so this nu * dt moves
# u and v by some 10-40% and T (250-300) by 0.5-3% in a step: the damping
# is what is compared
NU, DT = 1e22, 0.1


def _np(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _err(a, b):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _problem(ne, nlev, seed, dtype=np.float32, eb=8):
    jcs = j_build(ne)
    cfg = jt.Config(nelem=jcs.nelem, nlev=nlev, elem_block=eb)
    cast = lambda tree: jax.tree.map(lambda x: np.asarray(x, dtype), tree)
    return jcs, cfg, cast(jt.random_state(cfg, seed=seed)), cast(jcs.geometry)


def _torch_side(st, g, cfg):
    dv = jt.zero_derived(cfg)
    hv = jt.analytic_hvcoord(cfg)
    ts, _, tg, _ = from_numpy(_np(st), _np(dv), _np(g), _np(hv), device="cpu")
    return ts, tg, Config(nelem=cfg.nelem, nlev=cfg.nlev)


def _packed(ne, nlev, seed, eb=8, rows=3, two_float=False):
    """The packed operands of the Laplacian and the hyperviscosity step for
    both packages: the (u, v, T[, dp]) stack of time level np1."""
    jcs, cfg, st, g = _problem(ne, nlev, seed, eb=eb)
    dxb, dyb = block_derivative_ops(eb, g.dvv, np.float32)
    meta = np.asarray(j_pack_meta(g, st.phis, jnp.float32))
    x = np.concatenate([
        np.asarray(j_pack_field(jnp.asarray(f[cfg.np1], jnp.float32)))
        for f in (st.u, st.v, st.t, st.dp3d)[:rows]])
    jp = j_plan(jcs.gdof, ne)
    plan = plan_from_fields(jp.ne, jp.edges, jp.corner_rows)
    if two_float:
        rsp = j_rsp_lanes_2f(np.asarray(g.spheremp, np.float32), jcs.gdof,
                             jcs.ndof)
    else:
        rsp = np.asarray(g.rspheremp, np.float32).reshape(1, -1)
    dvv = torch.from_numpy(np.asarray(g.dvv, np.float32))
    return ((jnp.asarray(dxb).T, jnp.asarray(dyb).T), meta, x, jp, plan,
            np.ascontiguousarray(rsp), dvv, jcs, cfg)


@pytest.mark.parametrize("nu_ratio", [1.0, 2.5])
def test_torch_biharmonic_wk_f64_matches_jax(nu_ratio):
    jcs, cfg, st, g = _problem(2, 5, seed=3, dtype=np.float64)
    n = cfg.np1
    ref = j_biharmonic_wk(st.u[n], st.v[n], st.t[n], g, jnp.asarray(jcs.gdof),
                          jcs.ndof, nu_ratio)
    ts, tg, _ = _torch_side(st, g, cfg)
    got = biharmonic_wk(ts.u[n], ts.v[n], ts.t[n], tg, jcs.gdof, jcs.ndof,
                        nu_ratio)
    for name, a, b in zip(("u", "v", "t"), got, ref):
        e = _err(a, b)
        assert e < F64_TOL, (name, e)


@pytest.mark.parametrize("subcycle,nu_ratio", [(1, 1.0), (2, 1.0), (3, 0.5)])
def test_torch_apply_hyperviscosity_f64_matches_jax(subcycle, nu_ratio):
    """timeloop.apply_hyperviscosity in f64 against JAX's; the input state
    and the other time levels are not modified."""
    jcs, cfg, st, g = _problem(3, 4, seed=5, dtype=np.float64)
    ref = j_apply_hyperviscosity(st, g, jnp.asarray(jcs.gdof), jcs.ndof, cfg,
                                 nu=NU, nu_div_ratio=nu_ratio, dt=DT,
                                 subcycle=subcycle)
    ts, tg, tcfg = _torch_side(st, g, cfg)
    before = ts.u.clone()
    got = apply_hyperviscosity(ts, tg, jcs.gdof, jcs.ndof, tcfg, NU,
                               nu_div_ratio=nu_ratio, dt=DT,
                               subcycle=subcycle, device="cpu")
    for name in ("u", "v", "t"):
        e = _err(getattr(got, name)[cfg.np1],
                 np.asarray(getattr(ref, name))[cfg.np1])
        assert e < F64_TOL, (name, e)
        assert torch.equal(getattr(got, name)[cfg.n0],
                           getattr(ts, name)[cfg.n0])
    assert torch.equal(ts.u, before)
    assert torch.equal(got.dp3d, ts.dp3d)


@pytest.mark.parametrize("ne,eb,rows,nu_ratio", [(2, 8, 3, 1.0), (2, 8, 4, 2.5),
                                                 (3, 6, 3, 0.5)])
def test_torch_vlap_plain_matches_pallas(ne, eb, rows, nu_ratio):
    """vlap_plain (and the wrapper on CPU tensors, which runs it) against
    vlap_pallas_packed_t in interpret mode, each output block on its own;
    a taller [4*nlev] x gives the same bits as its first three blocks; the
    slab is the output at the fix lanes."""
    nlev = 6
    (dxbt, dybt), meta, x, _, plan, _, dvv, _, _ = _packed(
        ne, nlev, seed=20 + ne, eb=eb, rows=rows)
    sc = jnp.full((1, 4), nu_ratio, jnp.float32)
    ref = np.asarray(vlap_pallas_packed_t(sc, dxbt, dybt, jnp.asarray(meta),
                                          jnp.asarray(x), eb=eb, nlev=nlev,
                                          interpret=True))
    M, X = torch.from_numpy(meta), torch.from_numpy(x)
    count = vlap_cuda.launches
    got = vlap_cuda(M, X, dvv, nlev, nu_ratio)
    assert vlap_cuda.launches == count                # no launch on the CPU
    assert got.shape == (3 * nlev, x.shape[1])
    errs = {n: _err(a, b) for n, a, b in zip(
        ("lap_u", "lap_v", "lap_t"), got.split(nlev), np.split(ref, 3))}
    assert max(errs.values()) < LAP_TOL, errs
    assert torch.equal(got, vlap_plain(M, X[:3 * nlev].contiguous(), dvv,
                                       nlev, nu_ratio))
    fix = fix_tables(plan, "cpu")
    out, slab = vlap_cuda(M, X, dvv, nlev, nu_ratio, fix=fix)
    assert torch.equal(out, got)
    assert slab.shape == (fix.nfix, 3 * nlev)
    assert torch.equal(slab, got[:, fix.read_lanes.long()].T)


def test_torch_vlap_terms_are_each_held():
    """Each term of the vector Laplacian on its own against the field-form
    operators in f64: nu_ratio scales only the grad-div term, and the rigid
    term is what is left of a constant T and zero wind."""
    nlev = 3
    jcs, cfg, st, g = _problem(2, nlev, seed=8, dtype=np.float64)
    ts, tg, _ = _torch_side(st, g, cfg)
    from tinman_sandbox_tpu_torch.kernels.layout import (
        pack_field_t, pack_meta_t, unpack_field_t)
    from tinman_sandbox_tpu_torch.ops import (
        laplace_simple, vlaplace_sphere_wk_contra)
    from tinman_sandbox_tpu_torch import CONSTANTS

    n = cfg.np1
    meta = pack_meta_t(tg, ts.phis, torch.float64)
    x = torch.cat([pack_field_t(f[n]) for f in (ts.u, ts.v, ts.t)])
    rr = CONSTANTS.rrearth
    for nu_ratio in (1.0, 3.0):
        got = vlap_plain(meta, x, tg.dvv, nlev, nu_ratio)
        l1, l2 = vlaplace_sphere_wk_contra(
            ts.u[n], ts.v[n], tg.dvv, tg.d[:, None], tg.dinv[:, None],
            tg.mp[:, None], tg.spheremp[:, None], tg.metinv[:, None],
            tg.metdet[:, None], tg.rmetdet[:, None], rr, nu_ratio)
        lt = laplace_simple(ts.t[n], tg.dvv, tg.dinv[:, None],
                            tg.spheremp[:, None], rr)
        for name, a, b in zip(("u", "v", "t"), got.split(nlev), (l1, l2, lt)):
            e = _err(unpack_field_t(a, cfg.nelem), b.numpy())
            assert e < 1e-11, (name, nu_ratio, e)
    # a constant scalar has no Laplacian: far below the 1e-9 scale of a
    # random field's
    flat = x.clone()
    flat[2 * nlev:] = 7.0
    lap = vlap_plain(meta, flat, tg.dvv, nlev)
    assert float(lap[2 * nlev:].abs().max()) < 1e-18
    assert float(vlap_plain(meta, x, tg.dvv, nlev)[2 * nlev:].abs().max()) \
        > 1e-12


def test_torch_vlap_rejects_bad_operands():
    _, meta, x, _, _, _, dvv, _, _ = _packed(2, 4, seed=1)
    M, X = torch.from_numpy(meta), torch.from_numpy(x)
    with pytest.raises(ValueError, match="x must be"):
        vlap_cuda(M, X[:8].contiguous(), dvv, 4)
    with pytest.raises(ValueError, match="x must be"):
        vlap_cuda(M, X, dvv, 5)
    with pytest.raises(ValueError, match="meta"):
        vlap_cuda(M[:, :16].contiguous(), X, dvv, 4)
    with pytest.raises(ValueError, match="contiguous"):
        vlap_cuda(M, X.T.contiguous().T, dvv, 4)
    with pytest.raises(ValueError, match="dvv"):
        vlap_cuda(M, X, dvv.double(), 4)
    with pytest.raises(TypeError):
        vlap_cuda(M.int(), X.int(), dvv.int(), 4)


@pytest.mark.parametrize("ne,eb,rows,subcycle,two_float", [
    (2, 8, 3, 2, False), (2, 8, 4, 1, True), (2, 8, 4, 2, False),
    (3, 6, 3, 1, False), (3, 6, 4, 2, True)])
def test_torch_hypervis_packed_matches_jax(ne, eb, rows, subcycle, two_float):
    """apply_hypervis_packed_t (the wrappers on CPU tensors) against JAX's
    in interpret mode, on the [3*nlev] stack (a new stack comes back, the
    input stays) and on the full [4*nlev] buffer (updated IN PLACE, the dp
    rows bit for bit untouched); equal bit for bit to the pure plain twin."""
    nlev = 4
    (dxbt, dybt), meta, x, jp, plan, rsp, dvv, jcs, _ = _packed(
        ne, nlev, seed=3, eb=eb, rows=rows, two_float=two_float)
    ref = np.asarray(j_hypervis_packed(
        dxbt, dybt, jnp.asarray(meta), jnp.asarray(x), jp, jnp.asarray(rsp),
        NU, DT, eb=eb, nlev=nlev, subcycle=subcycle, interpret=True))
    M, R = torch.from_numpy(meta), torch.from_numpy(rsp)
    X = torch.from_numpy(x.copy())
    plain = apply_hypervis_packed_t_plain(dvv, M, X, plan, R, NU, DT, nlev,
                                          subcycle=subcycle)
    assert np.array_equal(X.numpy(), x)                       # pure
    got = apply_hypervis_packed_t(dvv, M, X, plan, R, NU, DT, nlev,
                                  subcycle=subcycle)
    assert got.shape == ref.shape == x.shape
    errs = [_err(a, b) for a, b in zip(got.split(nlev),
                                       np.split(ref, rows))]
    assert max(errs) < STEP_TOL, errs
    assert torch.equal(got, plain)
    if rows == 4:
        assert got is X                                       # in place
        assert np.array_equal(got[3 * nlev:].numpy(), x[3 * nlev:])
    else:
        assert np.array_equal(X.numpy(), x)
    # the damping itself: the increment of each block on its own, and it
    # is neither nothing nor the whole field
    for a, b, x0 in zip(got.split(nlev)[:3], np.split(ref, rows),
                        np.split(x, rows)):
        assert _err(a.numpy() - x0, b - x0) < INCR_TOL
        assert 0.002 < np.abs(b - x0).max() / np.abs(x0).max() < 0.6


def test_torch_hypervis_packed_rejects_bad_height():
    _, meta, x, _, plan, rsp, dvv, _, _ = _packed(2, 4, seed=1)
    with pytest.raises(ValueError, match="rows"):
        apply_hypervis_packed_t(dvv, torch.from_numpy(meta),
                                torch.from_numpy(x[:8].copy()), plan,
                                torch.from_numpy(rsp), NU, DT, 4)


def test_torch_hypervis_packed_matches_field_form_and_keeps_continuity():
    """The full-state packed wrapper in f32 against the port's field form
    in f32 at 2e-4 (subcycle 2, as tests/test_structured_dss.py); on a
    continuous state every alias of a dof is still equal afterwards."""
    nlev = 4
    jcs, cfg, st, g = _problem(2, nlev, seed=3)
    ts, tg, tcfg = _torch_side(st, g, cfg)
    ref = apply_hyperviscosity(ts, tg, jcs.gdof, jcs.ndof, tcfg, NU, dt=DT,
                               subcycle=2, device="cpu")
    plan = make_structured_plan(jcs.gdof, 2)
    got = apply_hypervis_t(ts, tg, plan, tcfg, NU, dt=DT, subcycle=2,
                           device="cpu")
    for name in ("u", "v", "t"):
        np.testing.assert_allclose(
            getattr(got, name)[cfg.np1].numpy(),
            getattr(ref, name)[cfg.np1].numpy(), rtol=FIELD_TOL,
            atol=FIELD_TOL, err_msg=name)
        assert torch.equal(getattr(got, name)[cfg.n0],
                           getattr(ts, name)[cfg.n0])
    assert torch.equal(got.dp3d, ts.dp3d)
    # continuity: project the level, damp it on the packed path
    from tinman_sandbox_tpu_torch.kernels.layout import pack_field_t

    def proj(x):
        out = x.clone()
        out[cfg.np1] = dss_project(x[cfg.np1], jcs.gdof, jcs.ndof,
                                   tg.spheremp, tg.rspheremp)
        return out

    cont = dataclasses.replace(ts, u=proj(ts.u), v=proj(ts.v), t=proj(ts.t))
    out = apply_hypervis_t(cont, tg, plan, tcfg, NU, dt=DT, device="cpu")
    for name in ("u", "v", "t"):
        assert continuity_error_t(
            pack_field_t(getattr(out, name)[cfg.np1]), jcs.gdof) == 0.0
