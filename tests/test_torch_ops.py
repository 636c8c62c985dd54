"""The port's operators and packed layout against the JAX package's, on the
same numpy inputs (f64 operators to 1e-12 scaled; the layout bitwise)."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tinman_sandbox_tpu import CONSTANTS, Config, random_geometry
from tinman_sandbox_tpu import ops as jops
from tinman_sandbox_tpu.kernels import layout as jlayout
from tinman_sandbox_tpu_torch import ops as tops
from tinman_sandbox_tpu_torch.grid import Geometry
from tinman_sandbox_tpu_torch.kernels import layout as tlayout

torch.set_num_threads(1)
RR = CONSTANTS.rrearth
CFG = Config(nelem=6, nlev=16)
GEOM = random_geometry(CFG, seed=7)
TOL = 1e-12


def _np(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _fields(n, seed=42, lo=-1.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, (CFG.nelem, CFG.nlev, 4, 4)) for _ in range(n)]


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


G = {k: np.asarray(v)[:, None] if np.ndim(v) > 2 else np.asarray(v)
     for k, v in _np(GEOM).items()}
TG = {k: torch.from_numpy(v) for k, v in G.items()}


def _pair(outs_j, outs_t):
    if not isinstance(outs_j, tuple):
        outs_j, outs_t = (outs_j,), (outs_t,)
    for a, b in zip(outs_t, outs_j):
        assert _err(a.numpy(), b) < TOL


@pytest.mark.parametrize("op", ["gradient", "divergence", "vorticity"])
def test_torch_sphere_ops_match_jax(op):
    s, v1, v2 = _fields(3)
    ts, tv1, tv2 = (torch.from_numpy(x) for x in (s, v1, v2))
    if op == "gradient":
        _pair(jops.gradient_sphere(s, G["dvv"], G["dinv"], RR),
              tops.gradient_sphere(ts, TG["dvv"], TG["dinv"], RR))
    elif op == "divergence":
        _pair(jops.divergence_sphere(v1, v2, G["dvv"], G["dinv"], G["metdet"],
                                     G["rmetdet"], RR),
              tops.divergence_sphere(tv1, tv2, TG["dvv"], TG["dinv"],
                                     TG["metdet"], TG["rmetdet"], RR))
    else:
        _pair(jops.vorticity_sphere(v1, v2, G["dvv"], G["d"], G["rmetdet"],
                                    RR),
              tops.vorticity_sphere(tv1, tv2, TG["dvv"], TG["d"],
                                    TG["rmetdet"], RR))


def test_torch_adjoint_contractions_match_jax():
    """_ax and _ay, the transposes of _dx and _dy, against JAX's."""
    from tinman_sandbox_tpu.ops import sphere as jsphere
    from tinman_sandbox_tpu_torch.ops import sphere as tsphere

    (x,) = _fields(1, seed=9)
    tx = torch.from_numpy(x)
    _pair(jsphere._ax(G["dvv"], x), tsphere._ax(TG["dvv"], tx))
    _pair(jsphere._ay(G["dvv"], x), tsphere._ay(TG["dvv"], tx))
    # adjoint identity: <_dx s, x> == <s, _ax x> with the index pairing
    # _dx[l, j] = sum_i Dvv[i, l] s[i, j], _ax[m, n] = sum_s Dvv[m, s] x[s, n]
    (s,) = _fields(1, seed=10)
    ts = torch.from_numpy(s)
    lhs = (tsphere._dx(TG["dvv"], ts) * tx).sum()
    rhs = (ts * tsphere._ax(TG["dvv"], tx)).sum()
    assert abs(float(lhs - rhs)) < 1e-10 * abs(float(lhs))


_WEAK_OPS = ["gradient_update", "divergence_update", "divergence_wk",
             "vorticity_vector", "laplace_simple", "laplace_tensor",
             "laplace_tensor_replace", "curl_wk_testcov", "grad_wk_testcov",
             "vlaplace_cartesian", "vlaplace_cartesian_reduced",
             "vlaplace_contra"]


@pytest.mark.parametrize("op", _WEAK_OPS)
def test_torch_weak_and_laplacian_ops_match_jax(op):
    """The weak-form operators and the Laplacian family in f64 against
    JAX's on the same random fields and geometry."""
    s, v1, v2, a1, a2 = _fields(5, seed=21)
    T = torch.from_numpy
    tv = np.random.default_rng(5).uniform(0.5, 1.5, (CFG.nelem, 1, 2, 2, 4, 4))
    g, tg = G, TG
    if op == "gradient_update":
        _pair(jops.gradient_sphere_update(s, g["dvv"], g["dinv"], RR, a1, a2),
              tops.gradient_sphere_update(T(s), tg["dvv"], tg["dinv"], RR,
                                          T(a1), T(a2)))
    elif op == "divergence_update":
        _pair(jops.divergence_sphere_update(
                  v1, v2, 0.3, -1.7, a1, g["dvv"], g["dinv"], g["metdet"],
                  g["rmetdet"], RR),
              tops.divergence_sphere_update(
                  T(v1), T(v2), 0.3, -1.7, T(a1), tg["dvv"], tg["dinv"],
                  tg["metdet"], tg["rmetdet"], RR))
    elif op == "divergence_wk":
        _pair(jops.divergence_sphere_wk(v1, v2, g["dvv"], g["dinv"],
                                        g["spheremp"], RR),
              tops.divergence_sphere_wk(T(v1), T(v2), tg["dvv"], tg["dinv"],
                                        tg["spheremp"], RR))
    elif op == "vorticity_vector":
        v = np.stack([v1, v2], axis=-3)
        _pair(jops.vorticity_sphere_vector(v, g["dvv"], g["d"], g["rmetdet"],
                                           RR),
              tops.vorticity_sphere_vector(T(v), tg["dvv"], tg["d"],
                                           tg["rmetdet"], RR))
    elif op == "laplace_simple":
        _pair(jops.laplace_simple(s, g["dvv"], g["dinv"], g["spheremp"], RR),
              tops.laplace_simple(T(s), tg["dvv"], tg["dinv"],
                                  tg["spheremp"], RR))
    elif op in ("laplace_tensor", "laplace_tensor_replace"):
        name = op
        _pair(getattr(jops, name)(s, g["dvv"], g["dinv"], g["spheremp"], tv,
                                  RR),
              getattr(tops, name)(T(s), tg["dvv"], tg["dinv"],
                                  tg["spheremp"], T(tv), RR))
    elif op == "curl_wk_testcov":
        _pair(jops.curl_sphere_wk_testcov(s, g["dvv"], g["d"], g["mp"], RR),
              tops.curl_sphere_wk_testcov(T(s), tg["dvv"], tg["d"], tg["mp"],
                                          RR))
    elif op == "grad_wk_testcov":
        _pair(jops.grad_sphere_wk_testcov(s, g["dvv"], g["d"], g["mp"],
                                          g["metinv"], g["metdet"], RR),
              tops.grad_sphere_wk_testcov(T(s), tg["dvv"], tg["d"], tg["mp"],
                                          tg["metinv"], tg["metdet"], RR))
    elif op in ("vlaplace_cartesian", "vlaplace_cartesian_reduced"):
        name = op.replace("vlaplace", "vlaplace_sphere_wk")
        _pair(getattr(jops, name)(v1, v2, g["dvv"], g["dinv"], g["spheremp"],
                                  tv, g["vec_sph2cart"], RR),
              getattr(tops, name)(T(v1), T(v2), tg["dvv"], tg["dinv"],
                                  tg["spheremp"], T(tv), tg["vec_sph2cart"],
                                  RR))
    else:
        _pair(jops.vlaplace_sphere_wk_contra(
                  v1, v2, g["dvv"], g["d"], g["dinv"], g["mp"], g["spheremp"],
                  g["metinv"], g["metdet"], g["rmetdet"], RR, 2.5),
              tops.vlaplace_sphere_wk_contra(
                  T(v1), T(v2), tg["dvv"], tg["d"], tg["dinv"], tg["mp"],
                  tg["spheremp"], tg["metinv"], tg["metdet"], tg["rmetdet"],
                  RR, 2.5))


@pytest.mark.parametrize("op", ["midpoint", "hydrostatic", "omega",
                                "virtual_temperature"])
def test_torch_scans_and_thermo_match_jax(op):
    dp, t, q, vgp, divdp = _fields(5, seed=3, lo=1.0, hi=2.0)
    phis = np.random.default_rng(4).uniform(0, 1, (CFG.nelem, 4, 4))
    T = torch.from_numpy
    p = np.array(jops.midpoint_pressure(740.0, dp))
    if op == "midpoint":
        _pair(jops.midpoint_pressure(740.0, dp),
              tops.midpoint_pressure(740.0, T(dp)))
    elif op == "hydrostatic":
        _pair(jops.preq_hydrostatic(phis, t, p, dp, CONSTANTS.Rgas),
              tops.preq_hydrostatic(T(phis), T(t), T(p), T(dp),
                                    CONSTANTS.Rgas))
    elif op == "omega":
        _pair(jops.preq_omega_ps(p, vgp, divdp),
              tops.preq_omega_ps(T(p), T(vgp), T(divdp)))
    else:
        rv = CONSTANTS.rgas_over_rvap_m1
        _pair(jops.virtual_temperature(t, q, dp, rv),
              tops.virtual_temperature(T(t), T(q), T(dp), rv))


def test_torch_pack_unpack_match_jax_bitwise():
    x = np.random.default_rng(0).normal(size=(3, 5, 7, 4, 4)).astype(np.float32)
    pj = np.asarray(jlayout.pack_field_t(x))
    pt = tlayout.pack_field_t(torch.from_numpy(x))
    assert pt.is_contiguous() and pt.shape == (3, 7, 80)
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(
        tlayout.unpack_field_t(pt, 5).numpy(),
        np.asarray(jlayout.unpack_field_t(pj, 5)))


def test_torch_pack_meta_matches_jax_bitwise():
    phis = np.random.default_rng(1).uniform(0, 1, (CFG.nelem, 4, 4))
    mj = np.asarray(jlayout.pack_meta_t(GEOM, phis, np.float32))
    tgeom = Geometry(**{k: torch.from_numpy(v) for k, v in _np(GEOM).items()})
    mt = tlayout.pack_meta_t(tgeom, torch.from_numpy(phis), torch.float32)
    assert tlayout.META_COLS == jlayout.META_COLS
    np.testing.assert_array_equal(mt.numpy(), mj)


@pytest.mark.parametrize("exact", [True, False])
def test_torch_state_norms_match_jax(exact):
    from tinman_sandbox_tpu import random_state
    from tinman_sandbox_tpu.ops.norms import state_norms as j_norms
    from tinman_sandbox_tpu_torch.ops.norms import state_norms as t_norms

    st = random_state(Config(nelem=2, nlev=5), seed=4)
    tst = SimpleNamespace(**{k: torch.from_numpy(np.asarray(getattr(st, k)))
                             for k in ("u", "v", "t", "dp3d")})
    assert t_norms(tst, exact=exact) == j_norms(st, exact=exact)
