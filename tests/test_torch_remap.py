"""The port's conservative vertical remap (``ops.remap``) and the packed
remap with its mass fixer (``dist.remap_packed_t4``, ``packed_air_mass``)
against the JAX package's on the same numpy inputs, and the properties of
``tests/test_remap.py`` on the port alone.

Tolerances: 1e-12 for the f64 port against JAX (the same formulation; the
sum over source cells runs in another order); 2e-5 (rtol and atol, the
limit of tests/test_structured_dss.py) for the f32 packed remap against
JAX's packed remap and against the port's field-form remap; the mass fixer
brings the packed air mass to its target within 4 f32 ulps, 4 * 2**-23
relative (the rescaled terms and their sum are rounded once more; seeds 0-5
measured at most 1.7 ulps); chunked and unchunked remaps are bit for bit
equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinman_sandbox_tpu import Config as JConfig
from tinman_sandbox_tpu import random_state as j_random_state
from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.dist.step_pallas import (
    packed_air_mass as j_packed_air_mass,
    remap_packed_t4 as j_remap_packed,
)
from tinman_sandbox_tpu.grid import HybridVCoord as JHybridVCoord
from tinman_sandbox_tpu.kernels.layout import pack_field_t as j_pack_field
from tinman_sandbox_tpu.ops.remap import (
    reference_dp as j_reference_dp,
    remap_column as j_remap_column,
    vertical_remap as j_vertical_remap,
)
from tinman_sandbox_tpu_torch import Config
from tinman_sandbox_tpu_torch.device import from_arrays
from tinman_sandbox_tpu_torch.dist import packed_air_mass, remap_packed_t4
from tinman_sandbox_tpu_torch.grid import HybridVCoord
from tinman_sandbox_tpu_torch.kernels.layout import pack_field_t
from tinman_sandbox_tpu_torch.ops.remap import (
    reference_dp,
    remap_column,
    remap_levels,
    vertical_remap,
)

torch.set_num_threads(2)
F64_TOL = 1e-12
PACKED_TOL = 2e-5
SCHEMES = ("pcm", "plm", "ppm")


def _T(a):
    return torch.from_numpy(np.array(a))


def _err(a, b):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _dps(nlev, seed=0, shape=(2, 4, 4)):
    """tests/test_remap.py's source and target layers (equal totals)."""
    rng = np.random.default_rng(seed)
    e, i, j = shape
    dp_src = rng.uniform(5.0, 15.0, (e, nlev, i, j))
    w = rng.uniform(0.5, 1.5, (e, nlev, i, j))
    dp_tgt = w / w.sum(axis=1, keepdims=True) * dp_src.sum(axis=1,
                                                           keepdims=True)
    return dp_src, dp_tgt


def _hv_arrays(nlev, p_top=500.0, p0=100000.0):
    etai = np.linspace(p_top / p0, 1.0, nlev + 1)
    b = ((etai - etai[0]) / (1.0 - etai[0])) ** 1.3
    a = etai - b
    return dict(ps0=p0, hyai=a, hybi=b, hyam=0.5 * (a[:-1] + a[1:]),
                hybm=0.5 * (b[:-1] + b[1:]))


# -- the properties of tests/test_remap.py, on the port ----------------------

def test_torch_remap_identity_when_grids_match():
    dp, _ = (_T(x) for x in _dps(9))
    q = _T(np.random.default_rng(1).normal(size=dp.shape))
    for scheme in SCHEMES:
        out = remap_column(q, dp, dp, scheme=scheme)
        np.testing.assert_allclose(out.numpy(), q.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_torch_remap_conservation_and_monotonicity():
    dp_src, dp_tgt = (_T(x) for x in _dps(12, seed=3))
    q = _T(np.random.default_rng(4).uniform(200, 300, size=dp_src.shape))
    for scheme in SCHEMES:
        out = remap_column(q, dp_src, dp_tgt, scheme=scheme)
        np.testing.assert_allclose((out * dp_tgt).sum(1).numpy(),
                                   (q * dp_src).sum(1).numpy(), rtol=1e-12)
        assert float(out.max()) <= float(q.max()) + 1e-10
        assert float(out.min()) >= float(q.min()) - 1e-10


def test_torch_remap_plm_beats_pcm_on_smooth_profile():
    nlev = 32
    dp_src = torch.full((1, nlev, 4, 4), 10.0, dtype=torch.float64)
    shift = _T(np.sin(np.linspace(0, 2 * np.pi, nlev))[None, :, None, None])
    dp_tgt = dp_src + shift
    dp_tgt = dp_tgt * (dp_src.sum(1, keepdim=True)
                       / dp_tgt.sum(1, keepdim=True))
    x = torch.cumsum(dp_src, 1) - 0.5 * dp_src
    q = torch.sin(x / 60.0)
    ti = torch.cat([torch.zeros_like(dp_tgt[:, :1]), torch.cumsum(dp_tgt, 1)],
                   1)
    exact = (-torch.cos(ti[:, 1:] / 60.0) + torch.cos(ti[:, :-1] / 60.0)) \
        * 60.0 / dp_tgt
    e = {s: float((remap_column(q, dp_src, dp_tgt, scheme=s) - exact)
                  .abs().max()) for s in SCHEMES}
    assert e["plm"] < 0.5 * e["pcm"], e


def test_torch_remap_unknown_scheme_raises():
    dp, _ = (_T(x) for x in _dps(4))
    with pytest.raises(ValueError, match="unknown remap scheme"):
        remap_column(dp, dp, dp, scheme="weno")


def _lagrangian_state(seed=7, nelem=2, nlev=10):
    """tests/test_remap.py's state-wrapper problem: random state, dp3d[np1]
    a perturbed Lagrangian column with the reference levels' totals."""
    cfg = JConfig(nelem=nelem, nlev=nlev)
    hv = _hv_arrays(nlev)
    st = j_random_state(cfg, seed=seed)
    rng = np.random.default_rng(seed + 1)
    ps = rng.uniform(9.5e4, 1.05e5, (nelem, 4, 4))
    dp_ref = np.asarray(j_reference_dp(JHybridVCoord(**hv), jnp.asarray(ps)))
    dp_lag = dp_ref * rng.uniform(0.9, 1.1, dp_ref.shape)
    dp_lag *= dp_ref.sum(1, keepdims=True) / dp_lag.sum(1, keepdims=True)
    dp3d = np.array(st.dp3d)
    dp3d[cfg.np1] = dp_lag
    st = dataclasses.replace(st, dp3d=dp3d)
    return cfg, st, hv, dp_ref, dp_lag


def _torch_state(st):
    from tinman_sandbox_tpu_torch.state import State

    return from_arrays(State, {f.name: np.asarray(getattr(st, f.name))
                               for f in dataclasses.fields(st)},
                       device="cpu")


def test_torch_vertical_remap_state_wrapper():
    jcfg, jst, hv, dp_ref, dp_lag = _lagrangian_state()
    cfg = Config(nelem=jcfg.nelem, nlev=jcfg.nlev)
    st = _torch_state(jst)
    keep = st.dp3d.clone()
    out = vertical_remap(st, from_arrays(HybridVCoord, hv, device="cpu"), cfg)
    assert torch.equal(st.dp3d, keep)                 # the input lives on
    np1, qn0 = cfg.np1, cfg.qn0
    np.testing.assert_allclose(out.dp3d[np1].sum(1).numpy(), dp_lag.sum(1),
                               rtol=1e-12)
    np.testing.assert_allclose(out.dp3d[np1].numpy(), dp_ref, rtol=1e-10)
    for name in ("u", "v", "t"):
        before = (np.asarray(getattr(jst, name))[np1] * dp_lag).sum(1)
        after = (getattr(out, name)[np1] * out.dp3d[np1]).sum(1).numpy()
        np.testing.assert_allclose(after, before, rtol=1e-11, err_msg=name)
    np.testing.assert_allclose(out.qdp[qn0].sum(2).numpy(),
                               np.asarray(jst.qdp)[qn0].sum(2), rtol=1e-11)
    # the other levels ride through
    for name in ("u", "v", "t", "dp3d"):
        assert torch.equal(getattr(out, name)[cfg.n0],
                           getattr(st, name)[cfg.n0])


# -- against the JAX package -------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
def test_torch_remap_column_matches_jax_f64(scheme):
    dp_src, dp_tgt = _dps(12, seed=5, shape=(3, 4, 4))
    q = np.random.default_rng(6).normal(size=dp_src.shape) * 20.0 + 250.0
    want = np.asarray(j_remap_column(jnp.asarray(q), jnp.asarray(dp_src),
                                     jnp.asarray(dp_tgt), scheme=scheme))
    got = remap_column(_T(q), _T(dp_src), _T(dp_tgt), scheme=scheme)
    assert _err(got, want) < F64_TOL


@pytest.mark.parametrize("scheme", SCHEMES)
def test_torch_vertical_remap_matches_jax_f64(scheme):
    jcfg, jst, hv, _, _ = _lagrangian_state(seed=11, nelem=3, nlev=8)
    ref = j_vertical_remap(jst, JHybridVCoord(**hv), jcfg, scheme=scheme)
    cfg = Config(nelem=jcfg.nelem, nlev=jcfg.nlev)
    out = vertical_remap(_torch_state(jst),
                         from_arrays(HybridVCoord, hv, device="cpu"), cfg,
                         scheme=scheme)
    for name in ("u", "v", "t", "dp3d", "qdp"):
        assert _err(getattr(out, name), getattr(ref, name)) < F64_TOL, name


def test_torch_reference_dp_matches_jax():
    hv = _hv_arrays(9)
    ps = np.random.default_rng(2).uniform(9e4, 1.1e5, (3, 4, 4))
    want = np.asarray(j_reference_dp(JHybridVCoord(**hv), jnp.asarray(ps)))
    got = reference_dp(from_arrays(HybridVCoord, hv, device="cpu"), _T(ps))
    assert _err(got, want) < F64_TOL


# -- the packed remap and the fixer ------------------------------------------

def _packed_problem(nlev=6, qsize=2, seed=4):
    """tests/test_structured_dss.py's packed-remap problem: ne 2, f32 random
    state with positive dp3d, physically monotone eta levels."""
    jcs = j_build(2)
    cfg = JConfig(nelem=jcs.nelem, nlev=nlev, qsize=qsize)
    cast = lambda t: jax.tree.map(lambda x: np.asarray(x, np.float32), t)
    st = cast(j_random_state(cfg, seed=seed))
    eta = np.linspace(0.0, 1.0, nlev + 1, dtype=np.float32)
    hyai = (0.1 * (1 - eta)).astype(np.float32)
    hv = dict(ps0=np.float32(1000.0), hyai=hyai, hybi=eta,
              hyam=0.5 * (hyai[:-1] + hyai[1:]), hybm=0.5 * (eta[:-1]
                                                            + eta[1:]))
    st = dataclasses.replace(
        st, dp3d=(np.abs(np.asarray(st.dp3d)) + 1.0).astype(np.float32))
    np1, qn0 = cfg.np1, cfg.qn0
    s = np.concatenate([np.asarray(j_pack_field(jnp.asarray(
        getattr(st, n)[np1]))) for n in ("u", "v", "t", "dp3d")])
    qdp = np.concatenate([np.asarray(j_pack_field(jnp.asarray(
        st.qdp[qn0, :, q]))) for q in range(qsize)])
    sph = np.asarray(jcs.geometry.spheremp, np.float32).reshape(1, -1)
    return jcs, cfg, st, hv, s, qdp, sph


def _thv(hv):
    return from_arrays(HybridVCoord, {k: np.asarray(v) for k, v in
                                      hv.items()}, device="cpu")


def test_torch_remap_packed_matches_jax_and_field():
    """remap_packed_t4 (f32) against JAX's remap_packed_t4 and against the
    port's field-form vertical_remap on the same state, every block."""
    jcs, cfg, st, hv, s, qdp, _ = _packed_problem()
    k, nelem = cfg.nlev, cfg.nelem
    js, jq = j_remap_packed(jnp.asarray(s), jnp.asarray(qdp),
                            JHybridVCoord(**hv), nelem=nelem, nlev=k,
                            qsize=cfg.qsize)
    ts, tq = remap_packed_t4(_T(s), _T(qdp), _thv(hv), nelem, k, cfg.qsize)
    assert ts.dtype == torch.float32 and tq.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=PACKED_TOL,
                               atol=PACKED_TOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=PACKED_TOL,
                               atol=PACKED_TOL)
    # against the port's own field form
    tcfg = Config(nelem=nelem, nlev=k, qsize=cfg.qsize)
    ref = vertical_remap(_torch_state(st), _thv(hv), tcfg)
    for i, name in enumerate(("u", "v", "t", "dp3d")):
        np.testing.assert_allclose(
            ts[i * k:(i + 1) * k].numpy(),
            pack_field_t(getattr(ref, name)[tcfg.np1]).numpy(),
            rtol=PACKED_TOL, atol=PACKED_TOL, err_msg=name)
    for q in range(cfg.qsize):
        np.testing.assert_allclose(
            tq[q * k:(q + 1) * k].numpy(),
            pack_field_t(ref.qdp[tcfg.qn0, :, q]).numpy(),
            rtol=PACKED_TOL, atol=PACKED_TOL)


def test_torch_remap_packed_fixer():
    """With a mass target the fixer rescales dp and every tracer by one
    ratio, after which packed_air_mass equals the target to f32 rounding;
    the result matches JAX's fixer. packed_air_mass is JAX's functional."""
    jcs, cfg, st, hv, s, qdp, sph = _packed_problem(seed=9)
    k, nelem = cfg.nlev, cfg.nelem
    assert abs(float(packed_air_mass(_T(s), _T(sph), k))
               / float(j_packed_air_mass(jnp.asarray(s), jnp.asarray(sph),
                                         k)) - 1.0) < 1e-6
    target = packed_air_mass(_T(s), _T(sph), k) * 1.001
    free = remap_packed_t4(_T(s), _T(qdp), _thv(hv), nelem, k, cfg.qsize)
    fixed = remap_packed_t4(_T(s), _T(qdp), _thv(hv), nelem, k, cfg.qsize,
                            sph_lanes=_T(sph), mass_target=target)
    m = packed_air_mass(fixed[0], _T(sph), k)
    assert abs(float(m) / float(target) - 1.0) < 4 * 2 ** -23
    r = float(target) / float(packed_air_mass(free[0], _T(sph), k))
    assert abs(r - 1.001) < 1e-4
    assert torch.equal(fixed[0][:3 * k], free[0][:3 * k])
    np.testing.assert_allclose(fixed[0][3 * k:].numpy(),
                               r * free[0][3 * k:].numpy(), rtol=1e-6)
    np.testing.assert_allclose(fixed[1].numpy(), r * free[1].numpy(),
                               rtol=1e-6)
    js, jq = j_remap_packed(jnp.asarray(s), jnp.asarray(qdp),
                            JHybridVCoord(**hv), nelem=nelem, nlev=k,
                            qsize=cfg.qsize, sph_lanes=jnp.asarray(sph),
                            mass_target=jnp.float32(float(target)))
    np.testing.assert_allclose(fixed[0].numpy(), np.asarray(js),
                               rtol=PACKED_TOL, atol=PACKED_TOL)
    np.testing.assert_allclose(fixed[1].numpy(), np.asarray(jq),
                               rtol=PACKED_TOL, atol=PACKED_TOL)


def test_torch_remap_packed_rejects_bad_shapes():
    jcs, cfg, st, hv, s, qdp, _ = _packed_problem()
    with pytest.raises(ValueError):
        remap_packed_t4(_T(s), _T(qdp), _thv(hv), cfg.nelem, cfg.nlev, 3)
    with pytest.raises(ValueError):
        remap_packed_t4(_T(s[:-1]), _T(qdp), _thv(hv), cfg.nelem, cfg.nlev,
                        cfg.qsize)


# -- chunks ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_torch_remap_chunks_are_bit_for_bit(scheme, dtype):
    """Chunks of 1, 7 and 64 columns, and the default, give the same bits
    as the whole [K, C] at once."""
    dp_src, dp_tgt = _dps(11, seed=7, shape=(5, 4, 4))
    q = np.random.default_rng(8).normal(size=dp_src.shape)
    cols = lambda x: torch.from_numpy(np.moveaxis(x, 1, 0).reshape(11, -1)
                                      .copy()).to(dtype)
    q, dp_src, dp_tgt = cols(q), cols(dp_src), cols(dp_tgt)
    whole = remap_levels(q, dp_src, dp_tgt, scheme, chunk=q.shape[1])
    for chunk in (1, 7, 64, None):
        assert torch.equal(remap_levels(q, dp_src, dp_tgt, scheme, chunk),
                           whole)


def test_torch_remap_packed_chunks_are_bit_for_bit(monkeypatch):
    """remap_packed_t4 with its temporaries cut to chunks of 37 columns
    gives the bits of one chunk."""
    import tinman_sandbox_tpu_torch.ops.remap as remap_mod

    jcs, cfg, st, hv, s, qdp, sph = _packed_problem()
    args = (_T(s), _T(qdp), _thv(hv), cfg.nelem, cfg.nlev, cfg.qsize)
    whole = remap_packed_t4(*args)
    k = cfg.nlev
    monkeypatch.setattr(remap_mod, "MAX_TEMP_BYTES", (k + 1) * k * 4 * 37)
    part = remap_packed_t4(*args)
    assert torch.equal(whole[0], part[0]) and torch.equal(whole[1], part[1])
