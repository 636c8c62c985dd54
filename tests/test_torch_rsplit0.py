"""The port's rsplit=0 (full eta-coordinate) CAAR step against the JAX
package's on the same numpy inputs: the scans, the array form and both
packed plain forms against caar_xla in f64, the f32 plain versions against
the two Pallas rsplit=0 kernels in interpret mode, and the refusals of the
loops and steps that have no rsplit=0 form.

Every problem here has a hybi RAMP: the JAX package's analytic hvcoord has
hybi = 0, which leaves the hybi*sdot term of the interface flux unseen. Its
nm1 level is zero, so that s1 = spheremp*dt2*tendency, and its winds are
scaled to 30 m/s: the vertical advection of u and v grows as the wind
squared, the pressure-gradient term they sit beside does not. So the rsplit=0
terms (vertical advection, the dp interface stencil) carry a share of each
output that the f32 tolerance sees; ``test_torch_rsplit0_terms_are_seen``
holds that. Errors are scaled max-abs, |a - b| / max|b|."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu.kernels import caar_xla
from tinman_sandbox_tpu.kernels.caar_pallas import caar_pallas
from tinman_sandbox_tpu.kernels.caar_pallas_t import caar_pallas_t
from tinman_sandbox_tpu.ops.scans import (
    eta_dot_dpdn_rsplit0 as j_eta,
    preq_vertadv as j_vertadv,
)
from tinman_sandbox_tpu_torch import Config
from tinman_sandbox_tpu_torch.convert import from_numpy
from tinman_sandbox_tpu_torch.kernels import caar_array
from tinman_sandbox_tpu_torch.kernels.caar import (
    caar,
    caar_packed_rsplit0,
    caar_packed_rsplit0_plain,
    pack_problem,
    run_leapfrog,
)
from tinman_sandbox_tpu_torch.kernels.caar_t import (
    _hyb_t,
    _scalars,
    caar_packed_rsplit0_t,
    caar_packed_rsplit0_t_plain,
    caar_t,
    pack_problem_t,
    run_leapfrog_t,
)
from tinman_sandbox_tpu_torch.ops.scans import (
    eta_dot_dpdn_rsplit0,
    preq_vertadv,
)

torch.set_num_threads(2)
NELEM, NLEV = 16, 12
F64_TOL = 1e-12      # same math in f64; only the summation order differs
F32_TOL = 3e-6       # the JAX package's own f32 limit (tests/test_caar_pallas_t.py)
WIND = 30.0         # m/s: the state's winds are U(-1, 1) times this
STATE_FIELDS = ("u", "v", "t", "dp3d")
DERIVED_FIELDS = ("vn0_u", "vn0_v", "phi", "omega_p", "eta_dot_dpdn")


def _np(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _err(a, b):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@functools.lru_cache(maxsize=None)
def _jax_problem(dtype, rsplit=0, hybi="ramp"):
    """A JAX problem with random state (nm1 level zero, winds x WIND),
    random accumulators, pecnd and eta_dot_dpdn, random geometry and a hybi
    ramp (or zeros)."""
    dtype = np.dtype(dtype).type
    cfg = jt.Config(nelem=NELEM, nlev=NLEV, elem_block=8, rsplit=rsplit)
    cast = lambda tree: jax.tree.map(lambda x: np.asarray(x, dtype), tree)
    st = cast(jt.random_state(cfg, seed=3))
    zero_nm1 = {}
    for name in STATE_FIELDS:
        x = np.array(getattr(st, name))
        x[cfg.nm1] = 0
        if name in ("u", "v"):
            x *= WIND
        zero_nm1[name] = x
    st = dataclasses.replace(st, **zero_nm1)
    dv = cast(jt.zero_derived(cfg))
    rng = np.random.default_rng(21)
    dv = dataclasses.replace(dv, **{
        n: rng.uniform(-1, 1, getattr(dv, n).shape).astype(dtype)
        for n in ("vn0_u", "vn0_v", "omega_p", "pecnd", "eta_dot_dpdn")})
    g = cast(jt.random_geometry(cfg, seed=4))
    hv = jt.analytic_hvcoord(cfg).astype(dtype)
    ramp = np.linspace(0.0, 1.0, NLEV + 1) if hybi == "ramp" \
        else np.zeros(NLEV + 1)
    hv = dataclasses.replace(hv, hybi=ramp.astype(dtype))
    return cfg, st, dv, g, hv


def _port(cfg, st, dv, g, hv):
    ts, td, tg, th = from_numpy(_np(st), _np(dv), _np(g), _np(hv),
                                device="cpu")
    return Config(nelem=cfg.nelem, nlev=cfg.nlev, rsplit=cfg.rsplit), ts, td, \
        tg, th


@functools.lru_cache(maxsize=None)
def _xla(moist):
    cfg, st, dv, g, hv = _jax_problem(np.float64)
    return caar_xla(st, dv, g, hv, cfg, 0.1, 0.5, moist=moist)


def _compare(jres, tres, np1, tol):
    (js, jd), (ts, td) = jres, tres
    errs = {n: _err(getattr(ts, n)[np1], np.asarray(getattr(js, n))[np1])
            for n in STATE_FIELDS}
    errs.update({n: _err(getattr(td, n), getattr(jd, n))
                 for n in DERIVED_FIELDS})
    assert max(errs.values()) < tol, errs


FORMS = {"array": caar_array, "t": caar_t, "row": caar}


def test_torch_rsplit0_scans_match_jax():
    rng = np.random.default_rng(5)
    divdp = rng.standard_normal((3, NLEV, 4, 4))
    hybi = np.linspace(0.0, 1.0, NLEV + 1)
    je, js = j_eta(jnp.asarray(divdp), hybi)
    te, ts = eta_dot_dpdn_rsplit0(torch.from_numpy(divdp),
                                  torch.from_numpy(hybi))
    assert _err(te, je) < F64_TOL and _err(ts, js) < F64_TOL
    assert float(te[:, 0].abs().max()) == float(te[:, -1].abs().max()) == 0
    t, u, v = (rng.standard_normal((3, NLEV, 4, 4)) for _ in range(3))
    rpdel = 1.0 / rng.uniform(10, 20, (3, NLEV, 4, 4))
    ref = j_vertadv(*map(jnp.asarray, (t, u, v)), je, jnp.asarray(rpdel))
    got = preq_vertadv(*map(torch.from_numpy, (t, u, v)), te,
                       torch.from_numpy(rpdel))
    for a, b in zip(got, ref):
        assert _err(a, b) < F64_TOL


@pytest.mark.parametrize("moist", [True, False])
@pytest.mark.parametrize("form", list(FORMS))
def test_torch_rsplit0_f64_matches_caar_xla(form, moist):
    """The array form and the two packed plain forms (the versions the
    kernel is held against on the card) in f64 against caar_xla at 1e-12,
    eta_dot_dpdn included."""
    cfg, *prob = _jax_problem(np.float64)
    tcfg, *tprob = _port(cfg, *prob)
    tres = FORMS[form](*tprob, tcfg, 0.1, 0.5, moist=moist, device="cpu")
    _compare(_xla(moist), tres, cfg.np1, F64_TOL)


@pytest.mark.parametrize("kernel,moist", [("t", True), ("t", False),
                                          ("row", True)])
def test_torch_rsplit0_f32_matches_pallas(kernel, moist):
    """The f32 plain versions through the full-state wrappers against the
    JAX rsplit=0 kernels (caar_pallas_packed_rsplit0_t / _rsplit0) in
    interpret mode, eta_dot_dpdn included."""
    cfg, *prob = _jax_problem(np.float32)
    tcfg, *tprob = _port(cfg, *prob)
    jfn = caar_pallas_t if kernel == "t" else caar_pallas
    jres = jfn(*prob, cfg, 0.1, 0.5, moist=moist, interpret=True)
    tres = FORMS[kernel](*tprob, tcfg, 0.1, 0.5, moist=moist, device="cpu")
    _compare(jres, tres, cfg.np1, F32_TOL)


def test_torch_rsplit0_terms_are_seen():
    """On these problems the rsplit=0 terms move u, v, T and dp away from
    the rsplit=1 result by at least 100x the f32 tolerance, and so does the
    hybi*sdot term (a zero against a ramp hybi): a kernel that dropped
    either would fail the f32 gates above and on the card."""
    out = {}
    for key in (("ramp", 0), ("ramp", 1), ("zero", 0)):
        cfg, *prob = _jax_problem(np.float64, rsplit=key[1], hybi=key[0])
        tcfg, *tprob = _port(cfg, *prob)
        out[key] = caar_array(*tprob, tcfg, 0.1, 0.5, device="cpu")[0]
    for other in (("ramp", 1), ("zero", 0)):
        for name in STATE_FIELDS:
            a, b = (getattr(out[k], name)[1] for k in (other, ("ramp", 0)))
            assert _err(a, b) > 100 * F32_TOL, (other, name, _err(a, b))


@pytest.mark.parametrize("layout", ["t", "row"])
def test_torch_rsplit0_wrappers_on_cpu_tensors(layout):
    """The wrappers on CPU tensors run their plain versions: the same bits,
    the four accumulators updated in place, no launch counted; and the row
    plain version is the t plain version transposed, bit for bit."""
    cfg, *prob = _jax_problem(np.float32)
    tcfg, ts, td, tg, th = _port(cfg, *prob)
    names = ("u0", "v0", "t0", "dp0", "um1", "vm1", "tm1", "dpm1", "qdp",
             "pecnd")
    scal = _scalars(0.1, 0.5, th, torch.float32, "cpu")
    pt = pack_problem_t(ts, td, tg, th, tcfg)
    hyb_t = _hyb_t(th.hybi, NLEV)
    acc_t = [pt[n] for n in ("vn0u", "vn0v", "omg")]
    eta_t = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (NLEV, NELEM * 16)).astype(np.float32))
    want_t = caar_packed_rsplit0_t_plain(scal, hyb_t, pt["meta"],
                                         *(pt[n] for n in names), *acc_t,
                                         eta_t, pt["dvv"])
    if layout == "t":
        wrapper, plain, args = caar_packed_rsplit0_t, \
            caar_packed_rsplit0_t_plain, (scal, hyb_t, pt["meta"],
                                          *(pt[n] for n in names))
        acc = [a.clone() for a in (*acc_t, eta_t)]
        back = lambda x: x
    else:
        pr = pack_problem(ts, td, tg, th, tcfg)
        wrapper, plain, args = caar_packed_rsplit0, caar_packed_rsplit0_plain, \
            (scal, hyb_t.T.contiguous(), pr["meta"], *(pr[n] for n in names))
        acc = [a.T.contiguous() for a in (*acc_t, eta_t)]
        back = lambda x: x.T
    want = plain(*args, *acc, pt["dvv"])
    launches = wrapper.launches
    got = wrapper(*args, *acc, pt["dvv"])
    assert wrapper.launches == launches
    assert all(g is a for g, a in zip(got[5:], acc))
    for g, w, wt in zip(got, want, want_t):
        assert torch.equal(g, w)
        assert torch.equal(back(g), wt)


@pytest.mark.parametrize("entry", ["run_leapfrog_t", "run_leapfrog",
                                   "caar_dss_t", "caar_dss", "ssprk3_t",
                                   "prim_t"])
def test_torch_rsplit0_refused_where_jax_refuses(entry):
    """The packed leapfrog loops (as run_leapfrog_pallas[_t]) and the
    assembled, SSPRK3 and full-model packed steps have no rsplit=0 form."""
    from tinman_sandbox_tpu_torch import dist

    cfg, *prob = _jax_problem(np.float64)
    tcfg, ts, td, tg, th = _port(cfg, *prob)
    call = {
        "run_leapfrog_t": lambda: run_leapfrog_t(ts, td, tg, th, tcfg, 1,
                                                 device="cpu"),
        "run_leapfrog": lambda: run_leapfrog(ts, td, tg, th, tcfg, 1,
                                             device="cpu"),
        "caar_dss_t": lambda: dist.caar_dss_t(ts, td, tg, th, None, tcfg,
                                              0.1, 0.5, device="cpu"),
        "caar_dss": lambda: dist.caar_dss(ts, td, tg, th, None, tcfg, 0.1,
                                          0.5, device="cpu"),
        "ssprk3_t": lambda: dist.ssprk3_t(ts, td, tg, th, None, tcfg, 0.1,
                                          device="cpu"),
        "prim_t": lambda: dist.prim_t(ts, td, tg, th, None, tcfg,
                                      device="cpu"),
    }[entry]
    with pytest.raises(NotImplementedError, match="rsplit"):
        call()
