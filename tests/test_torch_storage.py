"""The CAAR kernels' mixed-precision storage (``storage="bf16_aux"`` /
``"bf16_ro"``) in the port against the JAX package on the same numpy
inputs: the packs' bf16 fields bit for bit, the full-state steps on both
layouts at rsplit>0 and rsplit=0 against the Pallas kernels in interpret
mode and inside the JAX tests' envelopes of the f32 path, the stacked
assembled step, the operand contract of the wrappers, the bench's
``--storage`` and ``tools.bench_assembled``. On CPU tensors the wrappers
run the plain versions, which upcast the bf16 operands first.

Tolerances, scaled max-abs |a - b| / max|b|: 5e-5 against JAX on the same
bf16 operands (both compute in f32 after an exact upcast, the sums in
another order: the f32 gate of the port); the JAX tests' envelopes of the
f32 path, 1e-4 for bf16_aux and 1.5e-2 for bf16_ro (tests/test_caar_pallas
.py:221, tests/test_caar_pallas_t.py:108), and 2e-2 for the stacked step
(tests/test_structured_dss.py:760)."""
import dataclasses
import importlib
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.dist.step_pallas import (
    caar_dss_structured_packed_t4 as j_step_t4,
)
from tinman_sandbox_tpu.dist.structured_dss import make_structured_plan as j_plan
from tinman_sandbox_tpu.kernels.caar_pallas import caar_pallas
from tinman_sandbox_tpu.kernels.caar_pallas import pack_problem as j_pack
from tinman_sandbox_tpu.kernels.caar_pallas_t import _scalars as j_scalars
from tinman_sandbox_tpu.kernels.caar_pallas_t import caar_pallas_t
from tinman_sandbox_tpu.kernels.caar_pallas_t import pack_problem_t as j_pack_t
from tinman_sandbox_tpu_torch import Config, bench
from tinman_sandbox_tpu_torch.convert import from_numpy, plan_from_fields
from tinman_sandbox_tpu_torch.dist import (
    caar_dss_ring_t4,
    caar_dss_structured_packed_t4,
    continuity_error_t,
)
from tinman_sandbox_tpu_torch.kernels.caar import (
    caar,
    caar_packed,
    caar_packed_plain,
    caar_packed_rsplit0,
    caar_packed_rsplit0_plain,
    pack_problem,
)
from tinman_sandbox_tpu_torch.kernels.caar_t import (
    STORAGE,
    caar_packed_rsplit0_t,
    caar_packed_rsplit0_t_plain,
    caar_packed_t,
    caar_t,
    caar_t4_cuda,
    caar_t4_plain,
    pack_problem_t,
    random_packed_problem_t,
)
from tinman_sandbox_tpu_torch.kernels.dss import fix_tables
from tinman_sandbox_tpu_torch.kernels.ring_fused import caar_ring_packed_t4
from tinman_sandbox_tpu_torch.tools import bench_assembled

torch.set_num_threads(2)
# the module (the package's ``caar_t`` is the full-state function)
ct = importlib.import_module("tinman_sandbox_tpu_torch.kernels.caar_t")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = ("bf16_aux", "bf16_ro")
ENVELOPE = {"bf16_aux": 1e-4, "bf16_ro": 1.5e-2}
JAX_TOL = 5e-5
STATE = ("u", "v", "t", "dp3d")
DERIVED = ("vn0_u", "vn0_v", "phi", "omega_p")
AUX = ("qdp", "pecnd")
NM1 = ("um1", "vm1", "tm1", "dpm1")


def _np(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _err(a, b):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _bits(x):
    """A bf16 array of either package as its uint16 bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _setup(rsplit=1, derived_seed=None, nelem=16, nlev=12):
    """The JAX storage tests' problem (random state seed 3, random geometry
    seed 4, f32, eb 8; zero derived unless ``derived_seed`` draws the
    accumulators and pecnd) in both packages."""
    cfg = jt.Config(nelem=nelem, nlev=nlev, elem_block=8, rsplit=rsplit)
    cast = lambda tree: jax.tree.map(lambda x: np.asarray(x, np.float32),
                                     tree)
    st = cast(jt.random_state(cfg, seed=3))
    dv = cast(jt.zero_derived(cfg))
    if derived_seed is not None:
        rng = np.random.default_rng(derived_seed)
        dv = dataclasses.replace(dv, **{
            n: rng.uniform(-1, 1, getattr(dv, n).shape).astype(np.float32)
            for n in ("vn0_u", "vn0_v", "omega_p", "pecnd",
                      "eta_dot_dpdn")})
    g = cast(jt.random_geometry(cfg, seed=4))
    hv = jt.analytic_hvcoord(cfg).astype(np.float32)
    port = from_numpy(_np(st), _np(dv), _np(g), _np(hv), device="cpu")
    return (cfg, st, dv, g, hv), (Config(nelem=nelem, nlev=nlev,
                                         rsplit=rsplit), *port)


@pytest.mark.parametrize("storage", BF16)
@pytest.mark.parametrize("layout", ["t", "row"])
def test_torch_pack_storage_bits_match_jax(layout, storage):
    """The packs' bf16 fields are JAX's ``jnp.asarray(x, jnp.bfloat16)``
    bit for bit (round to nearest even), the f32 fields equal, and each
    field has the storage's dtype."""
    (cfg, st, dv, g, hv), (tcfg, ts, td, tg, th) = _setup(derived_seed=5)
    jp = (j_pack_t if layout == "t" else j_pack)(st, dv, g, hv, cfg,
                                                   storage=storage)
    tp = (pack_problem_t if layout == "t" else pack_problem)(
        ts, td, tg, th, tcfg, storage=storage)
    bf = AUX + (NM1 if storage == "bf16_ro" else ())
    for name in ("u0", "v0", "t0", "dp0", *AUX, *NM1, "vn0u", "vn0v", "omg",
                 "meta"):
        if name in bf:
            assert tp[name].dtype == torch.bfloat16, name
            assert np.array_equal(_bits(tp[name]), _bits(jp[name])), name
        else:
            assert tp[name].dtype == torch.float32, name
            assert np.array_equal(tp[name].numpy(), np.asarray(jp[name])), \
                name


@pytest.mark.parametrize("pack", [pack_problem_t, pack_problem])
def test_torch_pack_refuses_other_storage(pack):
    """Any other storage name is refused, as JAX's assert refuses it."""
    (cfg, st, dv, g, hv), (tcfg, ts, td, tg, th) = _setup(nelem=8, nlev=4)
    with pytest.raises(AssertionError):
        j_pack_t(st, dv, g, hv, cfg, storage="bf16")
    with pytest.raises(ValueError, match="storage='bf16'"):
        pack(ts, td, tg, th, tcfg, storage="bf16")
    with pytest.raises(ValueError, match="storage"):
        caar_t(ts, td, tg, th, tcfg, 0.5, 1.0, device="cpu", storage="f16")


def _compare(jres, tres, np1, tol, rsplit):
    (js, jd), (ts, td) = jres, tres
    errs = {n: _err(getattr(ts, n)[np1], np.asarray(getattr(js, n))[np1])
            for n in STATE}
    for n in DERIVED + (("eta_dot_dpdn",) if rsplit == 0 else ()):
        errs[n] = _err(getattr(td, n), getattr(jd, n))
    assert max(errs.values()) < tol, errs


@pytest.mark.parametrize("rsplit", [1, 0], ids=["rsplit1", "rsplit0"])
@pytest.mark.parametrize("layout", ["t", "row"])
def test_torch_storage_steps_match_jax(layout, rsplit):
    """``caar_t`` / ``caar`` with each bf16 storage against JAX's
    ``caar_pallas_t`` / ``caar_pallas`` (interpret mode) with the same
    storage: the same bf16 operands, f32 compute, at the port's f32 gate."""
    (cfg, st, dv, g, hv), (tcfg, ts, td, tg, th) = _setup(rsplit,
                                                          derived_seed=6)
    jfn, tfn = (caar_pallas_t, caar_t) if layout == "t" else (caar_pallas,
                                                               caar)
    for storage in BF16:
        jres = jfn(st, dv, g, hv, cfg, 0.5, 1.0, interpret=True,
                   storage=storage)
        tres = tfn(ts, td, tg, th, tcfg, 0.5, 1.0, device="cpu",
                   storage=storage)
        _compare(jres, tres, cfg.np1, JAX_TOL, rsplit)


@pytest.mark.parametrize("layout", ["t", "row"])
def test_torch_storage_within_jax_envelopes(layout):
    """Mirror of tests/test_caar_pallas.py:221 and
    tests/test_caar_pallas_t.py:108 on the port: each bf16 storage against
    the port's own f32 path, u, v, T and dp3d at np1 within the JAX tests'
    documented envelopes; JAX's own distance printed beside it."""
    (cfg, st, dv, g, hv), (tcfg, ts, td, tg, th) = _setup()
    fn = caar_t if layout == "t" else caar
    ref, _ = fn(ts, td, tg, th, tcfg, 0.5, 1.0, device="cpu")
    for storage, tol in ENVELOPE.items():
        out, _ = fn(ts, td, tg, th, tcfg, 0.5, 1.0, device="cpu",
                    storage=storage)
        for name in STATE:
            a, b = getattr(out, name)[cfg.np1], getattr(ref, name)[cfg.np1]
            assert _err(a, b) < tol, (name, storage, _err(a, b))
    # the bf16 state changes the answer: the envelope is not vacuous
    out, _ = fn(ts, td, tg, th, tcfg, 0.5, 1.0, device="cpu",
                storage="bf16_ro")
    assert _err(out.t[cfg.np1], ref.t[cfg.np1]) > 0


def _stacked_problem():
    """tests/test_structured_dss.py:760's problem: ne 2 x 4 levels, eb 4,
    random state seed 8 (f32), zero derived, ``_scalars(0.5, 1.0, hv)``,
    the one-float rspheremp row; JAX operands and the port's."""
    jcs = j_build(2)
    cfg = jt.Config(nelem=jcs.nelem, nlev=4, elem_block=4)
    cast = lambda t: jax.tree.map(lambda x: np.asarray(x, np.float32), t)
    st, dv = cast(jt.random_state(cfg, seed=8)), cast(jt.zero_derived(cfg))
    hv = jt.analytic_hvcoord(cfg).astype(np.float32)
    g = cast(jcs.geometry)
    pt = j_pack_t(st, dv, g, hv, cfg)
    cat = lambda keys: np.concatenate([np.asarray(pt[k]) for k in keys])
    j = dict(scal=np.asarray(j_scalars(0.5, 1.0, hv)), meta=pt["meta"],
             s0=cat(("u0", "v0", "t0", "dp0")), sm1=cat(NM1),
             qdp=pt["qdp"], pecnd=pt["pecnd"], acc=(pt["vn0u"], pt["vn0v"],
                                                    pt["omg"]),
             plan=j_plan(jcs.gdof, 2),
             rsp=jnp.asarray(g.rspheremp, jnp.float32).reshape(1, -1),
             px=tuple(pt[k] for k in ("dxbt", "dybt", "ainct", "astrt",
                                      "bstrt")))
    tt = lambda x: torch.from_numpy(np.array(x, np.float32))
    t = dict(scal=tt(j["scal"]), meta=tt(j["meta"]), s0=tt(j["s0"]),
             sm1=tt(j["sm1"]), qdp=tt(j["qdp"]), pecnd=tt(j["pecnd"]),
             acc=tuple(tt(a) for a in j["acc"]),
             plan=plan_from_fields(j["plan"].ne, j["plan"].edges,
                                   j["plan"].corner_rows),
             rsp=tt(j["rsp"]), dvv=tt(g.dvv))
    return j, t, jcs


def test_torch_stacked_bf16ro_step_matches_jax():
    """Mirror of tests/test_structured_dss.py:760: the stacked assembled
    step with bf16 sm1, qdp and pecnd against JAX's in interpret mode at
    5e-5 relative, and against the f32 step under 2e-2; the DSS after the
    kernel sees f32 only, so continuity stays exactly 0."""
    j, t, jcs = _stacked_problem()

    def jrun(sm1, qdp, pec):
        return j_step_t4(j["scal"], *j["px"], j["meta"], j["s0"], sm1, qdp,
                         pec, *j["acc"], j["plan"], j["rsp"], eb=4, nlev=4,
                         interpret=True)

    def trun(sm1, qdp, pec):
        acc = [a.clone() for a in t["acc"]]
        return caar_dss_structured_packed_t4(
            t["scal"], t["meta"], t["s0"], sm1, qdp, pec, *acc, t["dvv"],
            t["plan"], t["rsp"])

    bf = lambda x: jnp.asarray(x, jnp.bfloat16)
    tb = lambda x: x.to(torch.bfloat16)
    jref = jrun(bf(j["sm1"]), bf(j["qdp"]), bf(j["pecnd"]))
    got = trun(tb(t["sm1"]), tb(t["qdp"]), tb(t["pecnd"]))
    f32 = trun(t["sm1"], t["qdp"], t["pecnd"])
    for i in range(5):
        assert got[i].dtype == torch.float32
        assert _err(got[i], np.asarray(jref[i], np.float64)) < JAX_TOL, i
        rel = _err(got[i], f32[i])
        assert 0 <= rel < 2e-2, (i, rel)
        assert bool(torch.isfinite(got[i]).all())
    assert continuity_error_t(got[0], jcs.gdof) == 0.0


def _t_operands(storage, nelem=8, nlev=6):
    """Random stacked t-layout operands (s0, sm1, qdp, pecnd in
    ``storage``), meta, dvv, scal and accumulators."""
    rng = np.random.default_rng(11)
    e16 = 16 * nelem
    z = lambda *s: torch.from_numpy(rng.uniform(0.5, 1.5, s).astype(
        np.float32))
    const = (z(1, 4), z(16, e16), z(4 * nlev, e16), z(4 * nlev, e16),
             z(nlev, e16), z(nlev, e16))
    acc = tuple(z(nlev, e16) for _ in range(3))
    p = dict(zip(("scal", "meta", "s0", "sm1", "qdp", "pecnd"), const))
    if storage != "f32":
        for n in AUX + (("sm1",) if storage == "bf16_ro" else ()):
            p[n] = p[n].to(torch.bfloat16)
    return p, acc, z(4, 4)


@pytest.mark.parametrize("storage", BF16)
def test_torch_plain_on_bf16_is_plain_on_the_upcast(storage):
    """The plain versions on bf16 operands equal, bit for bit, the plain
    versions on the same operands upcast to f32: the t pair step, the t and
    row rsplit=0 steps and the row step (transposed operands)."""
    p, acc, dvv = _t_operands(storage)
    up = {k: v.float() for k, v in p.items()}
    args = lambda q: (q["scal"], q["meta"], q["s0"], q["sm1"], q["qdp"],
                      q["pecnd"], *acc, dvv)
    for a, b in zip(caar_t4_plain(*args(p)), caar_t4_plain(*args(up))):
        assert torch.equal(a, b)
    k = p["qdp"].shape[0]
    hyb = torch.stack([torch.linspace(0, 1, k + 1)[:k],
                       torch.linspace(0, 1, k + 1)[1:]], 1).contiguous()
    eta = acc[0] * 0.5

    def fields(q):
        return (*q["s0"].split(k), *q["sm1"].split(k), q["qdp"], q["pecnd"])

    got = caar_packed_rsplit0_t_plain(p["scal"], hyb, p["meta"], *fields(p),
                                      *acc, eta, dvv)
    want = caar_packed_rsplit0_t_plain(up["scal"], hyb, up["meta"],
                                       *fields(up), *acc, eta, dvv)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    T = lambda q: tuple(x.T.contiguous() for x in fields(q))
    tacc = tuple(a.T.contiguous() for a in acc)
    for a, b in zip(caar_packed_plain(p["scal"], p["meta"].T.contiguous(),
                                      *T(p), *tacc, dvv),
                    caar_packed_plain(up["scal"], up["meta"].T.contiguous(),
                                      *T(up), *tacc, dvv)):
        assert torch.equal(a, b)
    for a, b in zip(caar_packed_rsplit0_plain(
            p["scal"], hyb.T.contiguous(), p["meta"].T.contiguous(), *T(p),
            *tacc, eta.T.contiguous(), dvv),
            caar_packed_rsplit0_plain(
            up["scal"], hyb.T.contiguous(), up["meta"].T.contiguous(),
            *T(up), *tacc, eta.T.contiguous(), dvv)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("storage", ["f32", *BF16])
def test_torch_wrappers_admit_the_storage_contracts(storage):
    """The stacked, unstacked, rsplit=0 and ring wrappers take each storage
    contract; phi, s1, the accumulators and the slab come back f32 (from
    s0, not from a bf16 qdp), bit for bit the plain version."""
    const, (s0, sm1), acc, plan, rsp = bench.make_assembled_problem(
        2, 4, "cpu", storage=storage)
    scal, meta, qdp, pecnd, dvv = const
    assert qdp.dtype == (torch.float32 if storage == "f32"
                         else torch.bfloat16)
    assert sm1.dtype == (torch.bfloat16 if storage == "bf16_ro"
                         else torch.float32)
    fix = fix_tables(plan, "cpu")
    kacc = [a.clone() for a in acc]
    out = caar_t4_cuda(scal, meta, s0, sm1, qdp, pecnd, *kacc, dvv, fix=fix)
    want = caar_t4_plain(scal, meta, s0, sm1, qdp, pecnd, *acc, dvv, fix=fix)
    for a, b in zip(out, want):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    k = qdp.shape[0]
    u = caar_packed_t(scal, meta, *s0.split(k), *sm1.split(k), qdp, pecnd,
                      *(a.clone() for a in acc), dvv, fix=fix)
    assert all(x.dtype == torch.float32 for x in u)
    assert torch.equal(u[4], want[1]) and torch.equal(u[-1], want[-1])
    hyb = torch.zeros(k, 2)
    r0 = caar_packed_rsplit0_t(scal, hyb, meta, *s0.split(k), *sm1.split(k),
                               qdp, pecnd, *(a.clone() for a in acc),
                               acc[0].clone(), dvv)
    assert all(x.dtype == torch.float32 for x in r0)
    T = lambda x: x.T.contiguous()
    row = caar_packed(scal, T(meta), *map(T, s0.split(k)),
                      *map(T, sm1.split(k)), T(qdp), T(pecnd),
                      *(T(a) for a in acc), dvv)
    assert all(x.dtype == torch.float32 for x in row)
    assert torch.equal(row[4], T(want[1]))
    r0row = caar_packed_rsplit0(scal, T(hyb), T(meta), *map(T, s0.split(k)),
                                *map(T, sm1.split(k)), T(qdp), T(pecnd),
                                *(T(a) for a in acc), T(acc[0]), dvv)
    assert all(x.dtype == torch.float32 for x in r0row)
    ring = caar_ring_packed_t4(scal, meta, s0, sm1, qdp, pecnd,
                               *(a.clone() for a in acc), dvv, rsp, fix)
    assert all(x.dtype == torch.float32 for x in ring)
    assert torch.equal(ring[-1], want[-1]) and torch.equal(ring[1], want[1])


@pytest.mark.parametrize("case,error,match", [
    ("qdp_alone", ValueError, "pecnd"),
    ("pecnd_alone", ValueError, "qdp"),
    ("f16_qdp", ValueError, "qdp is torch.float16"),
    ("nm1_without_aux", ValueError, "qdp and pecnd"),
    ("lone_um1", ValueError, "um1 is bfloat16 but vm1"),
    ("lone_dpm1", ValueError, "dpm1 is bfloat16 but um1"),
    ("stage_mode", ValueError, "stage mode"),
    ("bf16_meta", ValueError, "meta"),
    ("bf16_acc", ValueError, "a field"),
    ("bf16_s0", TypeError, "bfloat16"),
    ("ring_stage", ValueError, "stage mode"),
])
def test_torch_wrappers_refuse_other_mixes(case, error, match):
    """Every mix outside the contracts is refused, naming the field: a lone
    bf16 qdp or pecnd in the pair form, f16, bf16 nm1 fields without bf16
    qdp and pecnd, a lone bf16 nm1 field, a bf16 qdp beside an f32 pecnd in
    the stage mode, bf16 meta, accumulators or n0 state, and bf16 in the
    ring's stage mode."""
    p, acc, dvv = _t_operands("bf16_ro")
    f = _t_operands("f32")[0]
    k = f["qdp"].shape[0]
    bf = lambda x: x.to(torch.bfloat16)

    def stacked(**over):
        q = dict(f, **over)
        return caar_t4_cuda(q["scal"], q["meta"], q["s0"], q["sm1"],
                            q["qdp"], q["pecnd"], *acc, dvv,
                            single=q.get("single", False))

    def unstacked(nm1):
        return caar_packed_t(f["scal"], f["meta"], *f["s0"].split(k), *nm1,
                             p["qdp"], p["pecnd"], *acc, dvv)

    fields = list(f["sm1"].split(k))
    calls = {
        "qdp_alone": lambda: stacked(qdp=bf(f["qdp"])),
        "pecnd_alone": lambda: stacked(pecnd=bf(f["pecnd"])),
        "f16_qdp": lambda: stacked(qdp=f["qdp"].half(),
                                   pecnd=f["pecnd"].half()),
        "nm1_without_aux": lambda: stacked(sm1=bf(f["sm1"])),
        "lone_um1": lambda: unstacked([bf(fields[0])] + fields[1:]),
        "lone_dpm1": lambda: unstacked(fields[:3] + [bf(fields[3])]),
        "stage_mode": lambda: stacked(sm1=None, single=True,
                                      qdp=p["qdp"]),
        "bf16_meta": lambda: stacked(meta=bf(f["meta"])),
        "bf16_acc": lambda: caar_t4_cuda(
            f["scal"], f["meta"], f["s0"], f["sm1"], f["qdp"], f["pecnd"],
            bf(acc[0]), *acc[1:], dvv),
        "bf16_s0": lambda: stacked(s0=bf(f["s0"])),
    }
    if case == "ring_stage":
        const, (s0, _), racc, plan, rsp = bench.make_assembled_problem(
            2, 4, "cpu", storage="bf16_aux")
        scal, meta, qdp, pecnd, rdvv = const
        calls[case] = lambda: caar_ring_packed_t4(
            scal, meta, s0, None, qdp, pecnd, *racc, rdvv, rsp,
            fix_tables(plan, "cpu"), single=True, emit_phi=False)
    with pytest.raises(error, match=match):
        calls[case]()


def test_torch_cuda_branch_passes_the_storage_code(monkeypatch):
    """A CUDA call of the stacked wrapper (reached by a check that reports a
    card and a stand-in library) hands ``caar_launch`` the storage code
    after the plan, the bf16 operands' own addresses (no f32 copy) and
    counts its launch in ``storage_launches`` too."""
    from tinman_sandbox_tpu_torch.kernels import _build

    calls = []

    class Lib:
        def caar_launch(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(ct, "_check", lambda *a, **kw: torch.device("cuda",
                                                                     0))
    monkeypatch.setattr(_build, "library", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    for storage, code in STORAGE.items():
        p, acc, dvv = _t_operands(storage, nelem=4)
        n, s = caar_t4_cuda.launches, caar_t4_cuda.storage_launches
        caar_t4_cuda(p["scal"], p["meta"], p["s0"], p["sm1"], p["qdp"],
                     p["pecnd"], *acc, dvv)
        args = calls.pop()
        assert args[37] == code
        k, e16 = p["qdp"].shape
        step = k * e16 * p["sm1"].element_size()
        assert args[7:13] == tuple(p["sm1"].data_ptr() + i * step
                                   for i in range(4)) + (
            p["qdp"].data_ptr(), p["pecnd"].data_ptr())
        assert caar_t4_cuda.launches == n + 1
        assert caar_t4_cuda.storage_launches == s + (code > 0)


# the staged row kernel's planes that take a bf16 qdp and pecnd as raw pairs
# before pass 3 writes them (csrc/caar.cu RowPlane: kPVt2, kPDpt)
ROW_RAW_PLANES = (7, 8)


def _row_call(monkeypatch, storage, nlev, r0, misalign=False):
    """One row-wrapper call (``caar_packed``, or ``caar_packed_rsplit0``
    with ``r0``) on a card that a stand-in library plays: returns the
    arguments it handed ``caar_launch``. With ``misalign`` qdp starts one
    element (2 bytes in bf16) past an aligned address."""
    from tinman_sandbox_tpu_torch.kernels import _build

    calls = []

    class Lib:
        def caar_launch(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(ct, "_check", lambda *a, **kw: torch.device("cuda",
                                                                     0))
    monkeypatch.setattr(_build, "library", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    p, acc, dvv = _t_operands(storage, nelem=4, nlev=nlev)
    T = lambda x: x.T.contiguous()
    qdp = T(p["qdp"])
    if misalign:
        flat = torch.empty(qdp.numel() + 1, dtype=qdp.dtype)
        flat[1:] = qdp.reshape(-1)
        qdp = flat[1:].view(qdp.shape)
    head = (T(p["meta"]), *map(T, p["s0"].split(nlev)),
            *map(T, p["sm1"].split(nlev)), qdp, T(p["pecnd"]),
            *(T(a) for a in acc))
    if r0:
        hyb = torch.zeros(2, nlev)
        caar_packed_rsplit0(p["scal"], hyb, *head, T(acc[0]), dvv)
    else:
        caar_packed(p["scal"], *head, dvv)
    return calls.pop()


@pytest.mark.parametrize("storage", ["f32", *BF16])
@pytest.mark.parametrize("nlev,r0", [(72, False), (72, True), (197, False),
                                     (161, True)],
                         ids=["72", "72_r0", "197", "161_r0"])
def test_torch_row_plan_keeps_its_planes_in_every_storage(monkeypatch,
                                                          storage, nlev, r0):
    """At nlev 72 and at the last staged nlev of each rsplit mode (197, and
    161 at rsplit=0) the row kernel is staged in ROW_PLANES planes, its
    shared memory the planes, the chunk totals and the meta within one
    block's, the next level windowed; a bf16 qdp and pecnd ride as raw
    pairs in half of two planes that both layouts have, so every storage
    hands the kernel the same plan, with its own storage code."""
    plan = ct.caar_row_plan(64, nlev, r0)
    last = nlev == (161 if r0 else 197)
    assert plan.stash and ct.caar_row_plan(64, nlev + 1, r0).stash != last
    assert plan.smem == 4 * ((ct.ROW_PLANES[r0] * nlev + 3 * plan.chunks)
                             * ct.TILE + 16 * ct.ROW_META_PITCH)
    assert plan.smem <= ct.SMEM_MAX
    assert max(ROW_RAW_PLANES) < min(ct.ROW_PLANES)
    # a tile's bf16 span (TILE columns of nlev levels, 2 bytes each) is
    # half of a plane of f32
    assert ct.TILE * nlev * 2 * 2 == ct.TILE * nlev * 4
    args = _row_call(monkeypatch, storage, nlev, r0)
    assert args[32] == 1                            # the row layout
    assert args[33:37] == (plan.chunks, plan.levels, 1, plan.blocks_per_sm)
    assert args[37] == STORAGE[storage]


@pytest.mark.parametrize("storage", ["f32", *BF16])
@pytest.mark.parametrize("r0", [False, True], ids=["rsplit1", "rsplit0"])
def test_torch_row_bf16_operands_must_be_4_byte_aligned(monkeypatch, storage,
                                                        r0):
    """The row kernel copies a bf16 qdp and pecnd as 4-byte pairs: a bf16
    qdp 2 bytes off a 4-byte boundary is refused before any launch, an f32
    one (copied 4 bytes an element) is not."""
    if storage == "f32":
        args = _row_call(monkeypatch, storage, 6, r0, misalign=True)
        assert args[37] == 0 and args[11] % 4 == 0
        return
    with pytest.raises(ValueError, match="4-byte aligned"):
        _row_call(monkeypatch, storage, 6, r0, misalign=True)


@pytest.mark.parametrize("nlev", [1, 6, 7, 72, 197])
def test_torch_row_tiles_start_and_span_even(nlev):
    """What the row kernel's raw pairs rest on: every tile of every column
    count the wrappers admit (whole elements of 16 columns) starts on an
    even element of a field and spans an even number of them, so each pair
    lies inside one tile's span and on a 4-byte boundary of an aligned
    field, whatever nlev's parity."""
    for ncol in range(16, 16 * 9, 16):
        for col0 in range(0, ncol, ct.TILE):
            span = min(ct.TILE, ncol - col0) * nlev
            assert (col0 * nlev) % 2 == 0 and span % 2 == 0


def test_torch_random_problem_storage_cast():
    """``random_packed_problem_t(storage=)`` is the f32 draw with the
    bench's post-init cast (qdp, pecnd; bf16_ro also the nm1 fields), bit
    for bit ``x.to(bfloat16)`` of the f32 draw."""
    cfg = Config(nelem=4, nlev=3)
    f32 = random_packed_problem_t(cfg, 2, device="cpu")
    for storage in BF16:
        p = random_packed_problem_t(cfg, 2, device="cpu", storage=storage)
        for name, x in f32.items():
            cast = name in AUX or (storage == "bf16_ro" and name in NM1)
            want = x.to(torch.bfloat16) if cast else x
            assert p[name].dtype == want.dtype and torch.equal(p[name],
                                                               want), name


@pytest.fixture
def cpu_card(monkeypatch):
    """The bench's main on the CPU: the device, the syncs, the card's name
    and the triad of a stand-in card (the kernels' plain versions run)."""
    from tinman_sandbox_tpu_torch import device
    from tinman_sandbox_tpu_torch.kernels import saxpby

    monkeypatch.setattr(device, "resolve_device",
                        lambda d=None: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    monkeypatch.setattr(saxpby, "saxpby_bandwidth_gbs", lambda **kw: 1.0)


@pytest.mark.parametrize("argv,nbytes", [
    (["--nelem", "32", "--nlev", "4"], lambda s: bench.bytes_per_step(
        32, 4, storage=s)),
    (["--nelem", "32", "--nlev", "4", "--layout", "row"],
     lambda s: bench.bytes_per_step(32, 4, storage=s)),
    (["--ne", "2", "--nlev", "4"], None),
    (["--ne", "2", "--nlev", "4", "--layout", "row"], None),
    (["--ne", "2", "--nlev", "4", "--ring"], None),
], ids=["raw", "raw-row", "ne2", "ne2-row", "ne2-ring"])
def test_torch_bench_storage_smoke(cpu_card, capsys, argv, nbytes):
    """``bench --storage`` in the raw and the assembled modes, both layouts
    and the ring: one JSON line with ``storage``, whose bytes are the f32
    count less 2 bytes an element of each bf16 field (2 for bf16_aux, 6
    for bf16_ro)."""
    lines = {}
    for storage in ("f32", *BF16):
        bench.main(argv + ["--nexec", "2", "--reps", "1", "--storage",
                           storage])
        out = capsys.readouterr().out.strip().splitlines()
        assert len(out) == 1
        lines[storage] = json.loads(out[0])
        assert lines[storage]["storage"] == storage
        assert f"storage={storage}" in lines[storage]["config"]
        assert lines[storage]["storage_launches"] == 0      # no card
    e16 = (32 if "--nelem" in argv else 6 * 4) * 16
    for storage, n in bench.BF16_FIELDS.items():
        got = lines[storage]["bytes_per_step"]
        assert got == lines["f32"]["bytes_per_step"] - n * 2 * e16 * 4
        if nbytes is not None:
            assert got == nbytes(storage)


@pytest.mark.parametrize("layout", ["t", "row"])
def test_torch_bench_chain_keeps_the_nm1_slot_bf16(layout):
    """``run_assembled`` in bf16_ro: after N steps the nm1 slot is still
    bf16, the old n0 rounded (the JAX bench's rotation cast), and the
    chain is the explicit steps with that cast."""
    const, (s0, sm1), acc, plan, rsp = bench.make_assembled_problem(
        2, 4, "cpu", layout=layout, storage="bf16_ro")
    (n0, nm1), acc2, phi = bench.run_assembled(
        const, (s0, sm1), [a.clone() for a in acc], plan, rsp, 3,
        layout=layout)
    flat = lambda x: x if isinstance(x, tuple) else (x,)
    assert all(x.dtype == torch.bfloat16 for x in flat(nm1))
    assert all(x.dtype == torch.float32 for x in (*flat(n0), *acc2, phi))
    (a0, a1), *_ = bench.run_assembled(
        const, (s0, sm1), [a.clone() for a in acc], plan, rsp, 2,
        layout=layout)
    for x, y in zip(flat(nm1), flat(a0)):
        assert torch.equal(x, y.to(torch.bfloat16))
    if layout == "t":
        two = bench.run_assembled(const, (s0, sm1), [a.clone() for a in acc],
                                  plan, rsp, 2, step=caar_dss_ring_t4)
        assert torch.equal(two[0][0], a0) and torch.equal(two[0][1], a1)


@pytest.mark.parametrize("mode", ["--rk", "--prim"])
def test_torch_bench_stage_modes_refuse_bf16(cpu_card, mode, capsys):
    """``--rk`` / ``--prim`` take a bf16 storage: one JSON line naming it,
    whose bytes are the f32 count less 2 bytes an element of each bf16
    read of the timed steps (qdp and pecnd on each ``--rk`` stage; pecnd
    alone on each ``--prim`` dynamics stage: its qdp is bf16 on the first,
    warm-up step only), bf16_ro equal to bf16_aux there; a storage the
    root bench refuses exits 2."""
    argv = ["--ne", "2", "--nlev", "4", mode, "--nexec", "2", "--reps", "1"]
    lines = {}
    for storage in ("f32", *BF16):
        bench.main(argv + ["--storage", storage])
        out = capsys.readouterr().out.strip().splitlines()
        assert len(out) == 1
        lines[storage] = json.loads(out[0])
        assert lines[storage]["storage"] == storage
        assert f"storage={storage}" in lines[storage]["config"]
        assert lines[storage]["storage_launches"] == 0      # no card
    rows = 6 if mode == "--rk" else 3
    for storage in BF16:
        assert lines[storage]["bytes_per_step"] == \
            lines["f32"]["bytes_per_step"] - rows * 2 * 24 * 16 * 4
    with pytest.raises(SystemExit) as e:
        bench.main(argv + ["--storage", "bf16"])
    assert e.value.code == 2


def test_torch_bench_assembled_tool_variants():
    """``tools.bench_assembled`` covers every variant of the JAX tool: the
    seven with a counterpart timed (one line each, finite and positive), the
    rest "not applicable" with a reason; the last line holds the sweep."""
    with open(os.path.join(ROOT, "tools", "bench_assembled.py")) as f:
        jax_names = re.findall(r'^\s+"(\w+)": v_\w+,', f.read(), re.M)
    assert len(jax_names) == 18
    assert set(jax_names) == set(bench_assembled.VARIANTS) | set(
        bench_assembled.NOT_APPLICABLE)
    assert not set(bench_assembled.VARIANTS) & set(
        bench_assembled.NOT_APPLICABLE)
    assert set(bench_assembled.NO_GRAPH) < set(bench_assembled.VARIANTS)
    lines = bench_assembled.main(["--device", "cpu", "--ne", "2", "--nlev",
                                  "3", "--nexec", "1", "--reps", "1"])
    sweep = lines[-1]["sweep"]
    assert [next(iter(ln)) for ln in lines[:-1]] == list(sweep)
    assert set(sweep) == set(jax_names)
    for name in bench_assembled.VARIANTS:
        assert 0 < sweep[name]["us_per_step"] < float("inf"), name
        assert sweep[name]["ggp_per_s"] > 0
    for name, why in bench_assembled.NOT_APPLICABLE.items():
        assert sweep[name] == why and why.startswith("not applicable: ")
    with pytest.raises(ValueError, match="unknown"):
        bench_assembled.main(["--device", "cpu", "--ne", "2", "--variants",
                              "t4_structured_lg8"])
