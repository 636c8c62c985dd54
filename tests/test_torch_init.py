"""The on-device initialisers of the ne120-class path and the bench's
direct-packed init, on the CPU:

  * ``state.random_state_device`` and
    ``kernels.caar_t.random_packed_problem_t`` give the shapes and dtypes
    of ``random_state`` / ``pack_problem_t``, every field inside its
    distribution's range, dp > 0, the same tensors for the same seed and
    others for another seed;
  * without a geometry the packed meta is O(1) with rmetdet = 1/metdet and
    zero pads; with one (a real cubed sphere) meta equals the metric rows of
    ``pack_problem_t`` on that geometry (phis 0) bit for bit, and JAX's
    ``random_packed_problem_t(geom=...)`` meta to 1e-7 (both f32 rows of
    one geometry);
  * ``bench.direct_init``: the host path below 16,384 elements, the device
    path from there on, and a refusal of the row layout there; the raw and
    assembled bench problems at that size (one level) are the direct
    path's."""
import dataclasses

import numpy as np
import pytest
import torch

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.kernels.caar_pallas_t import (
    random_packed_problem_t as j_random_packed,
)
from tinman_sandbox_tpu_torch import Config, bench, random_state, zero_derived
from tinman_sandbox_tpu_torch.dist import build_cubed_sphere
from tinman_sandbox_tpu_torch.kernels.caar_t import (
    pack_problem_t,
    random_packed_problem_t,
)
from tinman_sandbox_tpu_torch.kernels.layout import META_COLS
from tinman_sandbox_tpu_torch.state import random_state_device

RANGES = {"u": (-1, 1), "v": (-1, 1), "t": (250, 300), "dp3d": (10, 20),
          "ps_v": (9e4, 1.1e5), "phis": (0, 1), "qdp": (0, 1)}
PACKED_RANGES = {"u0": (-1, 1), "v0": (-1, 1), "t0": (250, 300),
                 "dp0": (10, 20), "um1": (-1, 1), "vm1": (-1, 1),
                 "tm1": (250, 300), "dpm1": (10, 20), "qdp": (0, 1),
                 "pecnd": (0, 1)}
MC = {n: i for i, n in enumerate(META_COLS)}


def test_torch_random_state_device():
    cfg = Config(nelem=6, nlev=5, qsize=2)
    a = random_state_device(cfg, seed=3, device="cpu")
    ref = random_state(cfg, seed=3, dtype=torch.float32, device="cpu")
    for f in dataclasses.fields(a):
        x = getattr(a, f.name)
        assert x.shape == getattr(ref, f.name).shape and \
            x.dtype == torch.float32, f.name
        lo, hi = RANGES[f.name]
        assert float(x.min()) >= lo and float(x.max()) <= hi, f.name
        assert float(x.std()) > 0, f.name
    assert float(a.dp3d.min()) > 0
    b = random_state_device(cfg, seed=3, device="cpu")
    c = random_state_device(cfg, seed=4, device="cpu")
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name))
        assert not torch.equal(getattr(a, f.name), getattr(c, f.name))
    d = random_state_device(cfg, seed=3, dtype=torch.float64, device="cpu")
    assert d.t.dtype == torch.float64


def test_torch_random_packed_problem_t():
    cfg = Config(nelem=24, nlev=5)
    p = random_packed_problem_t(cfg, seed=5, device="cpu")
    cs = build_cubed_sphere(2, dtype=torch.float32, device="cpu")
    ref = pack_problem_t(random_state(cfg, 1, torch.float32, "cpu"),
                         zero_derived(cfg, torch.float32, "cpu"), cs.geometry,
                         None, cfg)
    assert set(p) == set(ref)
    for k, x in p.items():
        assert x.shape == ref[k].shape and x.dtype == torch.float32, k
    for k, (lo, hi) in PACKED_RANGES.items():
        assert float(p[k].min()) >= lo and float(p[k].max()) <= hi, k
    for k in ("vn0u", "vn0v", "omg"):
        assert not p[k].any()
    m = p["meta"]
    assert float(m[:MC["pad1"]].min()) >= 0.5 - 1e-6
    assert torch.equal(m[MC["rmetdet"]], 1.0 / m[MC["metdet"]])
    assert not m[MC["pad1"]:].any()
    q = random_packed_problem_t(cfg, seed=5, device="cpu")
    r = random_packed_problem_t(cfg, seed=6, device="cpu")
    for k in p:
        assert torch.equal(p[k], q[k]), k
    assert not torch.equal(p["t0"], r["t0"])


def test_torch_random_packed_meta_on_a_geometry():
    ne, nlev = 2, 4
    jcs = j_build(ne)
    cs = build_cubed_sphere(ne, dtype=torch.float32, device="cpu")
    cfg = Config(nelem=cs.nelem, nlev=nlev)
    p = random_packed_problem_t(cfg, seed=7, geom=cs.geometry, device="cpu")
    st = random_state(cfg, 1, torch.float32, "cpu")
    st = dataclasses.replace(st, phis=torch.zeros_like(st.phis))
    ref = pack_problem_t(st, zero_derived(cfg, torch.float32, "cpu"),
                         cs.geometry, None, cfg)
    assert torch.equal(p["meta"], ref["meta"])
    assert torch.equal(p["dvv"], ref["dvv"])
    jcfg = jt.Config(nelem=jcs.nelem, nlev=nlev, elem_block=4)
    jg = dataclasses.replace(jcs.geometry, **{
        f.name: np.asarray(getattr(jcs.geometry, f.name), np.float32)
        for f in dataclasses.fields(jcs.geometry)})
    jmeta = np.asarray(j_random_packed(jcfg, seed=7, geom=jg)["meta"])
    np.testing.assert_allclose(p["meta"].numpy(), jmeta, rtol=0, atol=1e-7)


def test_torch_bench_direct_init():
    n = bench.DIRECT_NELEM
    assert not bench.direct_init(n - 1) and not bench.direct_init(n - 1, "row")
    assert bench.direct_init(n)
    with pytest.raises(ValueError, match="row"):
        bench.direct_init(n, "row")
    with pytest.raises(ValueError, match="row"):
        bench.make_problem(n, 1, "cpu", layout="row")
    (scal, meta, s0, sm1, qdp, pecnd, dvv), acc = bench.make_problem(
        n, 1, "cpu")
    assert s0.shape == sm1.shape == (4, n * 16) and meta.shape == (16, n * 16)
    assert float(s0[3].min()) >= 10 and not torch.cat(acc).any()
    fresh = random_packed_problem_t(Config(nelem=n, nlev=1), 7, device="cpu")
    assert torch.equal(s0[2], fresh["t0"][0]) and torch.equal(qdp,
                                                              fresh["qdp"])
    ne = 53                                   # 16,854 elements
    const, (a0, _), _, _, rsp = bench.make_assembled_problem(ne, 1, "cpu")
    cs = build_cubed_sphere(ne, dtype=torch.float32, device="cpu")
    fresh = random_packed_problem_t(Config(nelem=cs.nelem, nlev=1), 7,
                                    geom=cs.geometry, device="cpu")
    assert torch.equal(const[1], fresh["meta"])
    assert torch.equal(a0[0], fresh["u0"][0]) and rsp.shape[0] == 2
