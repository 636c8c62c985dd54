"""The port's structured DSS (plain version and the kernel wrappers on CPU
tensors) against the JAX package's on random f32 [k, E16] fields of the
real cubed sphere, the JAX Pallas kernels in interpret mode.

Tolerances: with the single-f32 rspheremp every path computes the same f32
adds and products in the same order, so the results are equal bit for bit.
With the two-float rspheremp the port computes fmaf(y, hi, y*lo) (as the
kernel on the card does, ``dist.dss.mul_2f``), where the JAX package's
y*hi + y*lo is whatever fused multiply-add XLA on the CPU contracts it to:
there the test allows 1e-6 scaled max-abs, a few f32 ulps."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.dist.structured_dss import (
    dss_structured_t as j_dss_structured_t,
    make_structured_plan as j_plan,
    rsp_lanes_2f as j_rsp_lanes_2f,
)
from tinman_sandbox_tpu.kernels.dss_pallas import (
    _compact_arrays,
    _fixup_arrays_t,
    dss_structured_t_pallas,
    dss_structured_t_pallas_cpre,
    extract_tiles_ct,
)
from tinman_sandbox_tpu_torch.dist import (
    build_cubed_sphere,
    dss_scaled,
    dss_structured_scaled_t,
    dss_structured_t,
    make_structured_plan,
    rsp_2f,
    rsp_lanes_2f,
)
from tinman_sandbox_tpu_torch.kernels.dss import (
    dss_extract_cuda,
    dss_extract_plain,
    dss_fixup_cuda,
    dss_fixup_plain,
    dss_structured_t_cuda,
    dss_structured_t_cuda_pre,
    dss_sweep_cuda,
    dss_sweep_plain,
    fix_tables,
)
from tinman_sandbox_tpu_torch.kernels.layout import pack_field_t, unpack_field_t

torch.set_num_threads(2)
TWO_FLOAT_TOL = 1e-6


def _grid(ne):
    jcs = j_build(ne)
    return jcs, j_plan(jcs.gdof, ne), make_structured_plan(jcs.gdof, ne)


def _rsp(jcs, two_float):
    g = jcs.geometry
    if two_float:
        return j_rsp_lanes_2f(np.asarray(g.spheremp, np.float32), jcs.gdof,
                              jcs.ndof)
    return np.asarray(g.rspheremp, np.float32).reshape(1, -1)


def _field(jcs, k, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((k, jcs.nelem * 16)).astype(np.float32)


def _compare(got, ref, two_float):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    if two_float:
        err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
        assert err < TWO_FLOAT_TOL, err
    else:
        np.testing.assert_array_equal(got, ref)


def _continuity_spread(y, gdof):
    """max over dofs of (max - min) of the values of its aliases."""
    lanes = torch.from_numpy(np.asarray(gdof).reshape(-1).astype(np.int64))
    first = np.unique(np.asarray(gdof).reshape(-1), return_index=True)[1]
    canon = torch.from_numpy(first)[lanes]
    return float((y - y[:, canon]).abs().max())


@pytest.mark.parametrize("ne", [2, 3])
def test_torch_dss_structured_t_matches_jax_bitwise(ne):
    """The plain structured DSS (unscaled) against JAX's dss_structured_t."""
    jcs, jp, p = _grid(ne)
    x = _field(jcs, 5, seed=ne)
    ref = np.asarray(j_dss_structured_t(jnp.asarray(x), jp))
    got = dss_structured_t(torch.from_numpy(x), p)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("ne,two_float", [(2, False), (2, True), (3, False),
                                          (3, True)])
def test_torch_dss_kernels_match_pallas(ne, two_float):
    """Extract + fixup + sweep (the kernel wrappers on CPU tensors, that is
    the plain versions) against dss_structured_t_pallas in interpret mode;
    each wrapper equals its plain version; no launch is counted on the
    CPU."""
    jcs, jp, p = _grid(ne)
    x = _field(jcs, 8, seed=10 + ne)
    rsp = _rsp(jcs, two_float)
    ref = dss_structured_t_pallas(jnp.asarray(x), jp, jnp.asarray(rsp),
                                  interpret=True)
    X, R = torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(rsp))
    counts = [f.launches for f in (dss_extract_cuda, dss_fixup_cuda,
                                   dss_sweep_cuda)]
    got = dss_structured_t_cuda(X, p, R)
    assert [f.launches for f in (dss_extract_cuda, dss_fixup_cuda,
                                 dss_sweep_cuda)] == counts
    _compare(got, ref, two_float)
    # the same on the slice formulation, and each wrapper = its plain form
    _compare(dss_structured_scaled_t(X, p, R), ref, two_float)
    t = fix_tables(p, "cpu")
    slab = dss_extract_plain(X, t)
    vd = dss_fixup_plain(slab, t, R)
    assert torch.equal(dss_extract_cuda(X, t), slab)
    assert torch.equal(dss_fixup_cuda(slab, t, R), vd)
    assert torch.equal(dss_sweep_cuda(X, R, vd, t),
                       dss_sweep_plain(X, R, vd, t))
    assert torch.equal(dss_sweep_plain(X, R, vd, t), got)


@pytest.mark.parametrize("two_float", [False, True])
def test_torch_dss_compact_slab_matches_jax(two_float):
    """The port's slab row by row against JAX's compact slab
    (extract_tiles_ct; rows mapped through _compact_arrays), bitwise, and
    the pre-slab DSS against dss_structured_t_pallas_cpre (ne=2)."""
    jcs, jp, p = _grid(2)
    x = _field(jcs, 6, seed=21)
    rsp = _rsp(jcs, two_float)
    gtiles = _fixup_arrays_t(jp)[0]
    cm = _compact_arrays(jp)
    m_rows, q, rows_uniq = cm[0], cm[1], cm[8]
    xs = extract_tiles_ct(jnp.asarray(x), gtiles,
                          jnp.asarray(np.asarray(q, np.float32)), m_rows,
                          interpret=True)
    t = fix_tables(p, "cpu")
    X, R = torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(rsp))
    slab = dss_extract_cuda(X, t)
    assert slab.shape == (t.nfix, 6)
    rank = t.fix_rank[t.fix_lanes.long()].long().numpy()
    np.testing.assert_array_equal(slab.numpy()[rank],
                                  np.asarray(xs)[np.asarray(rows_uniq)])
    ref = dss_structured_t_pallas_cpre(jnp.asarray(x), xs, jp,
                                       jnp.asarray(rsp), interpret=True)
    _compare(dss_structured_t_cuda_pre(X, slab, p, R), ref, two_float)


@pytest.mark.parametrize("ne", [2, 3])
def test_torch_dss_continuity_is_exact(ne):
    """After DSS every alias of every dof holds the same bits, with either
    rspheremp; and a continuous field projects onto itself."""
    jcs, _, p = _grid(ne)
    x = torch.from_numpy(_field(jcs, 7, seed=30 + ne))
    for two_float in (False, True):
        R = torch.from_numpy(np.ascontiguousarray(_rsp(jcs, two_float)))
        assert _continuity_spread(dss_structured_t_cuda(x, p, R),
                                  jcs.gdof) == 0.0
    cs = build_cubed_sphere(ne, dtype=torch.float32, device="cpu")
    sph = cs.geometry.spheremp.reshape(1, -1)
    dof = torch.from_numpy(cs.gdof.reshape(1, -1).astype(np.float32))
    cont = torch.sin(1e-2 * dof * torch.arange(1.0, 8.0)[:, None])
    R = torch.from_numpy(rsp_lanes_2f(cs.geometry.spheremp, cs.gdof, cs.ndof))
    proj = dss_structured_t_cuda((sph * cont).contiguous(), p, R)
    assert float((proj - cont).abs().max()) < 2e-6


def test_torch_dss_structured_matches_segment_sum_two_float():
    """The structured path with the two-float rspheremp against the
    segment-sum dss_scaled with rsp_2f, both in f64 on the CPU (1e-13
    scaled: the two sum the aliases in another order)."""
    jcs, _, p = _grid(3)
    cs = build_cubed_sphere(3, device="cpu")
    x = np.random.default_rng(41).standard_normal((cs.nelem, 4, 4, 4))
    hi, lo = rsp_2f(cs.geometry.spheremp, cs.gdof, cs.ndof)
    ref = dss_scaled(torch.from_numpy(x), cs.gdof, cs.ndof,
                     (torch.from_numpy(hi.astype(np.float64)),
                      torch.from_numpy(lo.astype(np.float64))))
    R = torch.from_numpy(np.stack([hi.reshape(-1), lo.reshape(-1)])
                         .astype(np.float64))
    got = unpack_field_t(dss_structured_t_cuda(
        pack_field_t(torch.from_numpy(x)), p, R), cs.nelem)
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-13


def test_torch_fix_tables_at_ne30():
    """The fix-lane tables of ne30: 2,832 line interiors and 24 corner
    lanes; the two index tables invert the lane lists."""
    cs = build_cubed_sphere(30, dtype=torch.float32, device="cpu")
    t = fix_tables(make_structured_plan(cs.gdof, 30), "cpu")
    assert t.nfix == 2856 and t.e16 == 86400
    lanes = t.read_lanes.long()
    assert bool((lanes[1:] > lanes[:-1]).all())
    assert torch.equal(t.fix_rank[lanes].long(), torch.arange(2856))
    assert torch.equal(t.fix_col[t.fix_lanes.long()].long(),
                       torch.arange(2856))
    assert int((t.fix_rank >= 0).sum()) == int((t.fix_col >= 0).sum()) == 2856
    assert int((t.fix_src[:, 3] < 0).sum()) >= 24     # the corners' triples


def test_torch_dss_wrappers_reject_bad_operands():
    jcs, _, p = _grid(2)
    t = fix_tables(p, "cpu")
    x = torch.from_numpy(_field(jcs, 4, seed=1))
    rsp = torch.ones(1, x.shape[1])
    vd = torch.zeros(4, t.nfix)
    with pytest.raises(ValueError):
        dss_extract_cuda(x[:, :-16].contiguous(), t)            # lane count
    with pytest.raises(ValueError):
        dss_sweep_cuda(x, torch.ones(3, x.shape[1]), vd, t)     # rsp rows
    with pytest.raises(ValueError):
        dss_sweep_cuda(x, rsp, vd[:, :-1], t)                   # vd width
    with pytest.raises(ValueError):
        dss_sweep_cuda(x.T.contiguous().T, rsp, vd, t)          # layout
    with pytest.raises(ValueError):
        dss_fixup_cuda(torch.zeros(t.nfix, 4), t, rsp.double())  # dtypes
    with pytest.raises(TypeError):
        dss_extract_cuda(x.int(), t)
