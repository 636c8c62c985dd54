"""The on-card equivalence tool (``tools/equiv_check.py``, counterpart of
the JAX repository's ``tools/tpu_equiv_check.py``) run on the CPU: with
``--device cpu`` its kernel paths are the plain versions, at ne 2, nlev 8
and 16 raw elements. The report holds every key of the JAX tool but the
``hv_fast_*`` ones, each error finite and within the JAX tool's pass rule,
the compact-slab key marked not applicable with its reason, and the report
file equal to the printed line. Without ``--device cpu`` on a machine with
no card the tool raises instead of running on the CPU."""
import collections
import contextlib
import io
import json

import pytest
import torch

from tinman_sandbox_tpu_torch.tools import equiv_check

torch.set_num_threads(2)
ARGS = ["--device", "cpu", "--ne", "2", "--nlev", "8", "--nelem", "16"]
# the JAX tool's keys (TPU_EQUIV.json) and the fields each holds
KEYS = {
    "raw_kernel_relmax": ("u", "v", "t", "dp3d", "omega_p", "phi"),
    "raw_kernel_t_relmax": ("u", "v", "t", "dp3d", "omega_p"),
    "assembled_step_relmax": ("u", "v", "t", "dp3d"),
    "assembled_step_t_relmax": ("u", "v", "t", "dp3d"),
    "assembled_step_t4_relmax": ("u", "v", "t", "dp3d"),
    "sharded_paths_relmax": tuple(f"{tag}_{n}" for tag in ("sharded",
                                                           "banded")
                                  for n in ("u", "v", "t", "dp3d")),
    "prim_packed_relmax": ("u", "v", "t", "dp3d", "qdp", "phi"),
    "prim_packed_q35_relmax": ("u", "v", "t", "dp3d", "qdp0", "qdp17",
                               "qdp34"),
    "prim_packed_q35_limit_relmax": ("qdp0", "qdp17", "qdp34",
                                     "mass_drift"),
    "limiter_iters1": ("qdp0_vs_field", "qdp17_vs_field", "qdp34_vs_field",
                       "mass_drift", "stage_overshoot_iters1",
                       "stage_overshoot_iters2"),
}
SCALARS = ("fused_extract_slab_relmax", "worst_relmax", "prim_worst_relmax",
           "prim_q35_worst_relmax", "prim_q35_limit_worst_relmax")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(exit code, the report file, the printed lines) of one run."""
    out = tmp_path_factory.mktemp("equiv") / "report.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = equiv_check.main(ARGS + ["--out", str(out)])
    with open(out) as f:
        return rc, json.load(f), [ln for ln in buf.getvalue().splitlines()
                                  if ln]


@pytest.mark.parametrize("key", sorted(KEYS))
def test_torch_equiv_check_key(run, key):
    got = run[1][key]
    assert set(got) == set(KEYS[key])
    for name, v in got.items():
        assert v == v and 0.0 <= v < 1e-3, (key, name, v)


def test_torch_equiv_check_passes(run):
    rc, report, _ = run
    assert rc == 0 and report["pass"] is True
    for key in SCALARS:
        assert isinstance(report[key], float), key
    # the slab the CAAR step emits is its own s1 at the fix lanes
    assert report["fused_extract_slab_relmax"] == 0.0
    for key, limit in equiv_check.LIMITS.items():
        value = (report["prim_packed_q35_limit_relmax"]["mass_drift"]
                 if key == "prim_q35_limit_mass_drift" else report[key])
        assert value < limit, (key, value)
    assert not any(k.startswith("hv_fast") for k in report)
    assert report["backend"] == "cpu" and report["card"] is None
    assert report["sharded_meshes"]["sharded"] == {"shards": 1}


def test_torch_equiv_check_compact_slab_not_applicable(run):
    slab = run[1]["compact_extract_slab_relmax"]
    assert slab["applicable"] is False
    assert "compact" in slab["reason"].lower() and len(slab["reason"]) > 80


def test_torch_equiv_check_mass_drift():
    """The tracer-mass drift weighs each node by its element's spheremp
    (over every level), not a broadcast of elements against elements."""
    gen = torch.Generator().manual_seed(0)
    sph = torch.rand(6, 4, 4, generator=gen, dtype=torch.float64) + 0.5
    src = torch.rand(6, 3, 4, 4, generator=gen, dtype=torch.float64)
    assert equiv_check.mass_drift(sph, src * (1 + 1e-6), src) == \
        pytest.approx(1e-6, rel=1e-6)
    # moving mass between nodes of equal weight keeps it
    sph = torch.ones(6, 4, 4, dtype=torch.float64)
    moved = src.clone()
    moved[0, 0, 0, 0] += 0.25
    moved[5, 2, 3, 3] -= 0.25
    assert equiv_check.mass_drift(sph, moved, src) < 1e-15
    with pytest.raises(ValueError):
        equiv_check.mass_drift(sph[:, None], src, src)


@pytest.mark.parametrize("ne,mesh", [(2, (12, 2)), (3, (18, 3)),
                                     (4, (1, 2)), (30, (12, 2))])
def test_torch_equiv_check_banded_mesh(ne, mesh):
    """The smallest band decomposition the port admits: one shard of two
    bands where a band's lanes fill whole 128-lane tiles (ne 4), else a
    band chunk a shard; every smaller mesh is refused."""
    from tinman_sandbox_tpu_torch.dist.banded_t4 import _banded_tables

    plan = collections.namedtuple("Plan", "ne")(ne)
    assert equiv_check.banded_mesh(ne) == mesh
    n, m = mesh
    _banded_tables(plan, m, n)
    for smaller in range(1, n):
        for bands in range(2, ne + 1):
            with pytest.raises(ValueError):
                _banded_tables(plan, bands, smaller)


def test_torch_equiv_check_prints_one_line(run):
    """The report printed as one JSON line (what a chip run's log carries
    back) equals the file."""
    _, report, lines = run
    assert len(lines) == 1
    assert json.loads(lines[0]) == report


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_torch_equiv_check_refuses_cpu_fallback(tmp_path):
    out = tmp_path / "never.json"
    with pytest.raises(RuntimeError, match="cuda"):
        equiv_check.main(["--ne", "2", "--nlev", "8", "--nelem", "16",
                          "--out", str(out)])
    assert not out.exists()
