"""The DSS fix-lane patch wrappers (``dss_merge_patch_cuda``,
``dss_patch_tiles_cuda``, kernel ``dss_patch`` of ``csrc/dss.cu``) on the
CPU: every operand the wrappers refuse, one case each, a valid call that
runs the plain version bit for bit and counts no launch, and the tables the
kernel walks (the fix lanes ascending with their vd columns) writing the
same elements as the plain version.

The wrappers check their operands with plain comparisons before they pick
the plain version (a CPU tensor) or the kernel (a CUDA tensor), so each
refusal here is the refusal a card would give. The JAX side of the patch is
held in ``test_torch_ring.py`` (``merge_patch_pallas`` through the split
DSS) and ``test_torch_banded.py`` (``merge_patch_tiles``).
"""
import numpy as np
import pytest
import torch

from tinman_sandbox_tpu_torch.dist import build_cubed_sphere, make_structured_plan
from tinman_sandbox_tpu_torch.dist.sharded_t4 import shard_fix_tables
from tinman_sandbox_tpu_torch.kernels.dss import (
    _patch_plain,
    dss_merge_patch_cuda,
    dss_patch_tiles_cuda,
    fix_tables,
)

torch.set_num_threads(2)
K = 6


@pytest.fixture(scope="module")
def fix():
    cs = build_cubed_sphere(2, dtype=torch.float32, device="cpu")
    return fix_tables(make_structured_plan(cs.gdof, cs.ne), "cpu")


def _operands(fix, seed=3):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return f(K, fix.e16), f(K, fix.nfix), f(K, fix.e16)


def _case(name, fix):
    """(w, vd, tables, mix, match) of one refused call."""
    import dataclasses

    w, vd, mx = _operands(fix)
    e16, n = fix.e16, fix.nfix
    mix = (mx, 0.75, 0.25)
    if name == "vd rows":
        return w, torch.zeros(K + 1, n), fix, None, "must be"
    if name == "vd width":
        return w, vd[:, 1:].contiguous(), fix, None, "vd has shape"
    if name == "w width":
        return torch.zeros(K, e16 + 1), vd, fix, None, "w must be"
    if name == "w shorter":
        return torch.zeros(K - 1, e16), vd, fix, None, "w must be"
    if name == "w not 2-D":
        return torch.zeros(K * e16), vd, fix, None, "w must be"
    if name == "mix shorter":
        return w, vd, fix, (mx[1:], 0.75, 0.25), "mix field must be"
    if name == "mix width":
        return w, vd, fix, (torch.zeros(K, e16 - 1), 0.75, 0.25), \
            "mix field must be"
    if name == "int64 w":
        return w.long(), vd, fix, None, "float fields"
    if name == "int64 vd":
        return w, vd.long(), fix, None, "vd is torch.int64"
    if name == "int64 fix_lanes":
        return w, vd, dataclasses.replace(
            fix, fix_lanes=fix.fix_lanes.long()), None, "fix_lanes is"
    if name == "f64 mix field":
        return w, vd, fix, (mx.double(), 0.75, 0.25), "mix field is"
    if name == "non-contiguous w":
        return torch.zeros(e16, K).T, vd, fix, None, "w must be contiguous"
    if name == "non-contiguous vd":
        return w, torch.zeros(n, K).T, fix, None, "vd must be contiguous"
    if name == "non-contiguous mix field":
        return w, vd, fix, (torch.zeros(e16, K).T, 0.75, 0.25), \
            "mix field must be contiguous"
    if name == "w overlaps vd":
        buf = torch.zeros(K * e16)
        return buf.view(K, e16), buf[:K * n].view(K, n), fix, None, \
            "overlaps vd"
    if name == "w overlaps the mix field":
        return w, vd, fix, (w, 0.75, 0.25), "overlaps the mix field"
    if name == "vd on another device":
        return w, torch.empty(K, n, device="meta"), fix, None, "vd is"
    if name == "mix field on another device":
        return w, vd, fix, (torch.empty(K, e16, device="meta"), 0.75,
                            0.25), "mix field is"
    if name == "tensor coefficient":
        return w, vd, fix, (mx, torch.tensor(0.75), 0.25), "numbers"
    if name == "w on an unsupported device":
        return torch.empty(K, e16, device="meta"), vd, fix, mix, \
            "unsupported device"
    raise KeyError(name)


CASES = ["vd rows", "vd width", "w width", "w shorter", "w not 2-D",
         "mix shorter", "mix width", "int64 w", "int64 vd", "int64 fix_lanes",
         "f64 mix field", "non-contiguous w", "non-contiguous vd",
         "non-contiguous mix field", "w overlaps vd",
         "w overlaps the mix field", "vd on another device",
         "mix field on another device", "tensor coefficient",
         "w on an unsupported device"]
# only the merge patch takes w and the mix field at vd's height exactly
TALLER = ["w taller", "mix taller"]


@pytest.mark.parametrize("wrapper", ["merge", "tiles"])
@pytest.mark.parametrize("case", CASES + TALLER)
def test_torch_patch_wrappers_refuse(fix, wrapper, case):
    fn = dss_merge_patch_cuda if wrapper == "merge" else dss_patch_tiles_cuda
    if case in TALLER:
        w, vd, mx = _operands(fix)
        tall = torch.zeros(K + 2, fix.e16)
        args = ((tall, vd, fix, None) if case == "w taller"
                else (w, vd, fix, (tall, 0.75, 0.25)))
        if wrapper == "tiles":          # taller w and mix field are its form
            launches = fn.launches
            assert fn(*args) is args[0] and fn.launches == launches
            return
        with pytest.raises(ValueError, match="must be"):
            fn(*args)
        return
    w, vd, tables, mix, match = _case(case, fix)
    before = w.clone() if w.device.type == "cpu" else None
    with pytest.raises((ValueError, TypeError), match=match):
        fn(w, vd, tables, mix)
    if before is not None:
        assert torch.equal(w, before)     # refused before touching w


@pytest.mark.parametrize("wrapper", ["merge", "tiles"])
@pytest.mark.parametrize("mixed", [False, True])
def test_torch_patch_wrappers_on_cpu_are_plain(fix, wrapper, mixed):
    """A valid call on CPU tensors: the plain version bit for bit (numpy
    coefficients, as the steps pass them), w returned, no launch counted;
    the tiles form leaves rows below vd's height of a taller w untouched."""
    fn = dss_merge_patch_cuda if wrapper == "merge" else dss_patch_tiles_cuda
    w, vd, mx = _operands(fix, seed=5)
    if wrapper == "tiles":
        w = torch.cat([w, torch.ones(3, fix.e16)])
        mx = torch.cat([mx, torch.ones(1, fix.e16)])
    mix = (mx, np.float32(1.0 / 3.0), np.float32(2.0 / 3.0)) if mixed else None
    want = _patch_plain(w.clone(), vd, fix.fix_lanes, mix)
    launches = fn.launches
    got = fn(w, vd, fix, mix)
    assert got is w and torch.equal(got, want)
    assert fn.launches == launches
    assert torch.equal(w[K:], torch.ones(w.shape[0] - K, fix.e16))


@pytest.mark.parametrize("ne,shards", [(2, 1), (3, 1), (4, 1), (4, 4)])
def test_torch_patch_kernel_walk_is_the_plain_patch(ne, shards):
    """The kernel's walk: thread p writes lane read_lanes[p] from vd column
    read_col[p]. On the whole sphere and on each shard's tables, read_lanes
    is the fix lanes ascending, read_col their vals columns, and the walk
    emulated in torch writes what ``_patch_plain`` writes, bit for bit."""
    cs = build_cubed_sphere(ne, dtype=torch.float32, device="cpu")
    plan = make_structured_plan(cs.gdof, cs.ne)
    e16 = cs.nelem * 16
    width = e16 // shards
    tables = ([fix_tables(plan, "cpu")] if shards == 1 else
              [shard_fix_tables(plan, s * width, (s + 1) * width, "cpu")
               for s in range(shards)])
    rng = np.random.default_rng(ne)
    for t in tables:
        lanes, cols = t.read_lanes.long(), t.read_col.long()
        assert bool((lanes[1:] > lanes[:-1]).all())
        assert torch.equal(lanes, torch.sort(t.fix_lanes.long())[0])
        assert torch.equal(t.fix_lanes.long()[cols], lanes)
        assert torch.equal(t.fix_col.long()[lanes], cols)
        w = torch.from_numpy(rng.standard_normal((5, t.e16)).astype(
            np.float32))
        vd = torch.from_numpy(rng.standard_normal((5, t.nfix)).astype(
            np.float32))
        walked = w.clone()
        walked[:, lanes] = vd[:, cols]
        assert torch.equal(walked, _patch_plain(w.clone(), vd, t.fix_lanes))
