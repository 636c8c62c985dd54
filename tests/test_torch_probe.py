"""The probe's chained FP32 product (``kernels.probe``) and the probe tool
(``tools.probe_kernel``) against the JAX repository's ``tools/
probe_kernel.py``.

The JAX side is the tool's own ``mm_kernel``: its source is read out of
``tools/probe_kernel.py`` (the FunctionDef of that name inside ``main``) and
run through ``pl.pallas_call(..., interpret=True)`` with the tool's VMEM
specs, at the three smallest of its shapes, on the same numpy inputs.

Tolerances: the port's plain version against the JAX kernel within 2e-6 of
max|o| (twenty f32 products of length k <= 256 each, summed in two orders);
both against 20*(a@b) in f64 within 2e-6 of max|o| (the f32 rounding of a
length-k dot and of twenty adds); the wrapper on CPU tensors bit for bit the
plain version.

The kernel's launch plan (``probe_plan``) and its summation order: each
cluster rank's k range adds its partial product into its own accumulator
twenty times, then the ranks' accumulators are summed in rank order. A torch
emulation of that order is held against the JAX kernel at the three small
shapes and against the f64 product at 512^3 and 1024^3, within the same 2e-6
of max|o| that gates the kernel on the card.
"""
import ast
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tinman_sandbox_tpu_torch.kernels.probe import (
    PROBE_REPS,
    PROBE_SHAPES,
    SMEM_MAX,
    SMS,
    probe_bytes,
    probe_flops,
    probe_mm_cuda,
    probe_mm_plain,
    probe_plan,
)
from tinman_sandbox_tpu_torch.tools import probe_kernel

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "probe_kernel.py")
TOL = 2e-6
SMALL = [(128, 128, 72), (256, 256, 72), (256, 256, 128)]
# the shapes at which chip_smoke.py checks the kernel's pipelined mode
PIPELINED = [(512, 4096, 512), (250, 2000, 250)]


def _tool_main():
    with open(TOOL) as f:
        src = f.read()
    main = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    return src, main


def _jax_mm_kernel():
    """The tool's mm_kernel, compiled from its own source."""
    src, main = _tool_main()
    fn = next(n for n in ast.walk(main)
              if isinstance(n, ast.FunctionDef) and n.name == "mm_kernel")
    ns = {"jax": jax, "jnp": jnp}
    exec(textwrap.dedent(ast.get_source_segment(src, fn)), ns)
    return ns["mm_kernel"]


def _jax_probe(a, b):
    m, n = a.shape[0], b.shape[1]
    return np.asarray(pl.pallas_call(
        _jax_mm_kernel(),
        out_shape=jax.ShapeDtypeStruct((m, n), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(jnp.asarray(a), jnp.asarray(b)))


def _operands(m, k, n):
    # the tool's inputs: normal draws from seeds 0 and 1
    a = np.random.default_rng(0).normal(size=(m, k)).astype(np.float32)
    b = np.random.default_rng(1).normal(size=(k, n)).astype(np.float32)
    return a, b


def _err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def test_torch_probe_shapes_are_the_tools():
    """The five (m, k, n) and the twenty repetitions are the JAX tool's."""
    src, main = _tool_main()
    loops = [n for n in ast.walk(main) if isinstance(n, ast.For)
             and isinstance(n.target, ast.Tuple)
             and [e.id for e in n.target.elts] == ["m", "k", "n"]]
    assert len(loops) == 1
    assert tuple(ast.literal_eval(loops[0].iter)) == PROBE_SHAPES
    assert "range(20)" in ast.get_source_segment(src, main)
    assert PROBE_REPS == 20


@pytest.mark.parametrize("m,k,n", SMALL)
def test_torch_probe_plain_matches_jax_kernel(m, k, n):
    a, b = _operands(m, k, n)
    want = _jax_probe(a, b)
    got = probe_mm_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    assert _err(got.numpy(), want) < TOL


@pytest.mark.parametrize("m,k,n", SMALL)
def test_torch_probe_both_match_f64(m, k, n):
    a, b = _operands(m, k, n)
    exact = PROBE_REPS * (a.astype(np.float64) @ b.astype(np.float64))
    assert _err(_jax_probe(a, b), exact) < TOL
    got = probe_mm_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert _err(got.numpy(), exact) < TOL


def test_torch_probe_plain_adds_each_product():
    """acc = acc + a@b per repetition: bit for bit the explicit chain (not
    reps*(a@b), another rounding)."""
    a, b = (torch.from_numpy(x) for x in _operands(64, 48, 40))
    want = torch.zeros(64, 40)
    for _ in range(3):
        want = want + a @ b
    assert torch.equal(probe_mm_plain(a, b, reps=3), want)


def test_torch_probe_wrapper_on_cpu_is_plain():
    a, b = (torch.from_numpy(x) for x in _operands(128, 128, 72))
    launches = probe_mm_cuda.launches
    assert torch.equal(probe_mm_cuda(a, b), probe_mm_plain(a, b))
    assert probe_mm_cuda.launches == launches      # CPU tensors launch nothing


def test_torch_probe_wrapper_rejects_bad_operands():
    a = torch.zeros(8, 4)
    with pytest.raises(ValueError):
        probe_mm_cuda(a, torch.zeros(5, 3))
    with pytest.raises(TypeError):
        probe_mm_cuda(a, torch.zeros(4, 3, dtype=torch.float64))
    with pytest.raises(ValueError):
        probe_mm_cuda(a, torch.zeros(4, 3), reps=0)
    with pytest.raises(ValueError):
        probe_mm_cuda(torch.zeros(8), torch.zeros(8, 3))


def test_torch_probe_counts():
    assert probe_flops(1024, 1024, 1024) == 20 * 2 * 1024 ** 3
    assert probe_bytes(128, 128, 72) == 4 * (128 * 128 + 128 * 72 + 128 * 72)


def test_torch_probe_tool_on_cpu(capsys):
    out = probe_kernel.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert out["device"] == "cpu" and out["card"] is None
    assert len(out["matmul"]) == 1 and out["matmul"][0]["m"] == 128
    assert out["matmul"][0]["cublas_ms"] is None
    assert out["matmul"][0]["bound_by"] == "operations"
    assert out["caar"]["ms_per_step"] > 0 and out["triad_gb_per_s"] > 0
    lines = [ln for ln in text.splitlines() if ln.strip()]
    assert len(lines) == 4
    assert all("not the card's" in ln for ln in lines)
    assert "matmul f32 [128,128]@[128,72] x20:" in text
    assert "caar row 16x72:" in text


def test_torch_probe_tool_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe_kernel.main([])


def _split_order(a, b, plan, reps=PROBE_REPS):
    """The kernel's summation order in torch f32: each cluster rank's partial
    product over its k range (computed once: every repetition adds the same
    partial), added into the rank's accumulator ``reps`` times from zero,
    then the ranks' accumulators summed in rank order."""
    o = None
    for lo, hi in plan.k_ranges():
        part = a[:, lo:hi] @ b[lo:hi]
        acc = torch.zeros_like(part)
        for _ in range(reps):
            acc = acc + part
        o = acc if o is None else o + acc
    return o


@pytest.mark.parametrize("m,k,n", list(PROBE_SHAPES) + PIPELINED)
def test_torch_probe_plan_fits_the_card(m, k, n):
    """Per shape: the cluster's k ranges partition [0, k) in rank order, the
    cluster is at most 8 CTAs, shared memory at most 227 KB and enough for
    the resident steps or the stages and for the cluster's sum, and the
    large shapes launch at least one CTA an SM."""
    p = probe_plan(m, k, n)
    ranges = p.k_ranges()
    assert len(ranges) == p.ksplit and 1 <= p.ksplit <= 8
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert p.smem <= SMEM_MAX == 227 * 1024
    steps = -(-p.kc // 16)
    assert p.stages == (steps if p.resident else 3)
    assert p.smem >= 4 * p.stages * 16 * (p.tm + 4 + p.tn)
    if p.ksplit > 1:
        assert p.smem >= 4 * p.tm * p.tn
    assert p.tm % p.ksplit == 0 and p.threads == p.tm * p.tn // 64
    assert p.ctas == -(-m // p.tm) * -(-n // p.tn) * p.ksplit
    if m >= 512:
        assert p.ctas >= SMS


def test_torch_probe_plan_modes_and_refusals():
    """The five shapes hold their k ranges resident; the PIPELINED shapes
    take the pipeline, one on each tile; a short k is not split; a size of
    0 is refused."""
    assert all(probe_plan(*s).resident for s in PROBE_SHAPES)
    plans = [probe_plan(*s) for s in PIPELINED]
    assert not any(p.resident for p in plans)
    assert {(p.tm, p.tn) for p in plans} == {(128, 64), (64, 64)}
    assert probe_plan(7, 9, 5).ksplit == 1          # k too short to split
    with pytest.raises(ValueError):
        probe_plan(0, 4, 4)


@pytest.mark.parametrize("m,k,n", SMALL)
def test_torch_probe_split_order_matches_jax_kernel(m, k, n):
    a, b = _operands(m, k, n)
    plan = probe_plan(m, k, n)
    assert plan.ksplit > 1
    got = _split_order(torch.from_numpy(a), torch.from_numpy(b), plan)
    assert _err(got.numpy(), _jax_probe(a, b)) < TOL


@pytest.mark.parametrize("m,k,n", [s for s in PROBE_SHAPES if s[0] >= 512])
def test_torch_probe_split_order_matches_f64(m, k, n):
    a, b = _operands(m, k, n)
    plan = probe_plan(m, k, n)
    assert plan.ksplit > 1
    got = _split_order(torch.from_numpy(a), torch.from_numpy(b), plan)
    exact = PROBE_REPS * (a.astype(np.float64) @ b.astype(np.float64))
    assert _err(got.numpy(), exact) < TOL
