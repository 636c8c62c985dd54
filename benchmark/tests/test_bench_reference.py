"""The reference and the check at a size the CPU holds: the reference
against the port's plain step and remap in float64, a sound run passing
the cells' limits, the control and each planted fault failing them."""
from __future__ import annotations

import json
import os

import pytest
import torch

from tinman_sandbox_tpu_torch.dist import packed_air_mass

from benchmark import check, inputs, program, run, spec
from benchmark.reference import grid as G, layout, step as ref
from benchmark.tests import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77
CELLS = ("ne30_e3sm_q35", "ne30_tinman_q1", "ne120_e3sm_q35")


def test_grid_matches_the_port():
    from tinman_sandbox_tpu_torch.dist import build_cubed_sphere

    g = G.build(3)
    cs = build_cubed_sphere(3, device="cpu")
    assert (g["gdof"] == cs.gdof).all() and g["ndof"] == cs.ndof
    for k in ("d", "dinv", "metdet", "spheremp", "rspheremp", "fcor",
              "metinv", "mp", "dvv"):
        ours = torch.as_tensor(g[k])
        assert torch.allclose(ours, getattr(cs.geometry, k), rtol=1e-12,
                              atol=1e-14), k


@pytest.mark.parametrize("remap_step, limiter, fixer", [
    (False, True, True), (True, True, True), (False, False, True),
    (True, False, True), (True, True, False)])
def test_reference_step_matches_the_port_plain_in_float64(remap_step, limiter,
                                                           fixer):
    """The harness's step of the port (``program.step``: the step, and on
    a remap step the remap with the fixer where the configuration has it)
    in float64 from its packed state against the reference's step from
    the same state, with the limiter and the fixer as the configuration
    says; and the program's step does follow the configuration."""
    cell = tiny.cell(qsize=2)
    cfg = cell.config
    cfg.update(limiter=limiter, mass_fixer=fixer)
    spec.check_config({k: v for k, v in cfg.items() if k != "name"})
    g, lv = G.build(cfg["ne"]), G.eta_levels(cfg["nlev"])
    nelem, nlev = g["nelem"], cfg["nlev"]
    raw = inputs.draw(SEED, nelem, nlev, 2, lv, CPU)
    p, s, qdp, acc = program.setup(g, lv, raw, cfg, CPU, torch.float64)
    # the program's two-float rspheremp is 1 / the sum of float32-rounded
    # spheremp, for its float32 path; float64 takes the exact one
    p.rsp = torch.as_tensor(g["rspheremp"].reshape(1, -1))
    # a target off the state's mass, so that the fixer moves the result
    target = 1.001 * packed_air_mass(s, p.sph_lanes, nlev)
    if fixer:
        p.mass_target = target

    def run_step(prog):
        s1, q1, acc1, phi = program.step(prog, s, qdp,
                                         tuple(a.clone() for a in acc),
                                         remap_step)
        out = layout.unpack_state(s1, nelem, nlev)
        out["q"] = layout.unpack_tracers(q1, nelem, nlev)
        for k, a in zip(check.ACC, acc1):
            out[k] = layout.unpack(a, nelem)
        return out, layout.unpack(phi, nelem)

    S = ref.Sphere(g, torch.float64, CPU)
    st = layout.unpack_state(s, nelem, nlev)
    st["q"] = layout.unpack_tracers(qdp, nelem, nlev)
    for k, a in zip(check.ACC, acc):
        st[k] = layout.unpack(a, nelem)
    consts = dict(phis=raw["phis"].double(),
                  pecnd=torch.zeros_like(st["u"]))
    out, rphi = ref.model_step(S, lv, st, consts, cfg, remap_step,
                               1.001 * ref.air_mass(S, st["dp"]),
                               tracer_block=1)
    prog, phi = run_step(p)
    nums = check.step_numbers(st, out, rphi, prog, phi)
    assert max(nums.values()) < 1e-9, nums
    # the other setting moves the result: the comparison tells them apart
    if remap_step:
        p.mass_target = None if fixer else target
    else:
        p.limit = not limiter
    other, ophi = run_step(p)
    assert check.step_numbers(st, out, rphi, other, ophi)["q"] > 1e-6


def _limits(name):
    with open(os.path.join(spec.HERE, "limits", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_passes_and_the_control_fails(name):
    cell = tiny.cell(name, qsize=1 if name == "ne30_tinman_q1" else 3)
    res, lines = run.run_cell(cell, SEED, 0.0, False, CPU, control=True)
    assert res["correct"], res["check"]
    assert not check.verdict(res["control"], cell.limits), res["control"]
    assert len(lines) == len(tiny.NAMES)


def _unchanged(p, s, qdp, acc, remap, spans=False):
    _, _, acc2, phi = program.step(p, s, qdp, tuple(a.clone() for a in acc),
                                   remap)
    return s, qdp, acc, phi


def _half(p, s, qdp, acc, remap, spans=False):
    old = (s, qdp, tuple(a.clone() for a in acc))
    s2, q2, acc2, phi = program.step(p, s, qdp, acc, remap)
    h = s2.shape[1] // 2
    s2, q2 = s2.clone(), q2.clone()
    s2[:, h:], q2[:, h:] = old[0][:, h:], old[1][:, h:]
    for a, a0 in zip(acc2, old[2]):
        a[:, h:] = a0[:, h:]
    return s2, q2, acc2, phi


def _tracers_swapped(p, s, qdp, acc, remap, spans=False):
    s2, q2, acc2, phi = program.step(p, s, qdp, acc, remap)
    k = p.cfg.nlev
    return s2, torch.cat([q2[:k], q2[2 * k:3 * k], q2[k:2 * k],
                          q2[3 * k:]]), acc2, phi


def _altered(p, s, qdp, acc, remap, spans=False):
    s2, q2, acc2, phi = program.step(p, s, qdp, acc, remap)
    s2 = s2.clone()
    s2[0, 5] += 1.0
    return s2, q2, acc2, phi


def _no_exchange(monkeypatch):
    """Every closer without the DSS's sum over the elements that share a
    dof: each lane keeps its own value, scaled by its rspheremp."""
    import tinman_sandbox_tpu_torch.dist.step_t as st

    def closer(x, slab, plan, rsp, mix=None):
        y = x * rsp[0]
        if mix is None:
            return y
        mx, ca, cb = mix
        if mx.shape[0] == y.shape[0]:
            return ca * mx + cb * y
        # hyperviscosity's update lands in the rows of the taller state
        mx[:y.shape[0]] = ca * mx[:y.shape[0]] + cb * y
        return mx

    monkeypatch.setattr(st, "dss_structured_t_cuda_pre", closer)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "no_exchange", "tracers_swapped"])
def test_a_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    cell = tiny.cell(qsize=3)
    step = {"unchanged": _unchanged, "half": _half, "altered": _altered,
            "tracers_swapped": _tracers_swapped}.get(fault, program.step)
    if fault == "no_exchange":
        _no_exchange(monkeypatch)
    res, _ = run.run_cell(cell, SEED, 0.0, False, CPU, step=step)
    assert not res["correct"], res["check"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_on_the_card(name):
    """The control at a size a test holds, on the card: a sound run
    passes, the reference in TF32 in its place does not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = tiny.cell(name, ne=4, nlev=72,
                     qsize=1 if name == "ne30_tinman_q1" else 4)
    res, _ = run.run_cell(cell, SEED, 0.0, False, torch.device("cuda", 0),
                          control=True)
    assert res["correct"], res["check"]
    assert not check.verdict(res["control"], cell.limits)


def test_limits_name_every_number():
    for name in CELLS:
        assert sorted(_limits(name)) == sorted(tiny.NAMES)
