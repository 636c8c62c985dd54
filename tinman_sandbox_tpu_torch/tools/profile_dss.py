"""Stage breakdown of the structured DSS and the assembled step on the card
(counterpart of the JAX repository's ``tools/profile_dss.py``).

    python -m tinman_sandbox_tpu_torch.tools.profile_dss [--ne 30] \
        [--nlev 72] [--nexec 30]
    python -m tinman_sandbox_tpu_torch.tools.profile_dss --device cpu \
        --ne 2 --nlev 4 --nexec 1

Times each stage of the assembled step on the stacked [4*nlev, E16] state,
each a chain of ``--nexec`` calls from one start, one JSON line a stage
under the JAX tool's names:

  * ``kernel_t4``: the CAAR kernel with its fix-lane slab
    (``caar_t4_cuda``), chained s1 -> n0 -> nm1 on its accumulators;
  * ``full_step_t4``: the assembled step ``caar_dss_structured_packed_t4``
    (the CAAR kernel with the slab, fixup, sweep), chained likewise;
  * ``full_dss``: the whole structured DSS ``dss_structured_t_cuda``
    (extract, fixup, sweep), chained on its own output;
  * ``sweep_only``: the sweep ``dss_sweep_cuda`` with a zero fixup buffer,
    chained on its own output;
  * ``extract+fixup``: ``dss_extract_cuda`` then ``dss_fixup_cuda`` of the
    state (the JAX tool chains them through a tiny add so that XLA keeps
    them; an eager call always runs, so the port reads the same state).

The JAX tool's compact stages ``c_sweep_only`` and ``c_fixup+scat`` are
the same measurements here, reported under both names with a note: the
port has one form of the fixup, the compact one (a [k, nfix] vals buffer
that the sweep reads through ``fix_col``), and no tile-dense buffer.
``scatter_zeros`` (the vals scattered into a tile-dense zero buffer) is
``"not applicable"`` with its reason; the JAX tool's ``--eb`` is a TPU
option and is dropped.

The problem is the JAX tool's: random state seed 8 (``random_state``, cast
to f32) on the ``--ne`` cubed sphere's geometry, zero accumulators,
analytic hvcoord, ``_scalars(0.5, 1.0, hv)``, the one-float rspheremp row.
Each line holds ``us_per_call`` (CUDA events over the chain),
``graph_us_per_call`` (replayed from a CUDA graph: the device alone),
``host_us_per_call``, the launches a call and the card's name and power
limit (``profiling.stage_time``). The tool runs on the card; ``--device
cpu`` runs the plain versions with wall-clock times. Without a card and
without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import json

import torch

__all__ = ["problem", "stages", "main", "SAME_AS", "NOT_APPLICABLE"]

SEED = 8

# the JAX tool's compact stages, measured by the port's one form
SAME_AS = {"c_sweep_only": "sweep_only", "c_fixup+scat": "extract+fixup"}
SAME_NOTE = ("the port has one fixup, the compact one (vals [k, nfix] read "
             "by the sweep through fix_col): the same measurement as {}")
NOT_APPLICABLE = {
    "scatter_zeros": "not applicable: the port's fixup writes the compact "
                     "vals [k, nfix] that the sweep reads through fix_col; no "
                     "tile-dense buffer is scattered (the TPU's dense / "
                     "compact choice has no counterpart)"}


def problem(ne: int, nlev: int, device):
    """The JAX tool's problem: (const, s0, sm1, acc, plan, rsp, gdof),
    const = (scal, meta, qdp, pecnd, dvv), s0 and sm1 stacked
    [4*nlev, E16], rsp the one-float rspheremp row [1, E16]."""
    from .. import Config, analytic_hvcoord, random_state, zero_derived
    from ..dist import build_cubed_sphere, make_structured_plan
    from ..kernels.caar_t import _scalars, pack_problem_t

    kw = dict(dtype=torch.float32, device=device)
    cs = build_cubed_sphere(ne, **kw)
    cfg = Config(nelem=cs.nelem, nlev=nlev)
    hv = analytic_hvcoord(cfg, **kw)
    p = pack_problem_t(random_state(cfg, seed=SEED, **kw),
                       zero_derived(cfg, **kw), cs.geometry, hv, cfg)
    s0 = torch.cat([p.pop(n) for n in ("u0", "v0", "t0", "dp0")])
    sm1 = torch.cat([p.pop(n) for n in ("um1", "vm1", "tm1", "dpm1")])
    const = (_scalars(0.5, 1.0, hv, torch.float32, device), p["meta"],
             p["qdp"], p["pecnd"], p["dvv"])
    rsp = cs.geometry.rspheremp.reshape(1, -1).contiguous()
    return (const, s0, sm1, (p["vn0u"], p["vn0v"], p["omg"]),
            make_structured_plan(cs.gdof, ne), rsp, cs.gdof)


def stages(const, s0, sm1, acc, plan, rsp, names=None):
    """The stages in order as (name, chain), chain(n) running n chained
    calls from the start (``profile_prim.stages``' contract: a stage's own
    operands are let go when the next is asked for); ``names`` keeps those
    it lists. The accumulators advance in place on copies."""
    from ..dist.step_t import caar_dss_structured_packed_t4
    from ..kernels.caar_t import caar_t4_cuda
    from ..kernels.dss import (
        dss_extract_cuda, dss_fixup_cuda, dss_structured_t_cuda,
        dss_sweep_cuda, fix_tables)

    scal, meta, qdp, pecnd, dvv = const
    fix = fix_tables(plan, s0.device)
    kacc = [a.clone() for a in acc]
    keep = lambda name: names is None or name in names

    def kernel(n):
        a, b = s0, sm1
        for _ in range(n):
            a, b = caar_t4_cuda(scal, meta, a, b, qdp, pecnd, *kacc, dvv,
                                fix=fix)[0], a
        return a

    def full(n):
        a, b = s0, sm1
        for _ in range(n):
            a, b = caar_dss_structured_packed_t4(scal, meta, a, b, qdp, pecnd,
                                                 *kacc, dvv, plan, rsp)[0], a
        return a

    def dss(n):
        x = s0
        for _ in range(n):
            x = dss_structured_t_cuda(x, plan, rsp)
        return x

    for name, chain in (("kernel_t4", kernel), ("full_step_t4", full),
                        ("full_dss", dss)):
        if keep(name):
            yield name, chain
    held = {}

    def zero_vals():
        if "vd" not in held:
            held["vd"] = torch.zeros(s0.shape[0], fix.nfix, dtype=s0.dtype,
                                     device=s0.device)
        return held["vd"]

    def sweep(n):
        x, vd0 = s0, zero_vals()
        for _ in range(n):
            x = dss_sweep_cuda(x, rsp, vd0, fix)
        return x

    if keep("sweep_only"):
        zero_vals()
        yield "sweep_only", sweep
        held.clear()

    def fixup(n):
        vd = None
        for _ in range(n):
            vd = dss_fixup_cuda(dss_extract_cuda(s0, fix), fix, rsp)
        return vd

    if keep("extract+fixup"):
        yield "extract+fixup", fixup


def run(args) -> list:
    """Every line the tool prints, as dicts."""
    from ..bench import card_name_and_power
    from ..device import resolve_device
    from .profile_prim import time_stages

    dev = resolve_device(args.device)
    card = card_name_and_power() if dev.type == "cuda" else None
    const, s0, sm1, acc, plan, rsp, _ = problem(args.ne, args.nlev, dev)
    lines = time_stages(stages(const, s0, sm1, acc, plan, rsp), args.nexec,
                        dev, card)
    by_name = {k: v for line in lines for k, v in line.items()}
    for alias, name in SAME_AS.items():
        lines.append({alias: dict(by_name[name],
                                  note=SAME_NOTE.format(name))})
    for name, why in NOT_APPLICABLE.items():
        lines.append({name: why})
    lines.append({"ne": args.ne, "nlev": args.nlev, "nexec": args.nexec,
                  "backend": dev.type, "card": card,
                  "peak_device_bytes": torch.cuda.max_memory_allocated(dev)
                  if dev.type == "cuda" else None})
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="tinman_sandbox_tpu_torch.tools.profile_dss",
        description="the stages of the structured DSS and the assembled "
                    "step timed apart")
    ap.add_argument("--ne", type=int, default=30)
    ap.add_argument("--nlev", type=int, default=72)
    ap.add_argument("--nexec", type=int, default=30,
                    help="chained calls a timed run")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: the plain versions, wall-clock times")
    args = ap.parse_args(argv)
    lines = run(args)
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
