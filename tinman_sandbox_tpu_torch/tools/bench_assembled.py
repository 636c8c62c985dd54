"""The assembled-step variants at ne30 on the card, in one process
(counterpart of the JAX repository's ``tools/bench_assembled.py``).

    python -m tinman_sandbox_tpu_torch.tools.bench_assembled [--ne 30] \
        [--nlev 72] [--nexec 100] [--reps 2] [--variants NAME ...]
    python -m tinman_sandbox_tpu_torch.tools.bench_assembled --device cpu \
        --ne 2 --nlev 4 --nexec 1

Times the CAAR step with and without its DSS epilogue on both packed
layouts, and with the bf16 read-only storage, one JSON line a variant
under the JAX tool's names, then one line with the whole sweep:

  * ``kernel_only``: the row CAAR kernel (``kernels.caar.caar_packed``);
  * ``structured``: the row assembled step
    (``dist.caar_dss_structured_packed``: the row kernel, then the
    structured DSS of the four fields stacked [E16, 4*nlev]);
    ``structured_bf16ro`` the same on "bf16_ro" operands (qdp, pecnd and
    the nm1 fields bf16: ``kernels.caar_t.STORAGE``);
  * ``t_kernel_only``: the t kernel on unstacked fields
    (``caar_packed_t``); ``t_structured``: its assembled step with a whole
    DSS a field (``dist.caar_dss_structured_packed_t``: the JAX step's
    ``stack_dss=False`` form; the JAX default stacks the four fields, which
    is the port's ``t4_structured``);
  * ``t4_structured``: the stacked assembled step
    (``dist.caar_dss_structured_packed_t4``: the CAAR kernel with its slab,
    fixup, sweep); ``t4_structured_bf16ro`` the same on "bf16_ro"
    operands.

Each chains as the JAX tool does (:239-262): a step's np1 fields become the
next step's n0 and its n0 the nm1, cast to the nm1 slot's dtype (bf16 in
the bf16ro variants), the accumulators running on (in place, on copies);
the kernel-only variants chain the same way. The other JAX variants are
``"not applicable"``, each with its reason (``NOT_APPLICABLE``): they
choose TPU options the port does not have. The problem is the JAX tool's:
random state seed 7 (f32) on the cubed sphere's geometry, zero
accumulators, analytic hvcoord, dt2 0.1, eta_ave_w 1, the one-float
rspheremp (a row on the t layout, a column on the row layout).

Each line holds ``us_per_step`` (CUDA events over a chain of ``--nexec``
steps, the best of ``--reps`` runs) and ``ggp_per_s`` as the JAX tool's,
``graph_us_per_step`` (the chain replayed from a CUDA graph: the device
alone; not for the row step, whose plain DSS copies from the host each
call: ``NO_GRAPH``), ``host_us_per_step``, the launches a step and the
card's name and power limit (``profiling.stage_time``). The JAX tool's ``--eb`` and
``--chunk`` are TPU options and are dropped. The tool runs on the card;
``--device cpu`` runs the plain versions with wall-clock times. Without a
card and without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import json

import torch

__all__ = ["VARIANTS", "NOT_APPLICABLE", "NO_GRAPH", "problem", "variants",
           "run", "main"]

SEED = 7
# the JAX tool's variants that have a counterpart, in its order
VARIANTS = ("kernel_only", "t_kernel_only", "t_structured", "t4_structured",
            "t4_structured_bf16ro", "structured", "structured_bf16ro")
# the variants whose chain no CUDA graph captures: the row step's DSS is
# plain PyTorch that copies its corner table from the host each call
NO_GRAPH = ("structured", "structured_bf16ro")
_IMPL = ("not applicable: the JAX step's impl= ({}) picks how the TPU "
         "kernel shifts its lanes; the port has one structured DSS kernel "
         "path")
_ROW_DSS = ("not applicable: the row DSS's {} is a TPU pipeline option; the "
            "port's row step runs one structured DSS over the four fields "
            "stacked")
_STACK = ("not applicable: the JAX t step's stack_dss=False (a DSS a field) "
          "is a TPU pipeline option; the port's unstacked t step runs a DSS "
          "a field already (t_structured), its stacked DSS is t4_structured")
_T4 = ("not applicable: the stacked step's {} chooses a TPU layout of the "
       "fix-lane values; the port's CAAR kernel writes the compact slab that "
       "its fixup and sweep read")
NOT_APPLICABLE = {
    "t_structured_slice": _IMPL.format("slice"),
    "t_structured_roll": _IMPL.format("roll"),
    "t_structured_nostack": _STACK,
    "structured_nostack": _ROW_DSS.format("stack_dss=False"),
    "structured_chunks5": _ROW_DSS.format("chunks=5"),
    "structured_bf16ro_chunks5": _ROW_DSS.format("chunks=5"),
    "kernel_only_chunks5": _ROW_DSS.format("chunks=5 (sliced dispatches)"),
    "gather": "not applicable: the alias-gather DSS is array code that "
              "dist.dss covers (ROADMAP, left out on purpose)",
    "t4_structured_nofuse": _T4.format("fuse_extract=False"),
    "t4_structured_densevd": _T4.format("compact=False"),
    "t4_structured_vdt": _T4.format("vdt=True"),
}


def problem(ne: int, nlev: int, device):
    """The JAX tool's problem at ne: {layout: {storage: ops}} with ops the
    packed operand dict of ``pack_problem_t`` / ``pack_problem`` (f32 and
    "bf16_ro"), and (scal, plan, rsp_t [1, E16], rsp_row [E16, 1])."""
    from .. import Config, analytic_hvcoord, random_state, zero_derived
    from ..dist import build_cubed_sphere, make_structured_plan
    from ..kernels.caar import pack_problem
    from ..kernels.caar_t import _scalars, pack_problem_t

    kw = dict(dtype=torch.float32, device=device)
    cs = build_cubed_sphere(ne, **kw)
    cfg = Config(nelem=cs.nelem, nlev=nlev)
    hv = analytic_hvcoord(cfg, **kw)
    st, dv = random_state(cfg, seed=SEED, **kw), zero_derived(cfg, **kw)
    ops = {layout: {s: pack(st, dv, cs.geometry, hv, cfg, storage=s)
                    for s in ("f32", "bf16_ro")}
           for layout, pack in (("t", pack_problem_t), ("row", pack_problem))}
    rsp = cs.geometry.rspheremp
    return ops, (_scalars(0.1, 1.0, hv, torch.float32, device),
                 make_structured_plan(cs.gdof, ne),
                 rsp.reshape(1, -1).contiguous(),
                 rsp.reshape(-1, 1).contiguous())


_N0 = ("u0", "v0", "t0", "dp0")
_NM1 = ("um1", "vm1", "tm1", "dpm1")


def variants(ops, common, names=None):
    """(name, chain) of each variant in ``names`` (default ``VARIANTS``),
    chain(n) running n chained steps from the problem's start (the
    accumulators advance in place on copies)."""
    from ..dist.step_t import (
        caar_dss_structured_packed, caar_dss_structured_packed_t,
        caar_dss_structured_packed_t4)
    from ..kernels.caar import caar_packed
    from ..kernels.caar_t import caar_packed_t

    scal, plan, rsp_t, rsp_row = common

    def unstacked(p, step, tail):
        """n0 <- np1, nm1 <- n0 on four fields a level."""
        acc = [p[n].clone() for n in ("vn0u", "vn0v", "omg")]

        def chain(n):
            s0, sm1 = tuple(p[x] for x in _N0), tuple(p[x] for x in _NM1)
            for _ in range(n):
                o = step(scal, p["meta"], *s0, *sm1, p["qdp"], p["pecnd"],
                         *acc, p["dvv"], *tail)
                s0, sm1 = o[:4], tuple(x.to(d.dtype)
                                       for x, d in zip(s0, sm1))
            return s0[0]
        return chain

    def stacked(p):
        """The stacked step: n0 <- np1, nm1 <- n0 cast to nm1's dtype."""
        acc = [p[n].clone() for n in ("vn0u", "vn0v", "omg")]
        start = (torch.cat([p[x] for x in _N0]),
                 torch.cat([p[x] for x in _NM1]))

        def chain(n):
            s0, sm1 = start
            for _ in range(n):
                s1 = caar_dss_structured_packed_t4(
                    scal, p["meta"], s0, sm1, p["qdp"], p["pecnd"], *acc,
                    p["dvv"], plan, rsp_t)[0]
                s0, sm1 = s1, s0.to(sm1.dtype)
            return s0
        return chain

    t, row = ops["t"], ops["row"]
    make = {
        "kernel_only": lambda: unstacked(row["f32"], caar_packed, ()),
        "t_kernel_only": lambda: unstacked(t["f32"], caar_packed_t, ()),
        "t_structured": lambda: unstacked(
            t["f32"], caar_dss_structured_packed_t, (plan, rsp_t)),
        "t4_structured": lambda: stacked(t["f32"]),
        "t4_structured_bf16ro": lambda: stacked(t["bf16_ro"]),
        "structured": lambda: unstacked(
            row["f32"], caar_dss_structured_packed, (plan, rsp_row)),
        "structured_bf16ro": lambda: unstacked(
            row["bf16_ro"], caar_dss_structured_packed, (plan, rsp_row)),
    }
    for name in names or VARIANTS:
        yield name, make[name]()


def run(args) -> list:
    """Every line the tool prints, as dicts."""
    from ..bench import card_name_and_power
    from ..device import resolve_device
    from .profile_prim import time_stages

    names = args.variants or list(VARIANTS) + list(NOT_APPLICABLE)
    unknown = [n for n in names if n not in VARIANTS and
               n not in NOT_APPLICABLE]
    if unknown:
        raise ValueError(f"bench_assembled: unknown variants {unknown}")
    dev = resolve_device(args.device)
    card = card_name_and_power() if dev.type == "cuda" else None
    ops, common = problem(args.ne, args.nlev, dev)
    gp = 6 * args.ne ** 2 * 16 * args.nlev
    timed = []
    for graph in (True, False):
        timed += time_stages(
            variants(ops, common, [n for n in names if n in VARIANTS and
                                   (n in NO_GRAPH) != graph]),
            args.nexec, dev, card, gridpoints=lambda _: gp, reps=args.reps,
            graph=graph)
    lines, sweep = [], {}
    for line in timed:
        (name, t), = line.items()
        sweep[name] = {"us_per_step": t.pop("us_per_call"),
                       "ggp_per_s": t.pop("ggp_per_s"),
                       "graph_us_per_step": t.pop("graph_us_per_call"),
                       "host_us_per_step": t.pop("host_us_per_call"), **t}
    for name in names:
        sweep.setdefault(name, NOT_APPLICABLE.get(name))
        lines.append({name: sweep[name]})
    lines.append({"sweep": sweep, "nelem": 6 * args.ne ** 2,
                  "nlev": args.nlev, "nexec": args.nexec, "reps": args.reps,
                  "backend": dev.type, "card": card})
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="tinman_sandbox_tpu_torch.tools.bench_assembled",
        description="the assembled-step variants, one JSON line each")
    ap.add_argument("--ne", type=int, default=30)
    ap.add_argument("--nlev", type=int, default=72)
    ap.add_argument("--nexec", type=int, default=100,
                    help="chained steps a timed run")
    ap.add_argument("--reps", type=int, default=2,
                    help="timed runs a variant (the best is kept)")
    ap.add_argument("--variants", nargs="*", default=None,
                    help="subset of variant names to run")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: the plain versions, wall-clock times")
    args = ap.parse_args(argv)
    lines = run(args)
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
