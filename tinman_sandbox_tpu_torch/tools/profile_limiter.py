"""Stage decomposition of the limited tracer stage on the card (counterpart
of the JAX repository's ``tools/profile_limiter.py``).

    python -m tinman_sandbox_tpu_torch.tools.profile_limiter [--ne 30] \
        [--nlev 72] [--qsize 35] [--nexec 10] [--json-out PATH]
    python -m tinman_sandbox_tpu_torch.tools.profile_limiter --device cpu \
        --ne 2 --nlev 4 --qsize 2 --nexec 1

Times one SSPRK3 tracer substep (``ssprk3_tracer_packed_t``, three stages
of the tracer kernel, fixup and sweep) under the JAX tool's ladder, whose
differences isolate each part of the fused limiter:

  * ``nolimit``: the Euler kernel (advection and the DSS only);
  * ``limit_i0``: the limited kernel with no clip-and-redistribute pass:
    the bounds, the mass sums and the exact-conservation residual pass;
  * ``limit_i1``, ``limit_i2``: one and two passes (2 is production).

It prints one line a rung and the decomposition by differences, in us a
block a SSP stage as the JAX tool does, with the port's block count: a
block of the limited kernel is 128 lanes x 8 levels of every tracer
(``csrc/tracer.cu``), ceil(E16/128) x ceil(nlev/8) of them (the JAX tool's
blocks are its 128-lane tiles, E16/128; both counts are in the report).
The JAX tool's ``transpose2`` and ``roll`` rungs are TPU min/max strategies
and its ``--lg`` a TPU lane grouping: the rungs are reported
``"not applicable"`` with the reason and the option is dropped.

The inputs are the JAX tool's: ``random_state`` seed 8 at ``--qsize``
tracers cast to f32, qdp[qn0] stacked tracer-major [qsize*nlev, E16], the
winds of the packed state's n0 level, the one-float rspheremp row, dt
0.02. The state is not projected (the JAX tool's is not): what each rung
costs does not depend on it. Each time is ``profiling.stage_time``'s:
CUDA events over ``--nexec`` chained substeps, from a CUDA graph, and the
host's issue time. ``--json-out`` writes the report. The tool runs on the
card; ``--device cpu`` runs the plain versions with wall-clock times.
Without a card and without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

__all__ = ["problem", "ladder", "blocks", "main", "LADDER", "NOT_APPLICABLE"]

SEED = 8
DT = 0.02
# rung -> (limit, iters)
LADDER = {"nolimit": (False, 2), "limit_i0": (True, 0),
          "limit_i1": (True, 1), "limit_i2": (True, 2)}
NOT_APPLICABLE = {
    name: "not applicable: a TPU min/max strategy of the group reductions "
          "(limit_strategy); csrc/tracer.cu reduces a group by a 4-lane "
          "tree and two xor shuffles, one strategy"
    for name in ("limit_i2_t2", "limit_i1_t2", "limit_i2_roll")}
# the JAX tool's decomposition: (name, minuend, subtrahend)
DECOMPOSITION = (
    ("bounds+sums+residual_us_per_block", "limit_i0", "nolimit"),
    ("iteration1_us_per_block", "limit_i1", "limit_i0"),
    ("iteration2_us_per_block", "limit_i2", "limit_i1"))
DECOMPOSITION_NA = ("minmax_transpose2_delta_us_per_block",
                    "minmax_roll_delta_us_per_block")


def _state_qn0(cfg, seed: int):
    """``random_state(cfg, seed)``'s n0 winds, T, dp, phis and qdp[qn0] as
    float32 numpy arrays, from the same numpy stream: the other qdp level
    is never drawn (at ne30 x qsize 35 it is 1.7 GB of float64)."""
    from ..config import NP, NUM_TIME_LEVELS

    rng = np.random.default_rng(seed)
    s3 = (NUM_TIME_LEVELS, cfg.nelem, cfg.nlev, NP, NP)
    out = {name: rng.uniform(lo, hi, s3)[cfg.n0].astype(np.float32)
           for name, lo, hi in (("u", -1, 1), ("v", -1, 1), ("t", 250, 300),
                                ("dp3d", 10, 20))}
    rng.uniform(9e4, 1.1e5, (NUM_TIME_LEVELS, cfg.nelem, NP, NP))   # ps_v
    out["phis"] = rng.uniform(0, 1, (cfg.nelem, NP, NP)).astype(np.float32)
    qshape = (cfg.nelem, cfg.qsize, cfg.nlev, NP, NP)
    for _ in range(cfg.qn0):
        rng.uniform(0, 1, qshape)
    out["qdp"] = rng.uniform(0, 1, qshape).astype(np.float32)
    return out


def problem(ne: int, nlev: int, qsize: int, device, seed: int = SEED):
    """The JAX tool's inputs: (meta, dvv, s0, qdp0, plan, rsp) with s0 the
    stacked n0 state [4*nlev, E16] and qdp0 the stacked tracers
    [qsize*nlev, E16]."""
    from ..config import Config
    from ..dist import build_cubed_sphere, make_structured_plan
    from ..kernels.layout import pack_field_t, pack_meta_t

    cs = build_cubed_sphere(ne, dtype=torch.float32, device=device)
    cfg = Config(nelem=cs.nelem, nlev=nlev, qsize=qsize)
    st = _state_qn0(cfg, seed)
    t = lambda a: torch.from_numpy(a).to(device)
    s0 = torch.cat([pack_field_t(t(st[n]))
                    for n in ("u", "v", "t", "dp3d")])
    q = t(st.pop("qdp"))
    qdp0 = torch.cat([pack_field_t(q[:, i]) for i in range(qsize)])
    del q
    # the JAX tool's meta is pack_problem_t's: the state's phis rides in it
    meta = pack_meta_t(cs.geometry, t(st["phis"]), torch.float32)
    return (meta, cs.geometry.dvv.to(torch.float32).contiguous(), s0, qdp0,
            make_structured_plan(cs.gdof, ne),
            cs.geometry.rspheremp.reshape(1, -1).contiguous())


def blocks(e16: int, nlev: int) -> dict:
    """The limited kernel's blocks (128 lanes x 8 levels of every tracer)
    and the JAX tool's (its 128-lane tiles)."""
    from ..kernels.tracer_t import TRACER_LEVELS, TRACER_TILE

    return {"port_blocks": -(-e16 // TRACER_TILE) * -(-nlev // TRACER_LEVELS),
            "jax_blocks": e16 // 128}


def ladder(meta, dvv, s0, qdp0, plan, rsp, dt: float = DT):
    """The rungs as (name, chain): chain(n) runs n chained substeps of the
    rung from qdp0 (``profile_prim.stages``' contract)."""
    from ..dist.step_t import ssprk3_tracer_packed_t

    nlev = s0.shape[0] // 4
    for name, (limit, iters) in LADDER.items():
        def chain(n, limit=limit, iters=iters):
            q = qdp0
            for _ in range(n):
                q = ssprk3_tracer_packed_t(
                    dvv, meta, s0, s0, q, plan, rsp, dt, nlev, limit=limit,
                    wind_rows=(0, 1), limit_iters=iters)
            return q

        yield name, chain


def run(args) -> dict:
    """The report (the tool's last line)."""
    from ..bench import card_name_and_power
    from ..device import resolve_device
    from .profile_prim import time_stages

    dev = resolve_device(args.device)
    card = card_name_and_power() if dev.type == "cuda" else None
    meta, dvv, s0, qdp0, plan, rsp = problem(args.ne, args.nlev, args.qsize,
                                             dev)
    e16 = s0.shape[1]
    nb = blocks(e16, args.nlev)
    print(f"# q{args.qsize} tracer stage, ne{args.ne} x {args.nlev} ({e16} "
          f"lanes, {nb['port_blocks']} blocks of 128 lanes x 8 levels; the "
          f"JAX tool's {nb['jax_blocks']}), qk={args.qsize * args.nlev}; "
          f"card {card}", flush=True)
    lines = {k: v for line in time_stages(
        ladder(meta, dvv, s0, qdp0, plan, rsp), args.nexec, dev,
        card) for k, v in line.items()}
    stage_us = {k: v["us_per_call"] for k, v in lines.items()}
    graph_us = {k: v["graph_us_per_call"] for k, v in lines.items()}
    for name, us in stage_us.items():
        print(f"{name:16s} {us / 1000.0:9.3f} ms/stage-call "
              f"({us / nb['port_blocks'] / 3.0:6.3f} us/block/SSP-stage)",
              flush=True)
    graphs = None not in graph_us.values()
    best = graph_us if graphs else stage_us
    per = lambda a, b: (best[a] - best[b]) / nb["port_blocks"] / 3.0
    dec = {name: per(a, b) for name, a, b in DECOMPOSITION}
    dec.update({name: "not applicable: a TPU min/max strategy"
                for name in DECOMPOSITION_NA})
    print("\n# decomposition (us/block/SSP-stage, from the graph times "
          "where there are):")
    for k, v in dec.items():
        print(f"  {k:44s} " + (f"{v:+7.3f}" if isinstance(v, float) else v))
    return dict(shape=f"ne{args.ne}x{args.nlev} q{args.qsize}",
                nblocks=nb["port_blocks"], jax_nblocks=nb["jax_blocks"],
                stage_us=stage_us, stage_graph_us=graph_us,
                stage_host_us={k: v["host_us_per_call"]
                               for k, v in lines.items()},
                launches={k: v["launches"] for k, v in lines.items()},
                not_applicable=NOT_APPLICABLE, decomposition=dec,
                decomposition_times="graph" if graphs else "events",
                seed=SEED, dt=DT, nexec=args.nexec, backend=dev.type,
                card=card)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="tinman_sandbox_tpu_torch.tools.profile_limiter",
        description="the limited tracer stage's parts by differences")
    ap.add_argument("--ne", type=int, default=30)
    ap.add_argument("--nlev", type=int, default=72)
    ap.add_argument("--qsize", type=int, default=35)
    ap.add_argument("--nexec", type=int, default=10,
                    help="chained substeps a timed run")
    ap.add_argument("--json-out", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: the plain versions, wall-clock times")
    args = ap.parse_args(argv)
    out = run(args)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
