"""Weak / strong scaling sweep of the element-sharded step (counterpart of
the JAX repository's ``tools/scaling.py``).

Runs the element-sharded CAAR + psum halo DSS (``dist.caar_halo_step``) on
1, 2, 4 and 8 shards of a ``LocalMesh`` and prints one JSON line a shard
count (wall seconds of ``--steps`` chained steps, best of 3, gridpoints/s
and the efficiency against the first count), then one line of all of them.
Every shard of a ``LocalMesh`` runs on one device, one after another: the
lines say ``"emulation": true`` and are no scaling result.

    python -m tinman_sandbox_tpu_torch.tools.scaling --ne 8 --nlev 72 \\
        --steps 10 [--weak] [--devices 1 2 4 8] [--device cpu]

It runs on the card unless ``--device cpu`` is given (the JAX tool's
``--cpu``), in f32.
"""
from __future__ import annotations

import argparse
import json
import math
import time

import torch

__all__ = ["main"]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="tinman_sandbox_tpu_torch.tools.scaling")
    ap.add_argument("--ne", type=int, default=6)
    ap.add_argument("--nlev", type=int, default=72)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--weak", action="store_true",
                    help="scale the problem with the shard count")
    ap.add_argument("--devices", type=int, nargs="*", default=[1, 2, 4, 8],
                    help="shard counts of the LocalMesh")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..dist import LocalMesh, caar_halo_step, make_dss_plan, shard_problem
    from ..multichip import element_sharded_problem

    dev = resolve_device(args.device)
    results = []
    for nd in args.devices:
        ne = args.ne
        if args.weak:
            # elements grow about linearly with the shards
            ne = int(round(args.ne * math.sqrt(nd)))
        while (6 * ne * ne) % nd:
            ne += 1
        cs, cfg, st, dv, geom, hv = element_sharded_problem(
            nd, dev, args.nlev, ne)
        mesh = LocalMesh(nd, dev)
        plan = make_dss_plan(cs.gdof, nd)
        st, dv, gm = shard_problem(mesh, st, dv, geom)

        def run():
            s, d = st, dv
            for _ in range(args.steps):
                s, d = caar_halo_step(s, d, gm, hv, plan, mesh, cfg, 0.01,
                                      1.0)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        run()                                    # warm-up
        wall = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            wall = min(wall, time.perf_counter() - t0)
        gps = cs.nelem * args.nlev * 16 * args.steps / wall
        results.append({
            "devices": nd, "ne": ne, "nelem": cs.nelem, "nlev": args.nlev,
            "steps": args.steps, "wall_s": wall, "gridpoints_per_s": gps,
            "perimeter_fraction": plan.perimeter_fraction,
            "emulation": True, "device": str(dev) if dev.type == "cpu"
            else torch.cuda.get_device_name(dev)})
    base = results[0]
    for r in results:
        if args.weak:
            r["efficiency"] = (r["gridpoints_per_s"] / r["nelem"]) / \
                (base["gridpoints_per_s"] / base["nelem"])
        else:
            r["efficiency"] = r["gridpoints_per_s"] / (
                base["gridpoints_per_s"] * r["devices"] / base["devices"])
        print(json.dumps(r))
    print(json.dumps({"scaling": "weak" if args.weak else "strong",
                      "emulation": True, "runs": results}))
    return results


if __name__ == "__main__":
    main()
