"""Long-run energy and mass drift of the full field-form cadence
(counterpart of the JAX repository's ``tools/energy_drift.py``).

Integrates ``timeloop.prim_run_step`` (SSPRK3 dynamics with DSS,
hyperviscosity, qsplit = 2 limited tracers, the vertical remap every third
step) with the two-float rspheremp projection and the global dry-mass fixer
at every remap, from the resting atmosphere with a warm bubble
(``examples.simulated_day.bubble_problem``), and records the global
diagnostics (``ops.energy_diagnostics``: KE, IE, PE, M) and the dp3d>0
check every ``--every`` steps as JSON.

    python -m tinman_sandbox_tpu_torch.tools.energy_drift --steps 720 \\
        --every 72 [--device cpu]

The report goes to ``--out``, by default ``ENERGY_DRIFT_TORCH.json`` at the
repository root (``ENERGY_DRIFT.json`` there is the JAX package's), with the
device, and on the card its name and power limit. It runs on the card unless
``--device cpu`` is given (the JAX tool's ``--cpu``), in float64: the field
form is the port's oracle, and its drift is the formulation's, not f32
rounding's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

__all__ = ["DEFAULT_OUT", "main"]

DEFAULT_OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "ENERGY_DRIFT_TORCH.json")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="tinman_sandbox_tpu_torch.tools.energy_drift")
    ap.add_argument("--ne", type=int, default=4)
    ap.add_argument("--nlev", type=int, default=8)
    ap.add_argument("--steps", type=int, default=720,
                    help="720 x 600 s = 5 simulated days")
    ap.add_argument("--every", type=int, default=72)
    ap.add_argument("--dt", type=float, default=600.0)
    ap.add_argument("--nu", type=float, default=1e15)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None,
                    help=f"report path (default {DEFAULT_OUT})")
    args = ap.parse_args(argv)

    from ..bench import card_name_and_power
    from ..dist import rsp_2f
    from ..examples.simulated_day import bubble_problem
    from ..ops.diagnostics import energy_diagnostics
    from ..timeloop import air_mass, check_dp3d, prim_run_step

    cs, cfg, st, dv, hv = bubble_problem(args.ne, args.nlev, args.dt,
                                         args.device)
    dev = st.u.device
    g = cs.geometry
    # the conservation stack on the field cadence: the two-float rspheremp
    # projection and the global dry-mass fixer at every remap
    rsp2 = tuple(torch.from_numpy(x).to(dev)
                 for x in rsp_2f(g.spheremp, cs.gdof, cs.ndof))
    mass_target = air_mass(st, g.spheremp,
                           dataclasses.replace(cfg, np1=cfg.n0))

    def diag(tl):
        return {k: float(v) for k, v in
                energy_diagnostics(st, g.spheremp, cfg, tl=tl).items()}

    d0 = diag(cfg.n0)
    samples = [dict(step=0, **d0, dp3d_ok=True)]
    print("step 0:", json.dumps(d0), flush=True)
    c = cfg
    t0 = time.perf_counter()
    for step in range(1, args.steps + 1):
        st, dv, c = prim_run_step(st, dv, g, hv, c, cs.gdof, cs.ndof,
                                  nu=args.nu, qsplit=2, limit_tracers=True,
                                  remap=(step % 3 == 0), rsp2=rsp2,
                                  mass_target=mass_target, device=dev)
        if step % args.every == 0 or step == args.steps:
            ok, _ = check_dp3d(st, dataclasses.replace(c, np1=c.n0))
            samples.append(dict(step=step, **diag(c.n0), dp3d_ok=ok))
            print(f"step {step}:", json.dumps(samples[-1]), flush=True)
            if not bool(torch.isfinite(st.t).all()):
                raise RuntimeError("state blew up")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    final = samples[-1]
    report = {
        "config": {"ne": args.ne, "nelem": cs.nelem, "nlev": args.nlev,
                   "dt": args.dt, "steps": args.steps, "nu": args.nu,
                   "qsplit": 2, "remap_every": 3, "limit_tracers": True,
                   "dtype": "float64"},
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "card": card_name_and_power() if dev.type == "cuda" else None,
        "simulated_days": args.steps * args.dt / 86400.0,
        "samples": samples,
        "mass_drift_rel": abs(final["M"] / d0["M"] - 1.0),
        "ie_drift_rel": abs(final["IE"] / d0["IE"] - 1.0),
        "ke_final": final["KE"],
        "wall_s": wall,
    }
    out = args.out or DEFAULT_OUT
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"mass drift {report['mass_drift_rel']:.3e}  IE drift "
          f"{report['ie_drift_rel']:.3e}  KE {final['KE']:.3e}  -> {out}",
          flush=True)
    return report


if __name__ == "__main__":
    main()
