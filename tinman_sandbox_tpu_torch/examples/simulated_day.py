"""One simulated day of the field-form model cadence (counterpart of the
JAX repository's ``examples/simulated_day.py``): the reference's canonical
workload (86,400 s in 600 s steps) run as an integration.

  ne = 8 cubed sphere (384 elements) x 26 levels, a resting isothermal
  atmosphere with a warm bubble on a real hybrid coordinate, SSPRK3
  dynamics with DSS, biharmonic hyperviscosity, qsplit = 2 limited tracer
  transport and the vertical remap every third step
  (``timeloop.prim_run_step(remap=(step % 3 == 0))``), energy and mass
  diagnostics every 24 steps, a checkpoint at the end.

    python -m tinman_sandbox_tpu_torch.examples.simulated_day [--ne 8] \\
        [--nlev 26] [--steps 144] [--device cpu]

It runs on the card unless ``--device cpu`` is given (the JAX example's
``--cpu``), in float64: the field form is the port's oracle.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

__all__ = ["bubble_problem", "main"]


def bubble_problem(ne: int, nlev: int, dt: float, device="cuda"):
    """The resting isothermal atmosphere with a +0.5 K warm bubble on the
    hybrid coordinate p_top = 5 hPa .. ps0 = 1000 hPa (B = eta-ramp^1.3):
    continuous fields, so no projection is needed. Returns (cs, cfg, state,
    derived, hv) on ``device``, in float64."""
    from .. import Config, zero_derived
    from ..config import NP, NUM_TIME_LEVELS, QDP_TIME_LEVELS
    from ..device import from_arrays, resolve_device
    from ..dist import build_cubed_sphere
    from ..grid import HybridVCoord
    from ..ops.remap import reference_dp
    from ..state import State

    dev, dtype = resolve_device(device), torch.float64
    cs = build_cubed_sphere(ne, dtype=dtype, device=dev)
    cfg = Config(nelem=cs.nelem, nlev=nlev, dt=dt)
    p0, p_top = 1.0e5, 500.0
    etai = np.linspace(p_top / p0, 1.0, nlev + 1)
    b = ((etai - etai[0]) / (1.0 - etai[0])) ** 1.3
    a = etai - b
    hv = from_arrays(HybridVCoord, dict(
        ps0=p0, hyai=a, hybi=b, hyam=0.5 * (a[:-1] + a[1:]),
        hybm=0.5 * (b[:-1] + b[1:])), dtype, dev)

    ps = torch.full((cs.nelem, NP, NP), p0, dtype=dtype, device=dev)
    dp_ref = reference_dp(hv, ps)                       # [e, nlev, np, np]
    bubble = torch.from_numpy(0.5 * np.exp(
        -((np.asarray(cs.lat) - 0.0) ** 2
          + (np.asarray(cs.lon) - 1.0) ** 2) / 0.05)).to(dev, dtype)[:, None]

    def tile(x):
        return x.expand(NUM_TIME_LEVELS, *x.shape).contiguous()

    zeros3 = torch.zeros((NUM_TIME_LEVELS, cs.nelem, nlev, NP, NP),
                         dtype=dtype, device=dev)
    state = State(
        u=zeros3, v=zeros3.clone(),
        t=tile((280.0 + bubble) * torch.ones_like(dp_ref)),
        dp3d=tile(dp_ref), ps_v=tile(ps),
        phis=torch.zeros((cs.nelem, NP, NP), dtype=dtype, device=dev),
        qdp=(torch.full((QDP_TIME_LEVELS, cs.nelem, cfg.qsize, nlev, NP, NP),
                        1e-3, dtype=dtype, device=dev)
             * dp_ref[None, :, None]))
    return cs, cfg, state, zero_derived(cfg, dtype=dtype, device=dev), hv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tinman_sandbox_tpu_torch.examples.simulated_day")
    ap.add_argument("--ne", type=int, default=8)
    ap.add_argument("--nlev", type=int, default=26)
    ap.add_argument("--steps", type=int, default=144)
    ap.add_argument("--dt", type=float, default=600.0)
    ap.add_argument("--nu", type=float, default=1e15)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from ..ops.diagnostics import energy_diagnostics
    from ..timeloop import check_dp3d, prim_run_step, save_checkpoint

    cs, cfg, st, dv, hv = bubble_problem(args.ne, args.nlev, args.dt,
                                         args.device)
    dev = st.u.device
    g = cs.geometry
    print(f"cubed sphere ne={args.ne}: {cs.nelem} elements, {cs.ndof} dofs, "
          f"{args.nlev} levels; dt={args.dt}s x {args.steps} steps "
          f"({dev.type}, float64)")

    def show(label, d):
        print(label + "  ".join(f"{k}={float(v):.6e}" for k, v in d.items()))

    d0 = energy_diagnostics(st, g.spheremp, cfg)
    show("initial: ", d0)
    c = cfg
    t0 = time.perf_counter()
    for step in range(1, args.steps + 1):
        st, dv, c = prim_run_step(st, dv, g, hv, c, cs.gdof, cs.ndof,
                                  nu=args.nu, qsplit=2, limit_tracers=True,
                                  remap=(step % 3 == 0), device=dev)
        if step % 24 == 0:
            d = energy_diagnostics(st, g.spheremp, cfg, tl=c.n0)
            ok, mn = check_dp3d(st, dataclasses.replace(c, np1=c.n0))
            show(f"step {step:4d}: ", d)
            if not ok:
                print(f"  [dp3d min {mn:.2e}!]")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    d1 = energy_diagnostics(st, g.spheremp, cfg, tl=c.n0)
    drift = abs(float(d1["M"]) / float(d0["M"]) - 1.0)
    show("final:   ", d1)
    print(f"mass drift: {drift:.2e}; wall {wall:.1f}s "
          f"({cs.nelem * args.nlev * 16 * args.steps / wall / 1e6:.1f} "
          f"Mgp/s, {dev.type})")
    if not bool(torch.isfinite(st.t).all()):
        raise RuntimeError("state blew up")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, st, dv, c, args.steps)
        print("checkpoint:", args.checkpoint)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
