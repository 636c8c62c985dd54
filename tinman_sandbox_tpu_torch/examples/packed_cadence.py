"""The production packed cadence end to end (counterpart of the JAX
repository's ``examples/packed_cadence.py``).

The full model step on the packed layout (``dist.prim_step_packed_t4``:
SSPRK3 dynamics, biharmonic hyperviscosity, limited SSPRK3 tracer
transport), the conservative vertical remap with the global dry-mass fixer
every ``--rsplit`` steps (``dist.remap_packed_t4``) and packed energy and
mass diagnostics (``ops.energy_diagnostics_packed_t``): the state packs
once, chains across steps and reads back only the diagnostics' scalars.

    python -m tinman_sandbox_tpu_torch.examples.packed_cadence --ne 8 \\
        --nlev 26 --steps 48
    python -m tinman_sandbox_tpu_torch.examples.packed_cadence --ne 4 \\
        --nlev 8 --steps 6 --device cpu

It runs on the card unless ``--device cpu`` is given (the JAX example's
``--cpu``; the kernels' plain versions then run). The JAX example's ``--eb``
(a TPU block width) has no counterpart. ``--checkpoint PATH`` restarts the
chain from PATH when it exists and writes it at the end
(``timeloop.save_packed_checkpoint``). The fixer's target, the initial
state's air mass, goes into the checkpoint's meta and a restart reads it
back (the JAX example measures it anew from the restored state), so a
restarted chain equals an uninterrupted one bit for bit, also on the card,
where the projection of the seeded initial state adds by atomics and its
bits vary from run to run. ``--drift-out``
records the sampled diagnostics as JSON with the card and its power limit.
The exit code is 0 when the state stays finite and the relative mass drift
under 1e-4.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

__all__ = ["eta_hvcoord", "make_cadence_problem", "cadence", "main"]


def eta_hvcoord(nlev: int, dtype=torch.float32, device="cuda"):
    """Physically monotone hybrid levels (increasing interface pressure):
    ps0 = 1000, hyai = 0.12*(1 - eta), hybi = eta on nlev + 1 even eta
    interfaces, in f32 as the JAX example builds them."""
    from ..device import from_arrays
    from ..grid import HybridVCoord

    eta = np.linspace(0.0, 1.0, nlev + 1, dtype=np.float32)
    hyai = (np.float32(0.12) * (np.float32(1.0) - eta)).astype(np.float32)
    return from_arrays(HybridVCoord, dict(
        ps0=1000.0, hyai=hyai, hybi=eta,
        hyam=np.float32(0.5) * (hyai[:-1] + hyai[1:]),
        hybm=np.float32(0.5) * (eta[:-1] + eta[1:])), dtype, device)


def make_cadence_problem(ne: int, nlev: int, qsize: int, dt: float,
                         init: str = "random", device="cuda", seed: int = 11):
    """The packed cadence's operands on the ne x ne x 6 sphere, f32:

      * ``random``: ``random_state(seed)`` with u, v, T + 280, |dp| +
        900/nlev and 0.01*|qdp| projected onto the continuous space (the
        spin-up stress test);
      * ``bubble``: a resting isothermal atmosphere on the reference levels
        with a +0.5 K warm bubble and tracers 1e-3 of dp (the long-horizon
        drift configuration).

    Returns a dict: cs, cfg, plan, hv (``eta_hvcoord``), scal, meta, pecnd,
    dvv, rsp (two-float rspheremp [2, E16]), sph_lanes [1, E16], and the
    chain s [4*nlev, E16], qdp [qsize*nlev, E16], acc (vn0u, vn0v, omg)."""
    import dataclasses

    from .. import Config, random_state, zero_derived
    from ..convert import pack_qdp_t
    from ..device import resolve_device
    from ..dist import (
        build_cubed_sphere, dss_project, make_structured_plan, rsp_lanes_2f)
    from ..kernels.caar_t import _scalars, pack_problem_t
    from ..kernels.layout import META_COLS
    from ..ops.remap import reference_dp

    dev = resolve_device(device)
    f32 = torch.float32
    cs = build_cubed_sphere(ne, dtype=f32, device=dev)
    cfg = Config(nelem=cs.nelem, nlev=nlev, qsize=qsize, dt=dt)
    st = random_state(cfg, seed=seed, dtype=f32, device=dev)
    g = cs.geometry
    hv = eta_hvcoord(nlev, f32, dev)
    n0, qn0 = cfg.n0, cfg.qn0

    def put(x, level, value):
        out = x.clone()
        out[level] = value
        return out

    if init == "bubble":
        ps = torch.full((cs.nelem, 4, 4), hv.ps0, dtype=f32, device=dev)
        dp_ref = reference_dp(hv, ps)
        bubble = 0.5 * np.exp(-((np.asarray(cs.lat) - 0.0) ** 2
                                + (np.asarray(cs.lon) - 1.0) ** 2) / 0.05)
        bubble = torch.from_numpy(bubble.astype(np.float32)).to(dev)[:, None]
        st = dataclasses.replace(
            st, u=torch.zeros_like(st.u), v=torch.zeros_like(st.v),
            t=put(st.t, n0, (280.0 + bubble) * torch.ones_like(dp_ref)),
            dp3d=put(st.dp3d, n0, dp_ref),
            qdp=put(st.qdp, qn0, 1e-3 * dp_ref[:, None].expand_as(
                st.qdp[qn0])))
    elif init == "random":
        def proj(x):
            return dss_project(x, cs.gdof, cs.ndof, g.spheremp, g.rspheremp)

        st = dataclasses.replace(
            st, u=put(st.u, n0, proj(st.u[n0])),
            v=put(st.v, n0, proj(st.v[n0])),
            t=put(st.t, n0, proj(st.t[n0] + 280.0)),
            dp3d=put(st.dp3d, n0, proj(st.dp3d[n0].abs() + 900.0 / nlev)),
            qdp=put(st.qdp, qn0, proj(st.qdp[qn0].abs() * 0.01)))
    else:
        raise ValueError(f"unknown init {init!r}")

    pt = pack_problem_t(st, zero_derived(cfg, dtype=f32, device=dev), g, hv,
                        cfg)
    meta = pt["meta"]
    return dict(
        cs=cs, cfg=cfg, plan=make_structured_plan(cs.gdof, ne), hv=hv,
        scal=_scalars(dt, 1.0, hv, f32, dev), meta=meta, pecnd=pt["pecnd"],
        dvv=pt["dvv"],
        rsp=torch.from_numpy(rsp_lanes_2f(g.spheremp, cs.gdof,
                                          cs.ndof)).to(dev),
        sph_lanes=meta[META_COLS.index("spheremp")][None, :],
        s=torch.cat([pt["u0"], pt["v0"], pt["t0"], pt["dp0"]]),
        qdp=pack_qdp_t(st, cfg, f32),
        acc=(pt["vn0u"], pt["vn0v"], pt["omg"]))


def cadence(prob: dict, s, qdp, acc, steps: int, step0: int = 0,
            nu: float = 1e15, qsplit: int = 2, rsplit: int = 3,
            mass_target=None):
    """Run the cadence on ``prob``'s constants from (s, qdp, acc), yielding
    (step, s, qdp, acc, remapped) after every step: the full model step
    (``prim_step_packed_t4``, limited tracers), then on every
    ``rsplit``-th step the remap with the fixer toward ``mass_target``
    (``remap_packed_t4``). The accumulators advance IN PLACE under the
    kernels."""
    from ..dist import prim_step_packed_t4, remap_packed_t4

    cfg = prob["cfg"]
    for step in range(step0 + 1, step0 + steps + 1):
        s, qdp, _, *acc = prim_step_packed_t4(
            prob["scal"], prob["meta"], s, qdp, prob["pecnd"], *acc,
            prob["dvv"], prob["plan"], prob["rsp"], nu, cfg.nlev,
            qsplit=qsplit, limit_tracers=True, dt=cfg.dt)
        remapped = bool(rsplit) and step % rsplit == 0
        if remapped:
            s, qdp = remap_packed_t4(s, qdp, prob["hv"], cfg.nelem, cfg.nlev,
                                     cfg.qsize, sph_lanes=prob["sph_lanes"],
                                     mass_target=mass_target)
        yield step, s, qdp, tuple(acc), remapped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tinman_sandbox_tpu_torch.examples.packed_cadence")
    ap.add_argument("--ne", type=int, default=8)
    ap.add_argument("--nlev", type=int, default=26)
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--dt", type=float, default=100.0)
    ap.add_argument("--nu", type=float, default=1e15)
    ap.add_argument("--qsize", type=int, default=2)
    ap.add_argument("--qsplit", type=int, default=2)
    ap.add_argument("--rsplit", type=int, default=3,
                    help="vertical remap cadence (steps)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: the kernels' plain versions (smoke)")
    ap.add_argument("--checkpoint", default=None,
                    help="write a packed-chain checkpoint here at the end "
                         "and restart from it if it already exists")
    ap.add_argument("--init", default="random", choices=("random", "bubble"),
                    help="projected random flow (spin-up stress test) or a "
                         "resting isothermal atmosphere + warm bubble (the "
                         "long-horizon drift configuration)")
    ap.add_argument("--drift-out", default=None,
                    help="record the sampled IE/KE/M diagnostics to this "
                         "JSON")
    args = ap.parse_args(argv)

    from ..bench import card_name_and_power
    from ..dist import packed_air_mass
    from ..ops.diagnostics import energy_diagnostics_packed_t
    from ..timeloop import (
        checkpoint_meta, load_packed_checkpoint, save_packed_checkpoint)

    prob = make_cadence_problem(args.ne, args.nlev, args.qsize, args.dt,
                                args.init, args.device)
    cfg = prob["cfg"]
    dev = prob["s"].device
    s, qdp, acc = prob["s"], prob["qdp"], prob["acc"]
    # the fixer's target: the initial state's air mass under the SAME f32
    # functional that the remap-time fixer measures with; a restart takes
    # the target of the run it continues from the checkpoint (one without
    # it keeps the seeded initial state's)
    mass0 = packed_air_mass(s, prob["sph_lanes"], cfg.nlev)
    step0 = 0
    if args.checkpoint and os.path.exists(args.checkpoint):
        s, qdp, acc, step0 = load_packed_checkpoint(
            args.checkpoint, cfg.nlev, s.shape[1], device=dev)
        stored = checkpoint_meta(args.checkpoint).get("mass_target")
        if stored is not None:
            mass0 = torch.tensor(stored, dtype=mass0.dtype, device=dev)
        print(f" restarted packed chain at step {step0} from "
              f"{args.checkpoint}", flush=True)

    def diag():
        return {k: float(v) for k, v in energy_diagnostics_packed_t(
            s, prob["meta"], cfg.nlev).items()}

    def show(step, d):
        print(f" step {step}: " + "  ".join(f"{k}={v:.6e}"
                                            for k, v in d.items()),
              flush=True)

    d0 = d = diag()
    show(step0, d0)
    samples = [dict(step=step0, **d0)]
    nsample = 24 if args.drift_out else 4
    t0 = time.perf_counter()
    for step, s, qdp, acc, _ in cadence(
            prob, s, qdp, acc, args.steps, step0, args.nu, args.qsplit,
            args.rsplit, mass0):
        if (step == step0 + args.steps
                or step % max(args.steps // nsample, 1) == 0):
            d = diag()
            samples.append(dict(step=step, **d))
            show(step, d)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    if args.checkpoint:
        save_packed_checkpoint(args.checkpoint, s, qdp, acc,
                               step0 + args.steps, mass_target=mass0)
        print(f" packed chain checkpointed to {args.checkpoint}", flush=True)

    drift = abs(d["M"] - d0["M"]) / abs(d0["M"])
    finite = bool(torch.isfinite(s).all())
    if args.drift_out:
        with open(args.drift_out, "w") as fh:
            json.dump({
                "config": dict(ne=args.ne, nelem=cfg.nelem, nlev=cfg.nlev,
                               dt=args.dt, steps=args.steps, nu=args.nu,
                               qsize=args.qsize, qsplit=args.qsplit,
                               rsplit=args.rsplit, init=args.init),
                "device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                "card": card_name_and_power() if dev.type == "cuda" else None,
                "path": "prim_step_packed_t4 + remap_packed_t4 (packed "
                        "cadence, limited tracers, dry-mass fixer)",
                "samples": samples,
                "mass_drift_rel": drift,
                "finite": finite,
            }, fh, indent=1)
        print(f" drift samples written to {args.drift_out}", flush=True)
    print(f" {args.steps} steps in {wall:.1f} s "
          f"({wall / max(args.steps, 1) * 1e3:.1f} ms/step incl. "
          f"diagnostics, {dev.type}); relative mass drift {drift:.2e}; "
          f"finite={finite}")
    return 0 if (finite and drift < 1e-4) else 1


if __name__ == "__main__":
    raise SystemExit(main())
