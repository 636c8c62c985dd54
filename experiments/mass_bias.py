#!/usr/bin/env python3
"""The float32 mass biases that the long-run gates found, measured on the
CPU with the port's plain versions and its emulated tracer kernel. An
experiment, not part of the port.

    python3 experiments/mass_bias.py [--quick]

from the repository root. Four measurements, one JSON line each:

  * ``projection``: the relative mass drift of 300 projections
    c <- rsp*DSS(sph*c) at ne 3 x 8 levels (tests/test_conservation.py's
    problem) with the one-float rspheremp, the two-float pair applied as two
    rounded products and a rounded sum (the DSS kernels' earlier scale),
    and the pair as one fmaf (``dist.dss.mul_2f``, the kernels' scale now);
  * ``bell``: a cosine bell once round the ne 6 sphere (480 steps, 2
    levels, radius 0.5 and 0.2 rad) through the float32 packed SSPRK3 tracer
    step, with the last Shu-Osher pair rounded on its own, f(1/3) + f(2/3)
    = 1 + 2**-25, and with ``timeloop.rk.third_stage_weights``;
  * ``combination``: the mean rounding error, relative to the mass, of one
    Shu-Osher combination ca*mx + cb*y over 2M random values (y within 1e-3
    of mx), as fmaf(ca, mx, cb*y) and as two rounded products and a rounded
    sum, for (0.75, 0.25) and both third-stage pairs;
  * ``limited_bell``: half a revolution (240 steps) of the limited bell at
    ne 6 x 4 levels with the tracer kernel's arithmetic emulated
    (``tracer_limit_emulated``), its combination as fmaf (the kernel's
    earlier form) and as two rounded products (its form now), beside the
    plain version.

``--quick`` cuts the bell runs to 100 steps (a check that the script runs).
These are CPU results of float32 arithmetic; no time is measured.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tinman_sandbox_tpu_torch.constants import CONSTANTS  # noqa: E402
from tinman_sandbox_tpu_torch.dist import (  # noqa: E402
    build_cubed_sphere, cosine_bell, dss_structured_t, make_structured_plan,
    rsp_lanes_2f, ssprk3_tracer_packed_t_plain, step_t)
from tinman_sandbox_tpu_torch.dist.dss import mul_2f  # noqa: E402
from tinman_sandbox_tpu_torch.kernels import tracer_t  # noqa: E402
from tinman_sandbox_tpu_torch.kernels.dss import (  # noqa: E402
    dss_structured_t_cuda)
from tinman_sandbox_tpu_torch.kernels.layout import (  # noqa: E402
    META_COLS, pack_field_t, pack_meta_t)
from tinman_sandbox_tpu_torch.timeloop.rk import (  # noqa: E402
    third_stage_weights)

PERIOD = 12.0 * 86400.0
ROUNDED_PAIR = lambda f: (f(1.0 / 3.0), f(2.0 / 3.0))   # noqa: E731


def f64_mass(sph, x) -> float:
    return float((sph.double() * x.double()).sum())


def projection() -> dict:
    ne, k = 3, 8
    cs = build_cubed_sphere(ne, device="cpu")
    plan = make_structured_plan(cs.gdof, ne)
    g = cs.geometry
    sph = g.spheremp.to(torch.float32).reshape(1, -1)
    rsp1 = g.rspheremp.to(torch.float32).reshape(1, -1)
    hi, lo = torch.from_numpy(rsp_lanes_2f(g.spheremp, cs.gdof,
                                           cs.ndof)).split(1)
    x0 = torch.from_numpy(np.abs(np.random.default_rng(3).standard_normal(
        (k, cs.nelem * 16))) + 1.0).float()
    scale = {"one_float": lambda y: rsp1 * y,
             "two_float_rounded": lambda y: y * hi + y * lo,
             "two_float_fmaf": lambda y: mul_2f(y, hi, lo)}
    out = {}
    for name, apply in scale.items():
        c = apply(dss_structured_t((sph * x0).contiguous(), plan))
        m0 = f64_mass(sph, c)
        for _ in range(300):
            c = apply(dss_structured_t((sph * c).contiguous(), plan))
        out[name] = abs(f64_mass(sph, c) - m0) / abs(m0)
    return out


def bell_problem(ne: int, radii):
    """(meta, dvv, vu, vv, q0, plan, rsp, sph, dt) of the solid-body bell at
    ne, one level a radius, f32, the CFL of tests/test_advection.py."""
    cs = build_cubed_sphere(ne, dtype=torch.float32, device="cpu")
    plan = make_structured_plan(cs.gdof, ne)
    g = cs.geometry
    nlev = len(radii)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a)).float()  # noqa
    u0 = 2.0 * np.pi * CONSTANTS.rearth / PERIOD
    vu = pack_field_t(f32(np.broadcast_to((u0 * np.cos(cs.lat))[:, None],
                                          (cs.nelem, nlev, 4, 4))))
    meta = pack_meta_t(g, torch.zeros_like(g.spheremp), torch.float32)
    rsp = torch.from_numpy(rsp_lanes_2f(g.spheremp, cs.gdof, cs.ndof))
    sph = meta[META_COLS.index("spheremp")]
    bell = pack_field_t(f32(np.stack([cosine_bell(cs.sphere_xyz, r)
                                      for r in radii], 1)))
    q0 = dss_structured_t_cuda((sph * bell).contiguous(), plan, rsp)
    return (meta, g.dvv.float().contiguous(), vu, torch.zeros_like(vu), q0,
            plan, rsp, sph, PERIOD / (80 * ne))


def bell(steps: int) -> dict:
    meta, dvv, vu, vv, q0, plan, rsp, sph, dt = bell_problem(6, (0.5, 0.2))
    out = {"steps": steps}
    for name, pair in (("rounded_pair", ROUNDED_PAIR),
                       ("third_stage_weights", third_stage_weights)):
        with mock.patch.object(step_t, "third_stage_weights", pair):
            q = q0
            for _ in range(steps):
                q = ssprk3_tracer_packed_t_plain(dvv, meta, vu, vv, q, plan,
                                                 rsp, dt, 2)
        out[name] = f64_mass(sph, q) / f64_mass(sph, q0) - 1.0
    return out


def combination() -> dict:
    rng = np.random.default_rng(0)
    n = 2_000_000
    mx = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
    y = mx * torch.from_numpy(rng.uniform(0.999, 1.001, n).astype(
        np.float32))
    out = {}
    for name, (ca, cb) in (("0.75_0.25", (0.75, 0.25)),
                           ("rounded_third", ROUNDED_PAIR(np.float32)),
                           ("third_stage_weights",
                            third_stage_weights(np.float32))):
        ca, cb = float(ca), float(cb)
        exact = ca * mx.double() + cb * y.double()
        fma = (ca * mx.double() + (cb * y).double()).float()
        two = ca * mx + cb * y
        out[name] = {
            "fmaf": float((fma.double() - exact).sum() / exact.sum()),
            "two_products": float((two.double() - exact).sum()
                                  / exact.sum())}
    return out


def limited_bell(steps: int) -> dict:
    meta, dvv, vu, vv, q0, plan, rsp, sph, dt = bell_problem(
        6, np.linspace(0.5, 0.2, 4))

    def emulated(fmaf):
        def limit(meta, vu, vv, q, dvv, dt, nlev, mix=None, wind_rows=(0, 0),
                  iters=2, fix=None):
            if mix is not None and fmaf:
                # the kernel's earlier combination: fmaf(ca, mx, cb*e)
                mx, ca, cb = mix
                e = tracer_t._advect_emulated(meta, vu, vv, q, dvv, dt, nlev,
                                              wind_rows)
                quads = lambda x: x.reshape(q.shape[0], -1, 4, 4)  # noqa
                y = tracer_t._fma(tracer_t._f32(ca), quads(mx),
                                  tracer_t._f32(cb) * e)
                w = meta[tracer_t._MC["spheremp"]].view(1, -1, 4, 4)
                y = tracer_t._limit_emulated(y, quads(q), w, iters)
                return tracer_t._with_slab((w * y).reshape(q.shape), fix)
            out, slab, _, _ = tracer_t.tracer_limit_emulated(
                meta, vu, vv, q, dvv, dt, nlev, mix, wind_rows, iters, fix)
            return out, slab
        return limit

    euler = step_t._mix_in_closer(tracer_t.tracer_euler_plain)
    out = {"steps": steps}
    for name, limiter in (("plain", tracer_t.tracer_limit_plain),
                          ("kernel_fmaf", emulated(True)),
                          ("kernel_two_products", emulated(False))):
        q = q0
        for _ in range(steps):
            q = step_t._ssprk3_tracer(euler, limiter, step_t._plain_dss_pre,
                                      dvv, meta, vu, vv, q, plan, rsp, dt, 4,
                                      True, (0, 0), 2)
        out[name] = f64_mass(sph, q) / f64_mass(sph, q0) - 1.0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    print(json.dumps({"projection": projection()}), flush=True)
    print(json.dumps({"bell": bell(100 if args.quick else 480)}), flush=True)
    print(json.dumps({"combination": combination()}), flush=True)
    print(json.dumps({"limited_bell": limited_bell(
        100 if args.quick else 240)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
