"""The band-sharded steps at 16 and 32 shards (counterpart of the JAX
repository's ``tools/validate_n16_32.py``).

On the JAX problem (nlev 4, qsize 2, random state seed 8, dt 0.02, one-row
rspheremp, nu 2.5e-4): the band-sharded assembled step
(``caar_dss_banded_t4``, overlap off and on) and the band-sharded full model
step (``prim_step_banded_t4``) over ``LocalMesh(N)`` at (N, ne, m) = (16, 8,
8) and (32, 16, 16), each output bit for bit the single-device step's
(``caar_dss_structured_packed_t4``, ``prim_step_packed_t4``). Prints one
JSON line an N, then the report.

    python -m tinman_sandbox_tpu_torch.tools.validate_n16_32 [--device cpu]

On the card the kernels run; ``--device cpu`` runs their plain versions.
"""
from __future__ import annotations

import argparse
import json

import torch

__all__ = ["CASES", "main"]

CASES = ((16, 8, 8), (32, 16, 16))         # (N, ne, m): 6m % N == 0


def _problem(ne: int, dev):
    from .. import Config, analytic_hvcoord, random_state, zero_derived
    from ..convert import pack_qdp_t
    from ..dist import build_cubed_sphere, make_structured_plan
    from ..kernels.caar_t import _scalars, pack_problem_t

    kw = dict(dtype=torch.float32, device=dev)
    cs = build_cubed_sphere(ne, **kw)
    cfg = Config(nelem=cs.nelem, nlev=4, qsize=2)
    st = random_state(cfg, seed=8, **kw)
    hv = analytic_hvcoord(cfg, **kw)
    p = pack_problem_t(st, zero_derived(cfg, **kw), cs.geometry, hv, cfg)
    return dict(
        scal=_scalars(0.02, 1.0, hv, torch.float32, dev), meta=p["meta"],
        s0=torch.cat([p[k] for k in ("u0", "v0", "t0", "dp0")]),
        sm1=torch.cat([p[k] for k in ("um1", "vm1", "tm1", "dpm1")]),
        qdp=p["qdp"], qdp0=pack_qdp_t(st, cfg, torch.float32),
        pecnd=p["pecnd"], acc=(p["vn0u"], p["vn0v"], p["omg"]),
        dvv=p["dvv"], plan=make_structured_plan(cs.gdof, ne),
        rsp=cs.geometry.rspheremp.reshape(1, -1).contiguous(), nlev=4)


def _same(label, got, want, mesh) -> None:
    from ..dist import unshard_packed_t4

    for i, (g, w) in enumerate(zip(got, want)):
        g = unshard_packed_t4(mesh, g)
        if not torch.equal(g, w):
            raise AssertionError(f"{label}: output {i} leaves the "
                                 f"single-device step by "
                                 f"{float((g - w).abs().max())}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="tinman_sandbox_tpu_torch.tools.validate_n16_32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..dist import (
        LocalMesh, caar_dss_banded_t4, caar_dss_structured_packed_t4,
        prim_step_banded_t4, prim_step_packed_t4, shard_packed_t4)

    dev = resolve_device(args.device)
    nu = 2.5e-4
    report = {}
    for n, ne, m in CASES:
        p = _problem(ne, dev)
        mesh = LocalMesh(n, dev)
        k, plan, acc = p["nlev"], p["plan"], p["acc"]
        fresh = lambda: [a.clone() for a in acc]
        ref = caar_dss_structured_packed_t4(
            p["scal"], p["meta"], p["s0"], p["sm1"], p["qdp"], p["pecnd"],
            *fresh(), p["dvv"], plan, p["rsp"])
        row = {}
        for overlap in (False, True):
            sh = shard_packed_t4(mesh, p["meta"], p["s0"], p["sm1"], p["qdp"],
                                 p["pecnd"], *fresh(), p["rsp"])
            got = caar_dss_banded_t4(p["scal"], *sh[:8], p["dvv"], plan,
                                     sh[8], mesh, m, overlap=overlap)
            label = "banded_overlap" if overlap else "banded"
            _same(f"N={n} {label}", got, ref, mesh)
            row[label] = "bit for bit"
        pref = prim_step_packed_t4(p["scal"], p["meta"], p["s0"], p["qdp0"],
                                   p["pecnd"], *fresh(), p["dvv"], plan,
                                   p["rsp"], nu, k, dt=0.02)
        sh = shard_packed_t4(mesh, p["meta"], p["s0"], p["qdp0"], p["pecnd"],
                             *fresh(), p["rsp"])
        pgot = prim_step_banded_t4(p["scal"], *sh[:4], *sh[4:7], p["dvv"],
                                   plan, sh[7], mesh, m, nu, k, dt=0.02)
        _same(f"N={n} prim", pgot, pref, mesh)
        row["prim_cadence"] = "bit for bit"
        report[f"N={n} ne={ne} m={m}"] = row
        print(f"N={n}:", json.dumps(row), flush=True)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
