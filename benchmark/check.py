"""The check that decides ``correct``.

The reference (``reference/``) works out, in float64 on the device, the
same things the program made, from the same raw inputs, and judges what
the timed path produced:

  * ``start``: the program's initial state (the projection and packing of
    the raw state) against the reference's own projection;
  * ``first``: the program's first step from that state (a warm-up step,
    through the same call as the window's) against the reference's first
    step from its own initial state;
  * ``step`` and ``remap``: a cadence period drawn from the seed inside the
    window, a step and the remap step after it. The reference follows the
    program from the program's own state there: it cannot follow the chain
    of thousands of steps, whose bits differ from run to run (the
    projection adds by atomics).

For a state field the number is the widest gap to the reference over the
reference's widest change in that step (u and v, T, dp, every tracer,
the three accumulators), for phi over its widest value, for the
start over each field's widest value. Each number has its limit in
``limits/<cell>.json``.

``control`` puts the reference computed in TF32 (``reference/tf32.py``) in
the program's place, from the same inputs the program had at each
position; its numbers are judged the same way.
"""
from __future__ import annotations

import torch

from .reference import layout, step as ref
from .reference.tf32 import TF32

FIELDS = ("u", "v", "T", "dp")
ACC = ("vn0u", "vn0v", "omg")
# tracers the reference advances at a time: bounds the memory its tracer
# substep holds (a float64 copy of 35 tracers is 1.7 GB at ne30 x 72)
TRACER_BLOCK = 7


def _gap(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor) -> float:
    a = a.to(b.dtype)
    d = (a - b).abs().max()
    if not bool(torch.isfinite(d)):
        return float("inf")
    return float(d / scale.abs().max())


def step_numbers(inp: dict, ref_out: dict, ref_phi, out: dict,
                 phi) -> dict:
    """The numbers of one checked step: ``out``/``phi`` judged against the
    reference's ``ref_out``/``ref_phi`` from the input ``inp``."""
    def inc(k):
        return _gap(out[k], ref_out[k], ref_out[k] - inp[k])

    return {"uv": max(inc("u"), inc("v")), "T": inc("T"), "dp": inc("dp"),
            "q": inc("q"), "phi": _gap(phi, ref_phi, ref_phi),
            "acc": max(inc(k) for k in ACC)}


def start_number(ref0: dict, cand0: dict) -> float:
    return max(_gap(cand0[k], ref0[k], ref0[k]) for k in FIELDS + ("q",))


def from_capture(cap: dict, nelem: int, nlev: int, dtype,
                 device) -> tuple:
    """A captured state (packed, float32) as the reference's field dict
    with every tracer, and phi where the capture holds one."""
    def f(x):
        return layout.unpack(x, nelem).to(device=device, dtype=dtype)

    st = {k: v.to(device=device, dtype=dtype) for k, v in
          layout.unpack_state(cap["s"], nelem, nlev).items()}
    st["q"] = layout.unpack_tracers(cap["qdp"], nelem, nlev) \
        .to(device=device, dtype=dtype)
    for k in ACC:
        st[k] = f(cap[k])
    return st, (f(cap["phi"]) if "phi" in cap else None)


def initial_state(S: ref.Sphere, raw: dict) -> tuple:
    """The reference's own initial state from the raw arrays: projected,
    zero accumulators; and the constant fields."""
    def p(x):
        return S.project(x.to(S.dtype))

    st = {k: p(raw[k]) for k in FIELDS}
    st["q"] = p(raw["q"])
    for k in ACC:
        st[k] = torch.zeros_like(st["u"])
    consts = dict(phis=raw["phis"].to(S.dtype),
                  pecnd=torch.zeros_like(st["u"]))
    return st, consts


def readings(grid: dict, levels: dict, config: dict, rsplit: int, raw: dict,
             caps: dict, device, control: bool = False,
             tracer_block: int = TRACER_BLOCK) -> dict:
    """The check's numbers for the program's captures ``caps`` (keys
    start, first, in, out, out2), or with ``control`` for the reference in
    TF32 put in the program's place. Every tracer is judged."""
    nelem, nlev = grid["nelem"], int(config["nlev"])
    torch.backends.cuda.matmul.allow_tf32 = False
    S = ref.Sphere(grid, torch.float64, device)
    r0, consts = initial_state(S, raw)
    target = ref.air_mass(S, r0["dp"])

    def load(key):
        return from_capture(caps[key], nelem, nlev, torch.float64, device)

    if control:
        S32 = ref.Sphere(grid, torch.float32, device)
        consts32 = {k: v.float() for k, v in consts.items()}
        with TF32():
            c0, _ = initial_state(S32, {k: v.float() for k, v in
                                        raw.items()})
            cmass = ref.air_mass(S32, c0["dp"])

        def candidate(key, inp, remap_step):
            """The control's output of the step from ``inp`` (its own
            initial state for the first step)."""
            st = c0 if inp is None else {k: v.float() for k, v in
                                         inp.items()}
            with TF32():
                return ref.model_step(S32, levels, st, consts32, config,
                                      remap_step, cmass, tracer_block)
        start = c0
    else:
        def candidate(key, inp, remap_step):
            return load(key)
        start = load("start")[0]
    nums = {"start": start_number(r0, start)}
    del start
    # (name, the capture the program's output is in, its input's capture)
    for name, key, src in (("first", "first", None), ("step", "out", "in"),
                           ("remap", "out2", "out")):
        remap_step = (1 % rsplit == 0) if name == "first" \
            else name == "remap"
        inp = r0 if src is None else load(src)[0]
        out, phi = ref.model_step(S, levels, inp, consts, config,
                                  remap_step, target, tracer_block)
        cand, cphi = candidate(key, None if src is None else inp,
                               remap_step)
        for k, v in step_numbers(inp, out, phi, cand, cphi).items():
            nums[f"{name}.{k}"] = v
        del inp, out, phi, cand, cphi
    return nums


def verdict(nums: dict, limits: dict) -> bool:
    """Every number at or under its limit; a number without a limit, or a
    limit without its number, fails."""
    if set(nums) != set(limits):
        return False
    return all(nums[k] <= limits[k] for k in nums)
