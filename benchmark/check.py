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

The captures are in host memory (``capture.py``). The fields other than
the tracers come to the card in float64 whole; the tracers come
``block_size`` at a time, are advanced by the reference, judged and
dropped. A tracer number's widest gap and widest change are each taken
over all blocks before the one division, so it is the number of the whole
array, bit for bit.

``control`` puts the reference computed in TF32 (``reference/tf32.py``) in
the program's place, from the same inputs the program had at each
position; its numbers are judged the same way.
"""
from __future__ import annotations

import torch

from .reference import layout, step as ref
from .reference.tf32 import TF32, round_tf32

FIELDS = ("u", "v", "T", "dp")
ACC = ("vn0u", "vn0v", "omg")
# tracers the reference holds at a time, fewer where a block of them in
# float64 would pass BLOCK_BYTES: bounds what the tracer substep holds (a
# float64 copy of 35 tracers is 1.7 GB at ne30 x 72, 27.9 GB at ne120)
TRACER_BLOCK = 7
BLOCK_BYTES = 2 ** 30


def block_size(nelem: int, nlev: int) -> int:
    return max(1, min(TRACER_BLOCK, BLOCK_BYTES // (nelem * nlev * 16 * 8)))


class Widest:
    """A field's widest gap to the reference and the widest scale, over
    the blocks ``add`` is given; ``number`` divides them once."""

    def __init__(self):
        self.gap = self.scale = None

    def add(self, a: torch.Tensor, b: torch.Tensor,
            scale: torch.Tensor) -> None:
        gap = (a.to(b.dtype) - b).abs().max()
        scale = scale.abs().max()
        if self.gap is not None:
            gap = torch.maximum(self.gap, gap)
            scale = torch.maximum(self.scale, scale)
        self.gap, self.scale = gap, scale

    def number(self) -> float:
        if not bool(torch.isfinite(self.gap)):
            return float("inf")
        return float(self.gap / self.scale)


def _gap(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor) -> float:
    w = Widest()
    w.add(a, b, scale)
    return w.number()


def step_numbers(inp: dict, ref_out: dict, ref_phi, out: dict, phi,
                 q: Widest | None = None) -> dict:
    """The numbers of one checked step: ``out``/``phi`` judged against the
    reference's ``ref_out``/``ref_phi`` from the input ``inp``; the
    tracers' number from ``q`` where they were judged block by block, else
    from the dicts' "q"."""
    def inc(k):
        return _gap(out[k], ref_out[k], ref_out[k] - inp[k])

    if q is None:
        q = Widest()
        q.add(out["q"], ref_out["q"], ref_out["q"] - inp["q"])
    return {"uv": max(inc("u"), inc("v")), "T": inc("T"), "dp": inc("dp"),
            "q": q.number(), "phi": _gap(phi, ref_phi, ref_phi),
            "acc": max(inc(k) for k in ACC)}


def start_number(ref0: dict, cand0: dict, q: Widest | None = None) -> float:
    if q is None:
        q = Widest()
        q.add(cand0["q"], ref0["q"], ref0["q"])
    return max([_gap(cand0[k], ref0[k], ref0[k]) for k in FIELDS]
               + [q.number()])


def from_capture(cap: dict, nelem: int, nlev: int, dtype,
                 device) -> tuple:
    """A captured state (packed float32, in host memory) as the
    reference's fields but the tracers, phi where the capture holds one,
    and ``tracers(b, n)``: tracers b to b + n - 1 [nelem, n, nlev, 4, 4],
    moved to ``device`` and converted when asked."""
    def f(x):
        return layout.unpack(x.to(device), nelem).to(dtype)

    st = {k: f(cap["s"][i * nlev:(i + 1) * nlev])
          for i, k in enumerate(FIELDS)}
    for k in ACC:
        st[k] = f(cap[k])

    def tracers(b, n):
        rows = cap["qdp"][b * nlev:(b + n) * nlev].to(device)
        return layout.unpack_tracers(rows, nelem, nlev).to(dtype)

    return st, (f(cap["phi"]) if "phi" in cap else None), tracers


def initial_state(S: ref.Sphere, raw: dict) -> tuple:
    """The reference's own initial state from the raw arrays but the
    tracers (``initial_tracers``): projected, zero accumulators; and the
    constant fields."""
    def p(x):
        return S.project(x.to(S.dtype))

    st = {k: p(raw[k]) for k in FIELDS}
    for k in ACC:
        st[k] = torch.zeros_like(st["u"])
    consts = dict(phis=raw["phis"].to(S.dtype),
                  pecnd=torch.zeros_like(st["u"]))
    return st, consts


def initial_tracers(S: ref.Sphere, raw_q: torch.Tensor, b: int, n: int):
    """Tracers b to b + n - 1 of the reference's initial state."""
    return S.project(raw_q[:, b:b + n].to(S.dtype))


def readings(grid: dict, levels: dict, config: dict, rsplit: int, draw,
             caps: dict, device, control: bool = False,
             tracer_block: int | None = None) -> dict:
    """The check's numbers for the program's captures ``caps`` (keys
    start, first, in, out, out2), or with ``control`` for the reference in
    TF32 put in the program's place. ``draw()`` gives the raw inputs on
    ``device``; they are dropped once the first step is judged. Every
    tracer is judged, ``tracer_block`` (default ``block_size``) at a
    time."""
    nelem, nlev = grid["nelem"], int(config["nlev"])
    nq = int(config["qsize"])
    blk = tracer_block or block_size(nelem, nlev)
    blocks = [(b, min(blk, nq - b)) for b in range(0, nq, blk)]
    torch.backends.cuda.matmul.allow_tf32 = False
    S = ref.Sphere(grid, torch.float64, device)
    raw = draw()
    r0, consts = initial_state(S, raw)
    target = ref.air_mass(S, r0["dp"])

    def load(key):
        return from_capture(caps[key], nelem, nlev, torch.float64, device)

    if control:
        S32 = ref.Sphere(grid, torch.float32, device)
        consts32 = {k: v.float() for k, v in consts.items()}
        with TF32():
            c0, _ = initial_state(S32, {k: v.float() for k, v in raw.items()
                                        if k != "q"})
            cmass = ref.air_mass(S32, c0["dp"])

        def c0_tracers(b, n):
            with TF32():
                return initial_tracers(S32, raw["q"], b, n)

        def candidate(key, inp, inp_q, remap_step):
            """The control's step from the program's input ``inp``,
            ``inp_q`` (its own initial state for the first step): the
            fields, phi and tracers(b, n, the reference's input block)."""
            if inp is None:
                st32, moist = c0, c0_tracers(0, 1)

                def q32(b, n, x):
                    return c0_tracers(b, n)
            else:
                st32 = {k: v.float() for k, v in inp.items()}
                moist = inp_q(0, 1).float()

                def q32(b, n, x):
                    return x.float()
            with TF32():
                a = ref.air_step(S32, levels, st32, moist[:, 0], consts32,
                                 config, remap_step, cmass)

            def tracers(b, n, x):
                # read in TF32, as the whole array's slices were
                q = round_tf32(q32(b, n, x))
                with TF32():
                    return ref.tracer_step(S32, a, q)
            return a.out, a.phi, tracers
        start, start_q = c0, c0_tracers
    else:
        def candidate(key, inp, inp_q, remap_step):
            st, phi, tracers = load(key)
            return st, phi, (lambda b, n, _: tracers(b, n))
        start, _, start_q = load("start")

    def r0_tracers(b, n):
        return initial_tracers(S, raw["q"], b, n)

    nums = {}
    # (name, the capture the program's output is in, its input's capture)
    for name, key, src in (("first", "first", None), ("step", "out", "in"),
                           ("remap", "out2", "out")):
        remap_step = (1 % rsplit == 0) if name == "first" \
            else name == "remap"
        if src is None:
            inp, inp_q = r0, r0_tracers
        else:
            inp, _, inp_q = load(src)
        a = ref.air_step(S, levels, inp, inp_q(0, 1)[:, 0], consts, config,
                         remap_step, target)
        cand, cphi, cand_q = candidate(key, None if src is None else inp,
                                       inp_q, remap_step)
        q = Widest()
        q0 = Widest()
        for b, n in blocks:
            x = inp_q(b, n)
            y = ref.tracer_step(S, a, x)
            q.add(cand_q(b, n, x), y, y - x)
            if src is None:
                # the start's tracers: the first step's input
                q0.add(start_q(b, n), x, x)
            del x, y
        if src is None:
            nums["start"] = start_number(r0, start, q0)
            del r0, start, start_q, raw
        for k, v in step_numbers(inp, a.out, a.phi, cand, cphi, q).items():
            nums[f"{name}.{k}"] = v
        del inp, inp_q, a, cand, cphi, cand_q
    return nums


def verdict(nums: dict, limits: dict) -> bool:
    """Every number at or under its limit; a number without a limit, or a
    limit without its number, fails."""
    if set(nums) != set(limits):
        return False
    return all(nums[k] <= limits[k] for k in nums)
