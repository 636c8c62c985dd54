"""A cell at a size a CPU test holds: the repository's cell files with the
grid, the levels and the tracers cut."""
from __future__ import annotations

import copy

from benchmark import spec

NAMES = ["start"] + [f"{p}.{k}" for p in ("first", "step", "remap")
                     for k in ("uv", "T", "dp", "q", "phi", "acc")]


def cell(name="ne30_e3sm_q35", ne=2, nlev=8, qsize=3) -> spec.Cell:
    c = copy.deepcopy(spec.load_cell(name))
    c.config.update(ne=ne, nelem=6 * ne * ne, nlev=nlev, qsize=qsize)
    c.traffic.update(sample_within=12, trace_steps=6)
    return c
