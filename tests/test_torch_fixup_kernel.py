"""The tiled DSS fixup kernel (``csrc/dss.cu``, ``dss_fixup_kernel``) on the
CPU, through the emulation of its index walk in ``kernels/dss.py`` (the
kernel itself runs only on the card, where ``chip_smoke.py`` phases 4, 9 and
11 hold it bit for bit to its plain version): each block of 32 fix lanes x
32 rows sums into a shared tile and stores it transposed. The walk must
write every element of vd exactly once with the bits of ``dss_fixup_plain``
(the same summands in the same order), on the ne30 tables at ragged and
whole tile heights and on a shard's tables, whose slab is the gathered side
lines (``sharded_t4.shard_fix_tables``).
"""
import functools

import numpy as np
import pytest
import torch

from tinman_sandbox_tpu_torch.config import NPSQ
from tinman_sandbox_tpu_torch.dist import (build_cubed_sphere,
                                           make_structured_plan, rsp_lanes_2f)
from tinman_sandbox_tpu_torch.dist.sharded_t4 import shard_fix_tables
from tinman_sandbox_tpu_torch.kernels.dss import (dss_fixup_emulated,
                                                  dss_fixup_plain, fix_tables)

torch.set_num_threads(2)
NE = 30


@functools.lru_cache(maxsize=None)
def _sphere():
    cs = build_cubed_sphere(NE, dtype=torch.float32, device="cpu")
    plan = make_structured_plan(cs.gdof, NE)
    rsp2 = torch.from_numpy(rsp_lanes_2f(cs.geometry.spheremp, cs.gdof,
                                         cs.ndof))
    return plan, rsp2


def _check(tables, rows, rsp, seed):
    gen = torch.Generator().manual_seed(seed)
    slab = torch.randn(tables.nsrc, rows, generator=gen)
    vd, writes = dss_fixup_emulated(slab, tables, rsp)
    assert torch.equal(writes, torch.ones_like(writes))
    assert torch.equal(vd, dss_fixup_plain(slab, tables, rsp))


@pytest.mark.parametrize("rows", [1, 31, 72, 100])
@pytest.mark.parametrize("nrsp", [1, 2])
def test_torch_fixup_tiles_equal_plain_on_ne30(rows, nrsp):
    """ne30's 2,856 fix lanes (89.25 tiles) at heights below, at and past
    whole tiles, with one or two rspheremp rows."""
    plan, rsp2 = _sphere()
    _check(fix_tables(plan, "cpu"), rows, rsp2[:nrsp].contiguous(),
           rows + nrsp)


@pytest.mark.parametrize("nshard, shard", [(6, 0), (3, 1), (2, 1)])
def test_torch_fixup_tiles_equal_plain_on_a_shard(nshard, shard):
    """A face shard's fixup: its own fix lanes summing rows of the gathered
    side-line slab [24*ne*4, k]."""
    plan, rsp2 = _sphere()
    fl = NE * NE * NPSQ
    lo, hi = shard * (6 // nshard) * fl, (shard + 1) * (6 // nshard) * fl
    tables = shard_fix_tables(plan, lo, hi, "cpu")
    assert tables.nsrc == 24 * NE * 4 != tables.nfix
    _check(tables, 72, rsp2[:, lo:hi].contiguous(), nshard + shard)
