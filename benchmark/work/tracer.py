"""The tracer kernels: three limited SSPRK3 stages a substep, qsplit
substeps a step. A stage reads the two wind blocks (2 nlev rows), the
stage input (qsize blocks), on stages 2 and 3 the substep's input for the
Shu-Osher combination (qsize), and 7 meta rows (Dinv, metdet, rmetdet,
spheremp); it writes the stage output (qsize).

Operations a point, level and tracer of a stage: v q 2, the metric
combination 8, the two contractions and their sum 17, the rmetdet and
rrearth scale 2, the Euler update 2, the element bounds 2, the element
mass 2, two limiter passes of 12 (clip 2, clipped-off mass 3, room 1,
room's mass 2, share 1, update 3), the residual pass 3, the spheremp fold
1: 63; the combination adds 3 on stages 2 and 3.
"""
from benchmark.work import ROW

OPS = 63
MIX_OPS = 3


def work(shape: dict) -> dict:
    e16, k, q = shape["nelem"] * 16, shape["nlev"], shape["qsize"]
    sub = max(int(shape["qsplit"]), 1)
    rows = 3 * (2 * k + 2 * q * k + 7) + 2 * q * k
    ops = (3 * OPS + 2 * MIX_OPS) * q * k
    return dict(bytes=sub * rows * e16 * ROW, flops=sub * ops * e16)
