"""The DSS kernels (the fixup and the sweep of each closer, one layer):
rspheremp * DSS of a producer's output, with the Shu-Osher or
hyperviscosity combination where the step carries one. A closer reads its
R rows, the two rspheremp rows and, with a combination, the R rows it
mixes in, and writes R rows. A step's closers: three on the dynamics'
4 nlev rows (stages 2 and 3 mix in s0), per hyperviscosity subcycle two on
3 nlev rows (the second mixes in the state), per tracer substep three on
qsize nlev rows (no combination: the limited stage carries it).

Operations a row and lane: the sum over a dof's aliases (at most 3 adds,
about 0.43 a lane on the cubed sphere; counted 1), the two-float rspheremp
scale 3, the spheremp fold of the producer 1: 5, and 3 for a combination.
"""
from benchmark.work import ROW

OPS, MIX_OPS = 5, 3


def work(shape: dict) -> dict:
    e16, k, q = shape["nelem"] * 16, shape["nlev"], shape["qsize"]
    sub = max(int(shape["qsplit"]), 1)
    hv = int(shape["subcycle"])
    # (rows, mixes) of each closer
    closers = [(4 * k, False), (4 * k, True), (4 * k, True)] \
        + hv * [(3 * k, False), (3 * k, True)] + 3 * sub * [(q * k, False)]
    rows = sum(r * (3 if mix else 2) + 2 for r, mix in closers)
    ops = sum(r * (OPS + (MIX_OPS if mix else 0)) for r, mix in closers)
    return dict(bytes=rows * e16 * ROW, flops=ops * e16)
