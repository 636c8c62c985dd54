"""The dynamics kernel: three SSPRK3 stages a step, each one CAAR
evaluation and update. A stage reads the stage's state (4 nlev rows), the
moisture tracer and pecnd (1 + 1) and the three accumulators (3), and
writes the updated state (4), the accumulators (3) and, on the last
stage, phi (1). Its meta rows are left out, as the port's bench counts
them (``work/step.py`` counts them once a step).

Operations a point and level of a stage (caar_rhs): midpoint pressure 4,
grad p 24, v.grad p 3, u dp and v dp 2, div(v dp) 27, vorticity 25,
virtual temperature 4, geopotential 8, omega_p 6, the kinetic-plus-
geopotential energy 6, grad T 24, grad of that energy 24, the pressure
term and f + vorticity 3, the four tendencies 15, the stage update 8, the
accumulators 6: 189.
"""
from benchmark.work import ROW

OPS = 189


def work(shape: dict) -> dict:
    e16, k = shape["nelem"] * 16, shape["nlev"]
    rows = 3 * 9 * k + 3 * 7 * k + k
    return dict(bytes=rows * e16 * ROW, flops=3 * OPS * k * e16)
