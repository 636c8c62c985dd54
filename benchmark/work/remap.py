"""The remap kernel, every rsplit-th step (amortised over the steps): it
reads the state (4 nlev rows) and the tracers (qsize) and writes them
remapped. Operations a point, level and remapped field (u, v, T, each
tracer): the interfaces 2, the minmod slope 8, the integral at a target
interface 10, the difference and division 2, the mixing ratio and back 3:
25.
"""
from benchmark.work import ROW

OPS = 25


def work(shape: dict) -> dict:
    e16, k, q = shape["nelem"] * 16, shape["nlev"], shape["qsize"]
    per = 1.0 / max(int(shape["rsplit"]), 1)
    return dict(bytes=per * 2 * (4 + q) * k * e16 * ROW,
                flops=per * OPS * (3 + q) * k * e16)
