"""The whole cadence step, what no implementation can avoid: the state
(4 nlev rows), the tracers (qsize) and the three accumulators read and
written once, pecnd and the 16 meta rows read once, phi written once; and
every layer's operations (``caar``, ``tracer``, ``dss``, ``vlap``,
``remap``).
"""
from benchmark.work import ROW, caar, dss, remap, tracer, vlap


def work(shape: dict) -> dict:
    e16, k, q = shape["nelem"] * 16, shape["nlev"], shape["qsize"]
    rows = 2 * (4 * k + q * k + 3 * k) + k + 16 + k
    ops = sum(m.work(shape)["flops"]
              for m in (caar, tracer, dss, vlap, remap))
    return dict(bytes=rows * e16 * ROW, flops=ops)
