"""The hyperviscosity kernel: per subcycle two weak Laplacians of the
(u, v, T) rows, each reading 3 nlev rows and writing 3 (meta left out, as
the port's bench counts them). Operations a point and level: the scalar
Laplacian 50 (a gradient 24, the weak divergence 26), the vector one 116
(divergence 27, vorticity 25, the weak gradient 33, the weak curl 25, the
rigid-rotation term 6): 166.
"""
from benchmark.work import ROW

OPS = 166


def work(shape: dict) -> dict:
    e16, k = shape["nelem"] * 16, shape["nlev"]
    n = 2 * int(shape["subcycle"])
    return dict(bytes=n * 6 * k * e16 * ROW, flops=n * OPS * k * e16)
