"""Device time a step of the operations that no kernel-name map in
``metrics/`` claims: PyTorch's own kernels on the path (the fixer's sum
and scale, the stage weight's copy and product, copies). Each such
kernel is named on standard error, so that a renamed or new kernel shows.
"""
import re


def read(ctx):
    rx = [re.compile(p) for p in ctx.claimed()]
    tot, names = 0.0, {}
    for t0, t1, name in ctx.trace.device_ops:
        if not any(r.search(name) for r in rx):
            tot += t1 - t0
            names[name] = names.get(name, 0) + 1
    for name, n in sorted(names.items()):
        ctx.note(f"unclaimed: {n} x {name[:160]}")
    return tot * 1e-3 / ctx.trace.steps if names else None
