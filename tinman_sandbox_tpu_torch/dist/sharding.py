"""The device mesh of the multi-device steps (counterpart of
``jax.sharding.Mesh``, of ``shard_map``'s collectives and of
``tinman_sandbox_tpu/dist/sharding.py::make_mesh``).

A mesh has ``n`` shards on one axis. The port writes each multi-device step
once, as phases: a per-shard producer, a collective, a per-shard finish.
Values that differ by shard travel as Python lists, one tensor for each
shard this process holds (``mesh.shards``: shard indices, in order), and the
collectives take and return such lists with the semantics of JAX's:

  * ``ppermute(xs, pairs)``: shard ``dst`` receives ``xs`` of shard ``src``
    for each ``(src, dst)``; a shard that receives nothing gets zeros;
  * ``all_gather(xs)``: every shard gets all shards' tensors stacked in
    shard order, [n, *shape];
  * ``psum(xs)``: every shard gets the sum over all shards.

Two meshes serve them:

  * ``LocalMesh(n, device=None)`` holds all n shards in one process on one
    device, the card unless the caller asks for the CPU (the analog of JAX's
    virtual 8-device CPU mesh). Its collectives are device-local copies and
    sums; a step over it launches each kernel once per shard.
  * ``DistMesh(group=None)`` runs over ``torch.distributed``, one shard per
    rank, lists of length 1: ``gloo`` on the CPU, ``nccl`` across cards.
    ``batch_isend_irecv`` serves ``ppermute``, ``all_gather_into_tensor``
    ``all_gather`` and ``all_reduce`` ``psum``. NCCL refuses two ranks on one
    card, so on one H100 only ``LocalMesh`` runs the steps.

The element-sharded tiers of the JAX package (``shard_problem``, the halo
exchanges) are not ported yet.
"""
from __future__ import annotations

import warnings

import torch

from ..device import resolve_device

__all__ = ["LocalMesh", "DistMesh", "make_mesh"]


class LocalMesh:
    """All ``n`` shards of the mesh in this process, on ``device``."""

    def __init__(self, n: int, device=None):
        if n < 1:
            raise ValueError(f"a mesh needs n >= 1 shards, got {n}")
        self.n = n
        self.device = resolve_device("cuda" if device is None else device)
        self.shards = list(range(n))

    def _check(self, xs):
        if len(xs) != self.n:
            raise ValueError(f"LocalMesh({self.n}): expected {self.n} "
                             f"tensors, got {len(xs)}")

    def ppermute(self, xs, pairs):
        self._check(xs)
        out = [None] * self.n
        for src, dst in pairs:
            if out[dst] is not None:
                raise ValueError(f"ppermute: shard {dst} receives twice")
            out[dst] = xs[src]
        return [torch.zeros_like(x) if o is None else o
                for x, o in zip(xs, out)]

    def all_gather(self, xs):
        self._check(xs)
        g = torch.stack(xs)
        return [g] * self.n

    def psum(self, xs):
        self._check(xs)
        total = xs[0].clone()
        for x in xs[1:]:
            total += x
        return [total] * self.n


class DistMesh:
    """One shard per rank of a ``torch.distributed`` process group (the
    default group if None): shard index = rank."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.shards = [self.rank]
        self.device = torch.device("cpu") \
            if dist.get_backend(group) == "gloo" else \
            torch.device("cuda", torch.cuda.current_device())

    def _one(self, xs):
        if len(xs) != 1:
            raise ValueError(f"DistMesh: expected this rank's one tensor, "
                             f"got {len(xs)}")
        return xs[0].contiguous()

    def _peer(self, shard):
        return shard if self.group is None else \
            self._dist.get_global_rank(self.group, shard)

    def ppermute(self, xs, pairs):
        x = self._one(xs)
        d = self._dist
        out, ops = None, []
        for src, dst in pairs:
            if src == self.rank:
                ops.append(d.P2POp(d.isend, x, self._peer(dst), self.group))
            if dst == self.rank:
                if out is not None:
                    raise ValueError(f"ppermute: shard {dst} receives twice")
                out = torch.empty_like(x)
                ops.append(d.P2POp(d.irecv, out, self._peer(src),
                                   self.group))
        if ops:
            for req in d.batch_isend_irecv(ops):
                req.wait()
        return [torch.zeros_like(x) if out is None else out]

    def all_gather(self, xs):
        x = self._one(xs)
        # shards concatenated on the leading axis (gloo's layout), then
        # viewed stacked; newer torch calls this all_gather_single
        g = x.new_empty(self.n * x.shape[0], *x.shape[1:])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            self._dist.all_gather_into_tensor(g, x, group=self.group)
        return [g.view(self.n, *x.shape)]

    def psum(self, xs):
        x = self._one(xs).clone()
        self._dist.all_reduce(x, group=self.group)
        return [x]


def make_mesh(n: int, device=None) -> LocalMesh:
    """An n-shard mesh on one device (counterpart of ``make_mesh`` of the
    JAX package's ``dist/sharding.py``, there over n devices)."""
    return LocalMesh(n, device)
