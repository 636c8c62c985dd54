"""The device mesh of the multi-device steps (counterpart of
``jax.sharding.Mesh``, of ``shard_map``'s collectives and of
``tinman_sandbox_tpu/dist/sharding.py::make_mesh``).

A mesh has ``n`` shards, on one axis or, a ``LocalMesh``, on several named
axes (``mesh.shape``, ``mesh.axis_names``; a shard's index is row-major in
its coordinates, ``mesh.coords``). The port writes each multi-device step
once, as phases: a per-shard producer, a collective, a per-shard finish.
Values that differ by shard travel as Python lists, one tensor for each
shard this process holds (``mesh.shards``: shard indices, in order), and the
collectives take and return such lists with the semantics of JAX's. Each
runs over the whole mesh, or on a ``LocalMesh`` with ``axis=`` along one
named axis: within each line of shards that differ only in that
coordinate, in its order.

  * ``ppermute(xs, pairs)``: shard ``dst`` receives ``xs`` of shard ``src``
    for each ``(src, dst)`` (positions on the axis with ``axis=``); a shard
    that receives nothing gets zeros;
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

The element-sharded tiers (``dist/halo.py``, ``dist/halo_ppermute.py``,
``dist/overlap.py``) split ``State`` / ``Derived`` / ``Geometry`` on the
element axis into contiguous shards (``shard_problem``, back with
``unshard``); hvcoord, ``dvv`` and the plans are the same on every shard
(``replicate``).

The GSPMD axes of the JAX package's tests (tests/test_sharding_axes.py)
take any named axis and any array dimension: ``shard_tensor(mesh, x,
spec)`` with ``spec`` = {axis name: dimension} (JAX's PartitionSpec; an
axis it leaves out replicates; the name None is the whole mesh), ``shard_tree`` for a dataclass by field,
and ``unshard_tensor`` / ``unshard_tree`` back. ``exclusive_prefix`` is the
carry of a scan that crosses shards: each shard gets the sum of the
per-shard totals before it on an axis (or after it, ``reverse``), built on
``all_gather`` so that ``DistMesh`` runs it too (``dist/level_sharded.py``).
"""
from __future__ import annotations

import dataclasses
import math
import warnings

import torch

from ..device import TensorFields, resolve_device

__all__ = ["LocalMesh", "DistMesh", "make_mesh", "shard_problem", "unshard",
           "replicate", "shard_tensor", "unshard_tensor", "shard_tree",
           "unshard_tree", "exclusive_prefix"]

# the element axis of each field (the time-levelled prognostics and qdp lead
# with the time-level axis; dvv has none)
_ELEM_AXIS = {
    "u": 1, "v": 1, "t": 1, "dp3d": 1, "ps_v": 1, "qdp": 1,
    "phis": 0,
    "vn0_u": 0, "vn0_v": 0, "phi": 0, "omega_p": 0,
    "eta_dot_dpdn": 0, "pecnd": 0,
    "fcor": 0, "metdet": 0, "rmetdet": 0, "spheremp": 0, "rspheremp": 0,
    "d": 0, "dinv": 0, "mp": 0, "metinv": 0, "vec_sph2cart": 0,
    "dvv": None,
}


class LocalMesh:
    """All ``n`` shards of the mesh in this process, on ``device``. ``n`` is
    a shard count (one axis) or a shape such as (4, 2), whose axes
    ``axis_names`` names (default "x" for one axis)."""

    def __init__(self, n, device=None, axis_names=None):
        shape = (n,) if isinstance(n, int) else tuple(n)
        if not shape or min(shape) < 1:
            raise ValueError(f"a mesh needs n >= 1 shards, got {n}")
        names = tuple(axis_names) if axis_names is not None else \
            (("x",) if len(shape) == 1 else None)
        if names is None or len(names) != len(shape) \
                or len(set(names)) != len(names):
            raise ValueError(f"a mesh of shape {shape} needs "
                             f"{len(shape)} distinct axis names, got "
                             f"{axis_names}")
        self.shape, self.axis_names = shape, names
        self.n = math.prod(shape)
        self.device = resolve_device("cuda" if device is None else device)
        self.shards = list(range(self.n))

    def coords(self, shard: int) -> tuple:
        """The shard's coordinate on each axis."""
        return _coords(self.shape, shard)

    def axis_index(self, shard: int, axis=None) -> int:
        """The shard's position on ``axis`` (None: its index)."""
        return shard if axis is None else \
            self.coords(shard)[self._axis(axis)]

    def axis_size(self, axis=None) -> int:
        return self.n if axis is None else self.shape[self._axis(axis)]

    def _axis(self, axis) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"the mesh has axes {self.axis_names}, not "
                             f"{axis!r}")
        return self.axis_names.index(axis)

    def _lines(self, axis):
        """The groups of shards a collective on ``axis`` runs within, each
        in its order on the axis."""
        if axis is None:
            return [self.shards]
        a = self._axis(axis)
        lines = {}
        for s in self.shards:
            c = self.coords(s)
            lines.setdefault(c[:a] + c[a + 1:], []).append(s)
        return list(lines.values())

    def _check(self, xs):
        if len(xs) != self.n:
            raise ValueError(f"LocalMesh({self.n}): expected {self.n} "
                             f"tensors, got {len(xs)}")

    def ppermute(self, xs, pairs, axis=None):
        self._check(xs)
        out = [None] * self.n
        for line in self._lines(axis):
            for src, dst in pairs:
                if out[line[dst]] is not None:
                    raise ValueError(f"ppermute: shard {line[dst]} receives "
                                     "twice")
                out[line[dst]] = xs[line[src]]
        return [torch.zeros_like(x) if o is None else o
                for x, o in zip(xs, out)]

    def all_gather(self, xs, axis=None):
        self._check(xs)
        out = [None] * self.n
        for line in self._lines(axis):
            g = torch.stack([xs[s] for s in line])
            for s in line:
                out[s] = g
        return out

    def psum(self, xs, axis=None):
        self._check(xs)
        out = [None] * self.n
        for line in self._lines(axis):
            total = xs[line[0]].clone()
            for s in line[1:]:
                total += xs[s]
            for s in line:
                out[s] = total
        return out


def _coords(shape, shard: int) -> tuple:
    out = []
    for size in reversed(shape):
        out.append(shard % size)
        shard //= size
    return tuple(reversed(out))


class DistMesh:
    """One shard per rank of a ``torch.distributed`` process group (the
    default group if None): shard index = rank, on one axis; its
    collectives run over the whole mesh (``axis`` None)."""

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

    def axis_index(self, shard: int, axis=None) -> int:
        self._axis(axis)
        return shard

    def axis_size(self, axis=None) -> int:
        self._axis(axis)
        return self.n

    def _axis(self, axis) -> None:
        if axis is not None:
            raise ValueError(f"DistMesh has one axis: axis None, not "
                             f"{axis!r}")

    def _one(self, xs):
        if len(xs) != 1:
            raise ValueError(f"DistMesh: expected this rank's one tensor, "
                             f"got {len(xs)}")
        return xs[0].contiguous()

    def _peer(self, shard):
        return shard if self.group is None else \
            self._dist.get_global_rank(self.group, shard)

    def ppermute(self, xs, pairs, axis=None):
        self._axis(axis)
        x = self._one(xs)
        d = self._dist
        out, ops = None, []
        for src, dst in pairs:
            if src == dst == self.rank:          # a self-send: a local copy
                if out is not None:
                    raise ValueError(f"ppermute: shard {dst} receives twice")
                out = x.clone()
                continue
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

    def all_gather(self, xs, axis=None):
        self._axis(axis)
        x = self._one(xs)
        # shards concatenated on the leading axis (gloo's layout), then
        # viewed stacked; newer torch calls this all_gather_single
        g = x.new_empty(self.n * x.shape[0], *x.shape[1:])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            self._dist.all_gather_into_tensor(g, x, group=self.group)
        return [g.view(self.n, *x.shape)]

    def psum(self, xs, axis=None):
        self._axis(axis)
        x = self._one(xs).clone()
        self._dist.all_reduce(x, group=self.group)
        return [x]


def make_mesh(n: int, device=None) -> LocalMesh:
    """An n-shard mesh on one device (counterpart of ``make_mesh`` of the
    JAX package's ``dist/sharding.py``, there over n devices)."""
    return LocalMesh(n, device)


def _fields(tree):
    return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)]


def shard_problem(mesh, *trees):
    """Split dataclasses of tensors (``State``, ``Derived``, ``Geometry``)
    on their element axis (``_ELEM_AXIS``, 0 for a field it does not name)
    into ``mesh.n`` contiguous shards. Returns, for each tree, the list of
    the shards this process holds (``mesh.shards``), on ``mesh.device``;
    one list alone for one tree."""
    out = []
    for tree in trees:
        per = [{} for _ in mesh.shards]
        for name, x in _fields(tree):
            ax = _ELEM_AXIS.get(name, 0)
            x = x.to(mesh.device)
            if ax is None:
                for p in per:
                    p[name] = x
                continue
            if x.shape[ax] % mesh.n:
                raise ValueError(f"shard_problem: {name} has "
                                 f"{x.shape[ax]} elements, not a multiple "
                                 f"of {mesh.n} shards")
            parts = x.chunk(mesh.n, dim=ax)
            for p, s in zip(per, mesh.shards):
                p[name] = parts[s].contiguous()
        out.append([dataclasses.replace(tree, **p) for p in per])
    return out[0] if len(out) == 1 else tuple(out)


def unshard(mesh, *shard_lists):
    """The inverse of ``shard_problem``: each list of shards (one tree a
    shard this process holds) put back together on the element axis, the
    whole tree on every process (a ``DistMesh`` gathers it)."""
    out = []
    for shards in shard_lists:
        whole = {}
        for name, _ in _fields(shards[0]):
            ax = _ELEM_AXIS.get(name, 0)
            xs = [getattr(s, name) for s in shards]
            if ax is None:
                whole[name] = xs[0]
                continue
            g = mesh.all_gather(xs)[0]               # [n, *shard shape]
            whole[name] = torch.cat(list(g.unbind(0)), dim=ax)
        out.append(dataclasses.replace(shards[0], **whole))
    return out[0] if len(out) == 1 else tuple(out)


def replicate(mesh, tree):
    """The same ``tree`` for every shard this process holds: a dataclass of
    tensors (hvcoord, a geometry's ``dvv``) or a tensor moved to
    ``mesh.device``, anything else (a host plan) as it is."""
    if isinstance(tree, (torch.Tensor, TensorFields)):
        tree = tree.to(mesh.device)
    return [tree] * len(mesh.shards)


def shard_tensor(mesh, x: torch.Tensor, spec: dict) -> list:
    """The shards of ``x`` this process holds, on ``mesh.device``: for each
    {axis name: dimension} of ``spec`` the dimension cut into the axis's
    size contiguous parts, the shard taking the part at its position on
    the axis (a dimension must divide); replicated over the axes ``spec``
    leaves out (``{}``: the whole tensor on every shard)."""
    x = x.to(mesh.device)
    for axis, dim in spec.items():
        if x.shape[dim] % mesh.axis_size(axis):
            raise ValueError(f"shard_tensor: dimension {dim} of "
                             f"{tuple(x.shape)} does not split over the "
                             f"{mesh.axis_size(axis)} shards of {axis!r}")
    out = []
    for s in mesh.shards:
        part = x
        for axis, dim in spec.items():
            part = part.chunk(mesh.axis_size(axis), dim=dim)[
                mesh.axis_index(s, axis)]
        out.append(part.contiguous())
    return out


def unshard_tensor(mesh, xs: list, spec: dict) -> torch.Tensor:
    """The inverse of ``shard_tensor``: the whole tensor, gathered along
    each axis of ``spec`` (on every process of a ``DistMesh``)."""
    for axis, dim in spec.items():
        xs = [torch.cat(list(g.unbind(0)), dim=dim)
              for g in mesh.all_gather(xs, axis)]
    return xs[0]


def shard_tree(mesh, tree, specs: dict) -> list:
    """A dataclass of tensors cut by field: ``specs`` maps a field's name to
    its ``shard_tensor`` spec (a field it leaves out is replicated). Returns
    the list of shards this process holds."""
    per = [{} for _ in mesh.shards]
    for name, x in _fields(tree):
        for p, part in zip(per, shard_tensor(mesh, x, specs.get(name, {}))):
            p[name] = part
    return [dataclasses.replace(tree, **p) for p in per]


def unshard_tree(mesh, shards: list, specs: dict):
    """The inverse of ``shard_tree``."""
    return dataclasses.replace(shards[0], **{
        name: unshard_tensor(mesh, [getattr(s, name) for s in shards],
                             specs.get(name, {}))
        for name, _ in _fields(shards[0])})


def exclusive_prefix(mesh, xs: list, axis=None, reverse: bool = False):
    """The carry of a scan across shards: for each shard this process holds,
    the sum of the tensors ``xs`` of the shards before it on ``axis`` (None:
    the whole mesh), zeros on the first; with ``reverse`` of the shards
    after it, zeros on the last. The sums run from the far end in towards
    the shard (the order a scan from that end adds them). Built on
    ``mesh.all_gather``."""
    out = []
    for s, x, g in zip(mesh.shards, xs, mesh.all_gather(xs, axis)):
        i = mesh.axis_index(s, axis)
        parts = list(g[i + 1:].flip(0)) if reverse else list(g[:i])
        total = torch.zeros_like(x)
        for part in parts:
            total = total + part
        out.append(total)
    return out
