"""Checkpoint and restore of the prognostic state (counterpart of
``tinman_sandbox_tpu/timeloop/checkpoint.py``).

The keys and the ``meta`` encoding (a JSON object as a uint8 array) are the
JAX package's, so a file written by either package loads in the other:

  * ``save_checkpoint`` / ``load_checkpoint``: ``state.<field>`` and
    ``derived.<field>`` arrays, meta {step, n0, np1, nm1, qn0, nlev, qsize,
    nelem};
  * ``save_packed_checkpoint`` / ``load_packed_checkpoint``: the packed
    cadence chain, ``packed.s`` [4*nlev, E16], ``packed.qdp``
    [qsize*nlev, E16] and the accumulators ``packed.vn0u`` / ``vn0v`` /
    ``omg``, meta {step, packed: true} and, where the caller gives it, the
    mass fixer's target {mass_target} (a key JAX's loader ignores; read it
    back with ``checkpoint_meta``).

Every save writes ``<path>.tmp`` and publishes it with ``os.replace``, so a
reader never sees a half-written checkpoint.

The non-blocking directory checkpoint (counterpart of the JAX package's
orbax-backed ``save_checkpoint_orbax`` / ``finish_async_checkpoints`` /
``load_checkpoint_orbax``; orbax's own on-disk format is not read or
written here):

  * ``save_checkpoint_dir``: snapshots the state and derived tensors at the
    call and writes them on a background thread while the time loop runs
    on. A CUDA tensor is copied device-to-host into pinned memory with
    ``non_blocking=True`` on the current stream, so kernels enqueued on that
    stream later, in-place writes included, run after the copy; the writer
    waits on an event recorded behind the copies. A CPU tensor is copied at
    the call. The writer puts ``state.<field>.npy``, ``derived.<field>.npy``
    and ``meta.json`` (the npz form's meta) into ``<path>.tmp/`` and
    publishes the directory by renames: an existing one is replaced (as
    orbax's ``force=True``), and a reader never sees a half-written one.
  * ``finish_async_checkpoints``: waits for every save in flight and
    re-raises the first writer's error.
  * ``load_checkpoint_dir``: ``load_checkpoint``'s contract on a directory.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import Config
from ..device import from_arrays, resolve_device
from ..state import Derived, State

__all__ = ["save_checkpoint", "load_checkpoint", "save_packed_checkpoint",
           "load_packed_checkpoint", "checkpoint_meta", "save_checkpoint_dir",
           "finish_async_checkpoints", "load_checkpoint_dir"]

_STATE_FIELDS = [f.name for f in dataclasses.fields(State)]
_DERIVED_FIELDS = [f.name for f in dataclasses.fields(Derived)]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _meta_array(meta: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8).copy()


def _publish(path: str, arrays: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)          # atomic: never a half-written checkpoint


def _run_meta(cfg: Config, step: int) -> dict:
    return {"step": step, "n0": cfg.n0, "np1": cfg.np1, "nm1": cfg.nm1,
            "qn0": cfg.qn0, "nlev": cfg.nlev, "qsize": cfg.qsize,
            "nelem": cfg.nelem}


def save_checkpoint(path: str, state: State, derived: Derived, cfg: Config,
                    step: int) -> None:
    """Write state, derived and the run's time levels and dimensions to
    ``path`` (.npz)."""
    arrays = {f"state.{n}": _host(getattr(state, n)) for n in _STATE_FIELDS}
    arrays |= {f"derived.{n}": _host(getattr(derived, n))
               for n in _DERIVED_FIELDS}
    arrays["meta"] = _meta_array(_run_meta(cfg, step))
    _publish(path, arrays)


def _restored(meta: dict, arrays, cfg: Config, device):
    """(state, derived, cfg, step) from a checkpoint's meta and its arrays
    by key (``state.<field>``, ``derived.<field>``); raises if its nlev,
    qsize or nelem differ from ``cfg``'s."""
    for dim in ("nlev", "qsize", "nelem"):
        if meta[dim] != getattr(cfg, dim):
            raise ValueError(f"checkpoint {dim}={meta[dim]} != config "
                             f"{dim}={getattr(cfg, dim)}")
    state = from_arrays(State, {n: arrays(f"state.{n}")
                                for n in _STATE_FIELDS}, device=device)
    derived = from_arrays(Derived, {n: arrays(f"derived.{n}")
                                    for n in _DERIVED_FIELDS}, device=device)
    cfg = dataclasses.replace(cfg, n0=meta["n0"], np1=meta["np1"],
                              nm1=meta["nm1"], qn0=meta["qn0"])
    return state, derived, cfg, meta["step"]


def load_checkpoint(path: str, cfg: Config, device="cuda"):
    """Read a checkpoint onto ``device`` (each array in its stored dtype).
    Returns (state, derived, cfg with the stored time levels, step); raises
    if its nlev, qsize or nelem differ from ``cfg``'s."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        return _restored(meta, lambda key: z[key], cfg, device)


# -- the non-blocking directory checkpoint ------------------------------------

# one writer thread: saves land in the order they were asked for
_WRITER: ThreadPoolExecutor | None = None
_PENDING: list = []


def _snapshot(x: torch.Tensor):
    """(host copy of x as it is at the call, x's CUDA device or None): a
    CUDA tensor is copied into pinned memory behind the current stream's
    work (ready once that stream passes the copy), a CPU tensor at once."""
    if x.device.type != "cuda":
        return x.detach().clone(), None
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x.detach(), non_blocking=True)
    return host, x.device


def _write_dir(path: str, snaps: dict, event, meta: dict) -> None:
    """The writer: wait for the copies, write ``<path>.tmp/``, publish."""
    if event is not None:
        event.synchronize()
    tmp, old = path + ".tmp", path + ".old"
    for d in (tmp, old):
        if os.path.isdir(d):
            shutil.rmtree(d)
    os.makedirs(tmp)
    for key, x in snaps.items():
        np.save(os.path.join(tmp, key + ".npy"), x.numpy())
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(path):
        os.replace(path, old)
    os.replace(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def save_checkpoint_dir(path: str, state: State, derived: Derived,
                        cfg: Config, step: int, wait: bool = False) -> None:
    """Checkpoint state, derived and the run's meta into the directory
    ``path`` without blocking (counterpart of ``save_checkpoint_orbax``):
    the tensors are snapshotted as they are at the call and written by a
    background thread while the caller goes on. In-place writes to the
    state after the call do not reach the checkpoint, if they run on the
    current stream (or on the host, for CPU tensors). ``wait=True`` returns
    once this checkpoint is on disk (and raises its writer's error);
    otherwise ``finish_async_checkpoints`` waits."""
    global _WRITER
    snaps, devs = {}, set()
    for prefix, obj, names in (("state", state, _STATE_FIELDS),
                               ("derived", derived, _DERIVED_FIELDS)):
        for n in names:
            snaps[f"{prefix}.{n}"], dev = _snapshot(getattr(obj, n))
            if dev is not None:
                devs.add(dev)
    if len(devs) > 1:
        raise ValueError("save_checkpoint_dir: tensors on "
                         f"{sorted(map(str, devs))}: one device at a time")
    event = None
    if devs:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(devs.pop()))
    if _WRITER is None:
        _WRITER = ThreadPoolExecutor(max_workers=1,
                                     thread_name_prefix="checkpoint")
    future = _WRITER.submit(_write_dir, os.path.abspath(path), snaps, event,
                            _run_meta(cfg, step))
    _PENDING.append(future)
    if wait:
        _PENDING.remove(future)
        future.result()


def finish_async_checkpoints() -> None:
    """Wait until every ``save_checkpoint_dir`` in flight is on disk
    (counterpart of ``finish_async_checkpoints``); re-raises the first
    writer error, after all have ended."""
    pending = list(_PENDING)
    _PENDING.clear()
    error = None
    for future in pending:
        try:
            future.result()
        except Exception as e:       # every save ends before the raise
            error = error or e
    if error is not None:
        raise error


def load_checkpoint_dir(path: str, cfg: Config, device="cuda"):
    """Read a directory checkpoint onto ``device`` (counterpart of
    ``load_checkpoint_orbax``): ``load_checkpoint``'s contract. Returns
    (state, derived, cfg with the stored time levels, step)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return _restored(meta, lambda key: np.load(os.path.join(
        path, key + ".npy")), cfg, device)


def save_packed_checkpoint(path: str, s, qdp, acc, step: int,
                           mass_target=None) -> None:
    """Checkpoint the packed cadence chain (the operands of
    ``dist.prim_step_packed_t4``: the stacked state s [4*nlev, E16], the
    tracers qdp [qsize*nlev, E16], the accumulators (vn0u, vn0v, omg))
    without unpacking, so the loop restarts exactly where it stopped. A
    ``mass_target`` (the dry-mass fixer's, a scalar) is kept in the meta,
    exactly: an f32 or f64 value survives the JSON float."""
    meta = {"step": step, "packed": True}
    if mass_target is not None:
        meta["mass_target"] = float(mass_target)
    _publish(path, {
        "packed.s": _host(s), "packed.qdp": _host(qdp),
        "packed.vn0u": _host(acc[0]), "packed.vn0v": _host(acc[1]),
        "packed.omg": _host(acc[2]), "meta": _meta_array(meta)})


def checkpoint_meta(path: str) -> dict:
    """The ``meta`` object of an npz checkpoint of either form."""
    with np.load(path) as z:
        return json.loads(bytes(z["meta"]).decode())


def load_packed_checkpoint(path: str, nlev: int | None = None,
                           e16: int | None = None, device="cuda"):
    """Read a packed checkpoint onto ``device``. Returns (s, qdp,
    (vn0u, vn0v, omg), step); with ``nlev`` and ``e16`` given, raises if the
    stored chain has another shape."""
    dev = resolve_device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if not meta.get("packed"):
            raise ValueError(f"{path} is not a packed checkpoint")
        s, qdp = z["packed.s"], z["packed.qdp"]
        acc = [z[f"packed.{n}"] for n in ("vn0u", "vn0v", "omg")]
    k = nlev if nlev is not None else s.shape[0] // 4
    e = e16 if e16 is not None else s.shape[1]
    ok = (s.shape == (4 * k, e) and qdp.shape[1] == e and qdp.shape[0] > 0
          and qdp.shape[0] % k == 0 and all(a.shape == (k, e) for a in acc))
    if not ok:
        raise ValueError(
            f"packed checkpoint {path}: s {s.shape}, qdp {qdp.shape}, "
            f"accumulators {[a.shape for a in acc]} do not match nlev={k}, "
            f"e16={e}")
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return to(s), to(qdp), tuple(to(a) for a in acc), int(meta["step"])
