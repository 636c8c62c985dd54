"""Checkpoint and restore of the prognostic state as npz files (counterpart
of the npz half of ``tinman_sandbox_tpu/timeloop/checkpoint.py``).

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
reader never sees a half-written checkpoint. The JAX package's orbax
directory checkpoints have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..config import Config
from ..device import from_arrays, resolve_device
from ..state import Derived, State

__all__ = ["save_checkpoint", "load_checkpoint", "save_packed_checkpoint",
           "load_packed_checkpoint", "checkpoint_meta"]

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


def save_checkpoint(path: str, state: State, derived: Derived, cfg: Config,
                    step: int) -> None:
    """Write state, derived and the run's time levels and dimensions to
    ``path`` (.npz)."""
    arrays = {f"state.{n}": _host(getattr(state, n)) for n in _STATE_FIELDS}
    arrays |= {f"derived.{n}": _host(getattr(derived, n))
               for n in _DERIVED_FIELDS}
    arrays["meta"] = _meta_array({
        "step": step, "n0": cfg.n0, "np1": cfg.np1, "nm1": cfg.nm1,
        "qn0": cfg.qn0, "nlev": cfg.nlev, "qsize": cfg.qsize,
        "nelem": cfg.nelem})
    _publish(path, arrays)


def load_checkpoint(path: str, cfg: Config, device="cuda"):
    """Read a checkpoint onto ``device`` (each array in its stored dtype).
    Returns (state, derived, cfg with the stored time levels, step); raises
    if its nlev, qsize or nelem differ from ``cfg``'s."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        for dim in ("nlev", "qsize", "nelem"):
            if meta[dim] != getattr(cfg, dim):
                raise ValueError(f"checkpoint {dim}={meta[dim]} != config "
                                 f"{dim}={getattr(cfg, dim)}")
        state = from_arrays(State, {n: z[f"state.{n}"]
                                    for n in _STATE_FIELDS}, device=device)
        derived = from_arrays(Derived, {n: z[f"derived.{n}"]
                                        for n in _DERIVED_FIELDS},
                              device=device)
    cfg = dataclasses.replace(cfg, n0=meta["n0"], np1=meta["np1"],
                              nm1=meta["nm1"], qn0=meta["qn0"])
    return state, derived, cfg, meta["step"]


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
