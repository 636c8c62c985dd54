"""The port's npz checkpoints (``timeloop.checkpoint``): round trips that
restore bit for bit, a resumed run equal to an uninterrupted one (as
tests/test_timeloop.py holds the JAX package's), the shape checks, and
files written by either package loaded by the other.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinman_sandbox_tpu import Config as JConfig
from tinman_sandbox_tpu import random_state as j_random_state
from tinman_sandbox_tpu import zero_derived as j_zero_derived
from tinman_sandbox_tpu.timeloop import (
    load_checkpoint as j_load,
    load_packed_checkpoint as j_load_packed,
    save_checkpoint as j_save,
    save_packed_checkpoint as j_save_packed,
)
from tinman_sandbox_tpu_torch import (
    Config,
    analytic_hvcoord,
    random_geometry,
    random_state,
    zero_derived,
)
from tinman_sandbox_tpu_torch.timeloop import (
    checkpoint_meta,
    load_checkpoint,
    load_packed_checkpoint,
    run_leapfrog,
    save_checkpoint,
    save_packed_checkpoint,
)

torch.set_num_threads(2)
STATE = ("u", "v", "t", "dp3d", "ps_v", "phis", "qdp")
DERIVED = ("vn0_u", "vn0_v", "phi", "omega_p", "eta_dot_dpdn", "pecnd")


def _setup(nelem=2, nlev=4):
    cfg = Config(nelem=nelem, nlev=nlev, dt=10.0)
    kw = dict(device="cpu")
    return (cfg, random_state(cfg, seed=1, **kw), zero_derived(cfg, **kw),
            random_geometry(cfg, seed=2, **kw), analytic_hvcoord(cfg, **kw))


def _equal(a, b, names):
    return all(torch.equal(getattr(a, n), getattr(b, n)) for n in names)


def test_torch_checkpoint_roundtrip_and_resume(tmp_path):
    cfg, st, dv, geom, hv = _setup()
    st1, dv1, cfg1 = run_leapfrog(st, dv, geom, hv, cfg, nsteps=1,
                                  device="cpu")
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, st1, dv1, cfg1, step=1)
    assert os.listdir(tmp_path) == ["ck.npz"]        # no .tmp left behind
    st2, dv2, cfg2, step = load_checkpoint(path, cfg, device="cpu")
    assert step == 1
    assert (cfg2.n0, cfg2.np1, cfg2.nm1, cfg2.qn0) == (cfg1.n0, cfg1.np1,
                                                       cfg1.nm1, cfg1.qn0)
    assert _equal(st2, st1, STATE) and _equal(dv2, dv1, DERIVED)
    assert st2.u.dtype == st1.u.dtype
    # resuming from the checkpoint equals an uninterrupted run
    sa, da, ca = run_leapfrog(st1, dv1, geom, hv, cfg1, nsteps=2,
                              device="cpu")
    sb, db, cb = run_leapfrog(st2, dv2, geom, hv, cfg2, nsteps=2,
                              device="cpu")
    assert _equal(sa, sb, STATE) and _equal(da, db, DERIVED)
    assert (ca.n0, ca.np1, ca.nm1) == (cb.n0, cb.np1, cb.nm1)


@pytest.mark.parametrize("dim", ["nlev", "qsize", "nelem"])
def test_torch_checkpoint_shape_mismatch_raises(tmp_path, dim):
    cfg, st, dv, _, _ = _setup()
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, st, dv, cfg, step=0)
    other = dataclasses.replace(cfg, **{dim: getattr(cfg, dim) + 1})
    with pytest.raises(ValueError, match=dim):
        load_checkpoint(path, other, device="cpu")


def _packed_chain(nlev=3, e16=32, qsize=2, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    return f(4 * nlev, e16), f(qsize * nlev, e16), (f(nlev, e16),
                                                    f(nlev, e16),
                                                    f(nlev, e16))


def test_torch_packed_checkpoint_roundtrip(tmp_path):
    s, qdp, acc = _packed_chain()
    path = str(tmp_path / "pk.npz")
    save_packed_checkpoint(path, s, qdp, acc, step=7)
    assert os.listdir(tmp_path) == ["pk.npz"]
    s2, q2, acc2, step = load_packed_checkpoint(path, nlev=3, e16=32,
                                                device="cpu")
    assert step == 7 and torch.equal(s2, s) and torch.equal(q2, qdp)
    assert all(torch.equal(a, b) for a, b in zip(acc2, acc))
    # the shape is read from the file when not given
    s3, *_ = load_packed_checkpoint(path, device="cpu")
    assert torch.equal(s3, s)


@pytest.mark.parametrize("nlev,e16", [(4, 32), (3, 48)])
def test_torch_packed_checkpoint_shape_mismatch_raises(tmp_path, nlev, e16):
    s, qdp, acc = _packed_chain()
    path = str(tmp_path / "pk.npz")
    save_packed_checkpoint(path, s, qdp, acc, step=1)
    with pytest.raises(ValueError, match="do not match"):
        load_packed_checkpoint(path, nlev=nlev, e16=e16, device="cpu")


def test_torch_packed_checkpoint_refuses_a_state_file(tmp_path):
    cfg, st, dv, _, _ = _setup()
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, st, dv, cfg, step=0)
    with pytest.raises(ValueError, match="not a packed checkpoint"):
        load_packed_checkpoint(path, device="cpu")


def test_torch_packed_checkpoint_keeps_the_mass_target(tmp_path):
    """The fixer's target rides in the meta exactly (an f32 value through
    the JSON float), and JAX's loader reads such a file all the same."""
    s, qdp, acc = _packed_chain(seed=2)
    path = str(tmp_path / "pk.npz")
    target = (s[9:12] * 0.37).sum()
    save_packed_checkpoint(path, s, qdp, acc, step=3, mass_target=target)
    meta = checkpoint_meta(path)
    assert meta == {"step": 3, "packed": True,
                    "mass_target": float(target)}
    assert torch.tensor(meta["mass_target"], dtype=torch.float32) == target
    js, _, _, jstep = j_load_packed(path)
    assert jstep == 3 and np.array_equal(js, s.numpy())


# -- across the two packages -------------------------------------------------

def test_torch_checkpoint_loads_a_jax_file(tmp_path):
    jcfg = JConfig(nelem=2, nlev=4, n0=1, np1=2, nm1=0, qn0=1)
    jst, jdv = j_random_state(jcfg, seed=3), j_zero_derived(jcfg)
    path = str(tmp_path / "jax.npz")
    j_save(path, jst, jdv, jcfg, step=5)
    st, dv, cfg, step = load_checkpoint(path, Config(nelem=2, nlev=4),
                                        device="cpu")
    assert step == 5 and (cfg.n0, cfg.np1, cfg.nm1, cfg.qn0) == (1, 2, 0, 1)
    for n in STATE:
        assert np.array_equal(getattr(st, n).numpy(),
                              np.asarray(getattr(jst, n))), n
    for n in DERIVED:
        assert np.array_equal(getattr(dv, n).numpy(),
                              np.asarray(getattr(jdv, n))), n


def test_torch_checkpoint_written_loads_in_jax(tmp_path):
    cfg, st, dv, _, _ = _setup(nelem=3, nlev=5)
    cfg = dataclasses.replace(cfg, n0=2, np1=0, nm1=1, qn0=1)
    path = str(tmp_path / "torch.npz")
    save_checkpoint(path, st, dv, cfg, step=9)
    jst, jdv, jcfg, step = j_load(path, JConfig(nelem=3, nlev=5))
    assert step == 9
    assert (jcfg.n0, jcfg.np1, jcfg.nm1, jcfg.qn0) == (2, 0, 1, 1)
    for n in STATE:
        assert np.array_equal(np.asarray(getattr(jst, n)),
                              getattr(st, n).numpy()), n
    for n in DERIVED:
        assert np.array_equal(np.asarray(getattr(jdv, n)),
                              getattr(dv, n).numpy()), n


def test_torch_packed_checkpoint_across_packages(tmp_path):
    s, qdp, acc = _packed_chain(seed=4)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    j_save_packed(jpath, jnp.asarray(s.numpy()), jnp.asarray(qdp.numpy()),
                  tuple(jnp.asarray(a.numpy()) for a in acc), 11)
    s2, q2, acc2, step = load_packed_checkpoint(jpath, nlev=3, e16=32,
                                                device="cpu")
    assert step == 11 and torch.equal(s2, s) and torch.equal(q2, qdp)
    assert all(torch.equal(a, b) for a, b in zip(acc2, acc))
    save_packed_checkpoint(tpath, s, qdp, acc, step=12)
    js, jq, jacc, jstep = j_load_packed(tpath)
    assert jstep == 12 and np.array_equal(js, s.numpy())
    assert np.array_equal(jq, qdp.numpy())
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(jacc, acc))
