"""The port's mesh (``dist/sharding.py``) against JAX's collectives: the
``LocalMesh`` ``ppermute`` (zeros where a shard receives nothing),
``all_gather`` and ``psum`` against ``jax.shard_map`` of the same
collective on the 8-device CPU mesh of tests/conftest.py, the shard split
and its inverse, and ``DistMesh`` on a 4-process CPU ``gloo`` group running
the plain band-sharded step bit for bit as ``LocalMesh`` does. The group
starts from a ``file://`` store under the test's temporary directory (no
port), and its processes are joined under a hard 120 s limit and killed
past it."""
import multiprocessing
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from tinman_sandbox_tpu_torch import bench
from tinman_sandbox_tpu_torch.dist import (
    LocalMesh,
    caar_dss_banded_t4_plain,
    make_mesh,
    shard_packed_t4,
    unshard_packed_t4,
)
from tinman_sandbox_tpu_torch.multichip import gloo_worker

N = 8
GLOO_WORLD = 4
GLOO_TIMEOUT_S = 120


def _shards(seed, shape=(3, 5)):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((N, *shape)).astype(np.float32)


def _jax(fn, x):
    """fn applied under shard_map to the shards x[s]; returns [N, ...]."""
    mesh = Mesh(np.asarray(jax.devices()[:N]), ("e",))
    f = shard_map(lambda a: fn(a[0])[None], mesh=mesh, in_specs=P("e"),
                  out_specs=P("e"), check_vma=False)
    return np.asarray(f(jnp.asarray(x)))


@pytest.mark.parametrize("pairs", [
    ((0, 1), (1, 2), (3, 4), (5, 6), (6, 7)),      # some shards get nothing
    tuple((s, (s + 3) % N) for s in range(N)),       # a full rotation
])
def test_torch_local_ppermute_matches_jax(pairs):
    x = _shards(1)
    got = LocalMesh(N, "cpu").ppermute([torch.from_numpy(a) for a in x],
                                       pairs)
    want = _jax(lambda a: jax.lax.ppermute(a, "e", perm=pairs), x)
    for s in range(N):
        assert np.array_equal(got[s].numpy(), want[s])
    dst = {d for _, d in pairs}
    assert all(not got[s].any() for s in range(N) if s not in dst)


def test_torch_local_all_gather_and_psum_match_jax():
    x = _shards(2)
    mesh = LocalMesh(N, "cpu")
    xs = [torch.from_numpy(a) for a in x]
    gathered = mesh.all_gather(xs)
    want = _jax(lambda a: jax.lax.all_gather(a, "e"), x)
    summed = mesh.psum(xs)
    want_sum = _jax(lambda a: jax.lax.psum(a, "e"), x)
    for s in range(N):
        assert np.array_equal(gathered[s].numpy(), want[s])
        assert np.allclose(summed[s].numpy(), want_sum[s], rtol=1e-6,
                           atol=1e-6)
    # one nonzero term a slot, as the banded S / N lines: exact
    sparse = np.zeros_like(x)
    for s in range(N):
        sparse[s, s % 3, s % 5] = x[s, 0, 0]
    got = mesh.psum([torch.from_numpy(a) for a in sparse])[0]
    assert np.array_equal(got.numpy(), _jax(
        lambda a: jax.lax.psum(a, "e"), sparse)[0])


def test_torch_local_mesh_checks():
    mesh = LocalMesh(3, "cpu")
    xs = [torch.zeros(2) for _ in range(3)]
    with pytest.raises(ValueError):
        mesh.psum(xs[:2])
    with pytest.raises(ValueError):
        mesh.ppermute(xs, [(0, 2), (1, 2)])
    with pytest.raises(ValueError):
        LocalMesh(0, "cpu")
    assert make_mesh(4, "cpu").shards == [0, 1, 2, 3]


def test_torch_local_mesh_defaults_to_the_card():
    """Without ``device`` the mesh is on the card; with none it raises."""
    if torch.cuda.is_available():
        assert LocalMesh(2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            LocalMesh(2)


def test_torch_shard_split_round_trips():
    mesh = LocalMesh(6, "cpu")
    a = torch.arange(4 * 96, dtype=torch.float32).reshape(4, 96)
    (parts,) = shard_packed_t4(mesh, a)
    assert all(p.is_contiguous() and p.shape == (4, 16) for p in parts)
    assert torch.equal(parts[2], a[:, 32:48])
    assert torch.equal(unshard_packed_t4(mesh, parts), a)
    with pytest.raises(ValueError):
        shard_packed_t4(LocalMesh(5, "cpu"), a)


def test_torch_distmesh_gloo_equals_localmesh(tmp_path):
    """The plain band-sharded step (ne 4, m 2) over a 4-process gloo
    ``DistMesh`` equals the same step over ``LocalMesh(4)`` bit for bit,
    overlap off and on, and the ranks' collectives are LocalMesh's."""
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{tmp_path}/gloo_init"
    procs = [ctx.Process(target=gloo_worker,
                         args=(r, GLOO_WORLD, init, str(tmp_path)))
             for r in range(GLOO_WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + GLOO_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
    for p in procs:
        p.join(5)
    assert not hung, f"gloo ranks still running after {GLOO_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * GLOO_WORLD

    mesh = LocalMesh(GLOO_WORLD, "cpu")
    (scal, meta, qdp, pecnd, dvv), (s0, sm1), acc, plan, rsp = \
        bench.make_assembled_problem(4, 4, "cpu")
    sh = shard_packed_t4(mesh, meta, s0, sm1, qdp, pecnd, *acc, rsp)
    x = [torch.arange(6.0).reshape(2, 3) + 10 * r for r in range(GLOO_WORLD)]
    pairs = [(s, s + 1) for s in range(0, GLOO_WORLD - 1, 2)]
    want = {"ppermute": mesh.ppermute(x, pairs),
            "all_gather": mesh.all_gather(x), "psum": mesh.psum(x)}
    for r in range(GLOO_WORLD):
        got = torch.load(tmp_path / f"rank{r}.pt")
        for name, w in want.items():
            assert torch.equal(got[name], w[r]), (r, name)
        for overlap in (False, True):
            ref = caar_dss_banded_t4_plain(scal, *sh[:8], dvv, plan, sh[8],
                                           mesh, 2, overlap=overlap)
            for a, b in zip(got[overlap], ref):
                assert torch.equal(a, unshard_packed_t4(mesh, b))
