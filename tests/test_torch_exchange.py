"""The feature exchange, the process-group bootstrap and the distributed
shufflers of the PyTorch port against the JAX package, on the CPU.

One spawn of WORLD = 4 gloo ranks (file rendezvous in a temp directory)
runs every ``assemble_features`` case of the JAX package's
``tests/test_spmd.py`` (plain, a VIP cache, overflow, a hot prefix, the
fp8 wire) in float32 and bfloat16; the same inputs go through JAX's
``shard_map`` on a 4-device virtual mesh. The exchange moves rows without
arithmetic, so rows and ExchangeStats must be equal; the fp8 wire's
decode is one float32 multiply in both, held within 1e-6 relative.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp
from jax.sharding import NamedSharding, PartitionSpec as P

from salient_plusplus_tpu.parallel import make_mesh
from salient_plusplus_tpu.parallel import exchange as jexchange
from salient_plusplus_tpu.parallel.mesh import (
    multiprocess_intended as jmultiprocess_intended)
from salient_plusplus_tpu.sampling import shufflers as jshufflers

from salient_plusplus_tpu_torch.parallel import exchange, mesh
from salient_plusplus_tpu_torch.sampling import shufflers
from tests import _torch_exchange_worker as W

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def port_outputs(tmp_path_factory):
    """Every case's rows and stats from the 4 gloo ranks, {key: [rank]}."""
    d = tmp_path_factory.mktemp("exchange")
    ctx = tmp.spawn(W.run_rank, args=(str(d / "rendezvous"), str(d)),
                    nprocs=W.WORLD, join=False)
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail("the gloo ranks did not finish in 240 s")
    outs = [np.load(d / f"out{r}.npz") for r in range(W.WORLD)]
    return {k: [o[k] for o in outs] for k in outs[0].files}


def _jax_exchange(c, dtype):
    """The JAX package's assemble_features on the same inputs, one
    shard_map over a 4-device mesh: (rows [world, N_cap, F] f32, stats)."""
    mesh = make_mesh(W.WORLD)
    jdt = getattr(jnp, dtype)
    spec = NamedSharding(mesh, P("data"))
    shards = jax.device_put(
        jnp.asarray(c["shards"].reshape(-1, W.F)).astype(jdt), spec)
    cached = "cache_v" in c
    hot = c["hot_size"] if c["hot_size"] > 0 else None

    def f(local, n_id, count, *cv):
        cache = jexchange.DeviceCache(cv[0][0], cv[1][0]) if cached else None
        out, st = jexchange.assemble_features(
            local, n_id[0], count[0], jnp.asarray(c["part_offsets"]), "data",
            c["r_cap"], cache, hot_size=hot, wire_fp8=c["wire_fp8"])
        return out[None], jax.tree_util.tree_map(lambda v: v[None], st)

    args = [shards, jnp.asarray(c["n_id"]), jnp.asarray(c["counts"])]
    if cached:
        args += [jnp.asarray(c["cache_v"]),
                 jnp.asarray(c["cache_f"]).astype(jdt)]
    out, st = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=tuple(P("data") for _ in args),
        out_specs=(P("data"), P("data")), check_vma=False))(*args)
    return (np.asarray(out.astype(jnp.float32)),
            jax.tree_util.tree_map(np.asarray, st))


@pytest.mark.parametrize("dtype", W.DTYPES)
@pytest.mark.parametrize("name", W.CASES)
def test_assemble_features_matches_jax(port_outputs, name, dtype):
    c = W.make_case(name)
    want, jst = _jax_exchange(c, dtype)
    key = f"{name}_{dtype}"
    for r in range(W.WORLD):
        got = port_outputs[key][r]
        if c["wire_fp8"]:
            np.testing.assert_allclose(got, want[r], rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(got, want[r])
        n = c["counts"][r]
        assert np.all(got[n:] == 0)
        for field in jexchange.ExchangeStats._fields:
            a = port_outputs[f"{key}_{field}"][r]
            b = getattr(jst, field)[r]
            assert a == b, (field, r, a, b)
    # each case reaches its path
    stats = {f: sum(port_outputs[f"{key}_{f}"]) for f in
             jexchange.ExchangeStats._fields}
    assert stats["num_remote"] > 0
    assert (stats["num_overflow"] > 0) == (name == "overflow")
    assert (stats["num_cached"] >= 8 * W.WORLD) == (name == "cache")
    if name in ("plain", "cache", "fp8"):
        x = c["x"].astype(np.float32)
        if dtype == "bfloat16":
            x = torch.from_numpy(x).bfloat16().float().numpy()
        for r in range(W.WORLD):
            n = c["counts"][r]
            exact = x[c["n_id"][r, :n]]
            got = port_outputs[key][r][:n]
            if name == "fp8":  # e4m3: within amax / 8 of each element
                bound = np.abs(exact).max(axis=1, keepdims=True) / 8 + 1e-6
                assert np.all(np.abs(got - exact) <= bound)
            else:
                np.testing.assert_array_equal(got, exact)


def test_sorted_isin():
    ref = torch.tensor([2, 5, 9, 40, 41], dtype=torch.int32)
    ids = torch.tensor([5, 0, 41, 42, 9, 3, 100], dtype=torch.int64)
    hit, pos = exchange.sorted_isin(ref, ids)
    assert hit.tolist() == [True, False, True, False, True, False, False]
    assert pos.tolist() == [1, 0, 4, 4, 2, 1, 4]
    assert torch.equal(ref.long()[pos][hit], ids[hit])
    jhit, jpos = jexchange.sorted_isin(jnp.asarray(ref.numpy()),
                                       jnp.asarray(ids.numpy()))
    assert hit.tolist() == np.asarray(jhit).tolist()
    assert pos.tolist() == np.asarray(jpos).tolist()


@pytest.mark.parametrize("env,want", [
    ({}, False),
    ({"WORLD_SIZE": "2", "RANK": "0"}, True),
    ({"RANK": "1"}, True),
    ({"SLURM_NTASKS": "4"}, True),
    ({"SLURM_NTASKS": "1", "OMPI_COMM_WORLD_SIZE": "1"}, False),
    ({"OMPI_COMM_WORLD_SIZE": "2"}, True),
    ({"PMI_SIZE": "x"}, False),
    ({"JAX_COORDINATOR_ADDRESS": "h:1"}, False),
])
def test_multiprocess_intended(env, want):
    assert mesh.multiprocess_intended(env) is want
    # the launchers both packages know agree
    if not any(k in env for k in ("WORLD_SIZE", "RANK",
                                  "JAX_COORDINATOR_ADDRESS")):
        assert jmultiprocess_intended(env) is want


def test_maybe_initialize_distributed(monkeypatch, tmp_path):
    for v in ("WORLD_SIZE", "RANK", "SLURM_NTASKS", "SLURM_STEP_NUM_TASKS",
              "OMPI_COMM_WORLD_SIZE", "PMI_SIZE"):
        monkeypatch.delenv(v, raising=False)
    assert mesh.maybe_initialize_distributed("cpu") is False
    assert not dist.is_initialized()
    # intended but half-configured: fail fast, do not run as one process
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        mesh.maybe_initialize_distributed("cpu")
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    try:
        assert mesh.maybe_initialize_distributed("cpu") is True
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert mesh.maybe_initialize_distributed("cpu") is True  # idempotent
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("n,world", [(1000, 4), (1001, 4), (7, 3), (5, 8)])
def test_shufflers_match_jax(n, world):
    idx = np.random.default_rng(n).permutation(10 * n)[:n]
    for epoch in (0, 3):
        parts = []
        for r in range(world):
            got = shufflers.DistributedShuffler(idx, world, r).get_idx(epoch)
            want = jshufflers.DistributedShuffler(idx, world, r).get_idx(epoch)
            np.testing.assert_array_equal(got, want)
            assert len(got) <= -(-n // world)
            parts.append(got)
        np.testing.assert_array_equal(np.sort(np.concatenate(parts)),
                                      np.sort(idx))
        np.testing.assert_array_equal(
            shufflers.FederatedDistributedShuffler(idx, 9).get_idx(epoch),
            jshufflers.FederatedDistributedShuffler(idx, 9).get_idx(epoch))
