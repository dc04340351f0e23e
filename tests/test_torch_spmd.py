"""The data-parallel step of the PyTorch port (``parallel/spmd.py``) against
the JAX package's ``make_spmd_train_step`` / ``make_spmd_eval_step``, on
the CPU.

One spawn of WORLD = 2 gloo ranks (``tests/_torch_dist_worker.py``) runs
the port's ``train_step`` for SPMD_STEPS steps and one ``eval_step`` for
SAGE, GAT (every hop mirrored, the custom-VJP attention) and JKNet (its
BatchNorm statistics are averaged), with the features replicated and
partitioned; the same wire-encoded batches and the JAX package's initial
weights go through ``shard_map`` on a 2-device mesh. float32 and dropout
0: the loss, every parameter and BatchNorm statistic agree within 2e-4
(the reference-parity tolerance), the ExchangeStats summed over the ranks
and the eval counts are equal. Then the cold overlay's drop rule, the
ranks' dropout streams and the shard layout.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from salient_plusplus_tpu.data import synthetic as jsyn
from salient_plusplus_tpu.data.dataset import pad_feature_dim
from salient_plusplus_tpu.models import make_model as jmake_model
from salient_plusplus_tpu.parallel import make_mesh
from salient_plusplus_tpu.parallel import spmd as jspmd
from salient_plusplus_tpu.sampling import cpp as jcpp
from salient_plusplus_tpu.sampling import sampler as jsampler
from salient_plusplus_tpu.sampling.batch import BatchSpec as JBatchSpec
from salient_plusplus_tpu.train.state import create_train_state as jcreate
from salient_plusplus_tpu.train.step import decode_batch as jdecode

from salient_plusplus_tpu_torch.parallel import spmd
from tests import _torch_dist_worker as W

torch.set_num_threads(1)
TOL = 2e-4


def _gat_env(name):
    os.environ["SPTPU_GAT_CUSTOM_VJP"] = "1" if name == "GAT" else ""


def _jax_batches(name):
    g = W.spmd_graph(jsyn)
    return [[W.spmd_batch(jcpp, jsampler, JBatchSpec, g, t, r,
                          name == "GAT") for r in range(W.WORLD)]
            for t in range(W.SPMD_STEPS)]


def _jax_state(name, x, batches):
    model = jmake_model(name, x.shape[1], W.SPMD_HIDDEN, 4, 2, 0.0,
                        dtype=jnp.float32)
    ex = jdecode(batches[0][0])
    return jcreate(model, jnp.asarray(x)[ex.n_id], ex, W.SPMD_LR, seed=0)


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """{(model, mode): (port outputs by rank, JAX outputs)}."""
    d = tmp_path_factory.mktemp("spmd")
    x = pad_feature_dim(np.asarray(W.spmd_graph(jsyn).x, np.float32))
    batches, states = {}, {}
    try:
        for name in W.SPMD_MODELS:
            _gat_env(name)
            batches[name] = _jax_batches(name)
            states[name] = _jax_state(name, x, batches[name])
            flat = {f"p/{k}": v for k, v in W.flatten(jax.tree_util.tree_map(
                np.asarray, states[name].params)).items()}
            flat.update({f"s/{k}": v for k, v in W.flatten(
                jax.tree_util.tree_map(np.asarray,
                                       states[name].batch_stats)).items()})
            np.savez(d / f"init_{name}.npz", **flat)
        ranks = W.start(W.spmd_rank, (str(d / "rendezvous"), str(d)))
        mesh = make_mesh(W.WORLD)
        offs = jnp.asarray(np.arange(W.WORLD + 1) * W.SPMD_V_PER)
        out = {}
        for name in W.SPMD_MODELS:
            _gat_env(name)
            for mode in W.SPMD_MODES:
                feats = jnp.asarray(x)
                if mode == "partitioned":
                    feats = jax.device_put(feats,
                                           NamedSharding(mesh, P("data")))
                step = jspmd.make_spmd_train_step(
                    mesh, mode, r_cap=W.SPMD_R_CAP, donate_state=False)
                st, losses, exs = states[name], [], []
                for t in range(W.SPMD_STEPS):
                    st, loss, ex = step(st, feats,
                                        jspmd.stack_batches(batches[name][t]),
                                        offs, None)
                    losses.append(float(loss))
                    exs.append(None if ex is None else
                               jax.tree_util.tree_map(np.asarray, ex))
                ev = jspmd.make_spmd_eval_step(mesh, mode,
                                               r_cap=W.SPMD_R_CAP)(
                    st, feats, jspmd.stack_batches(batches[name][0]), offs,
                    None)
                out[name, mode] = dict(
                    losses=losses, exs=exs,
                    params=W.flatten(jax.tree_util.tree_map(np.asarray,
                                                            st.params)),
                    stats=W.flatten(jax.tree_util.tree_map(
                        np.asarray, st.batch_stats)),
                    eval=[int(v) for v in ev])
        W.wait(ranks, "spmd legs")
    finally:
        _gat_env("")
    port = [np.load(d / f"spmd{r}.npz") for r in range(W.WORLD)]
    return {k: (port, v) for k, v in out.items()}


@pytest.mark.parametrize("mode", W.SPMD_MODES)
@pytest.mark.parametrize("name", W.SPMD_MODELS)
def test_train_step_matches_jax(legs, name, mode):
    port, want = legs[name, mode]
    key = f"{name}_{mode}"
    for t in range(W.SPMD_STEPS):
        for r in range(W.WORLD):  # the group's mean loss, on every rank
            assert abs(float(port[r][f"{key}_loss{t}"])
                       - want["losses"][t]) < TOL, (t, r)
    for prefix, tree in (("p/", want["params"]), ("s/", want["stats"])):
        assert {k for k in port[0].files if k.startswith(key + "_" + prefix)
                } == {f"{key}_{prefix}{k}" for k in tree}
        for k, v in tree.items():
            for r in range(W.WORLD):  # and equal on every rank
                got = port[r][f"{key}_{prefix}{k}"]
                np.testing.assert_allclose(got, v, rtol=TOL, atol=TOL,
                                           err_msg=f"{k} rank {r}")
    if name == "JKNet":
        assert want["stats"], "JKNet has BatchNorm statistics"
    if mode == "replicated":
        assert all(e is None for e in want["exs"])
        return
    for t, jex in enumerate(want["exs"]):
        for f in jex._fields:
            got = sum(port[r][f"{key}_ex{t}_{f}"] for r in range(W.WORLD))
            assert got == getattr(jex, f), (t, f)
    assert sum(e.num_remote for e in want["exs"]) > 0
    assert sum(e.num_overflow for e in want["exs"]) == 0


@pytest.mark.parametrize("mode", W.SPMD_MODES)
@pytest.mark.parametrize("name", W.SPMD_MODELS)
def test_eval_step_matches_jax(legs, name, mode):
    port, want = legs[name, mode]
    got = sum(port[r][f"{name}_{mode}_eval"] for r in range(W.WORLD))
    assert got.tolist() == want["eval"]
    assert want["eval"][1] == W.WORLD * W.SPMD_BATCH


def test_dropout_differs_by_rank_and_reproduces(legs):
    port = legs["SAGE", "replicated"][0]
    a0, a1 = port[0]["dropout_out0"], port[1]["dropout_out0"]
    assert not np.allclose(a0, a1)  # same batch and weights, other masks
    for r in range(W.WORLD):
        np.testing.assert_array_equal(port[r]["dropout_out0"],
                                      port[r]["dropout_out1"])


@pytest.mark.parametrize("pads", ["at_cap", "past_cap"])
def test_overlay_drops_pads_as_jax(pads):
    """The owner-served layout: cold slots grouped by owner, not sorted,
    pads at the frontier cap (``fill_cold_requests``) or past it."""
    rng = np.random.default_rng(3)
    N, F, cap = 50, 6, 16
    x = rng.normal(size=(N, F)).astype(np.float32)
    pos = np.full(2 * cap, N if pads == "at_cap" else N + 7, np.int32)
    pos[:9] = rng.choice(N, 9, replace=False)
    pos[cap:cap + 5] = rng.choice(np.setdiff1d(np.arange(N), pos[:9]), 5,
                                  replace=False)
    rows = rng.normal(size=(2 * cap, F)).astype(np.float32)
    want = jnp.asarray(x).at[jnp.asarray(pos)].set(jnp.asarray(rows),
                                                    mode="drop")
    got = spmd.overlay_rows(torch.from_numpy(x), torch.from_numpy(pos),
                            torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_shard_features_by_partition_matches_jax():
    rng = np.random.default_rng(0)
    shards = [rng.normal(size=(n, 5)).astype(np.float32) for n in (7, 4, 6)]
    x, offs = spmd.shard_features_by_partition(shards)
    jx, joffs = jspmd.shard_features_by_partition(shards, make_mesh(3))
    np.testing.assert_array_equal(x, np.asarray(jx))
    np.testing.assert_array_equal(offs, joffs)
