"""The port's data-parallel trainer (``train/dist_loop.py``,
``train/dist_inference.py``) against the JAX package's
``DistributedTrainer``, on the CPU.

One spawn of WORLD = 2 gloo ranks (``tests/_torch_dist_worker.py``) runs
each leg of ``TRAINER_LEGS`` from the JAX package's initial weights:
tests/_mp_worker.py's config with a VIP cache, with the owner-served cold
tier and cold_fp8, with the replicated cold tier, and with a request
budget cut to force overflow; then ``__graft_entry__.py::
dryrun_multichip``'s two legs at world 2. The JAX trainers run the same
legs on a 2-device mesh meanwhile. Sampling, calibration, partitioning
and the cache choice are the same host code in both, so every cap, cache
id and exchange counter must be equal. The models compute in bf16, which
the two frameworks round at other places: losses agree within rtol 2e-2
and valid accuracy within 0.02. Sharded layerwise inference from the same
trained weights agrees as in tests/test_dist_inference.py (predictions >
0.995, values within 5e-2).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salient_plusplus_tpu import partition as jpartition
from salient_plusplus_tpu.config import RunConfig as JRunConfig
from salient_plusplus_tpu.data import synthetic as jsyn
from salient_plusplus_tpu.parallel import make_mesh
from salient_plusplus_tpu.sampling import cpp as jcpp
from salient_plusplus_tpu.sampling import sampler as jsampler
from salient_plusplus_tpu.sampling.batch import BatchSpec as JBatchSpec
from salient_plusplus_tpu.train import dist_loop as jdist_loop
from salient_plusplus_tpu.train.dist_inference import (
    layerwise_inference_spmd as jlayerwise_spmd)

from salient_plusplus_tpu_torch.config import RunConfig
from salient_plusplus_tpu_torch.data import synthetic
from salient_plusplus_tpu_torch.sampling import cpp, sampler
from salient_plusplus_tpu_torch.sampling.batch import BatchSpec
from salient_plusplus_tpu_torch.train.dist_loop import DistributedTrainer
from tests import _torch_dist_worker as W

torch.set_num_threads(1)
LOSS_RTOL, ACC_TOL = 2e-2, 0.02
INT_FIELDS = ("remote", "local", "cache_hits", "overflow", "sent_bytes",
              "wire_bytes", "cold_wire_bytes", "tight_steps", "iters",
              "r_cap")


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """{leg: (port records by rank, JAX record)}, plus the layerwise
    shards and the JAX embedding of the fully-random leg."""
    d = tmp_path_factory.mktemp("dist_trainer")
    jax_trainers = {}
    for leg in W.TRAINER_LEGS:
        g, labels, kw = W.trainer_inputs(leg, jsyn, jpartition)
        t = jdist_loop.DistributedTrainer(JRunConfig(**kw), g, labels,
                                          mesh=make_mesh(W.WORLD))
        jax_trainers[leg] = t
        np.savez(d / f"init_{leg}.npz", **W.flatten(
            jax.tree_util.tree_map(np.asarray, t.state.params)))
    ranks = W.start(W.trainer_rank, (str(d / "rendezvous"), str(d)))
    want = {leg: W.drive_leg(leg, t) for leg, t in jax_trainers.items()}
    W.wait(ranks, "trainer legs")
    out = {}
    for leg in W.TRAINER_LEGS:
        got = []
        for r in range(W.WORLD):
            with open(d / f"{leg}{r}.json") as f:
                got.append(json.load(f))
        out[leg] = (got, want[leg])
    # sharded layerwise inference of the port's trained weights, in JAX
    t = jax_trainers["dryrun_fully_random"]
    lw = [np.load(d / f"lw{r}.npz") for r in range(W.WORLD)]
    params = W.unflatten({k[2:]: lw[0][k] for k in lw[0].files
                          if k.startswith("p/")})
    t.state = t.state.replace(params=t._replicate(
        jax.tree_util.tree_map(jnp.asarray, params)))
    emb = jlayerwise_spmd(t, chunk=t.cfg.inference_chunk)
    emb = np.asarray(jax.jit(lambda e: e, out_shardings=t.repl_sharding)(emb))
    out["layerwise"] = (np.concatenate([s["emb"] for s in lw]),
                        np.asarray(emb, np.float32))
    return out


@pytest.mark.parametrize("leg", list(W.TRAINER_LEGS))
def test_trainer_caps_and_counters_equal_jax(legs, leg):
    got, want = legs[leg]
    for r, rec in enumerate(got):
        for k in ("iters_per_epoch", "spec", "tight", "r_cap0", "cold_cap",
                  "cold_r_cap", "r_cap1", "cache_ids", "r_caps"):
            assert rec.get(k) == want.get(k), (k, r)
        assert len(rec["epochs"]) == len(want["epochs"])
        for e, (a, b) in enumerate(zip(rec["epochs"], want["epochs"])):
            for k in INT_FIELDS:
                assert a[k] == b[k], (e, k, r)
        ids = want.get("cache_ids")
        assert rec["own_cache"] == (None if ids is None else ids[r])
    # each leg reaches its path
    ep = want["epochs"]
    assert ep[0]["remote"] > 0 and ep[-1]["overflow"] == 0
    if leg in ("federated_cache", "owner_cold_fp8", "replicated_cold"):
        assert ep[1]["cache_hits"] > 0 and want["r_cap1"] <= want["r_cap0"]
    if leg in ("owner_cold_fp8", "dryrun_federated"):
        assert all(e["cold_wire_bytes"] > 0 for e in ep)
    if leg == "r_cap_growth":
        assert ep[0]["overflow"] > 0 and want["r_caps"][-1] > 128
    if leg == "dryrun_federated":
        assert want["cache_ids"] is not None


@pytest.mark.parametrize("leg", list(W.TRAINER_LEGS))
def test_trainer_losses_and_accuracy_match_jax(legs, leg):
    got, want = legs[leg]
    for rec in got:
        for a, b in zip(rec["epochs"], want["epochs"]):
            assert np.isfinite(a["loss"])
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
        for k in ("valid", "layerwise_valid"):
            if k in want:
                assert abs(rec[k] - want[k]) <= ACC_TOL, (k, rec[k], want[k])
    if "valid" in want:
        assert want["valid"] > 0.5  # 4 classes: chance is 0.25


def test_sharded_layerwise_matches_jax(legs):
    got, want = legs["layerwise"]
    assert got.shape == want.shape
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree > 0.995, agree
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)


def _batch_pair(cold_cfg):
    """One batch through both packages' buffers with a distributed cold
    tier: 2 partitions of 128 rows, hot prefixes of 64."""
    g = synthetic.planted_partition(name="cold", num_nodes=256,
                                    num_classes=4, avg_degree=8,
                                    num_features=8, seed=9)
    rng = np.random.default_rng(4)
    x_cold = rng.integers(0, 2**16, (2 * 64, 128)).astype(np.uint16)
    seeds = np.sort(rng.choice(256, 32, replace=False))
    out = []
    for c, smp, spec_cls in ((jcpp, jsampler, JBatchSpec),
                             (cpp, sampler, BatchSpec)):
        spec = spec_cls.worst_case(32, (4, 3))
        kw = dict(cold_part_size=128, cold_hot_size=64, **cold_cfg)
        if not cold_cfg.get("cold_owner_mode"):
            kw.update(x_cold=x_cold, cold_cap=64)
        cfg = smp.FastSamplerConfig(spec=spec, batch_size=32, **kw)
        bufs = c.BatchBuffers(spec)
        bufs.attach_from_config(cfg, g.num_nodes)
        c.NativeSampler(np.asarray(g.rowptr), np.asarray(g.col)).sample_into(
            bufs, seeds, rng_seed=5)
        out.append((bufs, bufs.finalize_from_config(cfg)))
    return out


@pytest.mark.parametrize("mode", ["owner", "replicated"])
def test_cold_fills_match_jax(mode):
    owner = mode == "owner"
    cold_cfg = (dict(cold_owner_mode=True, cold_world=2, cold_r_cap=32)
                if owner else {})
    (jb, jdrop), (tb, tdrop) = _batch_pair(cold_cfg)
    assert tdrop == jdrop and tdrop > 0  # the budgets are short on purpose
    np.testing.assert_array_equal(tb.cold_pos, jb.cold_pos)
    assert int(tb.cold_count[0]) == int(jb.cold_count) > 0
    if owner:
        np.testing.assert_array_equal(tb.cold_req, jb.cold_req)
        assert tb.cold_rows is None and jb.cold_rows is None
        pb = tb.to_padded_batch()
        assert pb.cold_rows is None and pb.cold_pos.shape[0] == 64
    else:
        np.testing.assert_array_equal(tb.cold_rows, jb.cold_rows)


def test_cold_fold_update_raises_on_the_distributed_path():
    cfg = RunConfig(hbm_fraction=0.5, cold_fold_update=True)
    with pytest.raises(ValueError, match="cold_fold_update"):
        DistributedTrainer(cfg, None, None, device="cpu")
