"""Layerwise full-graph inference in the port (``models/inference.py``)
against the JAX package's ``layerwise_inference``, against the port's own
full-expansion batch forward, and through the Trainer and the driver with
``final_test_mode=layerwise``, on the CPU.

The graph is the suite's ``tiny_graph`` (500 nodes), 2 layers, hidden 16,
chunk 128, float32. BatchNorm running statistics are random (so that the
eval-mode path reads carried statistics, not the init's 0 and 1). Both
layerwise engines run the same float32 arithmetic with sums in another
order: tolerance 2e-4, the reference-parity tolerance of the suite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salient_plusplus_tpu.models import make_model as jmake_model
from salient_plusplus_tpu.models.inference import (
    layerwise_inference as j_layerwise)
from salient_plusplus_tpu.sampling.batch import BatchSpec as JBatchSpec
from salient_plusplus_tpu.sampling.cpp import NativeSampler as JNative

from salient_plusplus_tpu_torch import driver, weights
from salient_plusplus_tpu_torch.config import RunConfig
from salient_plusplus_tpu_torch.models import make_model
from salient_plusplus_tpu_torch.models.inference import (
    _chunk_spec, layerwise_inference)
from salient_plusplus_tpu_torch.sampling.batch import BatchSpec
from salient_plusplus_tpu_torch.sampling.cpp import NativeSampler
from salient_plusplus_tpu_torch.train.loop import Trainer
from tests.test_torch_models import _randomise_bn

torch.set_num_threads(1)
MODELS = ["SAGE", "SAGEClassic", "GIN", "JKNet", "SAGEResInception"]
TOL = 2e-4
HID, CHUNK = 16, 128


def _full_spec(g, seeds: int = 16):
    """Caps that hold a 2-hop full expansion of any seed set."""
    E, V = len(g.col), g.num_nodes
    return ((-1, -1), seeds, (seeds, V + 128, V + 128), (E + 128, E + 128))


def _models(g, name):
    """(jax model, params, batch_stats, port model in eval mode) with the
    same random weights and running statistics."""
    C = g.num_classes
    jmodel = jmake_model(name, g.num_features, HID, C, 2, dtype=jnp.float32)
    seeds = np.asarray(g.split_idx["valid"][:16])
    jb = JNative(np.asarray(g.rowptr), np.asarray(g.col)).sample(
        JBatchSpec(*_full_spec(g)), seeds, rng_seed=0)
    x = jnp.asarray(np.asarray(g.x, np.float32))[np.asarray(jb.n_id)]
    var = jax.tree_util.tree_map(np.array, jmodel.init(
        jax.random.key(0), x, jb, training=False))
    params, stats = _randomise_bn(dict(var["params"]),
                                  dict(var.get("batch_stats", {})),
                                  np.random.default_rng(5))
    model = make_model(name, g.num_features, HID, C, 2, dtype=torch.float32)
    model.load_state_dict({**weights.params_from_jax(params),
                           **weights.batch_stats_from_jax(stats)})
    return jmodel, params, stats, model.eval()


@pytest.mark.parametrize("name", MODELS)
def test_layerwise_matches_jax(tiny_graph, name):
    g = tiny_graph
    _, params, stats, model = _models(g, name)
    x = np.asarray(g.x, np.float32)
    ref = np.asarray(j_layerwise(name, params, g.rowptr, g.col,
                                 jnp.asarray(x), num_layers=2, chunk=CHUNK,
                                 dtype=jnp.float32, batch_stats=stats or None))
    got = layerwise_inference(name, model, g.rowptr, g.col,
                              torch.from_numpy(x), chunk=CHUNK)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert not model.training   # the mode it was given is kept
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", MODELS)
def test_layerwise_matches_full_expansion_forward(tiny_graph, name):
    """A 2-hop full-expansion batch sees every edge too, so the port's
    batch forward (eval mode) gives the layerwise rows of its seeds."""
    g = tiny_graph
    *_, model = _models(g, name)
    x = torch.from_numpy(np.asarray(g.x, np.float32))
    seeds = np.sort(np.asarray(g.split_idx["test"][:16]))
    b = NativeSampler(np.asarray(g.rowptr), np.asarray(g.col)).sample(
        BatchSpec(*_full_spec(g)), seeds, rng_seed=0)
    assert b.overflow.tolist() == [0, 0]
    with torch.no_grad():
        sampled = model(x.index_select(0, b.n_id), b)[:16]
    got = layerwise_inference(name, model, g.rowptr, g.col, x, chunk=CHUNK)
    np.testing.assert_allclose(sampled.numpy(), got[seeds].numpy(),
                               rtol=TOL, atol=TOL)


def test_chunk_spec_bounds_the_worst_chunk(tiny_graph):
    g = tiny_graph
    spec = _chunk_spec(np.asarray(g.rowptr), CHUNK)
    deg = np.diff(g.rowptr)
    worst = max(deg[s:s + CHUNK].sum() for s in range(0, g.num_nodes, CHUNK))
    assert spec.fanouts == (-1,) and spec.seed_cap == CHUNK
    assert worst < spec.edge_caps[0] <= worst + 256
    assert spec.node_caps[1] >= CHUNK + worst


@pytest.mark.parametrize("name,match", [
    ("ARMA", "broken in the reference"), ("GCN", "ROADMAP.md Queue 1 item 11"),
    ("GAT", "ROADMAP.md Queue 1 item 12")])
def test_layerwise_unserved_models_raise(name, match):
    with pytest.raises(NotImplementedError, match=match):
        layerwise_inference(name, None, np.zeros(2, np.int64),
                            np.zeros(0, np.int32), torch.zeros(1, 4))


def _cfg(**kw):
    base = dict(train_batch_size=64, test_batch_size=128,
                train_fanouts=[5, 3], batchwise_test_fanouts=[8, 8],
                final_test_fanouts=[8, 8], num_layers=2, hidden_features=16,
                num_workers=1, calibration_batches=2, lr=0.01, epochs=2,
                final_test_mode="layerwise", inference_chunk=128)
    base.update(kw)
    return RunConfig(**base)


@pytest.mark.parametrize("name,floor,gap", [("SAGE", 0.7, 0.15),
                                            ("GIN", 0.35, None)])
def test_trainer_layerwise_final_test(tiny_graph, name, floor, gap):
    """As the JAX suite's test: the trial's final accuracies come from
    layerwise inference and (SAGE) agree with batchwise eval. GIN learns
    slower in two epochs, and its sums over whole neighbourhoods move away
    from the BN statistics of fanout-5 training, so it is held only above
    chance (0.2)."""
    t = Trainer(_cfg(model_name=name), tiny_graph, device="cpu")
    res = t.run_trial(0)
    assert ("layerwise_acc", "test", res.final_test_acc) in t.logger.events
    assert res.final_test_acc > floor
    if gap is not None:
        assert abs(res.final_test_acc - t.evaluate("test")) < gap


def test_trainer_scores_unserved_model_batchwise(tiny_graph):
    """A model the JAX package does not serve layerwise (ARMA, not ported
    yet) is scored batchwise, with the JAX package's log line."""
    t = Trainer(_cfg(epochs=1), tiny_graph, device="cpu")
    t.cfg = t.cfg.replace(model_name="ARMA")
    accs = t.evaluate_layerwise(("valid", "test"))
    assert ("LAYERWISE_UNSUPPORTED_FALLBACK", "ARMA") in t.logger.events
    assert set(accs) == {"valid", "test"}
    assert not any(e[0] == "layerwise_acc" for e in t.logger.events
                   if isinstance(e, tuple))


def test_driver_layerwise_on_cpu(tmp_path):
    out = driver.main([
        "synth:V=2000,C=5,deg=8,F=16", "lw", "--epochs", "1",
        "--train_batch_size", "128", "--train_fanouts", "5,3",
        "--batchwise_test_fanouts", "6,6", "--final_test_fanouts", "6,6",
        "--num_layers", "2", "--hidden_features", "16", "--num_workers",
        "1", "--calibration_batches", "2", "--lr", "0.01",
        "--final_test_mode", "layerwise", "--inference_chunk", "256",
        "--output_root", str(tmp_path)], device="cpu")
    assert out[0]["final_valid"] > 0.5   # chance is 0.2
    log = (tmp_path / "lw" / "host0_logs.txt").read_text()
    assert "'layerwise_acc', 'valid'" in log
