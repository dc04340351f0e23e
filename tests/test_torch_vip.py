"""VIP caching and the communication-volume library of the PyTorch port
against the JAX package, on the CPU.

The numpy estimators, the native sampler's access counts and the
accounting are one algorithm in both packages on the same inputs, so
cached ids, access counts, volume tables, budget rows and the driver's
``communication_simulation`` results must be equal. The float32
``vip_analytical_device`` sums in another order than JAX's segment sum
and than numpy's float64, so it is held to the JAX suite's tolerance
(``tests/test_vip.py``: rtol 5e-3, atol 5e-5).
"""

import json
import warnings

import numpy as np
import pytest
import torch

from salient_plusplus_tpu import driver as jdriver
from salient_plusplus_tpu.caching import comm_budget as jbudget
from salient_plusplus_tpu.caching import experiment as jexperiment
from salient_plusplus_tpu.caching import simulate as jsimulate
from salient_plusplus_tpu.caching import vip as jvip
from salient_plusplus_tpu.config import RunConfig as JRunConfig
from salient_plusplus_tpu.data import synthetic as jsyn
from salient_plusplus_tpu.partition import (
    multiconstraint_partition as jpartition)
from salient_plusplus_tpu.sampling.batch import BatchSpec as JBatchSpec

from salient_plusplus_tpu_torch import driver
from salient_plusplus_tpu_torch.caching import comm_budget, experiment
from salient_plusplus_tpu_torch.caching import simulate, vip
from salient_plusplus_tpu_torch.data import synthetic
from salient_plusplus_tpu_torch.sampling.batch import BatchSpec

torch.set_num_threads(1)

SMALL = dict(name="small", num_nodes=5000, num_classes=10, avg_degree=10,
             num_features=32, seed=3)
FANOUTS = [5, 3]


@pytest.fixture(scope="module")
def small():
    g = synthetic.planted_partition(**SMALL)
    pids = (np.arange(g.num_nodes) * 4 // g.num_nodes).astype(np.int32)
    train = np.sort(np.random.default_rng(0).choice(
        g.num_nodes, 600, replace=False)).astype(np.int64)
    return g, pids, train


@pytest.mark.parametrize(
    "scheme", [s for s in vip.VIP_SCHEMES if s != "vip-analytical-device"])
def test_numpy_scheme_cache_ids_match_jax(small, scheme):
    g, pids, train = small
    accesses = jsimulate.simulate_vertex_accesses(
        g.rowptr, g.col, jvip.partitionwise_train_idx(pids, train), FANOUTS,
        128, num_epochs=1, seed=0)
    kw = dict(scheme=scheme, actual_vertex_accesses=accesses)
    lam = vip.get_lambda_vip_cache(g.rowptr, g.col, pids, train, FANOUTS,
                                   128, **kw)
    jlam = jvip.get_lambda_vip_cache(g.rowptr, g.col, pids, train, FANOUTS,
                                     128, **kw)
    for alpha in (0.05, 0.2):
        got, want = lam(alpha), jlam(alpha)
        assert len(got) == len(want) == 4
        for p, (a, b) in enumerate(zip(got, want)):
            assert len(a) == int(g.num_nodes * alpha / 4)
            np.testing.assert_array_equal(a, b)
            assert np.all(pids[a] != p)


def test_unknown_scheme_raises(small):
    g, pids, train = small
    with pytest.raises(ValueError, match="Invalid caching scheme"):
        vip.get_lambda_vip_cache(g.rowptr, g.col, pids, train, FANOUTS, 128,
                                 scheme="simulation")


def test_vip_device_matches_jax_and_numpy(small):
    g, _, _ = small
    pids = (np.arange(g.num_nodes) * 2 // g.num_nodes).astype(np.int32)
    tipp = vip.partitionwise_train_idx(pids, g.split_idx["train"])
    got = vip.vip_analytical_device(g.rowptr, g.col, tipp, 256, FANOUTS,
                                    edge_chunk=4096, device="cpu")
    assert g.num_edges > 3 * 4096  # several chunks ran
    jdev = jvip.vip_analytical_device(g.rowptr, g.col, tipp, 256, FANOUTS,
                                      edge_chunk=4096)
    ref = vip.vip_analytical(g.rowptr, g.col, tipp, 256, FANOUTS)
    for a, b, c in zip(got, jdev, ref):
        assert a.dtype == np.float32 and a.shape == (g.num_nodes,)
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-5)
        np.testing.assert_allclose(a, c, rtol=5e-3, atol=5e-5)
    # the scheme runs it on the device it is given
    lam = vip.get_lambda_vip_cache(g.rowptr, g.col, pids,
                                   g.split_idx["train"], FANOUTS, 256,
                                   scheme="vip-analytical-device",
                                   device="cpu")
    assert all(np.all(pids[c] != p) for p, c in enumerate(lam(0.1)))


def test_vip_device_needs_a_card_unless_told(small, monkeypatch):
    g, pids, train = small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        vip.vip_analytical_device(g.rowptr, g.col, [train], 256, FANOUTS)


def test_vertex_accesses_match_jax(small):
    g, pids, train = small
    tipp = vip.partitionwise_train_idx(pids, train)
    for epochs in (1, 2):
        got = simulate.simulate_vertex_accesses(g.rowptr, g.col, tipp,
                                                FANOUTS, 128, epochs, seed=4)
        want = jsimulate.simulate_vertex_accesses(g.rowptr, g.col, tipp,
                                                  FANOUTS, 128, epochs,
                                                  seed=4)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    # caps below the batches' frontiers: both grow the spec and run again
    # until nothing is dropped (no warning), to the same counts
    caps = dict(fanouts=(5, 3), seed_cap=128, node_caps=(128, 512, 1024),
                edge_caps=(768, 2560))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = simulate.simulate_vertex_accesses(
            g.rowptr, g.col, tipp, FANOUTS, 128, spec=BatchSpec(**caps))
        want = jsimulate.simulate_vertex_accesses(
            g.rowptr, g.col, tipp, FANOUTS, 128, spec=JBatchSpec(**caps))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_comm_volume_and_sweep_match_jax(small):
    g, pids, train = small
    kw = dict(schemes=("vip-analytical", "degree", "oracle", "random-walk"),
              replication_factors=(0.0, 0.1, 0.3), num_epochs=2, seed=1)
    got = simulate.run_replication_sweep(g.rowptr, g.col, pids, train,
                                         FANOUTS, 128, **kw)
    want = jsimulate.run_replication_sweep(g.rowptr, g.col, pids, train,
                                           FANOUTS, 128, **kw)
    assert got == want
    for by_alpha in got.values():
        for d in by_alpha.values():
            assert d["total"] == d["internal"] + d["cross"] + d["cache_hits"]
    assert simulate.tabulate_comm_results(got) == \
        jsimulate.tabulate_comm_results(want)
    acc = [np.random.default_rng(p).random(g.num_nodes) * 3 for p in range(4)]
    cached = [np.flatnonzero(pids != p)[:100] for p in range(4)]
    for c in (None, cached):
        assert simulate.evaluate_communication_volume(acc, pids, c) == \
            jsimulate.evaluate_communication_volume(acc, pids, c)


def test_experiment_cli_matches_jax(tmp_path):
    args = ["synth:V=2000,C=4,deg=8,F=8", "--parts", "2", "--fanouts", "4,3",
            "--minibatch", "128", "--schemes", "vip-analytical,degree",
            "--replication", "0,0.2"]
    res = experiment.main(args + ["--out", str(tmp_path / "port.json")])
    jres = jexperiment.main(args + ["--out", str(tmp_path / "jax.json")])
    assert res == jres
    with open(tmp_path / "port.json") as f, open(tmp_path / "jax.json") as g:
        assert json.load(f) == json.load(g)
    assert experiment.main(["--parse", str(tmp_path / "port.json")]) == \
        jexperiment.main(["--parse", str(tmp_path / "jax.json")])


def test_budget_matches_jax_at_its_link_rates():
    kw = dict(name="budget", num_nodes=6000, num_classes=6, avg_degree=10,
              num_features=32, seed=5)
    g, jg = synthetic.powerlaw_graph(**kw), jsyn.powerlaw_graph(**kw)
    labels = jpartition(jg.rowptr, jg.col, 4, seed=0)
    rates = {"nvlink": jbudget.LINK_RATES["v5p_ici"],
             "nic": jbudget.LINK_RATES["dcn_100g"]}
    rows = comm_budget.measure_budget(g, labels, alphas=(0.0, 0.05, 0.5),
                                      fanouts=(5, 3), batch_size=256,
                                      step_time_s=16e-3, link_rates=rates)
    jrows = jbudget.measure_budget(jg, labels, alphas=(0.0, 0.05, 0.5),
                                   fanouts=(5, 3), batch_size=256,
                                   step_time_s=16e-3)
    for r, j in zip(rows, jrows):
        assert (r.alpha, r.r_cap, r.wire_bytes_per_step,
                r.sim_cross_per_batch) == (j.alpha, j.r_cap,
                                           j.wire_bytes_per_step,
                                           j.sim_cross_per_batch)
        assert (r.comm_share_nvlink, r.comm_share_nic) == \
            (j.comm_share_ici, j.comm_share_dcn)
    assert rows[-1].r_cap < rows[0].r_cap
    for fp8 in (False, True):
        assert comm_budget.wire_bytes_per_step(8, 1024, 100, wire_fp8=fp8) \
            == jbudget.wire_bytes_per_step(8, 1024, 100, wire_fp8=fp8)
    assert comm_budget.comm_share(10 ** 6, 0.01, 5e10) == \
        jbudget.comm_share(10 ** 6, 0.01, 5e10)


SIM_ARGS = ["synth:V=3000,C=4,deg=6,F=8", "sim", "--execution_mode",
            "communication_simulation", "--train_fanouts", "4,3",
            "--train_batch_size", "128", "--cache_creation_epochs", "1"]


def _results(tmp_path, label):
    with open(tmp_path / label / "sim" / "results.json") as f:
        return json.load(f)


@pytest.mark.parametrize("strategy", ["vip", "degree"])
def test_driver_simulation_matches_jax(tmp_path, strategy):
    extra = ["--cache_strategy", strategy]
    out = driver.main(SIM_ARGS + extra + ["--output_root",
                                          str(tmp_path / "port")])
    jdriver.main(SIM_ARGS + extra + ["--output_root", str(tmp_path / "jax")])
    got, want = _results(tmp_path, "port"), _results(tmp_path, "jax")
    assert got == want
    assert set(got) == set(driver.SIM_SCHEMES.get(strategy, (strategy,)))
    for by_alpha in out.values():
        assert sorted(by_alpha) == [0.0, 0.01, 0.05, 0.1, 0.2]
        for d in by_alpha.values():
            assert d["total"] == d["internal"] + d["cross"] + d["cache_hits"]


def test_simulation_strategy_fault_of_the_reference(tmp_path):
    """The JAX driver passes ``--cache_strategy simulation`` to the sweep
    unmapped and ``caching/vip.py`` refuses it; the port maps it to
    ``vip-simulation``, as the JAX trainer's ``create_cache`` does, and its
    result equals the JAX sweep of that scheme."""
    extra = ["--cache_strategy", "simulation"]
    with pytest.raises(ValueError, match="Invalid caching scheme: simulation"):
        jdriver.main(SIM_ARGS + extra + ["--output_root",
                                         str(tmp_path / "jax")])
    driver.main(SIM_ARGS + extra + ["--output_root", str(tmp_path / "port")])
    g = jdriver.load_dataset(JRunConfig(), SIM_ARGS[0])
    labels = jpartition(g.rowptr, g.col, 4, seed=0)
    want = jsimulate.run_replication_sweep(
        g.rowptr, g.col, labels, g.split_idx["train"], [4, 3], 128,
        schemes=("vip-simulation",),
        replication_factors=(0.0, 0.01, 0.05, 0.1, 0.2), num_epochs=1,
        seed=0)
    assert _results(tmp_path, "port") == json.loads(json.dumps(want))
