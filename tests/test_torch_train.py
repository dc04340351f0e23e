"""Training through the PyTorch port: train steps against the JAX
package's ``make_train_step``, the port's Trainer and driver CLI on the
CPU, and the port's independence from JAX.

The train-step parity runs in float32 with dropout 0 (the two frameworks
draw different dropout bits) on carried-over weights; Adam's update is the
same formula in both (optax defaults = torch betas 0.9/0.999, eps 1e-8).
"""

import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salient_plusplus_tpu.models import make_model as jmake_model
from salient_plusplus_tpu.ops import mxu_segment as M
from salient_plusplus_tpu.train import step as jstep
from salient_plusplus_tpu.train.state import create_train_state as jcreate

from salient_plusplus_tpu_torch import driver, weights
from salient_plusplus_tpu_torch.config import RunConfig
from salient_plusplus_tpu_torch.data import synthetic
from salient_plusplus_tpu_torch.models import make_model
from salient_plusplus_tpu_torch.train import step as tstep
from salient_plusplus_tpu_torch.train.loop import Trainer
from salient_plusplus_tpu_torch.train.state import TrainState
from salient_plusplus_tpu_torch.utils import device as device_mod
from tests.test_torch_sage import C_OUT, HID, make_pair

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.01


@pytest.fixture(autouse=True)
def _interpret_mode():
    M.use_mxu_spmm(True, interpret=True)
    yield
    M.use_mxu_spmm(None, interpret=False)


def _trajectories(gsrc, steps):
    """Losses and params of both packages after each of ``steps`` steps
    on the same batches from the same weights."""
    pairs = [make_pair(gsrc, L=2, seed=s) for s in range(steps)]
    x = pairs[0][3]
    jmodel = jmake_model("SAGE", x.shape[1], HID, C_OUT, 2, 0.0,
                         dtype=jnp.float32)
    jb0 = jstep.decode_batch(pairs[0][1])
    ex_x, extra = jstep._x_and_extra(jnp.asarray(x), jb0, gsrc)
    jstate = jcreate(jmodel, ex_x, jb0, LR, seed=0)
    jstate = jstate.replace(params=jax.tree_util.tree_map(
        jnp.asarray, jstate.params))
    model = make_model("SAGE", x.shape[1], HID, C_OUT, 2, 0.0,
                       dtype=torch.float32)
    model.load_state_dict(weights.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params)))
    tstate = TrainState(model, LR, seed=0, device=torch.device("cpu"))
    jfn = jstep.make_train_step(global_msg0=gsrc)
    feats_j, feats_t = jnp.asarray(x), torch.from_numpy(x)
    out = []
    for _, jb, tb, _ in pairs:
        jstate, jloss = jfn(jstate, feats_j, jb)
        tloss = tstep.train_step(tstate, feats_t, tb, gsrc)
        out.append((float(jloss), float(tloss),
                    jax.tree_util.tree_map(np.asarray, jstate.params),
                    weights.params_to_jax(tstate.model.state_dict())))
    return out


def _assert_params_close(jp, tp, tol):
    la = jax.tree_util.tree_leaves_with_path(jp)
    lb = jax.tree_util.tree_leaves_with_path(tp)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, a), (_, b) in zip(la, lb):
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol, err_msg=str(k))


@pytest.mark.parametrize("gsrc", [False, True])
def test_one_train_step_matches_jax(gsrc):
    (jl, tl, jp, tp), = _trajectories(gsrc, 1)
    assert abs(jl - tl) < 2e-4, (jl, tl)
    _assert_params_close(jp, tp, 2e-4)


def test_five_step_trajectory_matches_jax():
    traj = _trajectories(True, 5)
    for jl, tl, _, _ in traj:
        assert abs(jl - tl) < 2e-4, (jl, tl)
    _assert_params_close(traj[-1][2], traj[-1][3], 2e-4)
    assert traj[-1][0] < traj[0][0]  # it trains


def _tiny_cfg(**kw):
    base = dict(train_batch_size=128, train_fanouts=[5, 3],
                batchwise_test_fanouts=[6, 6], final_test_fanouts=[6, 6],
                test_batch_size=256, num_layers=2, hidden_features=16,
                num_workers=1, calibration_batches=2, lr=0.01, epochs=3,
                max_batches_in_flight=2)
    base.update(kw)
    return RunConfig(**base)


def test_trainer_learns_on_planted_graph():
    g = synthetic.planted_partition(name="learn", num_nodes=1500,
                                    num_classes=4, avg_degree=8,
                                    num_features=16, seed=1)
    tr = Trainer(_tiny_cfg(), g, device="cpu")
    assert tr.features.dtype == torch.bfloat16
    assert tr.features.shape[1] == 128
    res = tr.run_trial(0)
    assert all(np.isfinite(res.losses))
    assert res.losses[-1] < res.losses[0]
    assert res.final_valid_acc > 0.8  # chance is 0.25


def test_trainer_refuses_unlabeled_train_nodes():
    """A train node labeled -1 trains as the last class in JAX and stops
    the card on a device-side assert in the port's loss: the Trainer
    refuses the split at construction, naming the count and first id."""
    g = synthetic.planted_partition(name="unl", num_nodes=600,
                                    num_classes=4, avg_degree=6,
                                    num_features=8, seed=3)
    train = np.asarray(g.split_idx["train"])
    g.y = np.asarray(g.y).copy()
    g.y[train[[5, 9]]] = -1
    with pytest.raises(ValueError, match=f"2 node.*first id {train[5]}"):
        Trainer(_tiny_cfg(), g, device="cpu")
    # an unlabeled node outside the train split is allowed
    g.y[train[[5, 9]]] = 0
    g.y[np.asarray(g.split_idx["test"])[0]] = -1
    Trainer(_tiny_cfg(), g, device="cpu")


def test_pipeline_disabled_gives_the_same_losses():
    g = synthetic.planted_partition(name="pipe", num_nodes=800,
                                    num_classes=3, avg_degree=6,
                                    num_features=8, seed=2)
    losses = []
    for disabled in (False, True):
        tr = Trainer(_tiny_cfg(pipeline_disabled=disabled, dropout=0.0),
                     g, device="cpu")
        losses.append([tr.train_epoch(e) for e in range(2)])
    assert losses[0] == losses[1]


def test_driver_cli_runs_on_cpu(tmp_path):
    out = driver.main([
        "synth:V=2000,C=5,deg=8,F=16", "job1", "--epochs", "1",
        "--train_batch_size", "128", "--train_fanouts", "5,3",
        "--batchwise_test_fanouts", "6,6", "--final_test_fanouts", "6,6",
        "--num_layers", "2", "--hidden_features", "16", "--num_workers",
        "1", "--calibration_batches", "2", "--lr", "0.01",
        "--output_root", str(tmp_path)], device="cpu")
    assert out[0]["final_valid"] > 0.5  # chance is 0.2
    assert np.isfinite(out[0]["losses"]).all()
    with open(tmp_path / "job1" / "results.json") as f:
        assert json.load(f)[0]["trial"] == 0
    assert (tmp_path / "job1" / "args.json").exists()


@pytest.mark.parametrize("flags", [
    ["--distribute_data", "true"],
    ["--distribute_data", "true", "--computation_mode", "frequency_cache"],
    ["--distribute_data", "true", "--hbm_fraction", "0.5"],
])
def test_driver_distribute_data_single_process(tmp_path, flags):
    """With one process the flag trains on one card, as the JAX driver
    does with one device."""
    out = driver.main(["synth:V=1500,C=3,deg=6,F=8", "j", "--epochs", "1",
                       "--train_batch_size", "128", "--train_fanouts", "3,2",
                       "--batchwise_test_fanouts", "4,4",
                       "--final_test_fanouts", "4,4", "--num_layers", "2",
                       "--hidden_features", "16", "--num_workers", "1",
                       "--calibration_batches", "2", "--lr", "0.01",
                       "--output_root", str(tmp_path), *flags], device="cpu")
    assert np.isfinite(out[0]["losses"]).all()
    assert out[0]["final_valid"] > 1 / 3  # chance
    assert (tmp_path / "j" / "host0_logs.txt").exists()


@pytest.fixture(scope="module")
def two_rank_driver(tmp_path_factory):
    """driver.main with --distribute_data in 2 gloo ranks
    (tests/_torch_dist_worker.py::driver_rank): the VIP cache with the
    owner-served cold tier, 2 epochs, then RESUME=1 to 3 epochs; then
    training from partition.cli's 2-part output, one shard a rank."""
    from tests import _torch_dist_worker as W
    from salient_plusplus_tpu_torch.partition import cli

    root = tmp_path_factory.mktemp("dist_driver")
    path = cli.main(["synth:V=2000,C=4,deg=6,F=8", "--parts", "2",
                     "--out_root", str(root), "--fanouts", "4,3",
                     "--minibatch", "64"])
    W.wait(W.start(W.driver_rank, (_free_port(), str(root),
                                   os.path.basename(path))),
           "driver ranks")
    return root


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("job", ["cache", "partitioned"])
def test_driver_distribute_data_two_ranks(two_rank_driver, job):
    root = two_rank_driver
    runs = []
    for r in range(2):
        with open(root / f"{job}_rank{r}.json") as f:
            runs.append(json.load(f)["out"][0])
    for k in ("best_epoch", "final_valid", "final_test", "losses"):
        assert runs[0][k] == runs[1][k], k  # every rank scored the same
    res = runs[0]
    assert np.isfinite(res["losses"]).all()
    assert res["final_valid"] > 0.5  # 4 classes: chance is 0.25
    job_dir = root / ("cache" if job == "cache" else "part")
    with open(job_dir / "results.json") as f:  # written by rank 0
        assert json.load(f)[0]["final_valid"] == res["final_valid"]
    assert (job_dir / "args.json").exists()
    logs = sorted(p.name for p in job_dir.glob("*_logs.txt"))
    assert [n[-15:] for n in logs] == ["-rank0_logs.txt", "-rank1_logs.txt"]
    if job == "cache":
        with open(job_dir / logs[0]) as f:
            text = f.read()
        assert "EFFECTIVE_CACHE_SIZE" in text and "COLD_WIRE_BYTES" in text
        with open(root / "resume_rank0.json") as f:
            resume = json.load(f)
        # RESUME=1 restarts after the latest epoch the 2-epoch run saved
        latest = resume["latest_before"]
        assert latest in (0, 1)
        assert len(resume["out"][0]["losses"]) == 3 - (latest + 1)
    else:
        for r in range(2):
            with open(root / f"refused_rank{r}.json") as f:
                assert json.load(f) is True  # replicated cold needs all shards


def test_driver_communication_simulation_runs_on_the_host(tmp_path,
                                                          monkeypatch):
    """The simulation mode partitions, samples and counts on the host: the
    CLI runs it without a card (parity with JAX: tests/test_torch_vip.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("SIM_PARTS", "3")
    out = driver.main(["synth:V=1500,C=3,deg=6,F=8", "sim",
                       "--execution_mode", "communication_simulation",
                       "--train_fanouts", "4,3", "--train_batch_size", "64",
                       "--cache_creation_epochs", "1", "--output_root",
                       str(tmp_path)])
    assert set(out) == {"vip-analytical", "degree"}
    for by_alpha in out.values():
        assert by_alpha[0.0]["cross"] > by_alpha[0.2]["cross"] > 0
        for d in by_alpha.values():
            assert d["total"] == d["internal"] + d["cross"] + d["cache_hits"]
    with open(tmp_path / "sim" / "results.json") as f:
        assert set(json.load(f)) == set(out)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_mod.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.main(["synth:V=500", "j", "--output_root", "/nonexistent"])
    assert device_mod.resolve_device("cpu").type == "cpu"


_FORBIDDEN = ("jax", "flax", "optax", "ml_dtypes", "salient_plusplus_tpu")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "salient_plusplus_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    rel = {os.path.relpath(f, REPO) for f in files}
    for new in ("ops/gat_agg.py", "train/checkpoint.py", "models/layers.py",
                "models/inference.py", "parallel/exchange.py",
                "sampling/cold_cache.py", "sampling/oracle.py",
                "train/cold_policy.py", "utils/data_collector.py",
                "partition/partitioner.py", "partition/cli.py",
                "data/partition_book.py", "data/reorder.py",
                "caching/vip.py", "caching/simulate.py",
                "caching/experiment.py", "caching/comm_budget.py",
                "parallel/mesh.py", "sampling/shufflers.py",
                "parallel/spmd.py", "train/dist_loop.py",
                "train/dist_inference.py", "data/ogb.py",
                "data/salient_import.py", "partition/quality_bench.py",
                "utils/download_datasets.py", "utils/configure_env.py",
                "utils/exp_launcher.py", "utils/readiness_drill.py",
                "experiments/fp8_study.py", "experiments/scaling_harness.py",
                "parallel/launch.py", "bench.py"):
        assert os.path.join("salient_plusplus_tpu_torch", new) in rel
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in _FORBIDDEN, (path, mod)
