"""The port's launchers against the JAX package's (``parallel/mesh.py``'s
rendezvous, ``parallel/launch.py``, the driver's local launch).

- ``launcher_env`` against JAX 0.9.0's ``SlurmCluster`` and
  ``OmpiCluster`` on a monkeypatched environment: host:port, rank, world
  and local rank for the node lists and URIs those classes parse, the
  port override (``MASTER_PORT`` where JAX reads ``JAX_COORDINATOR_PORT``)
  and both launchers at once (Open MPI first, in both).
- The runs JAX cannot join (no launcher it knows names a coordinator,
  though several processes are intended) raise in the port too, and so
  does an incomplete torchrun set; a local rank without a card raises.
- The local launch's decision table, the counterpart of the JAX driver's
  ``len(jax.devices()) > 1``, with the card count monkeypatched.
- Spawned on the CPU in gloo: the README's 2-rank driver job under only
  SLURM variables, only Open MPI variables, torchrun's, and
  ``launch_local``; each forms the group with a live heartbeat and ends
  with 0, and every results.json equals torchrun's key by key (but the
  epoch's wall time). A rank that fails fails ``launch_local``.

Each spawned run is killed after 120 s. Only the JAX cluster classes are
called, never ``jax.distributed``'s auto-detection, which would also
probe cloud metadata servers.
"""

import json
import os
import threading
import time

import pytest
import torch
from jax._src.clusters import ClusterEnv, OmpiCluster, SlurmCluster

from salient_plusplus_tpu.parallel import mesh as jax_mesh
from salient_plusplus_tpu_torch import driver
from salient_plusplus_tpu_torch.parallel import launch, mesh
from salient_plusplus_tpu_torch.parallel.launch import (
    RankFailed, launch_local, local_launch_ranks, run_ranks)

torch.set_num_threads(1)

SPAWN_TIMEOUT_S = 120
# README's 2-rank driver job (the data-parallel CPU example)
README_ARGV = ["synth:V=4096,C=4,deg=8,F=16", "dp", "--distribute_data",
               "true", "--computation_mode", "frequency_cache", "--epochs",
               "1", "--train_batch_size", "64", "--train_fanouts", "4,3",
               "--batchwise_test_fanouts", "5,5", "--final_test_fanouts",
               "5,5", "--num_layers", "2", "--hidden_features", "16",
               "--num_workers", "1"]
# a rank: the driver on the CPU, then its group and heartbeat
RANK_CODE = (
    "import sys; import torch.distributed as dist; "
    "from salient_plusplus_tpu_torch import driver; "
    "from salient_plusplus_tpu_torch.parallel import mesh; "
    "driver.main(sys.argv[1:], device='cpu'); "
    "hb = mesh.current_heartbeat(); "
    "print('GROUP', dist.get_rank(), dist.get_world_size(), "
    "dist.get_backend(), hb is not None)")
NODE_LISTS = ["n001", "n001,h2", "n[001-015],h2", "n[001,007-015],h2"]
URIS = ["1531576320.0;tcp://10.96.0.1,10.148.0.1,10.108.0.1:34911",
        "1314521088.0;tcp6://[fe80::b9b:ac5d:9cf0:b858,"
        "2620:10d:c083:150e::3000:2]:43370"]


@pytest.fixture
def clean_env(monkeypatch):
    """No launcher's variable, nor JAX's port override, in the
    environment."""
    for v in mesh.LAUNCHER_VARS + ("JAX_COORDINATOR_PORT",
                                      "CUDA_VISIBLE_DEVICES"):
        monkeypatch.delenv(v, raising=False)
    return monkeypatch


def _jax_view(cluster):
    """(host:port, world, rank, local rank) as JAX's ``cluster`` gives them
    (``auto_detect_unset_distributed_params``'s calls)."""
    return (cluster.get_coordinator_address(
                timeout_secs=None,
                override_coordinator_port=os.environ.get(
                    "JAX_COORDINATOR_PORT")),
            cluster.get_process_count(), cluster.get_process_id(),
            cluster.get_local_process_id())


def _port_view():
    e = mesh.launcher_env(os.environ)
    return (f"{e['MASTER_ADDR']}:{e['MASTER_PORT']}", int(e["WORLD_SIZE"]),
            int(e["RANK"]), int(e["LOCAL_RANK"]))


def _set_slurm(mp, node_list="n[001-015],h2"):
    for k, v in dict(SLURM_JOB_ID="813377", SLURM_STEP_NODELIST=node_list,
                     SLURM_NTASKS="16", SLURM_PROCID="5",
                     SLURM_LOCALID="1").items():
        mp.setenv(k, v)


def _set_ompi(mp, uri=URIS[0]):
    for k, v in dict(OMPI_MCA_orte_hnp_uri=uri, OMPI_COMM_WORLD_RANK="3",
                     OMPI_COMM_WORLD_SIZE="8",
                     OMPI_COMM_WORLD_LOCAL_RANK="3").items():
        mp.setenv(k, v)


def _override(mp, port):
    if port is not None:
        mp.setenv("MASTER_PORT", port)
        mp.setenv("JAX_COORDINATOR_PORT", port)


@pytest.mark.parametrize("port", [None, "29511"], ids=["job_port", "override"])
@pytest.mark.parametrize("node_list", NODE_LISTS)
def test_slurm_matches_jax(clean_env, node_list, port):
    _set_slurm(clean_env, node_list)
    _override(clean_env, port)
    assert SlurmCluster.is_env_present()
    assert _port_view() == _jax_view(SlurmCluster)
    assert _port_view()[0] == f"n001:{port or 813377 % 4096 + 61440}"


@pytest.mark.parametrize("port", [None, "29511"], ids=["job_port", "override"])
@pytest.mark.parametrize("uri", URIS, ids=["tcp", "tcp6"])
def test_ompi_matches_jax(clean_env, uri, port):
    _set_ompi(clean_env, uri)
    _override(clean_env, port)
    assert OmpiCluster.is_env_present()
    assert _port_view() == _jax_view(OmpiCluster)
    assert "[" not in _port_view()[0]


def test_one_bracketed_node_fault_of_the_reference(clean_env):
    """JAX's parse keeps the closing bracket of ``n[001]`` (no ``,`` or
    ``-`` follows the first number); the port stops at it."""
    _set_slurm(clean_env, "n[001]")
    assert _jax_view(SlurmCluster)[0].startswith("n001]:")
    assert _port_view()[0] == f"n001:{813377 % 4096 + 61440}"


def test_both_launchers_ompi_first_as_in_jax(clean_env):
    _set_slurm(clean_env)
    _set_ompi(clean_env)
    first = next(c for c in ClusterEnv._cluster_types
                 if c in (OmpiCluster, SlurmCluster) and c.is_env_present())
    assert first is OmpiCluster
    assert _port_view() == _jax_view(OmpiCluster) != _jax_view(SlurmCluster)


def test_master_addr_and_torchrun_set_win(clean_env):
    _set_slurm(clean_env)
    clean_env.setenv("MASTER_ADDR", "10.0.0.7")
    assert _port_view() == ("10.0.0.7:" + str(813377 % 4096 + 61440), 16, 5,
                            1)
    for k, v in dict(MASTER_PORT="29500", RANK="1", WORLD_SIZE="2",
                     LOCAL_RANK="1").items():
        clean_env.setenv(k, v)
    assert _port_view() == ("10.0.0.7:29500", 2, 1, 1)


@pytest.mark.parametrize("case", [
    dict(PMI_SIZE="2", PMI_RANK="0"),                         # MPICH hydra
    dict(SLURM_NTASKS="2", SLURM_PROCID="0", SLURM_LOCALID="0",
         SLURM_JOB_ID="123", SLURM_JOB_NODELIST="localhost"),  # sbatch step
    dict(OMPI_COMM_WORLD_SIZE="2", OMPI_COMM_WORLD_RANK="0",
         OMPI_COMM_WORLD_LOCAL_RANK="0"),                     # Open MPI 5
], ids=["mpich", "slurm_batch_step", "ompi5"])
def test_intended_without_a_launcher_raises_as_jax(clean_env, case):
    for k, v in case.items():
        clean_env.setenv(k, v)
    # JAX: several processes intended, no cluster it knows names a
    # coordinator, so jax.distributed.initialize() raises
    assert jax_mesh.multiprocess_intended(os.environ)
    assert not SlurmCluster.is_env_present()
    assert not OmpiCluster.is_env_present()
    assert mesh.multiprocess_intended(os.environ)
    assert mesh.launcher_env(os.environ) is None
    with pytest.raises(RuntimeError, match="names no rendezvous.*srun"):
        mesh.maybe_initialize_distributed("cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("missing", ["MASTER_ADDR", "MASTER_PORT", "RANK"])
def test_incomplete_torchrun_set_raises(clean_env, missing):
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT="29500",
                     RANK="0", WORLD_SIZE="2").items():
        if k != missing:
            clean_env.setenv(k, v)
    with pytest.raises(ValueError, match=f"incomplete: {missing}"):
        mesh.maybe_initialize_distributed("cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("local,count", [(0, 1), (1, 2), (3, 4), (1, 1),
                                         (4, 4), (0, 0)])
def test_card_index_never_wraps(clean_env, local, count):
    clean_env.setattr(torch.cuda, "device_count", lambda: count)
    clean_env.setenv("CUDA_VISIBLE_DEVICES", "7")
    env = dict(os.environ, LOCAL_RANK=str(local))
    if local < count:
        assert mesh.card_index(env) == local
    else:
        with pytest.raises(RuntimeError,
                           match=rf"LOCAL_RANK={local} .* is {count} "
                                 r"\(CUDA_VISIBLE_DEVICES=7\)"):
            mesh.card_index(env)


CUDA = torch.device("cuda")


@pytest.mark.parametrize("cards,distribute,training,device,env,want", [
    (1, True, True, CUDA, {}, 1),
    (4, True, True, CUDA, {}, 4),
    (4, False, True, CUDA, {}, 1),
    (4, True, False, CUDA, {}, 1),              # --do_test_run, simulation
    (4, True, True, torch.device("cpu"), {}, 1),
    (4, True, True, CUDA, {"RANK": "0"}, 1),
    (4, True, True, CUDA, {"WORLD_SIZE": "4"}, 1),
    (4, True, True, CUDA, {"SLURM_NTASKS": "4"}, 1),
    (4, True, True, CUDA, {"OMPI_COMM_WORLD_SIZE": "2"}, 1),
    # srun -n 1: one process with every card, as jax.devices() has them
    (4, True, True, CUDA, {"SLURM_NTASKS": "1", "SLURM_PROCID": "0"}, 4),
], ids=["one_card", "four_cards", "not_distributed", "not_training", "cpu",
        "rank_set", "world_set", "srun", "mpirun", "srun_one_task"])
def test_local_launch_decision(clean_env, cards, distribute, training,
                               device, env, want):
    clean_env.setattr(torch.cuda, "device_count", lambda: cards)
    assert local_launch_ranks(distribute, training, device,
                              dict(os.environ, **env)) == want


@pytest.mark.parametrize("extra,spawns", [
    ([], 4), (["--do_test_run", "0"], 0),
    (["--execution_mode", "communication_simulation"], 0)],
    ids=["train", "test_run", "simulation"])
def test_driver_main_takes_the_local_launch(clean_env, tmp_path, extra,
                                            spawns):
    """driver.main with 4 cards: a training run goes to launch_local with
    4 ranks and returns what it returns; the others never spawn (here
    they stop where the card is needed, or fail on the simulation's
    cache strategy)."""
    calls = []
    clean_env.setattr(torch.cuda, "device_count", lambda: 4)
    clean_env.setattr(launch, "launch_local",
                      lambda argv, n: calls.append((argv, n)) or ["rank0"])
    clean_env.setattr(driver, "run_communication_simulation",
                      lambda cfg, graph, logger: {"sim": True})
    argv = ["synth:V=300,C=3,deg=4,F=8", "j", "--distribute_data", "true",
            "--output_root", str(tmp_path), *extra]
    if spawns:
        assert driver.main(argv) == ["rank0"]
        assert calls == [(argv, 4)]
    elif "--do_test_run" in extra:
        clean_env.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            driver.main(argv)
    else:
        assert driver.main(argv) == {"sim": True}
    assert len(calls) == (1 if spawns else 0)


def _results(root):
    with open(os.path.join(root, "dp", "results.json")) as f:
        return json.load(f)


def _but_time(results):
    return [{k: v for k, v in r.items() if k != "epoch_times"}
            for r in results]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The README job four ways at once, 2 gloo ranks each: torchrun's
    variables, SLURM's only, Open MPI's only (``run_ranks``), and
    ``launch_local``. Returns {way: (outputs, results, output root)}."""
    root = tmp_path_factory.mktemp("launchers")
    got, errors = {}, []

    def run(way):
        out = str(root / way)
        try:
            if way == "local":
                t0 = time.time_ns()
                res = launch_local(README_ARGV + ["--output_root", out], 2,
                                   "cpu", timeout_s=SPAWN_TIMEOUT_S)
                got[way] = ((t0, time.time_ns()), res, out)
            else:
                rcs, outs, _ = run_ranks(
                    ["-c", RANK_CODE, *README_ARGV, "--output_root", out],
                    2, SPAWN_TIMEOUT_S, launcher=way)
                got[way] = (outs, _results(out), out)
        except Exception as e:  # noqa: BLE001 — reported by the tests
            errors.append((way, e))

    threads = [threading.Thread(target=run, args=(w,))
               for w in ("torchrun", "slurm", "ompi", "local")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(SPAWN_TIMEOUT_S + 30)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    return got


@pytest.mark.parametrize("way", ["torchrun", "slurm", "ompi"])
def test_launcher_pair_trains_like_torchrun(launched, way):
    outs, res, _ = launched[way]
    for r in range(2):
        # the group of 2 formed from this launcher's variables, in gloo,
        # with the rank's heartbeat running
        assert f"GROUP {r} 2 gloo True" in outs[r], outs[r][-2000:]
    assert _but_time(res) == _but_time(launched["torchrun"][1])
    assert res[0]["final_valid"] > 0.5   # 4 classes: chance is 0.25


def test_launch_local_matches_run_ranks(launched):
    (t0, t1), res, out = launched["local"]
    assert _but_time(res) == _but_time(launched["torchrun"][1])
    job = os.path.join(out, "dp")
    assert _results(out) == res
    # written by rank 0 during the launch; rank 1's output in its file
    assert t0 <= os.stat(os.path.join(job, "results.json")).st_mtime_ns <= t1
    assert os.path.exists(os.path.join(job, "rank1_output.txt"))
    logs = sorted(n[-15:] for n in os.listdir(job) if n.endswith("_logs.txt"))
    assert logs == ["-rank0_logs.txt", "-rank1_logs.txt"]


def test_launch_local_fails_with_the_rank(tmp_path):
    """A 3-part dataset for 2 ranks raises in the ranks (as JAX asserts
    parts == devices); launch_local ends both and raises with the code."""
    from salient_plusplus_tpu_torch.partition import cli

    path = cli.main(["synth:V=600,C=3,deg=4,F=8", "--parts", "3",
                     "--out_root", str(tmp_path), "--fanouts", "3,2",
                     "--minibatch", "32"])
    t0 = time.monotonic()
    with pytest.raises(RankFailed) as e:
        launch_local([os.path.basename(path), "bad", "--dataset_root",
                      str(tmp_path), "--distribute_data", "true",
                      "--output_root", str(tmp_path), "--num_workers", "1"],
                     2, "cpu", timeout_s=SPAWN_TIMEOUT_S)
    assert e.value.exit_code == e.value.returncode == 1
    assert time.monotonic() - t0 < SPAWN_TIMEOUT_S
    assert not os.path.exists(tmp_path / "bad" / "results.json")
