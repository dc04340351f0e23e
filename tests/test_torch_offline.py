"""The offline tools of the PyTorch port against the JAX package, on the
CPU: OGB / MAG240 ingest and the driver's fallback to it, the SALIENT++
import, the partitioned download, the partition-quality bench, the
environment config, the launcher, the readiness drill, ``Timer`` and the
sampler's sanitizer harness.

Every tool here is numpy, stdlib or torch on the host in both packages,
one algorithm on the same inputs, so outputs must be equal: arrays
equal, directories written by ``save`` byte-equal file by file, and
``meta.json`` equal as JSON. No test touches the network: ``ogb`` is a
module mocked in ``sys.modules``, SALIENT++ archives are ``.pt`` files
written here, and the download reads a ``file://`` bucket or a silent
socket on localhost.
"""

import filecmp
import json
import os
import socket
import subprocess
import sys
import tarfile
import time
import types

import numpy as np
import pytest
import torch

from salient_plusplus_tpu import driver as jdriver
from salient_plusplus_tpu.data import ogb as jogb
from salient_plusplus_tpu.data import salient_import as jimport
from salient_plusplus_tpu.data import synthetic as jsyn
from salient_plusplus_tpu.partition import cli as jcli
from salient_plusplus_tpu.partition import quality_bench as jquality
from salient_plusplus_tpu.utils import configure_env as jconfigure
from salient_plusplus_tpu.utils import download_datasets as jdownload
from salient_plusplus_tpu.utils import timing as jtiming

from salient_plusplus_tpu_torch import driver
from salient_plusplus_tpu_torch.config import RunConfig
from salient_plusplus_tpu_torch.data import ogb, salient_import, synthetic
from salient_plusplus_tpu_torch.data.dataset import GraphData
from salient_plusplus_tpu_torch.data.reorder import reorder_graph
from salient_plusplus_tpu_torch.partition import contiguous_partition
from salient_plusplus_tpu_torch.partition import quality_bench
from salient_plusplus_tpu_torch.train.loop import Trainer
from salient_plusplus_tpu_torch.utils import Timer
from salient_plusplus_tpu_torch.utils import configure_env, download_datasets
from salient_plusplus_tpu_torch.utils.exp_launcher import ExpLauncher
from salient_plusplus_tpu_torch.utils.readiness_drill import run_drill

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_RUN = ["--epochs", "1", "--train_batch_size", "32",
             "--train_fanouts", "4,3", "--batchwise_test_fanouts", "5,5",
             "--final_test_fanouts", "5,5", "--num_layers", "2",
             "--hidden_features", "16", "--num_workers", "1",
             "--calibration_batches", "2"]


def _assert_dirs_equal(a, b):
    """Directories written by both packages: the same files, every .npy
    byte-equal, every .json equal as JSON."""
    files = sorted(os.listdir(b))
    assert sorted(os.listdir(a)) == files
    npy = [f for f in files if f.endswith(".npy")]
    assert npy
    _, mismatch, errors = filecmp.cmpfiles(a, b, npy, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    for f in files:
        if f.endswith(".json"):
            with open(os.path.join(a, f)) as fa, \
                    open(os.path.join(b, f)) as fb:
                assert json.load(fa) == json.load(fb), f


def _assert_graphs_equal(g, jg):
    for k in ("rowptr", "col", "x", "y"):
        a, b = np.asarray(getattr(g, k)), np.asarray(getattr(jg, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert g.name == jg.name and g.num_classes == jg.num_classes
    assert sorted(g.split_idx) == sorted(jg.split_idx)
    for s in g.split_idx:
        np.testing.assert_array_equal(g.split_idx[s], jg.split_idx[s])


# ------------------------------------------------------------------ ogb
def _mock_ogb(monkeypatch, V=200, E=900, C=5, F=6, seed=0,
              labeled_splits=False):
    """An ``ogb.nodeproppred`` module whose dataset is made from ``seed``:
    float labels with NaN rows, as papers100M has; with
    ``labeled_splits`` only nodes outside the splits lack a label, as in
    OGB's own splits."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, V, E), rng.integers(0, V, E)
    feats = rng.standard_normal((V, F)).astype(np.float32)
    labels = rng.integers(0, C, (V, 1)).astype(np.float64)
    perm = rng.permutation(V)
    labels[perm[180::2] if labeled_splits else slice(None, None, 17)] = np.nan
    split = {"train": perm[:100], "valid": perm[100:140],
             "test": perm[140:180]}

    class FakeDataset:
        def __init__(self, name, root):
            self.name = name

        def get_idx_split(self):
            return {k: v.copy() for k, v in split.items()}

        def __getitem__(self, i):
            assert i == 0
            return ({"num_nodes": V, "edge_index": np.stack([src, dst]),
                     "node_feat": feats}, labels)

    mod = types.ModuleType("ogb")
    sub = types.ModuleType("ogb.nodeproppred")
    sub.NodePropPredDataset = FakeDataset
    mod.nodeproppred = sub
    monkeypatch.setitem(sys.modules, "ogb", mod)
    monkeypatch.setitem(sys.modules, "ogb.nodeproppred", sub)


def test_coo_to_csr_matches_jax():
    rng = np.random.default_rng(0)
    V = 500
    src, dst = rng.integers(0, V, 4000), rng.integers(0, V, 4000)
    got, want = ogb._coo_to_csr(src, dst, V), jogb._coo_to_csr(src, dst, V)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_load_ogb_matches_jax(tmp_path, monkeypatch):
    _mock_ogb(monkeypatch)
    g = ogb.load_ogb("ogbn-mock", str(tmp_path / "port"))
    jg = jogb.load_ogb("ogbn-mock", str(tmp_path / "jax"))
    _assert_graphs_equal(g, jg)
    assert g.name == "ogbn_mock" and g.x.dtype == np.float16
    assert (g.y[::17] == -1).all()
    _assert_dirs_equal(tmp_path / "port" / "ogbn_mock",
                       tmp_path / "jax" / "ogbn_mock")


def _mag240_arrays(seed=3, V=150, E=600, C=153):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, V, E), rng.integers(0, V, E)])
    x = rng.standard_normal((V, 8)).astype(np.float32)
    y = rng.integers(0, C, V).astype(np.float32)
    y[::11] = np.nan  # MAG240M: most papers unlabeled
    perm = rng.permutation(V)
    split = {"train": perm[:60], "valid": perm[60:90], "test": perm[90:120]}
    return ei, x, y, split


def test_import_mag240_matches_jax():
    ei, x, y, split = _mag240_arrays()
    g = ogb.import_mag240(ei, x, y, split, num_classes=153)
    _assert_graphs_equal(g, jogb.import_mag240(ei, x, y, split,
                                               num_classes=153))
    assert g.name == "MAG240" and (g.y[::11] == -1).all()


def test_load_mag240_matches_jax(tmp_path, monkeypatch):
    ei, x, y, split = _mag240_arrays(seed=5, V=120, E=480, C=10)

    class FakeLSC:
        num_classes = 10
        paper_feat = x.astype(np.float16)
        paper_label = y

        def __init__(self, root):
            pass

        def edge_index(self, s, r, d):
            assert (s, r, d) == ("paper", "cites", "paper")
            return ei

        def get_idx_split(self, name):
            return split[name]

    mod = types.ModuleType("ogb")
    sub = types.ModuleType("ogb.lsc")
    sub.MAG240MDataset = FakeLSC
    mod.lsc = sub
    monkeypatch.setitem(sys.modules, "ogb", mod)
    monkeypatch.setitem(sys.modules, "ogb.lsc", sub)
    g = ogb.load_mag240(str(tmp_path / "port"))
    _assert_graphs_equal(g, jogb.load_mag240(str(tmp_path / "jax")))
    np.testing.assert_array_equal(
        np.concatenate([g.split_idx["valid"], g.split_idx["test"]]),
        split["valid"])
    _assert_dirs_equal(tmp_path / "port" / "MAG240",
                       tmp_path / "jax" / "MAG240")


def test_driver_falls_back_to_ogb(tmp_path, monkeypatch):
    """A name that is neither a synth: spec nor a directory is ingested
    from OGB into --dataset_root, as the JAX driver does, then trained."""
    _mock_ogb(monkeypatch, labeled_splits=True)
    out = driver.main(["ogbn-mock", "ogbjob",
                       "--dataset_root", str(tmp_path / "ds"),
                       "--output_root", str(tmp_path / "jobs"),
                       *SMALL_RUN], device="cpu")
    assert len(out[0]["losses"]) == 1
    assert np.isfinite(out[0]["losses"]).all()
    cached = GraphData.load(str(tmp_path / "ds"), "ogbn_mock")
    assert cached.num_nodes == 200


@pytest.mark.parametrize("name", ["ogbn-mock", "MAG240"])
def test_driver_without_ogb_raises_import_error(tmp_path, monkeypatch, name):
    monkeypatch.setitem(sys.modules, "ogb", None)
    cfg = RunConfig(dataset_root=str(tmp_path))
    for load in (driver.load_dataset, jdriver.load_dataset):
        with pytest.raises(ImportError, match="requires the 'ogb' package"):
            load(cfg, name)


# ------------------------------------------------------- salient import
def _tiny_graph():
    return synthetic.planted_partition(
        name="sal", num_nodes=600, num_classes=4, avg_degree=6,
        num_features=12, seed=13)


def _save_pt(a, path):
    torch.save(torch.from_numpy(np.asarray(a)), path)


def test_salient_import_unpartitioned_matches_jax(tmp_path):
    """SALIENT++'s FastDataset layout (driver/dataset.py:85-142) through
    both importers; then two train steps of the port's Trainer on it."""
    g = _tiny_graph()
    src = tmp_path / "src"
    src.mkdir()
    _save_pt(g.rowptr, src / "rowptr.pt")
    _save_pt(g.col, src / "col.pt")
    _save_pt(np.asarray(g.x, np.float16), src / "x.pt")
    y = g.y.astype(np.float32)
    y[g.split_idx["test"][::3]] = np.nan  # unlabeled: scored, not trained
    _save_pt(y, src / "y.pt")
    _save_pt(g.split_idx["train"], src / "split_idx_train.pt")
    for s in ("valid", "test"):  # the other file name SALIENT++ writes
        _save_pt(g.split_idx[s], src / f"{s}_idx.pt")
    got = salient_import.import_salient_dataset(str(src), "sal-import",
                                                str(tmp_path / "port"))
    want = jimport.import_salient_dataset(str(src), "sal-import",
                                          str(tmp_path / "jax"))
    _assert_graphs_equal(got, want)
    _assert_dirs_equal(tmp_path / "port" / "sal-import",
                       tmp_path / "jax" / "sal-import")

    cfg = RunConfig(train_batch_size=64, train_fanouts=[5, 3],
                    hidden_features=16, num_layers=2, num_workers=1,
                    calibration_batches=2, seed=0)
    t = Trainer(cfg, GraphData.load(str(tmp_path / "port"), "sal-import"),
                device="cpu")
    t.train_sampler.set_epoch(t.shuffler.get_idx(0), 0)
    it = iter(t.train_sampler)
    losses = []
    for _ in range(2):
        bufs = next(it)
        losses.append(float(t.run_step(bufs.to_padded_batch(bufs.bucket))))
    it.close()
    assert np.isfinite(losses).all(), losses


def _write_partitioned(dst, k=2):
    """SALIENT++'s reformat_and_save layout (driver/dataset.py:223-268):
    per-field .pt files, the split dicts, part_offsets, x{rank}.pt."""
    g = _tiny_graph()
    pg, x_shards, _ = reorder_graph(g, contiguous_partition(g.num_nodes, k))
    os.makedirs(dst)
    _save_pt(pg.rowptr, f"{dst}/rowptr.pt")
    _save_pt(pg.col, f"{dst}/col.pt")
    _save_pt(np.asarray(pg.y, np.int64), f"{dst}/y.pt")
    _save_pt(pg.part_offsets, f"{dst}/part_offsets.pt")
    torch.save({s: torch.from_numpy(np.asarray(v))
                for s, v in pg.split_idx.items()}, f"{dst}/split_idx.pt")
    torch.save({r: {s: torch.from_numpy(np.asarray(v))
                    for s, v in d.items()}
                for r, d in pg.split_idx_parts.items()},
               f"{dst}/split_idx_parts.pt")
    torch.save({"num classes": pg.num_classes}, f"{dst}/meta_info.pt")
    torch.save(k, f"{dst}/num_parts.pt")
    for r, xs in enumerate(x_shards):
        _save_pt(np.asarray(xs, np.float16), f"{dst}/x{r}.pt")


def test_salient_import_partitioned_matches_jax(tmp_path):
    src = str(tmp_path / "psrc")
    _write_partitioned(src)
    got = salient_import.import_salient_partitioned(src, "sal-part",
                                                    str(tmp_path / "port"))
    want = jimport.import_salient_partitioned(src, "sal-part",
                                              str(tmp_path / "jax"))
    assert os.path.basename(got) == os.path.basename(want)
    assert "x1.npy" in os.listdir(got)
    _assert_dirs_equal(got, want)


# -------------------------------------------------------------- download
def test_archive_url_matches_jax_and_unknown_names_raise(tmp_path):
    for name in download_datasets.KNOWN:
        for k in (2, 8):
            assert (download_datasets.archive_url(name, k)
                    == jdownload.archive_url(name, k))
    assert download_datasets.KNOWN == jdownload.KNOWN
    with pytest.raises(ValueError):
        download_datasets.download_partitioned("not-a-dataset", 2,
                                               str(tmp_path))


def test_download_from_a_silent_host_times_out(tmp_path, monkeypatch):
    """A host that accepts the connection and never answers: both
    packages raise their actionable RuntimeError within the timeout."""
    with socket.socket() as srv:
        srv.bind(("127.0.0.1", 0))
        srv.listen(4)
        bucket = f"http://127.0.0.1:{srv.getsockname()[1]}"
        for mod in (download_datasets, jdownload):
            monkeypatch.setattr(mod, "BUCKET", bucket)
            t0 = time.monotonic()
            with pytest.raises(RuntimeError, match="cannot download"):
                mod.download_partitioned("ogbn-arxiv", 2,
                                         str(tmp_path / "out"), timeout=1.0)
            assert time.monotonic() - t0 < 10.0


def test_download_from_a_file_bucket_matches_jax(tmp_path, monkeypatch):
    """The whole path offline: an archive {name}-{k}.tar.gz of a SALIENT++
    partitioned directory in a file:// bucket, downloaded and converted
    by both packages into equal <name>-reordered-k{k} directories."""
    _write_partitioned(str(tmp_path / "ogbn-arxiv-2"))
    bucket = tmp_path / "bucket"
    bucket.mkdir()
    with tarfile.open(bucket / "ogbn-arxiv-2.tar.gz", "w:gz") as tar:
        tar.add(tmp_path / "ogbn-arxiv-2", arcname="ogbn-arxiv-2")
    out = {}
    for label, mod in (("port", download_datasets), ("jax", jdownload)):
        monkeypatch.setattr(mod, "BUCKET", bucket.as_uri())
        out[label] = mod.download_partitioned("ogbn-arxiv", 2,
                                              str(tmp_path / label))
    assert os.path.basename(out["port"]) == "ogbn-arxiv-reordered-k2"
    _assert_dirs_equal(out["port"], out["jax"])


# ------------------------------------------------------ quality, config
@pytest.mark.parametrize("kind", ["powerlaw", "planted"])
def test_quality_bench_matches_jax(kind):
    def untimed(d):
        return {k: ({kk: vv for kk, vv in v.items() if kk != "seconds"}
                    if isinstance(v, dict) else v) for k, v in d.items()}

    got = quality_bench.run(3000, 2, kind=kind)
    assert got["metis"] is None  # pymetis is not installed
    assert untimed(got) == untimed(jquality.run(3000, 2, kind=kind))


def test_configure_env_matches_jax(tmp_path, monkeypatch):
    assert configure_env.DATASET_BASE_GB == jconfigure.DATASET_BASE_GB
    for n in (0, 1, 4, 8, 96):
        assert (configure_env.recommended_num_workers(n)
                == jconfigure.recommended_num_workers(n))
    for free in (0.4, 0.5, 1.0, 2.0, 4.9, 5.0, 8.0, 100.0, 250.0, 400.0,
                 1000.0, 1e4):
        for ks in ((2, 4, 8), (1, 16), ()):
            assert (configure_env.feasible_datasets(free, ks)
                    == jconfigure.feasible_datasets(free, ks))
    monkeypatch.chdir(tmp_path)
    with open(configure_env.write_environment_config("port")) as f:
        got = json.load(f)
    with open(jconfigure.write_environment_config("jax")) as f:
        want = json.load(f)
    assert sorted(got) == sorted(want)
    for k in ("num_workers", "cpu_count"):
        assert got[k] == want[k]


# -------------------------------------------------------------- launcher
def test_exp_launcher_script(tmp_path):
    """One process a GPU: the script runs the port's driver under
    torchrun with the recommended flags; the SLURM variant adds its
    header."""
    lau = ExpLauncher(job_root=str(tmp_path), repo_root=".",
                      env={"OMP_NUM_THREADS": "1"})
    job_dir = lau.prepare("synth:V=1000", "jobx",
                          flags={"epochs": 2, "train_fanouts": [5, 3]})
    run_sh = os.path.join(job_dir, "run.sh")
    with open(run_sh) as f:
        script = f.read()
    assert 'torchrun --nproc_per_node "$NPROC"' in script
    assert "NPROC=${NPROC:-" in script
    assert "-m salient_plusplus_tpu_torch.driver synth:V=1000 jobx" in script
    assert "--train_fanouts 5,3" in script
    assert "--load_balance_scheme federated" in script
    assert "--cache_creation_epochs 2" in script
    assert "export OMP_NUM_THREADS=1" in script
    assert "salient_plusplus_tpu.driver" not in script
    assert os.access(run_sh, os.X_OK)
    subprocess.run(["bash", "-n", run_sh], check=True)
    job_dir2 = lau.prepare("synth:V=1000", "joby", slurm_nodes=2)
    with open(os.path.join(job_dir2, "run.sh")) as f:
        script2 = f.read()
    assert script2.startswith("#!/bin/bash\n#SBATCH --job-name=joby\n")
    assert "#SBATCH --nodes=2" in script2
    subprocess.run(["bash", "-n", os.path.join(job_dir2, "run.sh")],
                   check=True)


def test_wait_slurm_polls_until_done():
    lau = ExpLauncher()
    state = {"left": 3}

    def fake_poll(jid):
        assert jid == "4242"
        state["left"] -= 1
        return state["left"] > 0

    assert lau.wait_slurm("Submitted batch job 4242", poll_s=0.0,
                          _poll_cmd=fake_poll)
    assert state["left"] == 0
    assert not lau.wait_slurm("Submitted batch job 1", poll_s=0.0,
                              timeout_s=-1.0, _poll_cmd=lambda j: True)


# ----------------------------------------------------------------- drill
def test_readiness_drill_matches_jax(tmp_path):
    """The drill at toy scale on the CPU: its dataset (stage 1) and its
    reordered layout (stage 3) equal what JAX's powerlaw_graph(...).save
    and partition.cli write for the same arguments; the report has every
    stage with its peak RSS, the results and the child's kernel launches
    (0 on the CPU) and the layerwise final test's seconds; ``resume``
    skips stages 1-3; without a card the default device fails the drill."""
    root, out = tmp_path / "port", str(tmp_path / "drill.json")
    rep = run_drill(nodes=3000, parts=2, epochs=1, root=str(root),
                    feature_dim=16, fanouts="4,3", batch=64, workers=1,
                    json_out=out, final_test_mode="layerwise",
                    device="cpu")
    assert set(rep["stages"]) == {"generate_save", "partition_reorder",
                                  "train_cli"}
    for st in rep["stages"].values():
        assert st["peak_rss_gb"] > 0
    assert rep["results"][0]["final_test"] >= 0.0
    assert np.isfinite(rep["results"][0]["losses"]).all()
    assert rep["launches"] == {"sorted_segment_sum": 0,
                               "fused_gather_segment_sum": 0,
                               "gather_rows": 0}
    assert rep["max_memory_allocated"] is None and rep["layerwise_s"] > 0

    jroot = str(tmp_path / "jax")
    jsyn.powerlaw_graph(
        name="drill-products", num_nodes=3000, avg_degree=15,
        num_features=16, num_classes=47, seed=0, train_frac=0.08,
        valid_frac=0.02).save(jroot)
    jcli.main(["drill-products", "--dataset_root", jroot, "--out_root",
               jroot, "--parts", "2", "--fanouts", "4,3", "--minibatch",
               "64"])
    for d in ("drill-products", "drill-products-reordered-k2"):
        _assert_dirs_equal(root / d, os.path.join(jroot, d))
    assert rep["num_edges"] == int(np.load(
        os.path.join(jroot, "drill-products", "rowptr.npy"))[-1])

    before = os.path.getmtime(root / "drill-products" / "x.npy")
    rep2 = run_drill(nodes=3000, parts=2, epochs=1, root=str(root),
                     feature_dim=16, fanouts="4,3", batch=64, workers=1,
                     json_out=out, device="cpu", resume=True)
    assert rep2["resumed"]
    assert os.path.getmtime(root / "drill-products" / "x.npy") == before
    assert rep2["stages"]["generate_save"] == rep["stages"]["generate_save"]
    assert rep2["num_edges"] == rep["num_edges"]
    if not torch.cuda.is_available():
        # no fallback: the driver child asked for the card raises, and so
        # does the drill
        with pytest.raises(subprocess.CalledProcessError):
            run_drill(nodes=3000, parts=2, epochs=1, root=str(root),
                      feature_dim=16, fanouts="4,3", batch=64, workers=1,
                      resume=True)


# ------------------------------------------------------- timer, harness
def test_timer_matches_jax():
    got = {}
    for label, cls in (("port", Timer), ("jax", jtiming.Timer)):
        seen = []
        with cls("region", callback=lambda n, s: seen.append((n, s))) as t:
            time.sleep(0.02)
        assert seen == [("region", t.elapsed)] and t.elapsed >= 0.02
        t2 = cls()
        t2.__enter__()
        time.sleep(0.01)
        assert t2.stop() >= 0.01 and t2.stop() >= t2.elapsed >= 0.01
        got[label] = (sorted(vars(t)), type(t.__exit__(None, None, None)))
    assert got["port"] == got["jax"]


def test_sampler_test_harness_runs(tmp_path):
    """The sanitizer harness sits beside the port's sampler.cpp; its
    exerciser, built without sanitizers, passes."""
    d = os.path.join(REPO, "salient_plusplus_tpu_torch", "native")
    script = os.path.join(d, "run_sanitizers.sh")
    assert os.path.exists(os.path.join(d, "sampler_test.cpp"))
    assert os.access(script, os.X_OK)
    subprocess.run(["bash", "-n", script], check=True)
    exe = str(tmp_path / "sampler_test")
    subprocess.run(["g++", "-O2", "-std=c++17", "-pthread",
                    os.path.join(d, "sampler.cpp"),
                    os.path.join(d, "sampler_test.cpp"), "-o", exe],
                   check=True)
    res = subprocess.run([exe], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "sampler_test OK" in res.stdout


def test_unlabeled_train_node_fault_of_the_reference():
    """The ingest turns a missing label into -1. A train node labeled -1
    trains in JAX as the last class (``take_along_axis`` wraps the
    index); the port's ``masked_nll`` refuses the index instead. OGB's
    splits label every train node, so neither meets it on OGB data."""
    import jax.numpy as jnp

    from salient_plusplus_tpu.train import step as jstep
    from salient_plusplus_tpu_torch.train import step as tstep

    rng = np.random.default_rng(0)
    logp = np.log(rng.dirichlet(np.ones(5), 4)).astype(np.float32)
    y = np.array([1, -1, 3, 0], np.int32)
    got = float(jstep.masked_nll(jnp.asarray(logp), jnp.asarray(y),
                                 jnp.int32(4)))
    wrapped = -(logp[0, 1] + logp[1, 4] + logp[2, 3] + logp[3, 0]) / 4
    assert abs(got - wrapped) < 1e-5
    with pytest.raises(RuntimeError, match="out of bounds"):
        tstep.masked_nll(torch.from_numpy(logp), torch.from_numpy(y),
                         torch.tensor(4, dtype=torch.int32))
