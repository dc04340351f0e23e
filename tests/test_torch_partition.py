"""Partitioning, reordering and the partitioned dataset of the PyTorch port
against the JAX package, on the CPU.

Both packages call the same native partitioner with the same arguments,
so the labels must be equal, not close; reorder outputs, saved files,
partition books and iteration counts are integer or copied data and must
be equal too. Each package builds its graph from its own ``synthetic``
module with the same seed (the two generators are one algorithm).
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from salient_plusplus_tpu.data import dataset as jdataset
from salient_plusplus_tpu.data import partition_book as jbook
from salient_plusplus_tpu.data import reorder as jreorder
from salient_plusplus_tpu.data import synthetic as jsyn
from salient_plusplus_tpu import partition as jpartition
from salient_plusplus_tpu.partition import cli as jcli

from salient_plusplus_tpu_torch import partition
from salient_plusplus_tpu_torch.caching import vip
from salient_plusplus_tpu_torch.data import dataset, reorder, synthetic
from salient_plusplus_tpu_torch.data.partition_book import RangePartitionBook
from salient_plusplus_tpu_torch.partition import cli

torch.set_num_threads(1)

GRAPHS = {
    "small": dict(name="small", num_nodes=5000, num_classes=10,
                  avg_degree=10, num_features=32, seed=3),
    "planted20k": dict(name="p20k", num_nodes=20000, num_classes=8,
                       avg_degree=8, num_features=8, seed=11),
}


@pytest.fixture(scope="module")
def graphs():
    return {k: (synthetic.planted_partition(**kw),
                jsyn.planted_partition(**kw)) for k, kw in GRAPHS.items()}


def _weights(g):
    return partition.get_4d_node_weights(g.num_nodes, g.rowptr,
                                         g.split_idx["train"],
                                         g.split_idx["valid"])


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("multilevel", [True, False])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_partition_labels_match_jax(graphs, name, multilevel, k, seed):
    g, jg = graphs[name]
    np.testing.assert_array_equal(g.rowptr, jg.rowptr)
    np.testing.assert_array_equal(g.col, jg.col)
    w = _weights(g)
    got = partition.multiconstraint_partition(
        g.rowptr, g.col, k, w, seed=seed, multilevel=multilevel)
    want = jpartition.multiconstraint_partition(
        jg.rowptr, jg.col, k, w, seed=seed, multilevel=multilevel)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == set(range(k))


def test_partition_quality_and_weights_match_jax(graphs):
    g, jg = graphs["small"]
    w = _weights(g)
    np.testing.assert_array_equal(
        w, jpartition.get_4d_node_weights(jg.num_nodes, jg.rowptr,
                                          jg.split_idx["train"],
                                          jg.split_idx["valid"]))
    labels = partition.multiconstraint_partition(g.rowptr, g.col, 4, w)
    for lab in (labels, partition.random_partition(g.num_nodes, 4, seed=3),
                partition.contiguous_partition(g.num_nodes, 4)):
        assert partition.partition_quality(g.rowptr, g.col, lab, w) == \
            jpartition.partition_quality(jg.rowptr, jg.col, lab, w)
    np.testing.assert_array_equal(
        partition.random_partition(g.num_nodes, 3, seed=5),
        jpartition.random_partition(g.num_nodes, 3, seed=5))
    np.testing.assert_array_equal(
        partition.contiguous_partition(g.num_nodes, 3),
        jpartition.contiguous_partition(g.num_nodes, 3))


def _assert_pg_equal(pg, jpg):
    assert pg.name == jpg.name and pg.num_parts == jpg.num_parts
    assert pg.num_classes == jpg.num_classes and pg.rank == jpg.rank
    for f in ("rowptr", "col", "x", "y", "part_offsets"):
        a, b = getattr(pg, f), getattr(jpg, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert pg.split_idx.keys() == jpg.split_idx.keys()
    for s in pg.split_idx:
        np.testing.assert_array_equal(pg.split_idx[s], jpg.split_idx[s])
    assert (pg.split_idx_parts or {}).keys() == \
        (jpg.split_idx_parts or {}).keys()
    for p, sp in (pg.split_idx_parts or {}).items():
        for s in sp:
            np.testing.assert_array_equal(sp[s], jpg.split_idx_parts[p][s])
    assert pg.local_offset == jpg.local_offset
    assert pg.num_local_nodes == jpg.num_local_nodes


@pytest.mark.parametrize("equal_shards", [True, False])
def test_reorder_matches_jax(graphs, equal_shards):
    g, jg = graphs["small"]
    labels = partition.multiconstraint_partition(g.rowptr, g.col, 4,
                                                 _weights(g))
    tipp = vip.partitionwise_train_idx(labels, g.split_idx["train"])
    per_part = vip.vip_analytical(g.rowptr, g.col, tipp, 256, [5, 3])
    w = np.zeros(g.num_nodes, np.float32)
    for p, wp in enumerate(per_part):
        w[labels == p] = wp[labels == p]
    pg, shards, old2new = reorder.reorder_graph(
        g, labels, w, align=64, equal_shards=equal_shards)
    jpg, jshards, jold2new = jreorder.reorder_graph(
        jg, labels, w, align=64, equal_shards=equal_shards)
    _assert_pg_equal(pg, jpg)
    np.testing.assert_array_equal(old2new, jold2new)
    assert len(shards) == len(jshards) == 4
    for a, b in zip(shards, jshards):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_hot_order_matches_jax(graphs):
    g, jg = graphs["small"]
    h, o2n = reorder.hot_order_graph(g)
    jh, jo2n = jreorder.hot_order_graph(jg)
    np.testing.assert_array_equal(o2n, jo2n)
    assert h.name == jh.name
    for f in ("rowptr", "col", "x", "y"):
        np.testing.assert_array_equal(getattr(h, f), getattr(jh, f))
    for s in h.split_idx:
        np.testing.assert_array_equal(h.split_idx[s], jh.split_idx[s])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_saved_dataset_loads_in_the_other_package(graphs, tmp_path, writer):
    g, jg = graphs["small"]
    labels = partition.contiguous_partition(g.num_nodes, 3)
    labels = labels[np.random.default_rng(2).permutation(g.num_nodes)]
    if writer == "port":
        path = reorder.reorder_and_save(g, labels, str(tmp_path))
    else:
        path = jreorder.reorder_and_save(jg, labels, str(tmp_path))
    name = os.path.basename(path)
    for rank in range(3):
        pg = dataset.PartitionedGraphData.load_partitioned(
            str(tmp_path), name, rank)
        jpg = jdataset.PartitionedGraphData.load_partitioned(
            str(tmp_path), name, rank)
        _assert_pg_equal(pg, jpg)
    want, _, _ = jreorder.reorder_graph(jg, labels)
    np.testing.assert_array_equal(pg.rowptr, want.rowptr)


def test_partition_book_matches_jax():
    offs = np.array([0, 128, 256, 300, 512], np.int64)
    book, jb = RangePartitionBook(offs), jbook.RangePartitionBook(offs)
    ids = np.random.default_rng(0).integers(0, 512, 1000).astype(np.int32)
    want = jb.nid2partid(ids)
    assert book.num_parts == jb.num_parts == 4
    np.testing.assert_array_equal(book.nid2partid(ids), want)
    t = torch.from_numpy(ids)
    got = book.nid2partid(t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(book.nid2partid(t.long()).numpy(), want)
    for p in range(4):
        np.testing.assert_array_equal(book.nid2localnid(ids, p),
                                      jb.nid2localnid(ids, p))
        np.testing.assert_array_equal(book.nid2localnid(t, p).numpy(),
                                      jb.nid2localnid(ids, p))
        np.testing.assert_array_equal(book.nid_is_local(ids, p),
                                      jb.nid_is_local(ids, p))
        np.testing.assert_array_equal(book.nid_is_local(t, p).numpy(),
                                      jb.nid_is_local(ids, p))
        np.testing.assert_array_equal(book.partid2nids(p),
                                      jb.partid2nids(p))
        np.testing.assert_array_equal(book.partid2nids(p, "cpu").numpy(),
                                      jb.partid2nids(p))
    np.testing.assert_array_equal(book.part_sizes(), jb.part_sizes())


def test_get_num_iterations_matches_jax(graphs):
    g, jg = graphs["small"]
    for b in (1, 100, 1024, 10 ** 6):
        assert g.get_num_iterations(b) == jg.get_num_iterations(b)
    np.testing.assert_array_equal(g.degrees(), jg.degrees())


def test_partition_cli_writes_the_same_files(tmp_path):
    args = ["synth:V=3000,C=4,deg=6,F=8", "--parts", "3", "--fanouts", "4,3",
            "--minibatch", "64", "--save_labels"]
    out = {}
    for label, main in (("port", cli.main), ("jax", jcli.main)):
        root = tmp_path / label
        root.mkdir()
        out[label] = main(args + ["--out_root", str(root)])
    assert os.path.basename(out["port"]) == os.path.basename(out["jax"])
    files = sorted(os.listdir(out["jax"]))
    assert sorted(os.listdir(out["port"])) == files
    assert "x2.npy" in files and "split_train_part2.npy" in files
    _, mismatch, errors = filecmp.cmpfiles(out["port"], out["jax"], files,
                                           shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    labels = [f for f in os.listdir(tmp_path / "jax") if f.endswith(".npy")]
    assert labels and filecmp.cmp(tmp_path / "port" / labels[0],
                                  tmp_path / "jax" / labels[0],
                                  shallow=False)


def test_driver_trains_from_a_partitioned_dataset(tmp_path):
    """The offline pipeline, then the port's driver on its output: a
    ``<name>-reordered-k2`` directory is trained on one device from both
    shards (``load_full``), scored by ``--do_test_run``, and simulated."""
    from salient_plusplus_tpu_torch import driver
    from salient_plusplus_tpu_torch.config import RunConfig

    root = str(tmp_path / "ds")
    path = cli.main(["synth:V=2000,C=4,deg=8,F=16", "--parts", "2",
                     "--fanouts", "5,3", "--minibatch", "128",
                     "--out_root", root])
    name = os.path.basename(path)
    assert name.endswith("-reordered-k2")
    cfg = RunConfig(dataset_root=root)
    ref = driver.load_dataset(cfg, name)
    assert isinstance(ref, driver.PartitionedDatasetRef)
    full = driver.load_full_dataset(cfg, name)
    assert full.num_nodes == len(np.load(os.path.join(path, "y.npy")))
    np.testing.assert_array_equal(
        full.x, np.concatenate([np.load(os.path.join(path, f"x{p}.npy"))
                                for p in range(2)]))
    args = [name, "job", "--dataset_root", root, "--output_root",
            str(tmp_path / "out"), "--epochs", "1", "--train_batch_size",
            "128", "--train_fanouts", "5,3", "--batchwise_test_fanouts",
            "6,6", "--final_test_fanouts", "6,6", "--num_layers", "2",
            "--hidden_features", "16", "--num_workers", "1",
            "--calibration_batches", "2", "--lr", "0.01"]
    out = driver.main(args, device="cpu")
    assert out[0]["final_valid"] > 0.5  # chance is 0.25
    scored = driver.main(args + ["--do_test_run", str(out[0]["best_epoch"])],
                         device="cpu")
    assert scored[0]["valid"] > 0.5
    sim = driver.main(args + ["--execution_mode", "communication_simulation",
                              "--cache_creation_epochs", "1"])
    assert set(sim) == {"vip-analytical", "degree"}
