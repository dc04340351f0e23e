"""The rest of the trainer's samplers in the PyTorch port, on the CPU:
``FastPreSampler`` (a whole epoch sampled up front), the pure-numpy
oracle sampler and the ``OracleSampler`` train path, spec growth after a
cap overflow, and the ``collect_data`` dumps. Each is held to the JAX
package's counterpart where one exists (``tests/test_sampler_session.py``,
``test_oracle_sampler.py``, ``test_train_e2e.py``, ``test_utils_aux.py``).
"""

import dataclasses
import glob
import os

import jax
import numpy as np
import pytest
import torch

from salient_plusplus_tpu.data import synthetic as jsyn
from salient_plusplus_tpu.sampling import oracle as joracle
from salient_plusplus_tpu.sampling import sampler as jsampler
from salient_plusplus_tpu.sampling.batch import BatchSpec as JBatchSpec
from salient_plusplus_tpu.utils.data_collector import (
    DataCollector as JDataCollector)

from salient_plusplus_tpu_torch import driver
from salient_plusplus_tpu_torch.config import RunConfig
from salient_plusplus_tpu_torch.data import synthetic
from salient_plusplus_tpu_torch.sampling import oracle, sampler
from salient_plusplus_tpu_torch.sampling.batch import BatchSpec
from salient_plusplus_tpu_torch.sampling.shufflers import Shuffler
from salient_plusplus_tpu_torch.train.loop import Trainer
from salient_plusplus_tpu_torch.utils.data_collector import DataCollector
from tests.test_torch_data_sampling import _assert_batches_equal, _np

torch.set_num_threads(1)

SMALL = dict(name="small", num_nodes=5000, num_classes=10, avg_degree=10,
             num_features=32, seed=3)
CFG = dict(train_batch_size=256, test_batch_size=512, train_fanouts=[5, 3],
           batchwise_test_fanouts=[6, 6], final_test_fanouts=[6, 6],
           hidden_features=16, num_layers=2, lr=0.01, num_workers=2,
           calibration_batches=2, seed=4)


@pytest.fixture(scope="module")
def small():
    return synthetic.planted_partition(**SMALL)


def _events(t, name, since=0):
    return [e for e in t.logger.events[since:]
            if isinstance(e, tuple) and e[0] == name]


def _params(t):
    return {k: v.clone() for k, v in t.state.model.state_dict().items()}


# ----------------------------------------------------------- presampler
def _sampler(mod, spec_cls, g, spec, **kw):
    cfg = mod.FastSamplerConfig(
        spec=spec_cls(**dataclasses.asdict(spec)), batch_size=spec.seed_cap,
        base_seed=5, num_workers=2, compress_dst=True, pack_wire=True, **kw)
    s = mod.FastSampler(np.asarray(g.rowptr, np.int64),
                        np.asarray(g.col, np.int32),
                        np.asarray(g.y, np.int32), cfg)
    s.set_epoch(Shuffler(g.split_idx["train"]).get_idx(1)[:300], epoch=1)
    return s


def test_presampler_matches_streaming_and_jax(small):
    """The presampled epoch holds the streamed epoch's batches, in order,
    and the JAX package's FastPreSampler's, field for field."""
    spec = BatchSpec.worst_case(64, [4, 3])
    s = _sampler(sampler, BatchSpec, small, spec)
    streamed = []
    it = iter(s)
    for bufs in it:
        streamed.append(bufs.to_padded_batch().clone())
        it.recycle(bufs)
    pre = list(sampler.FastPreSampler(s))
    jpre = list(jsampler.FastPreSampler(
        _sampler(jsampler, JBatchSpec, small, spec)))
    assert len(streamed) == len(pre) == len(jpre) == 5
    for a, bufs, jbufs in zip(streamed, pre, jpre):
        b = bufs.to_padded_batch()
        for f in ("n_id_lo", "n_id_hi", "level_sizes", "y", "seed_count"):
            va, vb = getattr(a, f), getattr(b, f)
            assert (va is None) == (vb is None), f
            if va is not None:
                assert torch.equal(va, vb), f
        _assert_batches_equal(jbufs.to_padded_batch(), b)


def test_presampler_cold_fills_match_jax(small):
    """With a host cold tail the presampled buffers carry the JAX
    package's cold rows and positions, and the same drop count."""
    spec = BatchSpec.worst_case(64, [4, 3])
    H = 2000
    x = torch.from_numpy(np.asarray(small.x, np.float32)).to(torch.bfloat16)
    tail = x[H:].view(torch.int16).numpy().view(np.uint16).copy()
    kw = dict(hot_cutoff=H, cold_cap=384)
    pre = sampler.FastPreSampler(_sampler(sampler, BatchSpec, small, spec,
                                          x_cold=tail, **kw))
    jpre = jsampler.FastPreSampler(_sampler(
        jsampler, JBatchSpec, small, spec,
        x_cold=tail.view(jax.numpy.bfloat16), **kw))
    bufs, jbufs = pre.presample(1), jpre.presample(1)
    assert pre.dropped_cold == jpre.dropped_cold > 0
    for b, jb in zip(bufs, jbufs):
        tb, jb = b.to_padded_batch(), jb.to_padded_batch()
        np.testing.assert_array_equal(_np(tb.cold_pos), jb.cold_pos)
        np.testing.assert_array_equal(
            tb.cold_rows.view(torch.int16).numpy().view(np.uint16),
            np.asarray(jb.cold_rows).view(np.uint16))
        assert int(tb.cold_count) == int(jb.cold_count)


def _train(g, sampler_name, epochs=1, **kw):
    t = Trainer(RunConfig(**dict(CFG, train_sampler=sampler_name, **kw)), g,
                device="cpu")
    losses = [t.train_epoch(e) for e in range(epochs)]
    return t, losses


@pytest.mark.parametrize("frac", [1.0, 0.5])
def test_presampled_epoch_trains_as_streamed(small, frac):
    """One epoch through FastPreSampler: the streamed epoch's batches (in
    their full bucket), so the same loss within float32 rounding and the
    same parameters within 1e-5 (a tight-bucket batch runs its products
    over fewer pad rows); and, at hbm_fraction 0.5, bit-equal to the
    presampled epoch at 1.0."""
    t, (lp,) = _train(small, "FastPreSampler", hbm_fraction=frac)
    s, (ls,) = _train(small, "FastSampler", hbm_fraction=frac)
    assert abs(lp - ls) < 1e-5, (lp, ls)
    pp, ps = _params(t), _params(s)
    for k in pp:
        torch.testing.assert_close(pp[k], ps[k], rtol=1e-5, atol=1e-5)
    if frac < 1.0:
        f, _ = _train(small, "FastPreSampler")
        pf = _params(f)
        assert all(torch.equal(pp[k], pf[k]) for k in pp)


def test_presampled_cold_cap_grows_after_drops(small):
    t = Trainer(RunConfig(**dict(CFG, train_sampler="FastPreSampler",
                                 hbm_fraction=0.5)), small, device="cpu")
    t.train_sampler.cfg.cold_cap = 128  # sabotage
    t.train_epoch(0)
    grown = t.train_sampler.cfg.cold_cap
    assert grown > 128 and t._slack >= grown
    assert t.features.shape[0] == t.hot_cutoff + t._slack
    assert _events(t, "WARNING_COLD_DROPPED")
    n = len(t.logger.events)
    t.train_epoch(1)
    assert not _events(t, "WARNING_COLD_DROPPED", since=n)


# --------------------------------------------------------------- oracle
def _check_sample_invariants(g, s, seeds, fanouts):
    """Structural invariants of the reference's multilayer sampling
    (tests/test_oracle_sampler.py)."""
    assert s.level_sizes[0] == len(seeds)
    assert np.array_equal(s.n_id[: len(seeds)], seeds.astype(np.int32))
    assert len(np.unique(s.n_id)) == len(s.n_id)
    assert s.level_sizes == sorted(s.level_sizes)
    for h, fanout in enumerate(fanouts):
        dst, src = s.hops[h]
        n_in, n_out = s.level_sizes[h + 1], s.level_sizes[h]
        assert np.all(dst < n_out) and np.all(src < n_in)
        for d, sr in zip(dst[:300], src[:300]):
            u, v = int(s.n_id[d]), int(s.n_id[sr])
            assert v in g.col[g.rowptr[u]:g.rowptr[u + 1]]
        degs = np.diff(g.rowptr)[s.n_id[:n_out]]
        counts = np.bincount(dst, minlength=n_out)
        assert np.all(counts <= (degs if fanout < 0
                                 else np.minimum(fanout, degs)))
        pairs = dst.astype(np.int64) * len(s.n_id) + src
        assert len(np.unique(pairs)) == len(pairs)


@pytest.mark.parametrize("fanouts", [[5, 3], [-1, -1], [4, 2, 2]])
def test_oracle_matches_jax_and_keeps_invariants(small, fanouts):
    g = small
    seeds = g.split_idx["train"][:16 if -1 in fanouts else 96]
    j = joracle.multilayer_sample_np(g.rowptr, g.col, seeds, fanouts,
                                     np.random.default_rng(3))
    t = oracle.multilayer_sample_np(g.rowptr, g.col, seeds, fanouts,
                                    np.random.default_rng(3))
    np.testing.assert_array_equal(t.n_id, j.n_id)
    assert t.level_sizes == j.level_sizes
    for (td, ts), (jd, js) in zip(t.hops, j.hops):
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(ts, js)
    _check_sample_invariants(g, t, seeds, fanouts)


def test_oracle_pad_sample_matches_jax(small):
    """Caps that truncate: the same drops, the same padded batch."""
    g = small
    seeds = g.split_idx["train"][:64]
    spec = BatchSpec(fanouts=(4, 3), seed_cap=64, node_caps=(64, 256, 512),
                     edge_caps=(256, 512))
    kw = dict(node_caps=spec.node_caps, edge_caps=spec.edge_caps)
    t = oracle.multilayer_sample_np(g.rowptr, g.col, seeds, [4, 3],
                                    np.random.default_rng(0), **kw)
    j = joracle.multilayer_sample_np(g.rowptr, g.col, seeds, [4, 3],
                                     np.random.default_rng(0), **kw)
    assert (t.dropped_nodes, t.dropped_edges) == (j.dropped_nodes,
                                                  j.dropped_edges)
    assert t.dropped_nodes > 0
    tb = oracle.pad_sample(t, spec, np.asarray(g.y, np.int32))
    jb = joracle.pad_sample(j, JBatchSpec(**dataclasses.asdict(spec)),
                            np.asarray(g.y, np.int32))
    _assert_batches_equal(jb, tb)
    assert int(tb.seed_count) == 64
    assert tb.overflow.tolist() == [t.dropped_nodes, t.dropped_edges]
    with pytest.raises(ValueError, match="duplicate"):
        oracle.multilayer_sample_np(g.rowptr, g.col,
                                    np.array([1, 1]), [2])


def test_oracle_sampler_cross_check(small):
    """Training through the independent oracle sampler reaches the
    accuracy of the native path on the same task
    (tests/test_train_e2e.py:209)."""
    cfg = dict(train_fanouts=[8, 5], batchwise_test_fanouts=[10, 10],
               final_test_fanouts=[10, 10], hidden_features=32, seed=0)
    t, losses = _train(small, "OracleSampler", epochs=2, **cfg)
    assert losses[-1] < losses[0]
    assert any(e[-1] == "oracle" for e in _events(t, "epoch"))
    assert t.evaluate("valid") > 0.5
    with pytest.raises(ValueError, match="hbm_fraction=1"):
        _train(small, "OracleSampler", hbm_fraction=0.5)


def _shrunk(spec, frac=0.3):
    node_caps = [spec.node_caps[0]]
    for v in spec.node_caps[1:]:
        node_caps.append(max(node_caps[-1],
                             (max(128, int(v * frac)) // 128) * 128))
    edge_caps = tuple((max(512, int(v * frac)) // 512) * 512
                      for v in spec.edge_caps)
    return BatchSpec(spec.fanouts, spec.seed_cap, tuple(node_caps),
                     edge_caps)


def test_spec_grows_after_cap_overflow(small):
    """Cap-overflow epochs self-correct: the spec grows until nothing is
    truncated (tests/test_train_e2e.py:177)."""
    t = Trainer(RunConfig(**dict(CFG, train_fanouts=[8, 5],
                                 batchwise_test_fanouts=[10, 10],
                                 final_test_fanouts=[10, 10],
                                 hidden_features=32, calibration_batches=4,
                                 seed=1)), small, device="cpu")
    sab = _shrunk(t.train_spec)
    assert sab != t.train_spec
    t.train_spec = sab
    t.train_sampler.cfg.spec = sab
    t.train_tight = None
    t.train_sampler.cfg.tight_spec = None
    t.train_epoch(0)
    assert _events(t, "SAMPLER_OVERFLOW"), "the sabotaged spec must truncate"
    assert t.train_spec != sab
    for epoch in range(1, 5):
        n = len(t.logger.events)
        t.train_epoch(epoch)
        if not _events(t, "SAMPLER_OVERFLOW", since=n):
            break
    else:
        raise AssertionError("growth never reached a non-truncating spec")


# -------------------------------------------------------- data collector
@pytest.mark.parametrize("cls", [DataCollector, JDataCollector])
def test_data_collector(tmp_path, cls):
    """The port's collector writes the JAX package's layout; it also
    takes tensors, and a disabled one writes nothing."""
    dc = cls(str(tmp_path), rank=1, enabled=True, tag="t")
    dc.set_epoch(3)
    dc.collect("stats", a=np.arange(5), b=[1, 2])
    f = os.path.join(str(tmp_path), "collected_data_t", "epoch3",
                     "rank1_stats.npz")
    z = np.load(f)
    assert z["a"].tolist() == [0, 1, 2, 3, 4] and z["b"].tolist() == [1, 2]
    if cls is DataCollector:
        dc.collect("t", c=torch.arange(3), d=[torch.tensor(4),
                                              torch.tensor(5)])
        z = np.load(os.path.join(os.path.dirname(f), "rank1_t.npz"))
        assert z["c"].tolist() == [0, 1, 2] and z["d"].tolist() == [4, 5]
    off = cls(str(tmp_path / "off"), enabled=False)
    off.set_epoch(0)
    off.collect("x", a=[1])
    assert not os.path.exists(str(tmp_path / "off"))


def test_collect_data_wiring(tmp_path):
    g = synthetic.planted_partition(num_nodes=1500, num_classes=4,
                                    avg_degree=8, num_features=8, seed=2)
    cfg = RunConfig(train_batch_size=128, train_fanouts=[4, 3],
                    hidden_features=8, num_layers=2, num_workers=1,
                    calibration_batches=2, collect_data=True,
                    output_root=str(tmp_path))
    t = Trainer(cfg, g, device="cpu")
    t.train_epoch(0)
    files = sorted(glob.glob(str(tmp_path) + "/collected_data_*/epoch0/*.npz"))
    assert [os.path.basename(f) for f in files] == [
        f"rank0_batch{i}.npz" for i in range(4)]
    z = np.load(files[0])
    assert z["level_sizes"].shape == (3,) and int(z["seed_count"]) == 128
    assert z["edge_counts"].shape == (2,) and (z["edge_counts"] > 0).all()


# ------------------------------------------------------------- the driver
@pytest.mark.parametrize("flags", [
    ["--train_sampler", "FastPreSampler"],
    ["--train_sampler", "FastPreSampler", "--hbm_fraction", "0.5"],
    ["--train_sampler", "OracleSampler"],
    ["--collect_data", "true"],
])
def test_driver_samplers_on_cpu(tmp_path, flags):
    out = driver.main([
        "synth:V=2000,C=5,deg=8,F=16", "smp", "--epochs", "1",
        "--train_batch_size", "128", "--train_fanouts", "5,3",
        "--batchwise_test_fanouts", "6,6", "--final_test_fanouts", "6,6",
        "--num_layers", "2", "--hidden_features", "16", "--num_workers",
        "1", "--calibration_batches", "2", "--lr", "0.01",
        "--output_root", str(tmp_path), *flags], device="cpu")
    assert out[0]["final_valid"] > 0.5  # chance is 0.2
    assert np.isfinite(out[0]["losses"]).all()
    dumps = glob.glob(str(tmp_path) + "/collected_data_*/epoch0/*.npz")
    assert bool(dumps) == ("--collect_data" in flags)
