"""The host cold tier (``hbm_fraction < 1``) of the PyTorch port against the
JAX package, on the CPU.

Each module of the tier is held to its JAX counterpart on the same inputs:
the fp8 row codec, the host bf16 tail, the cold-row cache and its miss
ladder, the cache policy, the sampler's cold fills (plain, gsrc and cache
modes) and the step's overlay (the JAX overlay's K1 placement runs in
interpret mode, as ``tests/test_host_tier.py`` runs it). Byte-exact where
the data is integer or fp8; the bf16 rows are compared as bits.

Then the contract of the tier itself, as the JAX package's
``tests/test_host_tier.py``, ``test_gsrc_cold.py`` and
``test_cold_policy.py`` state it: the port's Trainer at hbm_fraction 0.5
and 0.05 leaves the parameters bit-equal to its run at 1.0 (the cold rows
are the same bf16 values, aggregated in the same order), for every mode.
One Adam step at 0.5 is held to the JAX Trainer's at 0.5 within 2e-4
(float32 models, dropout 0: the two frameworks draw other dropout bits).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salient_plusplus_tpu.config import RunConfig as JRunConfig
from salient_plusplus_tpu.data import synthetic as jsyn
from salient_plusplus_tpu.models import make_model as jmake_model
from salient_plusplus_tpu.ops import mxu_segment as M
from salient_plusplus_tpu.parallel import exchange as jexchange
from salient_plusplus_tpu.sampling import cold_cache as jcold_cache
from salient_plusplus_tpu.sampling import sampler as jsampler
from salient_plusplus_tpu.sampling.batch import BatchSpec as JBatchSpec
from salient_plusplus_tpu.train import cold_policy as jpolicy
from salient_plusplus_tpu.train import step as jstep
from salient_plusplus_tpu.train.loop import Trainer as JTrainer

from salient_plusplus_tpu_torch import driver, weights
from salient_plusplus_tpu_torch.config import RunConfig
from salient_plusplus_tpu_torch.data import synthetic
from salient_plusplus_tpu_torch.parallel import exchange
from salient_plusplus_tpu_torch.sampling import cold_cache, sampler
from salient_plusplus_tpu_torch.sampling.batch import BatchSpec
from salient_plusplus_tpu_torch.sampling.shufflers import Shuffler
from salient_plusplus_tpu_torch.train import cold_policy
from salient_plusplus_tpu_torch.train import step as tstep
from salient_plusplus_tpu_torch.train.loop import Trainer
from tests.test_torch_data_sampling import _assert_batches_equal, _np

torch.set_num_threads(1)

SMALL = dict(name="small", num_nodes=5000, num_classes=10, avg_degree=10,
             num_features=32, seed=3)
TINY = dict(name="tiny", num_nodes=500, num_classes=5, avg_degree=8,
            num_features=16, seed=7)
CFG = dict(train_batch_size=256, test_batch_size=512, train_fanouts=[5, 3],
           batchwise_test_fanouts=[6, 6], final_test_fanouts=[6, 6],
           hidden_features=16, num_layers=2, lr=0.01, num_workers=2,
           calibration_batches=2, seed=4)


@pytest.fixture(scope="module")
def small():
    return synthetic.planted_partition(**SMALL)


@pytest.fixture(scope="module")
def jsmall():
    return jsyn.planted_partition(**SMALL)


@pytest.fixture(autouse=True)
def _interpret_mode():
    M.use_mxu_spmm(True, interpret=True)
    yield
    M.use_mxu_spmm(None, interpret=False)


# ------------------------------------------------------------- fp8 codec
@pytest.mark.parametrize("scale", [1.0, 1e-3, 300.0])
def test_fp8_codec_matches_jax(scale):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((512, 96)) * scale).astype(np.float32)
    x[3] = 0.0
    x[7, :5] = [448.0, -448.0, 1e-9, 3e4, -2.5]
    jp, js = jexchange.fp8_encode_rows_np(x)
    tp, ts = exchange.fp8_encode_rows_np(x)
    assert tp.dtype == np.uint8 and ts.dtype == np.float32
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ts, js)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        jd = np.asarray(jexchange.fp8_decode_rows(
            jnp.asarray(jp), jnp.asarray(js), jdt)).astype(np.float32)
        td = exchange.fp8_decode_rows(torch.from_numpy(tp),
                                      torch.from_numpy(ts), tdt).float()
        np.testing.assert_array_equal(td.numpy(), jd)
    assert (exchange.wire_row_bytes(96, torch.bfloat16, True)
            == jexchange.wire_row_bytes(96, jnp.bfloat16, True) == 100)
    assert (exchange.wire_row_bytes(96, torch.bfloat16, False)
            == jexchange.wire_row_bytes(96, jnp.bfloat16, False) == 192)


@pytest.mark.parametrize("fp8", [False, True])
def test_host_cold_tail_matches_jax(fp8):
    """The Trainer's host tail: bf16 bits (uint16) equal to the JAX
    package's bf16 array, or its fp8 payload and scales."""
    kw = dict(CFG, hbm_fraction=0.3, cold_fp8=fp8)
    t = Trainer(RunConfig(**kw), synthetic.planted_partition(**TINY),
                device="cpu")
    j = JTrainer(JRunConfig(**kw), jsyn.planted_partition(**TINY))
    assert t.hot_cutoff == j.hot_cutoff == 150
    assert t._cold_cap_max == j._cold_cap_max
    assert t.train_sampler.cfg.cold_cap == j.train_sampler.cfg.cold_cap
    want = np.asarray(j.x_cold)
    if fp8:
        np.testing.assert_array_equal(t.x_cold, want)
        np.testing.assert_array_equal(t.x_cold_scale, j.x_cold_scale)
    else:
        assert t.x_cold.dtype == np.uint16
        np.testing.assert_array_equal(t.x_cold, want.view(np.uint16))
    # the device table holds the hot prefix (gsrc: then the slack)
    hot = t.features[:t.hot_cutoff].view(torch.int16).numpy()
    np.testing.assert_array_equal(
        hot.view(np.uint16),
        np.asarray(j.features[:j.hot_cutoff]).view(np.uint16))
    assert t.features.shape == j.features.shape


# -------------------------------------------------------- cold-row cache
def test_cold_cache_matches_jax():
    """Slots, misses and counters over a stream of batches (hits, clock
    evictions, over-budget drops, a grow between epochs)."""
    rng = np.random.default_rng(1)
    jc = jcold_cache.HostColdCache(num_cold_ids=300, slots=64)
    tc = cold_cache.HostColdCache(num_cold_ids=300, slots=64)
    for step in range(40):
        if step == 20:
            jc.grow(96)
            tc.grow(96)
        ids = rng.choice(300 if step % 3 else 80, size=rng.integers(1, 70),
                         replace=False)
        max_new = int(rng.integers(0, 50))
        js, jm = jc.assign(ids, max_new=max_new)
        ts, tm = tc.assign(ids, max_new=max_new)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tm, jm)
        assert (tc.hits, tc.misses, tc.dropped, tc.clock) == (
            jc.hits, jc.misses, jc.dropped, jc.clock)
    np.testing.assert_array_equal(tc.slot_of, jc.slot_of)
    np.testing.assert_array_equal(tc.id_at, jc.id_at)
    assert tc.reset_epoch_stats() == jc.reset_epoch_stats()
    for top in (128, 1000, 1024, 2560, 5000):
        for count in (0, 1, 127, 128, 129, 500, 1000, 5000, 9000):
            assert (cold_cache.miss_rung(count, top)
                    == jcold_cache.miss_rung(count, top)), (count, top)
    with pytest.raises(ValueError):
        cold_cache.HostColdCache(10, 0)


# ---------------------------------------------------------------- policy
_PLAN_CASES = [  # tests/test_cold_policy.py:15-76
    dict(credit_mbs=1300, chip_rate_eps=45e6, edges_per_batch=650_000,
         base_bytes_per_batch=2.3e6, cold_bytes_per_batch=6.0e6,
         cold_tail_rows=250_000),
    dict(credit_mbs=300, chip_rate_eps=45e6, edges_per_batch=650_000,
         base_bytes_per_batch=2.3e6, cold_bytes_per_batch=6.0e6,
         cold_tail_rows=250_000),
    dict(credit_mbs=160, chip_rate_eps=45e6, edges_per_batch=650_000,
         base_bytes_per_batch=2.3e6, cold_bytes_per_batch=6.0e6,
         cold_tail_rows=250_000),
    dict(credit_mbs=5, chip_rate_eps=45e6, edges_per_batch=650_000,
         base_bytes_per_batch=2.3e6, cold_bytes_per_batch=6.0e6,
         cold_tail_rows=10_000),
    dict(credit_mbs=10, chip_rate_eps=45e6, edges_per_batch=650_000,
         base_bytes_per_batch=2.3e6, cold_bytes_per_batch=0,
         cold_tail_rows=0),
]


def _plan_numbers(p):
    return (p.slots, p.projected_demand_mbs, p.residual_demand_mbs,
            p.credit_mbs)


@pytest.mark.parametrize("case", range(len(_PLAN_CASES)))
def test_plan_cold_cache_matches_jax(case):
    kw = _PLAN_CASES[case]
    t = cold_policy.plan_cold_cache(**kw)
    assert _plan_numbers(t) == _plan_numbers(jpolicy.plan_cold_cache(**kw))
    assert t.slots % 128 == 0 or t.slots == kw["cold_tail_rows"]


def test_measure_h2d_credit_is_none_on_the_cpu():
    assert cold_policy.measure_h2d_credit(torch.device("cpu")) is None


@pytest.mark.parametrize("credit", [2.0, 1e5])
def test_auto_policy_plan_matches_jax(small, jsmall, credit):
    """cold_cache_slots -1 with a given credit: the port's probe batch
    gives the JAX package's payload split, so the same plan."""
    kw = dict(CFG, hbm_fraction=0.6, cold_cache_slots=-1,
              h2d_credit_mbs=credit)
    t = Trainer(RunConfig(**kw), small, device="cpu")
    j = JTrainer(JRunConfig(**kw), jsmall)
    assert _plan_numbers(t.cold_plan) == _plan_numbers(j.cold_plan)
    assert (t._cold_cache is None) == (credit > 1e3)
    if t._cold_cache is not None:
        assert t._cold_cache.slots == j._cold_cache.slots
        assert t.features.shape[0] == t.hot_cutoff + t._cold_cache.slots + 1
        assert np.isfinite(t.train_epoch(0))
        assert (t._cold_cache.id_at >= 0).any()


def test_auto_policy_on_cpu_disables_the_cache(small):
    t = Trainer(RunConfig(**dict(CFG, hbm_fraction=0.6,
                                 cold_cache_slots=-1)), small, device="cpu")
    assert t._cold_cache is None and t.cold_plan is None
    assert ("COLD_CACHE_PLAN", "cpu-backend", 0) in t.logger.events


# --------------------------------------------------------- sampler fills
_COLD_FIELDS = ("cold_pos", "cold_count", "cold_scale")


def _cold_epoch(mod, spec_cls, cache_mod, g, spec, mode, fp8, workers):
    """An epoch of batches through one package's FastSampler at a 0.4
    hot/cold split; buffers are not recycled, so every batch stays
    readable. Cache mode: a fresh HostColdCache of 384 slots."""
    x = np.asarray(g.x, np.float32)
    H = int(0.4 * g.num_nodes)
    if fp8:
        x_cold, scale = exchange.fp8_encode_rows_np(x[H:])
    else:
        x_cold = torch.from_numpy(x[H:]).to(torch.bfloat16).view(
            torch.int16).numpy().view(np.uint16).copy()
        scale = None
    if mod is jsampler and not fp8:
        x_cold = x_cold.view(jnp.bfloat16)
    cache = (cache_mod.HostColdCache(g.num_nodes - H, 384)
             if mode.startswith("cache") else None)
    cfg = mod.FastSamplerConfig(
        spec=spec_cls(**dataclasses.asdict(spec)), batch_size=spec.seed_cap,
        base_seed=11, num_workers=workers, hot_cutoff=H, x_cold=x_cold,
        x_cold_scale=scale, cold_cap=256, cold_cache=cache,
        cold_fold=mode == "cache-fold", emit_gsrc=mode != "plain",
        compress_dst=True, pack_wire=True)
    s = mod.FastSampler(np.asarray(g.rowptr, np.int64),
                        np.asarray(g.col, np.int32),
                        np.asarray(g.y, np.int32), cfg,
                        idx=Shuffler(g.split_idx["train"]).get_idx(0)[:640])
    it = iter(s)
    return [b.to_padded_batch() for b in it], it.stats, cache


@pytest.mark.parametrize("mode,fp8", [("plain", False), ("gsrc", False),
                                      ("cache", False), ("cache-fold", False),
                                      ("gsrc", True), ("cache", True)])
def test_cold_fills_match_jax(small, mode, fp8):
    """The same batches, cold fields included, over-budget drops included.
    The drop count is held to the JAX package's with one sampler thread:
    its workers add to ``dropped_cold`` with a read-modify-write around
    the native gather, so with two threads it loses updates (ROADMAP.md
    Queue 3); the port's workers add under a lock. In cache mode the
    count is held to the cache's own count of dropped ids."""
    spec = BatchSpec.worst_case(128, [4, 3])
    jbs, jst, jc = _cold_epoch(jsampler, JBatchSpec, jcold_cache, small,
                               spec, mode, fp8, workers=1)
    tbs, tst, tc = _cold_epoch(sampler, BatchSpec, cold_cache, small, spec,
                               mode, fp8, workers=2)
    assert len(jbs) == len(tbs) == 5
    assert tst.cold_rows == jst.cold_rows > 0
    if tc is None:
        assert tst.dropped_cold == jst.dropped_cold > 0
    if mode == "plain":  # and to the count the batches themselves give
        H = int(0.4 * small.num_nodes)
        want = 0
        for tb in tbs:
            d = tb.decoded_n_id()
            n = int(d.level_sizes[-1])
            want += max(0, int((d.n_id[:n] >= H).sum()) - 256)
        assert tst.dropped_cold == want
    if tc is not None:
        assert tst.dropped_cold == tc.dropped == jc.dropped
    for jb, tb in zip(jbs, tbs):
        _assert_batches_equal(jb, tb)  # n_id (remapped, packed), src, ...
        rows = tb.cold_rows
        if fp8:
            assert rows.dtype == torch.uint8
            np.testing.assert_array_equal(rows.numpy(), jb.cold_rows)
        else:
            assert rows.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                rows.view(torch.int16).numpy().view(np.uint16),
                np.asarray(jb.cold_rows).view(np.uint16))
        for f in _COLD_FIELDS:
            jv, tv = getattr(jb, f), getattr(tb, f)
            assert (jv is None) == (tv is None), f
            if jv is not None:
                np.testing.assert_array_equal(_np(tv), np.asarray(jv), f)


def test_gather_features_overlay_matches_jax_and_full(small, jsmall):
    """The non-gsrc overlay (K1 as a sorted placement; its plain version
    here) equals the JAX overlay (K1 in interpret mode) and the
    all-in-memory gather ``features_full[n_id]``, bit for bit."""
    kw = dict(CFG, hbm_fraction=0.5, gsrc_mode="off")
    t = Trainer(RunConfig(**kw), small, device="cpu")
    j = JTrainer(JRunConfig(**kw), jsmall)
    full = Trainer(RunConfig(**dict(kw, hbm_fraction=1.0)), small,
                   device="cpu").features
    out = []
    for tr in (t, j):
        tr.train_sampler.set_epoch(tr.shuffler.get_idx(0), 0)
        it = iter(tr.train_sampler)
        bufs = next(it)
        out.append(bufs.to_padded_batch())
        it.close()
    tb = tstep.decode_batch(out[0].clone())
    jb = jstep.decode_batch(jax.tree_util.tree_map(np.array, out[1]))
    assert int(tb.cold_count) > 0
    x_port = tstep.gather_features(t.features, tb)
    x_jax = np.asarray(jstep.gather_features(j.features, jb))
    np.testing.assert_array_equal(
        x_port.view(torch.int16).numpy().view(np.uint16),
        x_jax.view(np.uint16))
    x_full = full[tb.n_id.long()]
    assert torch.equal(x_port.view(torch.int16), x_full.view(torch.int16))
    # the hot prefix alone clamps the cold rows: the overlay did the work
    assert not torch.equal(
        t.features[tb.n_id.clamp(max=t.hot_cutoff - 1).long()], x_full)


# ------------------------------------------ Trainer: 0.5 / 0.05 == 1.0
_REF = {}


def _params(t):
    return {k: v.clone() for k, v in t.state.model.state_dict().items()}


def _run(g, epochs=1, **kw):
    t = Trainer(RunConfig(**dict(CFG, **kw)), g, device="cpu")
    for e in range(epochs):
        t.train_epoch(e)
    return t, _params(t)


def _reference(g, model, epochs):
    key = (model, epochs)
    if key not in _REF:
        _REF[key] = _run(g, epochs, model_name=model)[1]
    return _REF[key]


def _events(t, name, since=0):
    return [e for e in t.logger.events[since:]
            if isinstance(e, tuple) and e[0] == name]


def _assert_equal_params(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("model,frac,extra", [
    ("SAGE", 0.5, {}), ("SAGE", 0.05, {}),
    ("SAGE", 0.5, {"gsrc_mode": "off"}), ("SAGE", 0.05, {"gsrc_mode": "off"}),
    ("GIN", 0.5, {}), ("GCN", 0.5, {}), ("GCN", 0.05, {}),
    ("SAGE", 0.5, {"cold_fold_update": True}),
    ("SAGE", 0.05, {"cold_fold_update": True}),
])
def test_trainer_cold_tier_bit_equals_all_in_memory(small, model, frac,
                                                    extra):
    t, p = _run(small, model_name=model, hbm_fraction=frac, **extra)
    assert t.hot_cutoff == max(1, int(small.num_nodes * frac))
    gsrc = model != "GCN" and extra.get("gsrc_mode") != "off"
    assert t._gsrc_cold == gsrc
    assert t._fold_cold == bool(extra.get("cold_fold_update"))
    _assert_equal_params(p, _reference(small, model, 1))


@pytest.mark.parametrize("fold", [False, True])
def test_trainer_cold_cache_bit_equals_all_in_memory(small, fold):
    """512 slots against a 2500-row tail: constant evictions over two
    epochs, the training still bit-equal to the all-in-memory run."""
    t, p = _run(small, epochs=2, hbm_fraction=0.5, cold_cache_slots=512,
                cold_fold_update=fold)
    cache = t._cold_cache
    assert cache is not None and cache.slots >= 512
    assert t.features.shape[0] == t.hot_cutoff + cache.slots + 1
    # the permanent zero row stays zero (the pads of every miss buffer)
    assert not t.features[-1].any()
    _assert_equal_params(p, _reference(small, "SAGE", 2))
    hits = _events(t, "COLD_CACHE")
    assert len(hits) == 2 and hits[1][3] > 0  # epoch 1 hits the cache


def test_trainer_cold_cache_full_tail_evaluates_exactly(small):
    """Slots covering the whole tail: evaluation runs against rows the
    training already placed (hit rate > 0.95, no drop) and scores what the
    uncached run scores."""
    t, p = _run(small, epochs=2, hbm_fraction=0.5,
                cold_cache_slots=small.num_nodes)
    acc = t.evaluate("valid")
    cache = t._cold_cache
    assert cache.hits / (cache.hits + cache.misses) > 0.95
    assert cache.dropped == 0
    u, pu = _run(small, epochs=2, hbm_fraction=0.5)
    _assert_equal_params(p, pu)
    assert acc == u.evaluate("valid")


def test_trainer_cold_fp8_gsrc_bit_equals_fallback(small):
    """fp8 cold rows decode into the slack region (gsrc) or in the
    overlay (gsrc off): the same decoded values, so bit-equal; and the
    quantised inputs still train."""
    on, p_on = _run(small, epochs=2, hbm_fraction=0.5, cold_fp8=True)
    off, p_off = _run(small, epochs=2, hbm_fraction=0.5, cold_fp8=True,
                      gsrc_mode="off")
    assert on._gsrc_cold and not off._gsrc_cold
    assert on.x_cold.dtype == np.uint8 and on.x_cold_scale is not None
    _assert_equal_params(p_on, p_off)
    assert on.evaluate("valid") == off.evaluate("valid") > 0.5


@pytest.mark.parametrize("frac", [0.5, 0.05])
def test_trainer_cold_evaluate_matches_all_in_memory(small, frac):
    t, _ = _run(small, hbm_fraction=frac)
    f, _ = _run(small)
    assert t.evaluate("valid") == f.evaluate("valid")
    assert t.evaluate_layerwise() == {"valid": f.evaluate("valid"),
                                      "test": f.evaluate("test")}
    assert "LAYERWISE_NEEDS_FULL_HBM_FALLBACK" in t.logger.events


# ------------------------------------------------ one step against JAX
@pytest.mark.parametrize("gsrc_mode", ["auto", "off"])
def test_one_cold_step_matches_jax_trainer(small, jsmall, gsrc_mode):
    """The first batch of epoch 0 at hbm_fraction 0.5 through each
    package's Trainer.run_step (cold rows into the slack, or the overlay),
    float32 models from the same weights, dropout 0: loss and parameters
    after one Adam step within 2e-4."""
    kw = dict(CFG, hbm_fraction=0.5, gsrc_mode=gsrc_mode, dropout=0.0)
    j = JTrainer(JRunConfig(**kw), jsmall)
    j.model = jmake_model("SAGE", jsmall.num_features, 16,
                          jsmall.num_classes, 2, 0.0, dtype=jnp.float32)
    j.reset()
    t = Trainer(RunConfig(**dict(kw, compute_dtype="float32")), small,
                device="cpu")
    t.state.model.load_state_dict(weights.params_from_jax(
        jax.tree_util.tree_map(np.asarray, j.state.params)))
    batches = []
    for tr in (j, t):
        tr.train_sampler.set_epoch(tr.shuffler.get_idx(0), 0)
        it = iter(tr.train_sampler)
        bufs = next(it)
        batches.append(bufs.to_padded_batch(bufs.bucket))
        it.close()
    jb = jax.tree_util.tree_map(np.array, batches[0])
    assert jb.cold_rows is not None
    jloss = float(j.run_step(jb))
    tloss = float(t.run_step(batches[1].clone()))
    assert abs(jloss - tloss) < 2e-4, (jloss, tloss)
    jp = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, j.state.params))
    tp = jax.tree_util.tree_leaves_with_path(
        weights.params_to_jax(t.state.model.state_dict()))
    assert [k for k, _ in jp] == [k for k, _ in tp]
    for (k, a), (_, b) in zip(jp, tp):
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-4,
                                   err_msg=str(k))


# ---------------------------------------------------- growth after drops
@pytest.mark.parametrize("gsrc_mode", ["auto", "off"])
def test_cold_cap_and_slack_grow_after_drops(gsrc_mode):
    """A sabotaged cold budget drops rows in epoch 0; the cap grows (and,
    in gsrc mode, the slack region of the table with it) and epoch 1
    drops nothing."""
    g = synthetic.planted_partition(**TINY)
    t = Trainer(RunConfig(**dict(CFG, train_batch_size=64, num_workers=1,
                                 hbm_fraction=0.5, gsrc_mode=gsrc_mode)),
                g, device="cpu")
    H = t.hot_cutoff
    assert t.features.shape[0] == H + t._slack
    assert t.train_sampler.cfg.cold_cap > 128
    t.train_sampler.cfg.cold_cap = 128  # sabotage
    t.train_epoch(0)
    grown = t.train_sampler.cfg.cold_cap
    assert grown > 128
    assert _events(t, "WARNING_COLD_DROPPED")
    assert grown <= t._cold_cap_max
    if gsrc_mode == "auto":
        assert t._slack >= grown
    assert t.features.shape[0] == H + t._slack
    n = len(t.logger.events)
    t.train_epoch(1)
    assert t.train_sampler.cfg.cold_cap == grown
    assert not _events(t, "WARNING_COLD_DROPPED", since=n)


def test_eval_cold_floor_grows_after_drops(small):
    """A split whose cold cap is too small drops cold rows; its floor
    grows by at least 1.25x a pass until a pass drops nothing, and that
    pass scores what the all-in-memory run scores."""
    t, _ = _run(small, hbm_fraction=0.5)
    f, _ = _run(small)
    want = f.evaluate("valid")
    key = ("valid", tuple(t.cfg.batchwise_test_fanouts))
    t.eval_cold_base[key] = 1024  # sabotage this split's calibrated cap
    floors = []
    for _ in range(10):
        n = len(t.logger.events)
        acc = t.evaluate("valid")
        if not _events(t, "EVAL_COLD_DROPPED", since=n):
            break
        floors.append(t.eval_cold_floor[key])
    assert floors and floors == sorted(set(floors)) and floors[0] >= 1280
    assert acc == want


def test_cold_cache_config_rejections():
    with pytest.raises(ValueError, match="cold tier"):
        RunConfig(cold_cache_slots=100, hbm_fraction=1.0)
    with pytest.raises(ValueError, match="FastSampler"):
        RunConfig(cold_cache_slots=100, hbm_fraction=0.5,
                  train_sampler="FastPreSampler")
    with pytest.raises(ValueError, match="gsrc"):
        RunConfig(cold_cache_slots=100, hbm_fraction=0.5, gsrc_mode="off")
    with pytest.raises(ValueError, match="cold_fold_update"):
        RunConfig(cold_fold_update=True)
    with pytest.raises(ValueError, match="cold_fp8"):
        RunConfig(cold_fp8=True)
    g = synthetic.planted_partition(**TINY)
    with pytest.raises(ValueError, match="gsrc-capable"):
        Trainer(RunConfig(**dict(CFG, model_name="GCN", hbm_fraction=0.5,
                                 cold_cache_slots=256)), g, device="cpu")


# ------------------------------------------------------------- the driver
@pytest.mark.parametrize("flags", [
    [], ["--final_test_mode", "layerwise"], ["--model_name", "GCN"],
    ["--cold_cache_slots", "1024", "--cold_fold_update", "true"],
    ["--cold_fp8", "true"],
])
def test_driver_cold_tier_on_cpu(tmp_path, flags):
    out = driver.main([
        "synth:V=2000,C=5,deg=8,F=16", "cold", "--epochs", "1",
        "--train_batch_size", "128", "--train_fanouts", "5,3",
        "--batchwise_test_fanouts", "6,6", "--final_test_fanouts", "6,6",
        "--num_layers", "2", "--hidden_features", "16", "--num_workers",
        "1", "--calibration_batches", "2", "--lr", "0.01",
        "--hbm_fraction", "0.5", "--output_root", str(tmp_path), *flags],
        device="cpu")
    assert out[0]["final_valid"] > 0.5  # chance is 0.2
    assert np.isfinite(out[0]["losses"]).all()
    log = (tmp_path / "cold").glob("*logs*")
    text = "".join(p.read_text() for p in log)
    if "layerwise" in flags:
        assert "LAYERWISE_NEEDS_FULL_HBM_FALLBACK" in text
