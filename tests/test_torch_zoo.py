"""The port's GAT, GCN and ARMA against the JAX package's, and all eight
models of the zoo against the numpy oracles of the reference's equations
(tests/test_reference_parity.py, reused by import).

One batch is sampled by both packages' samplers from the same seeds
through the wire path (ddeg, wire-pack) with each model's specs (GCN and
ARMA mirror every hop). The flax variables are initialised, BatchNorm
scales, biases and running statistics replaced by random values, and
carried to the port with ``weights``. float32, dropout 0 (the two
frameworks draw different bits); tolerance 2e-4, the reference-parity
tolerance, for outputs, running statistics, losses and parameters after
one Adam step. The JAX package's Pallas kernels run in interpret mode.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salient_plusplus_tpu.data import synthetic as jsyn
from salient_plusplus_tpu.data.dataset import pad_feature_dim
from salient_plusplus_tpu.models import make_model as jmake_model
from salient_plusplus_tpu.ops import mxu_segment as M
from salient_plusplus_tpu.sampling import cpp as jcpp
from salient_plusplus_tpu.sampling import sampler as jsampler
from salient_plusplus_tpu.sampling.batch import BatchSpec as JBatchSpec
from salient_plusplus_tpu.sampling.batch import \
    mirror_all_specs as jmirror_all_specs
from salient_plusplus_tpu.train import step as jstep
from salient_plusplus_tpu.train.state import create_train_state as jcreate

from salient_plusplus_tpu_torch import weights
from salient_plusplus_tpu_torch.models import (
    MODEL_REGISTRY, MODELS, make_model, mirror_all_specs)
from salient_plusplus_tpu_torch.sampling import cpp as tcpp
from salient_plusplus_tpu_torch.sampling import sampler as tsampler
from salient_plusplus_tpu_torch.sampling.batch import BatchSpec
from salient_plusplus_tpu_torch.train import step as tstep
from salient_plusplus_tpu_torch.train.state import TrainState
from tests import test_reference_parity as ref
from tests.test_torch_models import _np_tree, _randomise_bn
from tests.test_torch_sage import C_OUT, F_IN, HID

torch.set_num_threads(1)
TOL = 2e-4
NEW = ["GAT", "GCN", "ARMA"]


@pytest.fixture(autouse=True)
def _interpret_mode():
    M.use_mxu_spmm(True, interpret=True)
    yield
    M.use_mxu_spmm(None, interpret=False)


class _JitInit:
    """A flax model whose ``init`` is jitted (GAT's eager scans take ~20 s
    to initialise); ``apply`` is the model's."""

    def __init__(self, model):
        self.model, self.apply = model, model.apply

    def init(self, key, x, batch, training=False):
        return jax.jit(lambda k, xx, bb: self.model.init(
            k, xx, bb, training=training))(key, x, batch)


def _spec(name, one_cap=False):
    """The model's worst-case spec for 32 seeds and fanouts [8, 3] (above
    most degrees of the graph, so every hop has pads); with ``one_cap``
    every level past the seeds has the outermost cap, so a layer's input
    rows equal its hop's input cap."""
    spec = BatchSpec.worst_case(32, [8, 3])
    if one_cap:
        spec = dataclasses.replace(
            spec, node_caps=(32,) + (spec.node_caps[-1],) * 2)
    return mirror_all_specs(name, spec)[0]


def _pair(spec, seed=0):
    """(jax batch, port batch, padded f32 features) for one seed set."""
    g = jsyn.planted_partition(name="zoo", num_nodes=400, num_classes=C_OUT,
                               avg_degree=6, num_features=F_IN, seed=3)
    seeds = np.sort(np.random.default_rng(seed).choice(
        g.split_idx["train"], 32, replace=False))
    out = []
    for cpp, smp, spec_cls in ((jcpp, jsampler, JBatchSpec),
                               (tcpp, tsampler, BatchSpec)):
        sp = spec_cls(**dataclasses.asdict(spec))
        cfg = smp.FastSamplerConfig(spec=sp, batch_size=32, emit_gsrc=False,
                                    compress_dst=True, pack_wire=True)
        bufs = cpp.BatchBuffers(sp)
        bufs.attach_from_config(cfg, g.num_nodes)
        cpp.NativeSampler(np.asarray(g.rowptr), np.asarray(g.col)
                          ).sample_into(bufs, seeds, rng_seed=seed + 1,
                                        y_global=np.asarray(g.y, np.int32))
        bufs.finalize_from_config(cfg)
        out.append(bufs.to_padded_batch())
    return out[0], out[1], pad_feature_dim(np.asarray(g.x, np.float32))


def _setup(name, one_cap=False, seed=0):
    jb, tb, x = _pair(_spec(name, one_cap), seed)
    jmodel = _JitInit(jmake_model(name, x.shape[1], HID, C_OUT, 2, 0.0,
                                  dtype=jnp.float32))
    jbd = jstep.decode_batch(jb)
    jx = jnp.asarray(x)[jbd.n_id]
    var = jax.tree_util.tree_map(np.array, jmodel.init(
        jax.random.key(seed), jx, jbd))
    params, stats = _randomise_bn(dict(var["params"]),
                                  dict(var.get("batch_stats", {})),
                                  np.random.default_rng(seed + 1))
    model = make_model(name, x.shape[1], HID, C_OUT, 2, 0.0,
                       dtype=torch.float32)
    model.load_state_dict({**weights.params_from_jax(params),
                           **weights.batch_stats_from_jax(stats)})
    tbd = tstep.decode_batch(tb)
    tx = torch.from_numpy(x).index_select(0, tbd.n_id)
    return (jmodel, params, stats, jx, jb, jbd), (model, tx, tb, tbd), x


def test_make_model_builds_all_eight():
    assert sorted(MODEL_REGISTRY) == sorted(
        ["SAGE", "SAGEClassic", "GIN", "JKNet", "SAGEResInception", "GAT",
         "GCN", "ARMA"])
    for name in MODEL_REGISTRY:
        m = make_model(name, 8, 8, 3, 2)
        assert m.num_layers == 2 and sum(p.numel() for p in m.parameters())


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_traits(monkeypatch, name):
    """What each model declares: its outer hop mirrored exactly where the
    JAX package's rule mirrors it with its GAT switch unset (GATSkip, not
    in its zoo, as GAT), and layer 0 reading the table exactly where the
    forward takes ``features=``; the port's specs follow the trait."""
    monkeypatch.delenv("SPTPU_GAT_CUSTOM_VJP", raising=False)
    cls = MODELS[name]
    spec = JBatchSpec.worst_case(32, [8, 3])
    jname = "GAT" if name == "GATSkip" else name
    assert cls.mirrors_outer_hop is jmirror_all_specs(jname,
                                                      spec)[0].mirror_all
    assert mirror_all_specs(name, BatchSpec.worst_case(
        32, [8, 3]))[0].mirror_all is cls.mirrors_outer_hop
    assert cls.reads_table_at_layer0 is (
        "features" in inspect.signature(cls.forward).parameters)
    assert not (cls.reads_table_at_layer0 and cls.mirrors_outer_hop)


@pytest.mark.parametrize("name", NEW)
def test_weights_carry_round_trip(name):
    (_, params, stats, *_), (model, *_), _ = _setup(name)
    sd = model.state_dict()
    assert set(sd) == set(weights.params_from_jax(params)) | set(
        weights.batch_stats_from_jax(stats))
    for got, want in ((weights.params_to_jax(sd), params),
                      (weights.batch_stats_to_jax(sd), stats)):
        la = jax.tree_util.tree_leaves_with_path(want)
        lb = jax.tree_util.tree_leaves_with_path(got)
        assert [k for k, _ in la] == [k for k, _ in lb]
        for (_, a), (_, b) in zip(la, lb):
            np.testing.assert_array_equal(a, b)
    expect = {"GAT": "conv1.att_dst", "GCN": "bn0.var", "ARMA": "conv1.v.weight"}
    assert expect[name] in sd


@pytest.mark.parametrize("name", NEW)
def test_forward_eval_matches_jax(name):
    (jmodel, params, stats, jx, _, jbd), (model, tx, _, tbd), _ = \
        _setup(name)
    want = np.asarray(jax.jit(lambda v, xx, bb: jmodel.apply(
        v, xx, bb, training=False))({"params": params, "batch_stats": stats},
                                    jx, jbd))
    with torch.no_grad():
        got = model.eval()(tx, tbd, training=False).numpy()
    assert got.shape == want.shape == (32, HID if name == "ARMA" else C_OUT)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", NEW)
def test_forward_train_and_running_stats_match_jax(name):
    (jmodel, params, stats, jx, _, jbd), (model, tx, _, tbd), _ = \
        _setup(name)
    want, upd = jax.jit(lambda v, xx, bb: jmodel.apply(
        v, xx, bb, training=True, rngs={"dropout": jax.random.key(1)},
        mutable=["batch_stats"]))({"params": params, "batch_stats": stats},
                                  jx, jbd)
    with torch.no_grad():
        got = model.train()(tx, tbd, training=True).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    new = weights.batch_stats_to_jax(model.state_dict())
    la = jax.tree_util.tree_leaves_with_path(_np_tree(upd["batch_stats"]))
    lb = jax.tree_util.tree_leaves_with_path(new)
    assert [k for k, _ in la] == [k for k, _ in lb]
    assert bool(la) == (name == "GCN")   # GCN's BN between layers
    for (k, a), (_, b) in zip(la, lb):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg=str(k))
    assert all(not np.allclose(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(stats), jax.tree_util.tree_leaves(new)))


def _one_step(name, one_cap, seed=4, lr=0.01):
    """One Adam step of both packages from the same weights: the two
    losses and, per leaf of params and batch_stats, (path, jax, port)."""
    (jmodel, params, stats, _, jb, _), (model, _, tb, _), x = _setup(
        name, one_cap=one_cap, seed=seed)
    jstate = jcreate(jmodel, jnp.asarray(x)[jstep.decode_batch(jb).n_id],
                     jstep.decode_batch(jb), lr, seed=0)
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                          params),
                            batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                               stats))
    tstate = TrainState(model, lr, seed=0, device=torch.device("cpu"))
    jstate, jloss = jstep.make_train_step()(jstate, jnp.asarray(x), jb)
    tloss = tstep.train_step(tstate, torch.from_numpy(x), tb)
    sd = tstate.model.state_dict()
    leaves = []
    for want, got in ((_np_tree(jstate.params), weights.params_to_jax(sd)),
                      (_np_tree(jstate.batch_stats),
                       weights.batch_stats_to_jax(sd))):
        la = jax.tree_util.tree_leaves_with_path(want)
        lb = jax.tree_util.tree_leaves_with_path(got)
        assert [k for k, _ in la] == [k for k, _ in lb]
        leaves += [(jax.tree_util.keystr(k), a, b)
                   for (k, a), (_, b) in zip(la, lb)]
    return float(jloss), float(tloss), leaves


@pytest.mark.parametrize("name", NEW)
def test_train_step_matches_jax(name):
    """One step from the same weights: the loss, every parameter after
    Adam and GCN's running statistics. GCN runs on a spec whose levels
    past the seeds share one cap: there the JAX package's mirrored
    backward drops the mirror's pads too (see the next tests)."""
    jloss, tloss, leaves = _one_step(name, one_cap=name == "GCN")
    assert abs(jloss - tloss) < TOL
    for k, a, b in leaves:
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg=k)


def test_gcn_step_differs_from_jax_by_the_mirror_pads_only():
    """With distinct caps (32 / 384 / 1536) the JAX package's GCN adds the
    outer hop's mirror pads into row 384 of the layer-1 input, a
    zero-extended row that BN's statistics read; the port drops them
    (ROADMAP.md Queue 3). The losses agree; after one Adam step (lr 0.01)
    ``conv0.lin.kernel`` is more than the tolerance apart (Adam turns the
    small gradient difference into up to 2·lr) and every other leaf is
    within it."""
    jloss, tloss, leaves = _one_step("GCN", one_cap=False)
    assert abs(jloss - tloss) < TOL
    for k, a, b in leaves:
        err = float(np.abs(a - b).max())
        if k == "['conv0']['lin']['kernel']":
            assert TOL < err <= 2 * 0.01 + TOL, err
        else:
            assert err < TOL, (k, err)


def test_gcn_mirrored_backward_drops_the_mirror_pads():
    """With distinct caps a GCN layer's input has more rows than its hop's
    input cap, the mirror's pad value. The port's gradients through K1 over
    the mirror equal those of the mirror-free path (``index_add_``
    transpose of the gather), pads included nowhere. The JAX package sums
    that hop's mirror into ``x.shape[0]`` rows, so its pads land in the row
    at the cap (ROADMAP.md Queue 3)."""
    _, (model, tx, _, tbd), _ = _setup("GCN", seed=2)
    assert tbd.spec.node_caps[1] < tbd.spec.node_caps[2]
    assert all(e.msrc is not None for e in tbd.edges)
    bare = dataclasses.replace(tbd, edges=tuple(
        dataclasses.replace(e, msrc=None, mdst=None) for e in tbd.edges))
    grads = []
    for b in (tbd, bare):
        model.zero_grad()
        model.train()(tx, b, training=True).sum().backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=TOL,
                                   atol=TOL, msg=k)


# ------------------------------------------------- the numpy oracles
def _oracle(name, b, x, p, s):
    """The reference's equations in numpy (the conv and BN oracles of
    tests/test_reference_parity.py), composed as that file composes them:
    log-probabilities of the seed rows."""
    L = 2
    edges = [ref._edges(b, i) for i in range(L)]
    caps = b.spec.node_caps
    end = caps[0]
    if name in ("SAGE", "SAGEClassic", "GAT"):
        conv = ref.np_gat_conv if name == "GAT" else ref.np_sage_conv
        for i, (src, dst) in enumerate(edges):
            T = caps[L - i - 1]
            h = conv(p[f"conv{i}"], x, x[:T], src, dst, T)
            x = np.maximum(h, 0) if i != L - 1 else h
        z = x
    elif name == "GIN":
        for i, (src, dst) in enumerate(edges):
            T = caps[L - i - 1]
            x = ref.np_gin_conv(p[f"conv{i}"], s[f"conv{i}"], x, x[:T], src,
                                dst, T)
        z = ref.np_dense(p["lin2"], np.maximum(ref.np_dense(p["lin1"], x), 0))
    elif name == "JKNet":
        xs = []
        for i, (src, dst) in enumerate(edges):
            T = caps[L - i - 1]
            h = ref.np_sage_conv(p[f"conv{i}"], x, x[:T], src, dst, T)
            x = np.maximum(ref.np_bn_eval(p[f"bn{i}"], s[f"bn{i}"], h), 0)
            xs.append(x[:end])
        z = ref.np_dense(p["lin"], np.maximum.reduce(xs))
    elif name == "SAGEResInception":
        collect = [x[:end]]
        for i, (src, dst) in enumerate(edges):
            T = caps[L - i - 1]
            xt = x[:T]
            h = ref.np_sage_conv(p[f"conv{i}"], x, xt, src, dst, T)
            h = ref.np_bn_eval(p[f"bn{i}"], s[f"bn{i}"], h)
            h = np.where(h > 0, h, 0.01 * h)
            collect.append(h[:end])
            x = h + (ref.np_dense(p["res0"], xt) if i == 0 else xt)
        z = np.concatenate(collect, -1)
        z = ref.np_dense(p["mlp"]["fc1"], ref.np_dense(p["mlp"]["fc0"], z))
    elif name == "GCN":
        for i, (src, dst) in enumerate(edges):
            in_cap, T = caps[L - i], caps[L - i - 1]
            h = ref.np_gcn_conv(p[f"conv{i}"], x, src, dst, T)
            x = np.zeros((in_cap, h.shape[1]), np.float32)
            x[:T] = h
            if i != L - 1:
                x = np.maximum(ref.np_bn_eval(p[f"bn{i}"], s[f"bn{i}"], x), 0)
        z = x
    else:
        assert name == "ARMA"
        for i, (src, dst) in enumerate(edges):
            h = ref.np_arma_conv(p[f"conv{i}"], x, src, dst, caps[L - i - 1])
            x = np.maximum(h, 0) if i != L - 1 else h
        z = x
    seeds = int(b.seed_count)
    return ref.np_log_softmax(z[:seeds])


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_matches_reference_numpy_oracle(name):
    """Eval mode, random weights and running statistics (the oracle file's
    own generators), on that file's batch: 32 seeds, fanouts [4, 3], its
    300-node graph and standard-normal features."""
    from salient_plusplus_tpu.sampling.cpp import NativeSampler as JNative

    from salient_plusplus_tpu_torch.sampling.cpp import NativeSampler

    g = jsyn.planted_partition(name="parity", num_nodes=300,
                               num_classes=C_OUT, avg_degree=6,
                               num_features=F_IN, seed=3)
    seeds = np.sort(np.random.default_rng(0).choice(g.num_nodes, 32,
                                                    replace=False))
    spec = BatchSpec.worst_case(32, [4, 3])
    y = np.asarray(g.y, np.int32)
    jb = JNative(np.asarray(g.rowptr), np.asarray(g.col)).sample(
        JBatchSpec(**dataclasses.asdict(spec)), seeds, rng_seed=11,
        y_global=y)
    tb = NativeSampler(np.asarray(g.rowptr), np.asarray(g.col)).sample(
        spec, seeds, rng_seed=11, y_global=y)
    feats = np.random.default_rng(1).standard_normal(
        (g.num_nodes, F_IN)).astype(np.float32)
    x = feats[np.asarray(jb.n_id)]
    jmodel = _JitInit(jmake_model(name, F_IN, HID, C_OUT, 2, dropout=0.5,
                                  dtype=jnp.float32))
    var = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jb)
    p = _np_tree(ref._rng_weights(var["params"]))
    s = (_np_tree(ref._rng_stats(var["batch_stats"]))
         if "batch_stats" in var else {})
    model = make_model(name, F_IN, HID, C_OUT, 2, dropout=0.5,
                       dtype=torch.float32)
    model.load_state_dict({**weights.params_from_jax(p),
                           **weights.batch_stats_from_jax(s)})
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(feats).index_select(0, tb.n_id),
                           tb, training=False).numpy()
    want = _oracle(name, jb, x, p, s)
    seeds_n = want.shape[0]
    np.testing.assert_allclose(got[:seeds_n], want, rtol=TOL, atol=TOL)
