"""The port's SAGEClassic, GIN, JKNet and SAGEResInception against the JAX
package's, on carried-over params and batch statistics.

One batch is sampled by both packages' samplers from the same seeds
(tests/test_torch_sage.make_pair). The flax variables are initialised,
their BatchNorm scales, biases and running statistics are replaced by
random values (so that carrying them is tested), and they are carried to
the port with ``weights``. In float32 the forward must agree at the
reference-parity tolerance 2e-4, in eval mode (running statistics) and in
train mode (masked batch statistics), where the updated running
statistics must agree too. Dropout is off in train mode on both sides:
the two frameworks draw different bits.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salient_plusplus_tpu.models import make_model as jmake_model
from salient_plusplus_tpu.ops import mxu_segment as M
from salient_plusplus_tpu.train import step as jstep
from salient_plusplus_tpu.train.state import create_train_state as jcreate

from salient_plusplus_tpu_torch import weights
from salient_plusplus_tpu_torch.models import make_model, modules
from salient_plusplus_tpu_torch.train import step as tstep
from salient_plusplus_tpu_torch.train.state import TrainState
from tests.test_torch_sage import C_OUT, HID, make_pair

torch.set_num_threads(1)
TOL = 2e-4
# (model, gsrc): GIN and SAGEClassic may read layer 0 from the table
CASES = [("SAGEClassic", True), ("GIN", True), ("GIN", False),
         ("JKNet", False), ("SAGEResInception", False)]


@pytest.fixture(autouse=True)
def _interpret_mode():
    M.use_mxu_spmm(True, interpret=True)
    yield
    M.use_mxu_spmm(None, interpret=False)


@pytest.fixture
def no_dropout(monkeypatch):
    """SAGEResInception's dropout 0.1 is fixed in both packages: turn it
    into the identity on both sides."""
    monkeypatch.setattr(flax.linen, "Dropout",
                        lambda rate, deterministic=None: (lambda v: v))
    monkeypatch.setattr(modules.SAGEResInception, "inner_dropout", 0.0)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _randomise_bn(params, stats, rng):
    """Random BN scale/bias and running mean/var (var > 0)."""
    def walk(p, s):
        for k in p:
            if isinstance(p[k], dict) and "scale" in p[k]:
                f = p[k]["scale"].shape
                p[k]["scale"] = rng.uniform(0.5, 1.5, f).astype(np.float32)
                p[k]["bias"] = rng.normal(0, 0.3, f).astype(np.float32)
                s[k]["mean"] = rng.normal(0, 0.3, f).astype(np.float32)
                s[k]["var"] = rng.uniform(0.5, 2.0, f).astype(np.float32)
            elif isinstance(p[k], dict):
                walk(p[k], s.get(k, {}))
    walk(params, stats)
    return params, stats


def _setup(name, gsrc, seed=0):
    g, jb, tb, x = make_pair(gsrc, seed=seed)
    jmodel = jmake_model(name, x.shape[1], HID, C_OUT, 2, 0.0,
                         dtype=jnp.float32)
    jbd = jstep.decode_batch(jb)
    jx, jextra = jstep._x_and_extra(jnp.asarray(x), jbd, gsrc)
    var = jax.tree_util.tree_map(np.array, jmodel.init(
        jax.random.key(seed), jx, jbd, training=False, **jextra))
    params, stats = _randomise_bn(dict(var["params"]),
                                  dict(var.get("batch_stats", {})),
                                  np.random.default_rng(seed + 1))
    model = make_model(name, x.shape[1], HID, C_OUT, 2, 0.0,
                       dtype=torch.float32)
    model.load_state_dict({**weights.params_from_jax(params),
                           **weights.batch_stats_from_jax(stats)})
    tbd = tstep.decode_batch(tb)
    tx, textra = tstep._x_and_extra(torch.from_numpy(x), tbd, gsrc)
    return (jmodel, params, stats, jx, jbd, jextra), (model, tx, tbd, textra)


def test_bn_weight_carry_round_trip():
    """flax → port → flax is bit-equal for params (Dense kernels and biases,
    BN scales and biases) and batch_stats, and names every buffer."""
    (jmodel, params, stats, *_), (model, *_) = _setup("GIN", True)
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
    assert "conv0.bn.var" in sd and "conv0.bn.scale" in sd


@pytest.mark.parametrize("name,gsrc", CASES)
def test_forward_eval_matches_jax(name, gsrc):
    (jmodel, params, stats, jx, jb, jextra), (model, tx, tb, textra) = \
        _setup(name, gsrc)
    ref = np.asarray(jmodel.apply({"params": params, "batch_stats": stats},
                                  jx, jb, training=False, **jextra))
    model.eval()
    with torch.no_grad():
        got = model(tx, tb, training=False, **textra).numpy()
    assert got.shape == ref.shape == (32, C_OUT)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name,gsrc", CASES)
def test_forward_train_and_running_stats_match_jax(name, gsrc, no_dropout):
    (jmodel, params, stats, jx, jb, jextra), (model, tx, tb, textra) = \
        _setup(name, gsrc)
    ref, upd = jmodel.apply({"params": params, "batch_stats": stats}, jx, jb,
                            training=True, rngs={"dropout": jax.random.key(1)},
                            mutable=["batch_stats"], **jextra)
    model.train()
    with torch.no_grad():
        got = model(tx, tb, training=True, **textra).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=TOL, atol=TOL)
    new = weights.batch_stats_to_jax(model.state_dict())
    la = jax.tree_util.tree_leaves_with_path(_np_tree(upd["batch_stats"]))
    lb = jax.tree_util.tree_leaves_with_path(new)
    assert [k for k, _ in la] == [k for k, _ in lb]
    assert bool(la) == (name != "SAGEClassic")   # the BN models
    for (k, a), (_, b) in zip(la, lb):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg=str(k))
    assert all(not np.allclose(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(stats), jax.tree_util.tree_leaves(new)))


def test_gin_train_step_matches_jax():
    """One GIN step (gsrc, dropout 0, float32) from the same weights: loss,
    every param after Adam and the running statistics agree at 2e-4.

    Except the bias of each conv's first Linear: BatchNorm follows it and
    removes any per-column shift, so its gradient is rounding noise, which
    Adam's first step scales to about ±lr whatever its size. There both
    packages must have moved it by at most lr."""
    g, jb, tb, x = make_pair(True, seed=4)
    lr = 0.01
    jmodel = jmake_model("GIN", x.shape[1], HID, C_OUT, 2, 0.0,
                         dtype=jnp.float32)
    jb0 = jstep.decode_batch(jb)
    ex_x, _ = jstep._x_and_extra(jnp.asarray(x), jb0, True)
    jstate = jcreate(jmodel, ex_x, jb0, lr, seed=0)
    model = make_model("GIN", x.shape[1], HID, C_OUT, 2, 0.0,
                       dtype=torch.float32)
    model.load_state_dict({
        **weights.params_from_jax(_np_tree(jstate.params)),
        **weights.batch_stats_from_jax(_np_tree(jstate.batch_stats))})
    tstate = TrainState(model, lr, seed=0, device=torch.device("cpu"))
    jstate, jloss = jstep.make_train_step(global_msg0=True)(
        jstate, jnp.asarray(x), jb)
    tloss = tstep.train_step(tstate, torch.from_numpy(x), tb, True)
    assert abs(float(jloss) - float(tloss)) < TOL
    sd = tstate.model.state_dict()
    before = weights.params_from_jax(_np_tree(jcreate(
        jmodel, ex_x, jb0, lr, seed=0).params))
    for i in range(2):
        key, path = f"conv{i}.fc0.bias", (f"conv{i}", "fc0", "bias")
        j_new = np.asarray(jstate.params[path[0]][path[1]][path[2]])
        for new in (sd[key].numpy(), j_new):
            assert np.abs(new - before[key].numpy()).max() <= lr * 1.0001
        sd = {**sd, key: torch.from_numpy(j_new.copy())}
    for want, got in ((_np_tree(jstate.params), weights.params_to_jax(sd)),
                      (_np_tree(jstate.batch_stats),
                       weights.batch_stats_to_jax(sd))):
        la = jax.tree_util.tree_leaves_with_path(want)
        lb = jax.tree_util.tree_leaves_with_path(got)
        assert [k for k, _ in la] == [k for k, _ in lb]
        for (k, a), (_, b) in zip(la, lb):
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL,
                                       err_msg=str(k))
