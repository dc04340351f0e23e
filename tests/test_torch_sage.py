"""The port's SAGE against the JAX package's on carried-over weights.

One batch is sampled through the full wire path (ddeg, wire-pack, gsrc)
by both packages' samplers from the same seeds; the flax params are
carried to the port with ``weights.params_from_jax``. In float32 the
forward must agree at the reference-parity tolerance (RTOL = ATOL = 2e-4,
tests/test_reference_parity.py). In bfloat16 the two frameworks round at
other places (flax Dense vs F.linear), so the port is held to twice the
JAX package's own bf16-vs-f32 deviation on the same batch.
"""

import dataclasses

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
from salient_plusplus_tpu.train import step as jstep

from salient_plusplus_tpu_torch import weights
from salient_plusplus_tpu_torch.models import make_model
from salient_plusplus_tpu_torch.sampling import cpp as tcpp
from salient_plusplus_tpu_torch.sampling import sampler as tsampler
from salient_plusplus_tpu_torch.sampling.batch import BatchSpec
from salient_plusplus_tpu_torch.train import step as tstep

torch.set_num_threads(1)

F_IN, HID, C_OUT = 12, 16, 5
RTOL, ATOL = 2e-4, 2e-4


@pytest.fixture(autouse=True)
def _interpret_mode():
    M.use_mxu_spmm(True, interpret=True)
    yield
    M.use_mxu_spmm(None, interpret=False)


def make_pair(gsrc: bool, L: int = 2, batch_size: int = 32, seed: int = 0):
    """(graph, jax batch, port batch, padded f32 features) for one seed
    set, through each package's own buffers and wire encoding."""
    g = jsyn.planted_partition(name="sage", num_nodes=400,
                               num_classes=C_OUT, avg_degree=6,
                               num_features=F_IN, seed=3)
    spec = BatchSpec.worst_case(batch_size, [4, 3, 2][:L])
    seeds = np.sort(np.random.default_rng(seed).choice(
        g.split_idx["train"], batch_size, replace=False))
    y = np.asarray(g.y, np.int32)
    out = []
    for cpp, smp, spec_cls in ((jcpp, jsampler, JBatchSpec),
                               (tcpp, tsampler, BatchSpec)):
        sp = spec_cls(**dataclasses.asdict(spec))
        cfg = smp.FastSamplerConfig(spec=sp, batch_size=batch_size,
                                    emit_gsrc=gsrc, compress_dst=True,
                                    pack_wire=True)
        bufs = cpp.BatchBuffers(sp)
        bufs.attach_from_config(cfg, g.num_nodes)
        cpp.NativeSampler(np.asarray(g.rowptr), np.asarray(g.col)
                          ).sample_into(bufs, seeds, rng_seed=seed + 1,
                                        y_global=y)
        bufs.finalize_from_config(cfg)
        out.append(bufs.to_padded_batch())
    x = pad_feature_dim(np.asarray(g.x, np.float32))
    return g, out[0], out[1], x


def jax_forward(params, x_table, jb, gsrc, dtype):
    model = jmake_model("SAGE", F_IN, HID, C_OUT, jb.num_layers, 0.5,
                        dtype=dtype)
    jb = jstep.decode_batch(jb)
    x, extra = jstep._x_and_extra(jnp.asarray(x_table), jb, gsrc)
    if params is None:
        return model.init(jax.random.key(0), x, jb, training=False,
                          **extra)["params"]
    return np.asarray(model.apply({"params": params}, x, jb,
                                  training=False, **extra))


def port_forward(state_dict, x_table, tb, gsrc, dtype):
    model = make_model("SAGE", x_table.shape[1], HID, C_OUT, tb.num_layers,
                       0.5, dtype=dtype)
    model.load_state_dict(state_dict)
    tb = tstep.decode_batch(tb)
    x, extra = tstep._x_and_extra(torch.from_numpy(x_table), tb, gsrc)
    with torch.no_grad():
        return model(x, tb, training=False, **extra).numpy()


def _params(gsrc=True):
    g, jb, tb, x = make_pair(gsrc)
    p = jax_forward(None, x, jb, gsrc, jnp.float32)
    return jax.tree_util.tree_map(np.asarray, p)


def test_weight_carry_round_trip():
    p = _params()
    sd = weights.params_from_jax(p)
    assert sd["conv0.lin_l.weight"].shape == (HID, 128)  # padded input
    model = make_model("SAGE", 128, HID, C_OUT, 2, dtype=torch.float32)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    back = weights.params_to_jax(model.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(p)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("gsrc", [False, True])
def test_sage_forward_f32_matches_jax(gsrc):
    g, jb, tb, x = make_pair(gsrc)
    p = jax.tree_util.tree_map(
        np.asarray, jax_forward(None, x, jb, gsrc, jnp.float32))
    ref = jax_forward(p, x, jb, gsrc, jnp.float32)
    got = port_forward(weights.params_from_jax(p), x, tb, gsrc,
                       torch.float32)
    assert got.shape == ref.shape == (32, C_OUT)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("gsrc", [False, True])
def test_sage_forward_bf16_close_to_jax(gsrc):
    g, jb, tb, x = make_pair(gsrc, L=3)
    p = jax.tree_util.tree_map(
        np.asarray, jax_forward(None, x, jb, gsrc, jnp.float32))
    ref32 = jax_forward(p, x, jb, gsrc, jnp.float32)
    ref16 = jax_forward(p, x, jb, gsrc, jnp.bfloat16)
    got = port_forward(weights.params_from_jax(p), x, tb, gsrc,
                       torch.bfloat16)
    assert np.isfinite(got).all()
    jax_dev = np.abs(ref16 - ref32).max()
    assert np.abs(got - ref16).max() <= 2 * jax_dev + 1e-3, \
        (np.abs(got - ref16).max(), jax_dev)


def test_sage_gsrc_equals_frontier_gather():
    """gsrc mode (layer 0 reads the table by global ids) and the frontier
    gather give the same forward in the port, as in the JAX package."""
    p = _params()
    outs = []
    for gsrc in (False, True):
        g, jb, tb, x = make_pair(gsrc)
        outs.append(port_forward(weights.params_from_jax(p), x, tb, gsrc,
                                 torch.float32))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-5)


def test_unported_models_raise():
    """The whole zoo is ported: the three models that raised before build,
    and a name outside the zoo raises."""
    for name in ("GAT", "GCN", "ARMA"):
        assert make_model(name, 8, 8, 2, 2).num_layers == 2
    with pytest.raises(ValueError, match="unknown model"):
        make_model("GraphTransformer", 8, 8, 2, 2)
