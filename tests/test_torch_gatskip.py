"""GATSkip, PyG's ogbn-products GAT (4 heads, skip connections), in the
port against the plain float32 reference ``tests/reference_gatskip.py``,
on the CPU; GATConv's head average and bias; the zoo's GAT unchanged; the
model through the trainer, layerwise inference and `driver.main`.

The batch is sampled by the port's sampler from a planted graph, at 4
heads of 6 (and 4 of 5 in the last layer): per-head widths that are not a
multiple of 8, so heads straddle the card kernel's 16-byte vectors.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from salient_plusplus_tpu_torch import driver
from salient_plusplus_tpu_torch.config import RunConfig
from salient_plusplus_tpu_torch.data import synthetic
from salient_plusplus_tpu_torch.models import MODEL_REGISTRY, make_model
from salient_plusplus_tpu_torch.models.inference import layerwise_inference
from salient_plusplus_tpu_torch.models.layers import GATConv
from salient_plusplus_tpu_torch.ops import launch_counts
from salient_plusplus_tpu_torch.sampling.batch import BatchSpec
from salient_plusplus_tpu_torch.sampling.cpp import NativeSampler
from salient_plusplus_tpu_torch.train.loop import Trainer
from salient_plusplus_tpu_torch.train.step import decode_batch, gather_features
from tests import reference_gatskip as ref

torch.set_num_threads(1)
F_IN, HID, C_OUT, L = 12, 6, 5, 3
SEEDS, FANOUTS = 48, [5, 4, 3]


@pytest.fixture(scope="module")
def graph():
    return synthetic.planted_partition(name="gatskip", num_nodes=800,
                                       num_classes=C_OUT, avg_degree=8,
                                       num_features=F_IN, seed=7)


def _batch(g, seed=3):
    spec = BatchSpec.worst_case(SEEDS, FANOUTS)
    b = NativeSampler(np.asarray(g.rowptr), np.asarray(g.col)).sample(
        spec, np.sort(g.split_idx["train"][:SEEDS]), rng_seed=seed,
        y_global=np.asarray(g.y, np.int32))
    return decode_batch(b)


def _reference_inputs(g, b):
    """The batch as the reference reads it: the frontier's real rows, each
    layer's real edges (int64) and real targets."""
    ls = [int(v) for v in b.level_sizes]
    x = torch.from_numpy(np.asarray(g.x, np.float32)).index_select(
        0, b.n_id[: ls[L]].long())
    hops, targets = [], []
    for i, e in enumerate(b.edges):
        n = int(e.count)
        hops.append((e.src[:n].long(), e.dst[:n].long()))
        targets.append(ls[L - 1 - i])
    return x, hops, targets, b.y[: ls[0]].long()


def _masks(model, b, seed):
    """The dropout masks the port draws from a generator seeded ``seed``:
    one a hidden layer, in layer order, at the bucket's cap x (heads x
    hidden), kept where the draw is >= p and scaled by 1 / (1 - p)."""
    gen = torch.Generator().manual_seed(seed)
    p = model.dropout
    out = []
    for i in range(L - 1):
        _, cap = b.layer_caps(i)
        u = torch.rand((cap, model.heads * HID), generator=gen)
        out.append((u >= p).float() / (1.0 - p))
    return out


def test_parameter_count_is_the_leaderboards():
    """751,574 at 100 features, 4 heads of 128, 47 classes, 3 layers: the
    OGB leaderboard's count for PyG's example, and the equations'."""
    m = make_model("GATSkip", 100, 128, 47, 3)
    assert sum(p.numel() for p in m.parameters()) == 751_574
    assert ref.num_params(100, 128, 47, 3) == 751_574
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert shapes["conv0.lin_src.weight"] == (512, 100)
    assert shapes["conv1.att_src"] == (1, 4, 128)
    assert shapes["conv1.bias"] == (512,)
    assert shapes["conv2.lin_src.weight"] == (188, 512)
    assert shapes["conv2.bias"] == (47,)
    assert shapes["skip2.weight"] == (47, 512)
    assert set(shapes) == {f"{m_}{i}.{k}" for i in range(3) for m_, k in (
        ("conv", "lin_src.weight"), ("conv", "att_src"), ("conv", "att_dst"),
        ("conv", "bias"), ("skip", "weight"), ("skip", "bias"))}


def test_zoo_gat_builds_the_same_state_dict():
    """The zoo's GAT keeps one head, no bias and its parameter names."""
    m = make_model("GAT", 100, 256, 47, 3)
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == {
        "conv0.lin_src.weight": (256, 100), "conv0.att_src": (1, 1, 256),
        "conv0.att_dst": (1, 1, 256), "conv1.lin_src.weight": (256, 256),
        "conv1.att_src": (1, 1, 256), "conv1.att_dst": (1, 1, 256),
        "conv2.lin_src.weight": (47, 256), "conv2.att_src": (1, 1, 47),
        "conv2.att_dst": (1, 1, 47)}
    assert all(getattr(m, f"conv{i}").bias is None for i in range(3))
    # the JAX package's zoo stays the registry the parity tests walk
    assert "GATSkip" not in MODEL_REGISTRY


@pytest.mark.parametrize("use_bias", [False, True])
def test_gatconv_head_average_and_bias(graph, use_bias):
    """``concat=False`` is the mean of the concatenated heads; the bias is
    added after the concatenation or the average (float32: the two differ
    in summation order only)."""
    b = _batch(graph)
    x = gather_features(torch.from_numpy(np.asarray(graph.x, np.float32)), b)
    _, cap = b.layer_caps(0)
    e = b.edges[0]
    cat = GATConv(F_IN, 7, heads=4, dtype=torch.float32,
                  generator=torch.Generator().manual_seed(1))
    avg = GATConv(F_IN, 7, heads=4, dtype=torch.float32, concat=False,
                  use_bias=use_bias)
    avg.load_state_dict({**cat.state_dict(), **(
        {"bias": torch.linspace(-1, 1, 7)} if use_bias else {})})
    with torch.no_grad():
        want = cat(x, x[:cap], e, cap).view(cap, 4, 7).mean(1)
        got = avg(x, x[:cap], e, cap)
    assert avg.out_features == 7 and got.shape == (cap, 7)
    if use_bias:
        want = want + avg.bias
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    if use_bias:
        cat_b = GATConv(F_IN, 7, heads=4, dtype=torch.float32,
                        use_bias=True)
        bias = torch.linspace(-1, 1, 28)
        cat_b.load_state_dict({**cat.state_dict(), "bias": bias})
        with torch.no_grad():
            torch.testing.assert_close(
                cat_b(x, x[:cap], e, cap),
                cat(x, x[:cap], e, cap) + bias, rtol=1e-5, atol=1e-6)


# float32: the port and the reference run the same float32 arithmetic and
# differ in summation order only, so they agree to a few ulps (read on four
# batches and weight draws: log-probabilities 3.8e-6, loss 4.8e-7,
# gradients 2.1e-6 relative). bfloat16: the port rounds every product's
# operands, the attention logits and each layer's output to 8 bits of
# mantissa (a relative step of 2^-8, 0.4%) through three layers, and its
# last logits reach ~18, where one bf16 step is 0.125: its log-probabilities
# read 0.07-0.11 from the float32 reference's, the loss 1e-3-6.5e-3, and
# each gradient 0.3-8.6% (relative Frobenius error; the attention vectors'
# small gradients the most). The limits leave about twice that room.
TOLERANCE = {torch.float32: dict(logp=2e-5, loss=5e-6, grad=2e-5),
             torch.bfloat16: dict(logp=0.2, loss=0.02, grad=0.15)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_forward_and_gradients_match_reference(graph, dtype):
    """One training forward with dropout 0.5 (masks drawn by the port's
    generator), its mean NLL and every parameter's gradient against the
    plain float32 reference on the same real rows and edges."""
    b = _batch(graph)
    model = make_model("GATSkip", F_IN, HID, C_OUT, L, dropout=0.5,
                       dtype=dtype, generator=torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():   # biases away from their zero init
        for i in range(L):
            for k in ("conv", "skip"):
                getattr(model, f"{k}{i}").bias.uniform_(-0.5, 0.5,
                                                        generator=gen)
    feats = torch.from_numpy(np.asarray(graph.x, np.float32))
    x = gather_features(feats, b)
    logp = model.train()(x, b, training=True,
                         generator=torch.Generator().manual_seed(9))
    ns = int(b.seed_count)
    y = b.y[:ns].long()
    loss = torch.nn.functional.nll_loss(logp[:ns], y)
    loss.backward()
    params = {k: p.detach() for k, p in model.named_parameters()}
    rx, hops, targets, ry = _reference_inputs(graph, b)
    assert torch.equal(ry, y)
    want_logp, want_loss, want_grads = ref.loss_and_grads(
        params, rx, hops, targets, ry, _masks(model, b, 9))
    tol = TOLERANCE[dtype]
    assert float((logp[:ns].detach() - want_logp).abs().max()) < tol["logp"]
    assert abs(float(loss.detach()) - float(want_loss)) < tol["loss"]
    for k, p in model.named_parameters():
        g, w = p.grad, want_grads[k]
        rel = float((g - w).norm() / w.norm().clamp_min(1e-12))
        assert rel < tol["grad"], (k, rel)


def test_layerwise_matches_full_expansion_forward(graph):
    """A 3-hop full expansion sees every edge, so the batch forward (eval
    mode) gives the layerwise rows of its seeds: the skip term and the
    head average in each layer as the forward has them."""
    g = graph
    model = make_model("GATSkip", F_IN, HID, C_OUT, L, dtype=torch.float32,
                       generator=torch.Generator().manual_seed(4)).eval()
    x = torch.from_numpy(np.asarray(g.x, np.float32))
    seeds = np.sort(np.asarray(g.split_idx["test"][:16]))
    E, V = len(g.col), g.num_nodes
    b = NativeSampler(np.asarray(g.rowptr), np.asarray(g.col)).sample(
        BatchSpec((-1,) * L, 16, (16,) + (V + 128,) * L, (E + 128,) * L),
        seeds, rng_seed=0)
    assert not b.overflow.any()
    with torch.no_grad():
        sampled = model(x.index_select(0, b.n_id), b)[:16]
    got = layerwise_inference("GATSkip", model, g.rowptr, g.col, x,
                              chunk=128)
    np.testing.assert_allclose(sampled.numpy(), got[seeds].numpy(),
                               rtol=2e-4, atol=2e-4)


def _cfg(**kw):
    base = dict(model_name="GATSkip", train_batch_size=64,
                train_fanouts=[4, 3, 2], batchwise_test_fanouts=[5, 5, 5],
                final_test_fanouts=[5, 5, 5], test_batch_size=64,
                num_layers=L, hidden_features=HID, num_workers=1,
                calibration_batches=2, lr=0.01, max_batches_in_flight=2)
    base.update(kw)
    return RunConfig(**base)


def test_train_step_spans_and_counters(graph):
    """A train step records ``gat.skip`` once a layer inside
    ``step.forward`` and ``gat.attention.backward`` once a layer (on
    autograd's thread); ``launch_counts`` names the multi-head launches
    and the edge softmax's (none on the CPU)."""
    tr = Trainer(_cfg(), graph, device="cpu")
    tr.train_sampler.set_epoch(tr.shuffler.get_idx(0), 0)
    batch = next(tr._feeder(iter(tr.train_sampler), 1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss = tr.run_step(batch)
    assert np.isfinite(float(loss))
    names = [e.name for e in prof.events()]
    assert names.count("gat.skip") == L
    assert names.count("gat.attention.backward") == L
    for e in prof.events():
        if e.name == "gat.skip":
            p = e.cpu_parent
            while p is not None and not p.name.startswith("step."):
                p = p.cpu_parent
            assert p is not None and p.name == "step.forward"
    counts = launch_counts()
    assert counts["weighted_segment_sum.multihead"] == 0
    assert counts["edge_softmax"] == counts["edge_softmax.backward"] == 0


@pytest.mark.parametrize("mode", ["batchwise", "layerwise"])
def test_driver_trains_and_scores_gatskip(tmp_path, mode):
    """``--model_name GATSkip`` through ``driver.main`` for one epoch, with
    its final test batchwise or layerwise (the published test is
    layerwise)."""
    out = driver.main([
        "synth:V=2000,C=5,deg=8,F=16", "gs", "--model_name", "GATSkip",
        "--epochs", "1", "--train_batch_size", "128", "--train_fanouts",
        "4,3,2", "--batchwise_test_fanouts", "5,5,5",
        "--final_test_fanouts", "5,5,5", "--num_layers", "3",
        "--hidden_features", "8", "--num_workers", "1",
        "--calibration_batches", "2", "--lr", "0.01", "--final_test_mode",
        mode, "--inference_chunk", "256", "--output_root", str(tmp_path)],
        device="cpu")
    assert out[0]["final_valid"] > 0.3   # chance is 0.2
    log = (tmp_path / "gs" / "host0_logs.txt").read_text()
    assert ("'layerwise_acc', 'valid'" in log) == (mode == "layerwise")
