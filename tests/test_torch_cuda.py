"""The port's CUDA kernels (K1 sorted segment sum, K2 fused gather +
segment sum, K3 row gather, GAT's weighted gather + segment sum and its
backward) against their plain versions, on the card.

Run on a machine with an NVIDIA GPU:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(``--noconftest``: tests/conftest.py sets up JAX, which a GPU host need
not have; this file imports nothing of it.)

Whether a card exists is decided inside the ``cuda_device`` fixture, so
every test collects everywhere and skips without a card.

Tolerances: a float32 kernel sum differs from the same sum taken in
float64 only by its summation order. That error grows with the terms a
segment sums, so each output may differ by 1e-4 plus 1e-6 times the sum
of the absolute values of its terms (a 2400-edge hub row of unit normals
sums to about 50 and may differ by ~1e-4). The float64 sum is the
reference for float32, not the plain version: its ``index_add_`` atomics
add a 300k-edge segment in one f32 chain, which drifts further than that
from the exact sum when the rows repeat. For bfloat16 vals kernel and
plain version both accumulate the same bf16 inputs in float32, compared
at rtol 1e-2. K2 sums the same rows as K1 and is held to the same
tolerances; K3 copies bytes and must be exact. GAT's weighted sum
multiplies each row, converted to float32 exactly, by a float32 weight:
kernel and plain version, in either row type, are held to the float64
sum of the same products by the float32 rule.
"""

import numpy as np
import pytest
import torch

from salient_plusplus_tpu_torch.ops import pallas_aggregate as A
from salient_plusplus_tpu_torch.ops import pallas_gather as G
from salient_plusplus_tpu_torch.ops import sorted_segment as S
from salient_plusplus_tpu_torch.ops import weighted_segment as W

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _real_ids(rng, T, n_real, kind):
    """Sorted ids of the real edges. kind: "uniform"; "hub" (80% on row
    0, the rest spread, empty rows between); "one" (every real edge on row
    0); ("blocks", L): segments of exactly L edges from edge 0, so with L a
    multiple or a divisor of the kernels' 64-edge slice every boundary
    falls on or between slice boundaries."""
    if kind == "hub":
        k = int(n_real * 0.8)
        return np.concatenate([np.zeros(k, np.int64),
                               np.sort(rng.integers(1, T, n_real - k))])
    if kind == "one":
        return np.zeros(n_real, np.int64)
    if isinstance(kind, tuple) and kind[0] == "blocks":
        return np.arange(n_real) // kind[1]
    return np.sort(rng.integers(0, T, n_real))


def _case(E, F, T, n_real, pad, seed=0, kind="uniform"):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([_real_ids(rng, T, n_real, kind),
                          np.full(E - n_real, pad)]).astype(np.int32)
    vals = rng.standard_normal((E, F)).astype(np.float32)
    vals[n_real:] = 333.0  # garbage in pads must not leak
    return torch.from_numpy(vals), torch.from_numpy(ids)



def _exact(vals, ids, num_segments):
    """The segment sum in float64, and the sum of |terms| a row."""
    keep = ids.long().clamp(max=num_segments)
    out = torch.zeros(num_segments + 1, 2, vals.shape[1], dtype=torch.float64,
                      device=vals.device)
    v = vals.double()
    out.index_add_(0, keep, torch.stack([v, v.abs()], 1))
    return out[:num_segments, 0], out[:num_segments, 1]


def _exact_fused(emb, src, dst, count, num_segments):
    """K2's function in float64 (edges past count and pads dropped)."""
    from salient_plusplus_tpu_torch.ops.segment import _safe_dst

    ids = _safe_dst(dst, count, num_segments)
    rows = torch.where(ids < num_segments, src.long(), 0)
    return _exact(emb.index_select(0, rows), ids, num_segments)


def _assert_matches(got, exact, plain, dtype):
    """The stated tolerances: f32 against the float64 sum ``exact`` (sum,
    sum of |terms|) by summation order, 1e-4 + 1e-6 Σ|terms| a row; bf16
    against the plain version at rtol 1e-2."""
    assert got.dtype == torch.float32 and got.shape == plain.shape
    if dtype == torch.float32:
        ref, ref_abs = exact
        err = (got.double() - ref).abs()
        assert bool((err <= 1e-4 + 1e-6 * ref_abs).all()), float(err.max())
    else:
        torch.testing.assert_close(got, plain, atol=1e-2, rtol=1e-2)

CASES = [
    # (E, F, T, n_real, pad id, kind)
    (1024, 64, 128, 900, 128, "uniform"),
    (2048, 100, 384, 1737, 384, "uniform"),
    (512, 8, 128, 0, 128, "uniform"),        # no real edges
    (1024, 12, 256, 800, 640, "uniform"),    # pads above num_segments
    (4096, 16, 256, 3000, 256, "hub"),       # hub + empty segments
    (20000, 300, 5000, 19000, 5000, "uniform"),  # F beyond one pass
    # one segment holds every real edge, over ~4700 slices
    (300_000, 256, 64, 299_000, 64, "one"),
    # segment boundaries exactly on slice boundaries (and between them)
    (64 * 80, 128, 80, 64 * 80, 80, ("blocks", 64)),
    (64 * 80, 256, 40, 64 * 80 - 7, 40, ("blocks", 128)),
    (64 * 80, 64, 160, 64 * 80, 160, ("blocks", 32)),
    (50, 128, 32, 45, 32, "uniform"),        # E smaller than one slice
    (50, 256, 8, 50, 8, "one"),              # ... one segment, no pads
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain(cuda_device, case, dtype):
    E, F, T, n_real, pad, kind = case
    vals, ids = _case(E, F, T, n_real, pad, kind=kind)
    vals = vals.to(cuda_device, dtype)
    ids = ids.to(cuda_device)
    n0 = S.sorted_segment_sum_mxu.launches
    got = S.sorted_segment_sum_mxu(vals, ids, T)
    torch.cuda.synchronize()
    assert S.sorted_segment_sum_mxu.launches == n0 + 1
    assert got.shape == (T, F)
    _assert_matches(got, _exact(vals, ids, T),
                    S._sorted_segment_sum_plain(vals, ids, T), dtype)


def test_kernel_rejects_bad_inputs(cuda_device):
    vals = torch.zeros(8, 4, device=cuda_device)
    ids = torch.zeros(8, dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        S.sorted_segment_sum_mxu(vals, ids, 2)
    with pytest.raises(ValueError):
        S.sorted_segment_sum_mxu(vals.t(), ids.int()[:4], 2)
    with pytest.raises(TypeError):
        S.sorted_segment_sum_mxu(vals.half(), ids.int(), 2)


@pytest.mark.parametrize("layer", [0, 1])  # 0: no mirror (K2), 1: K1
@pytest.mark.parametrize("mean", [True, False])
def test_spmm_agg_on_card_matches_cpu(cuda_device, mean, layer):
    from salient_plusplus_tpu_torch.data import synthetic
    from salient_plusplus_tpu_torch.sampling.batch import BatchSpec
    from salient_plusplus_tpu_torch.sampling.cpp import NativeSampler

    g = synthetic.planted_partition("cuda-t", num_nodes=600, num_classes=4,
                                    avg_degree=6, num_features=12, seed=3)
    b = NativeSampler(np.asarray(g.rowptr), np.asarray(g.col)).sample(
        BatchSpec.worst_case(64, [4, 3]), np.arange(0, 576, 9)[:64],
        rng_seed=5)
    e = b.edges[layer]
    in_cap, out_cap = b.layer_caps(layer)
    x = torch.randn(in_cap, 12, generator=torch.Generator().manual_seed(0))
    w = torch.randn(out_cap, 12, generator=torch.Generator().manual_seed(1))
    outs = []
    for dev in ("cpu", cuda_device):
        xd = x.to(dev).detach().requires_grad_(True)
        out = S.spmm_agg(xd, e.to(dev), out_cap, mean=mean)
        (out * w.to(dev)).sum().backward()
        outs.append((out.detach().cpu(), xd.grad.cpu()))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(outs[1][1], outs[0][1], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_fused_kernel_matches_plain(cuda_device, case, dtype):
    """K2 on K1's cases, with src ids into a larger table, real-looking
    dst values written past count, and pad src ids that are no row."""
    E, F, T, n_real, pad, kind = case
    rng = np.random.default_rng(7)
    _, dst = _case(E, F, T, n_real, pad, kind=kind)
    dst[n_real:] = torch.from_numpy(rng.integers(0, T, E - n_real))
    N = 3 * T + 5
    emb = torch.from_numpy(rng.standard_normal((N, F)).astype(np.float32))
    src = torch.from_numpy(rng.integers(0, N, E).astype(np.int32))
    src[n_real:] = 2**31 - 1
    emb, src, dst = (t.to(cuda_device) for t in (emb.to(dtype), src, dst))
    count = torch.tensor(n_real, dtype=torch.int32, device=cuda_device)
    n0 = A.fused_gather_segment_sum.launches
    got = A.fused_gather_segment_sum(emb, src, dst, count, T)
    torch.cuda.synchronize()
    assert A.fused_gather_segment_sum.launches == n0 + 1
    assert got.shape == (T, F)
    _assert_matches(got, _exact_fused(emb, src, dst, count, T),
                    A._fused_gather_segment_sum_plain(emb, src, dst, count, T),
                    dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("count", [333, 0, 5000, -3, 2**31 - 1])
def test_fused_kernel_count(cuda_device, count, dtype):
    """K2 with count inside a slice (333), 0, past E (5000 > 4096, and the
    largest int32), and below 0 (clamped to 0): real-looking dst values
    and src ids that are no row lie past min(count, E) only."""
    E, F, T = 4096, 128, 300
    rng = np.random.default_rng(11)
    c = max(0, min(count, E))
    dst = np.sort(rng.integers(0, T, E)).astype(np.int32)
    dst[c:] = rng.integers(0, T, E - c)   # not sorted past count
    N = 1000
    src = rng.integers(0, N, E).astype(np.int32)
    src[c:] = 2**31 - 1
    emb = torch.from_numpy(rng.standard_normal((N, F)).astype(
        np.float32)).to(cuda_device, dtype)
    src, dst = (torch.from_numpy(t).to(cuda_device) for t in (src, dst))
    cnt = torch.tensor(count, dtype=torch.int32, device=cuda_device)
    got = A.fused_gather_segment_sum(emb, src, dst, cnt, T)
    _assert_matches(got, _exact_fused(emb, src, dst, cnt, T),
                    A._fused_gather_segment_sum_plain(emb, src, dst, cnt, T),
                    dtype)
    if c == 0:
        assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_kernels_are_deterministic(cuda_device, kernel):
    """The hub case (one segment over ~4700 slices, F 256) twice, and a
    typical case: bit-identical outputs, the sums in a fixed order."""
    for E, F, T, n_real, pad, kind in (CASES[6], CASES[5]):
        vals, ids = _case(E, F, T, n_real, pad, kind=kind)
        vals, ids = vals.to(cuda_device, torch.bfloat16), ids.to(cuda_device)
        if kernel == "K1":
            run = lambda: S.sorted_segment_sum_mxu(vals, ids, T)  # noqa: E731
        else:
            src = torch.arange(E, dtype=torch.int32, device=cuda_device)
            cnt = torch.tensor(n_real, dtype=torch.int32, device=cuda_device)
            run = lambda: A.fused_gather_segment_sum(  # noqa: E731
                vals, src, ids, cnt, T)
        first = run()
        for _ in range(2):
            assert torch.equal(run(), first)


@pytest.mark.parametrize("F,offset", [(12, 12), (128, 4)])
def test_kernels_on_misaligned_views(cuda_device, F, offset):
    """Contiguous bf16 views whose base is not 16-byte aligned: F 12 at an
    odd row (24-byte rows: the one-element path), and F 128 four elements
    into a buffer (256-byte rows, misaligned base: also that path)."""
    E, T, n_real = 3000, 200, 2900
    vals, ids = _case(E, F, T, n_real, T, seed=5, kind="hub")
    buf = torch.empty(E * F + offset, dtype=torch.bfloat16,
                      device=cuda_device)
    view = buf[offset:].view(E, F)
    view.copy_(vals.to(cuda_device, torch.bfloat16))
    ids = ids.to(cuda_device)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    got = S.sorted_segment_sum_mxu(view, ids, T)
    torch.testing.assert_close(got, S._sorted_segment_sum_plain(view, ids, T),
                               atol=1e-2, rtol=1e-2)
    src = torch.arange(E, dtype=torch.int32, device=cuda_device)
    cnt = torch.tensor(n_real, dtype=torch.int32, device=cuda_device)
    got = A.fused_gather_segment_sum(view, src, ids, cnt, T)
    torch.testing.assert_close(
        got, A._fused_gather_segment_sum_plain(view, src, ids, cnt, T),
        atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.uint8])
@pytest.mark.parametrize("N,F,n", [(1000, 128, 512), (300, 256, 128),
                                   (50, 12, 400), (70, 100, 9), (10, 300, 0),
                                   (5, 8, 33)])
def test_gather_kernel_matches_plain(cuda_device, dtype, N, F, n):
    """K3 is a byte copy: exact for every dtype, both the 16-byte path and
    the byte loop (F * itemsize not a multiple of 16), repeated ids."""
    rng = np.random.default_rng(N + F + n)
    table = torch.from_numpy(rng.integers(-100, 100, (N, F))).to(dtype)
    idx = torch.from_numpy(rng.integers(0, N, n).astype(np.int32))
    table, idx = table.to(cuda_device), idx.to(cuda_device)
    n0 = G.pallas_gather_rows.launches
    got = G.pallas_gather_rows(table, idx)
    torch.cuda.synchronize()
    assert G.pallas_gather_rows.launches == n0 + (1 if n else 0)
    assert got.dtype == dtype and got.shape == (n, F)
    assert torch.equal(got, G._gather_rows_plain(table, idx))


def test_new_kernels_reject_bad_inputs(cuda_device):
    emb = torch.zeros(8, 4, device=cuda_device)
    i32 = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        A.fused_gather_segment_sum(emb, i32.long(), i32, 8, 2)
    with pytest.raises(TypeError):
        A.fused_gather_segment_sum(emb.half(), i32, i32, 8, 2)
    with pytest.raises(ValueError):
        A.fused_gather_segment_sum(emb, i32, i32[:4], 8, 2)
    with pytest.raises(TypeError):
        G.pallas_gather_rows(emb, i32.long())
    with pytest.raises(ValueError):
        G.pallas_gather_rows(emb.t(), i32)


@pytest.mark.parametrize("name", ["SAGE", "SAGEClassic", "GIN", "JKNet",
                                  "SAGEResInception"])
def test_layerwise_on_card_matches_cpu(cuda_device, name):
    """Layerwise inference (K3 per chunk, K2 per hop) on the card against
    the CPU's plain versions, float32 with TF32 off: summation order only,
    1e-4 on log-probabilities."""
    from salient_plusplus_tpu_torch.data import synthetic
    from salient_plusplus_tpu_torch.models import make_model
    from salient_plusplus_tpu_torch.models.inference import (
        layerwise_inference)

    torch.backends.cuda.matmul.allow_tf32 = False
    g = synthetic.powerlaw_graph("lw-t", num_nodes=3000, avg_degree=8,
                                 num_features=24, num_classes=6, seed=2)
    x = torch.from_numpy(np.asarray(g.x, np.float32))
    model = make_model(name, 24, 32, 6, 2, dtype=torch.float32,
                       generator=torch.Generator().manual_seed(0))
    ref = layerwise_inference(name, model, g.rowptr, g.col, x, chunk=512)
    k2, k3 = A.fused_gather_segment_sum.launches, G.pallas_gather_rows.launches
    got = layerwise_inference(name, model.to(cuda_device), g.rowptr, g.col,
                              x.to(cuda_device), chunk=512)
    torch.cuda.synchronize()
    assert A.fused_gather_segment_sum.launches - k2 == 6 * 2
    assert G.pallas_gather_rows.launches - k3 == 6 * 2
    torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_kernel_gradient_matches_index_select(cuda_device, dtype):
    """K3 on a table that requires grad is differentiable on the card, as
    ``index_select`` is on the CPU: its backward adds the incoming rows
    back (repeated ids too) with ``index_add_`` in f32, cast to the
    table's dtype. The kernel launches once for the forward. f32: card
    and CPU agree within 1e-4 (summation order). bf16: the incoming rows
    are bf16, summed in f32 and rounded once, so the card's gradient lies
    within one bf16 rounding (2^-8 relative) of their float64 sum; the
    CPU's sums in bf16 and is not that reference."""
    from salient_plusplus_tpu_torch.ops.segment import gather_rows

    rng = np.random.default_rng(3)
    N, F, n = 500, 96, 2000
    table = torch.from_numpy(rng.standard_normal((N, F)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, N, n).astype(np.int32))
    w = torch.from_numpy(rng.standard_normal((n, F)).astype(np.float32))
    grads = []
    for dev in ("cpu", cuda_device):
        t = table.to(dev, dtype).detach().clone().requires_grad_(True)
        n0 = G.pallas_gather_rows.launches
        out = gather_rows(t, idx.to(dev))
        assert out.grad_fn is not None
        if dev != "cpu":
            assert G.pallas_gather_rows.launches == n0 + 1
        (out.float() * w.to(dev)).sum().backward()
        grads.append(t.grad.float().cpu())
    if dtype == torch.float32:
        torch.testing.assert_close(grads[1], grads[0], rtol=1e-4, atol=1e-4)
    else:
        rows = w.to(dtype).double()
        exact = torch.zeros(N, F, dtype=torch.float64).index_add_(
            0, idx.long(), rows).float()
        torch.testing.assert_close(grads[1], exact, rtol=2**-8, atol=1e-6)
    assert grads[1].abs().sum() > 0


@pytest.mark.parametrize("model_name", ["GAT", "GCN", "ARMA"])
def test_model_step_on_card_matches_cpu(cuda_device, model_name):
    """One train step of GAT, GCN and ARMA from the same weights and batch,
    on the card (kernels) and on the CPU (plain versions): float32 with
    TF32 off, dropout 0, so the two differ in summation order only. Loss
    within 1e-5, each gradient within 1e-3 relative (Frobenius) error; the
    card's step launches its kernels (GAT: the weighted sum once per hop
    forward; GCN: K1 once per hop forward and backward; ARMA: K3 once per
    hop; K3 once for the features)."""
    from salient_plusplus_tpu_torch.data import synthetic
    from salient_plusplus_tpu_torch.models import make_model, mirror_all_specs
    from salient_plusplus_tpu_torch.sampling.batch import BatchSpec
    from salient_plusplus_tpu_torch.sampling.cpp import NativeSampler
    from salient_plusplus_tpu_torch.train.state import TrainState
    from salient_plusplus_tpu_torch.train.step import train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    g = synthetic.planted_partition("cuda-m", num_nodes=3000, num_classes=6,
                                    avg_degree=10, num_features=24, seed=4)
    spec = mirror_all_specs(model_name,
                            BatchSpec.worst_case(128, [6, 4, 3]))[0]
    b = NativeSampler(np.asarray(g.rowptr), np.asarray(g.col)).sample(
        spec, np.sort(g.split_idx["train"][:128]), rng_seed=2,
        y_global=np.asarray(g.y, np.int32))
    feats = torch.from_numpy(np.asarray(g.x, np.float32))
    model = make_model(model_name, 24, 64, 6, 3, dropout=0.0,
                       dtype=torch.float32,
                       generator=torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    out = {}
    for dev in ("cpu", cuda_device):
        m = make_model(model_name, 24, 64, 6, 3, dropout=0.0,
                       dtype=torch.float32)
        m.load_state_dict(sd)
        st = TrainState(m.to(dev), 0.003, seed=0, device=torch.device(dev))
        k1 = S.sorted_segment_sum_mxu.launches
        k3 = G.pallas_gather_rows.launches
        ws = W.weighted_segment_sum.launches
        loss = float(train_step(st, feats.to(dev), b.to(dev)))
        out[str(dev)] = (loss, {k: p.grad.detach().cpu() for k, p in
                                m.named_parameters()})
        if dev != "cpu":
            k1 = S.sorted_segment_sum_mxu.launches - k1
            k3 = G.pallas_gather_rows.launches - k3
            ws = W.weighted_segment_sum.launches - ws
            want_k1 = {"GAT": 0, "GCN": 6, "ARMA": 0}[model_name]
            want_ws = 3 if model_name == "GAT" else 0
            assert (k1, k3, ws) == (want_k1,
                                    4 if model_name == "ARMA" else 1,
                                    want_ws)
    (lc, gc), (lg, gg) = out["cpu"], out[str(cuda_device)]
    assert abs(lc - lg) < 1e-5, (lc, lg)
    for k in gc:
        rel = float((gg[k] - gc[k]).norm() / gc[k].norm().clamp_min(1e-12))
        assert rel < 1e-3, (k, rel)


# GAT's weighted gather + segment sum: (E, T, N, n_real, H, C, kind), kind
# as in _real_ids
WEIGHTED_CASES = [
    (4096, 512, 2000, 3900, 1, 256, "uniform"),  # the cell's 256-wide rows
    (4096, 512, 2000, 3900, 2, 256, "uniform"),
    (2048, 300, 1000, 1800, 1, 47, "uniform"),   # 94-byte bf16 rows: the
    (2048, 300, 1000, 1800, 2, 47, "hub"),       # one-element path
    (1024, 128, 500, 1000, 1, 8, "hub"),
    (1024, 128, 500, 1000, 2, 8, "uniform"),
    # one segment holds every real edge, over ~600 slices
    (40_000, 64, 5000, 39_000, 1, 256, "one"),
    (512, 128, 300, 0, 1, 256, "uniform"),       # count 0
    # GATSkip's hidden layers: 4 heads of 128, 1 KB bf16 rows (vectors)
    (4096, 512, 2000, 3900, 4, 128, "uniform"),
    # its last layer: 4 heads of 47, heads straddle the 16-byte vectors
    (2048, 300, 1000, 1800, 4, 47, "hub"),
]


def _weighted_case(E, T, N, n_real, H, C, kind, dtype, device, seed=0):
    """Sorted real dst, then real-looking dst values, src ids that are no
    row and NaN weights past count; dst pads above T in the hub case."""
    rng = np.random.default_rng(seed + E + H * C)
    dst = np.concatenate([_real_ids(rng, T, n_real, kind),
                          rng.integers(0, T + 9, E - n_real)])
    src = np.concatenate([rng.integers(0, N, n_real),
                          np.full(E - n_real, 2**31 - 1)])
    att = rng.random((E, H)).astype(np.float32)
    att[n_real:] = np.nan
    xs = rng.standard_normal((N, H, C)).astype(np.float32)
    return (torch.from_numpy(xs).to(device, dtype),
            torch.from_numpy(att).to(device),
            torch.from_numpy(src.astype(np.int32)).to(device),
            torch.from_numpy(dst.astype(np.int32)).to(device),
            torch.tensor(n_real, dtype=torch.int32, device=device))


def _exact_weighted(xs, att, src, dst, count, T):
    """The weighted sum in float64 (edges past count and pads dropped), and
    the sum of |terms| a row, both [T, H * C]."""
    from salient_plusplus_tpu_torch.ops.segment import _real_rows

    ids, rows = _real_rows(src, dst, count, T)
    v = xs.index_select(0, rows).double() * att.double().nan_to_num()[
        :, :, None]
    return _exact(v.reshape(v.shape[0], -1), ids.int(), T)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", WEIGHTED_CASES)
def test_weighted_kernel_matches_plain(cuda_device, case, dtype):
    """Kernel and plain version against the float64 sum of the same
    products, one launch a call; count 0 writes zeros."""
    E, T, N, n_real, H, C, kind = case
    xs, att, src, dst, cnt = _weighted_case(*case, dtype, cuda_device)
    n0 = W.weighted_segment_sum.launches
    got = W.weighted_segment_sum(xs, att, src, dst, cnt, T)
    torch.cuda.synchronize()
    assert W.weighted_segment_sum.launches == n0 + 1
    assert got.shape == (T, H, C) and got.dtype == torch.float32
    plain = W._weighted_segment_sum_plain(xs, att, src, dst, cnt, T)
    exact = _exact_weighted(xs, att, src, dst, cnt, T)
    for out in (got, plain):
        _assert_matches(out.view(T, H * C), exact, plain.view(T, H * C),
                        torch.float32)
    if n_real == 0:
        assert torch.equal(got, torch.zeros_like(got))


def test_weighted_kernel_is_deterministic(cuda_device):
    """The one-segment case and a typical one, bf16, three calls each:
    bit-identical outputs."""
    for case in (WEIGHTED_CASES[6], WEIGHTED_CASES[0]):
        args = _weighted_case(*case, torch.bfloat16, cuda_device)
        first = W.weighted_segment_sum(*args, case[1])
        for _ in range(2):
            assert torch.equal(W.weighted_segment_sum(*args, case[1]), first)


def test_weighted_kernel_rejects_bad_inputs(cuda_device):
    xs = torch.zeros(8, 1, 4, device=cuda_device)
    att = torch.zeros(8, 1, device=cuda_device)
    i32 = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        W.weighted_segment_sum(xs, att.bfloat16(), i32, i32, 8, 2)
    with pytest.raises(TypeError):
        W.weighted_segment_sum(xs, att, i32.long(), i32, 8, 2)
    with pytest.raises(ValueError):
        W.weighted_segment_sum(xs, att[:4], i32, i32, 8, 2)
    with pytest.raises(ValueError):
        W.weighted_segment_sum(xs.view(8, 4), att, i32, i32, 8, 2)


def test_gat_forward_on_card_one_weighted_launch_a_layer(cuda_device):
    """A 3-layer GAT's scoring forward on the card: the weighted sum once a
    layer, no K1 (so none under ``gat.attention``), logits within 1e-4 of
    the CPU's (float32, TF32 off: summation order only)."""
    from salient_plusplus_tpu_torch.data import synthetic
    from salient_plusplus_tpu_torch.models import make_model
    from salient_plusplus_tpu_torch.sampling.batch import BatchSpec
    from salient_plusplus_tpu_torch.sampling.cpp import NativeSampler
    from salient_plusplus_tpu_torch.train.step import (decode_batch,
                                                       gather_features)

    torch.backends.cuda.matmul.allow_tf32 = False
    g = synthetic.planted_partition("cuda-gat", num_nodes=3000,
                                    num_classes=6, avg_degree=10,
                                    num_features=24, seed=4)
    b = NativeSampler(np.asarray(g.rowptr), np.asarray(g.col)).sample(
        BatchSpec.worst_case(256, [8, 8, 8]),
        np.sort(g.split_idx["test"][:256]), rng_seed=3)
    feats = torch.from_numpy(np.asarray(g.x, np.float32))
    model = make_model("GAT", 24, 64, 6, 3, dropout=0.0,
                       dtype=torch.float32,
                       generator=torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", cuda_device):
        m = make_model("GAT", 24, 64, 6, 3, dropout=0.0,
                       dtype=torch.float32)
        m.load_state_dict(model.state_dict())
        m.to(dev).eval()
        bd = decode_batch(b.to(dev))
        x = gather_features(feats.to(dev), bd)
        k1 = S.sorted_segment_sum_mxu.launches
        ws = W.weighted_segment_sum.launches
        with torch.no_grad():
            out[str(dev)] = m(x, bd, training=False).cpu()
        if dev != "cpu":
            torch.cuda.synchronize()
            assert S.sorted_segment_sum_mxu.launches == k1
            assert W.weighted_segment_sum.launches == ws + 3
    torch.testing.assert_close(out[str(cuda_device)], out["cpu"], atol=1e-4,
                               rtol=1e-4)


# The weighted sum's backward: (E, T, N, n_real, H, C, kind, hub src
# edges), kind as in _real_ids; pads at and above T sit between n_real and
# count, junk past count
GRAD_CASES = [
    (4096, 512, 2000, 3900, 4, 128, "uniform", 0),  # GATSkip's hidden
    (2048, 300, 1000, 1800, 4, 47, "hub", 0),       # its last layer
    (4096, 512, 2000, 3900, 1, 256, "uniform", 0),  # the zoo's GAT
    (512, 128, 300, 0, 4, 128, "uniform", 0),       # count 0
    # one source holds 10k edges, over ~160 slices of the src order
    (16_384, 2000, 5000, 16_000, 4, 128, "uniform", 10_000),
    (16_384, 2000, 5000, 16_000, 1, 256, "hub", 10_000),
]


def _grad_case(E, T, N, n_real, H, C, kind, hub, dtype, device, seed=0):
    """``_weighted_case``'s inputs with up to 37 pads (dst T and above,
    sorted, src ids that are no row, NaN weights) between the real edges
    and count, ``hub`` real edges from source 7, and an output gradient
    [T, H, C] f32."""
    xs, att, src, dst, _ = _weighted_case(E, T, N, n_real, H, C, kind,
                                          dtype, device, seed)
    rng = np.random.default_rng(seed + 1)
    pads = min(E - n_real, 37)
    dst[n_real:n_real + pads] = torch.from_numpy(np.sort(
        rng.integers(T, T + 3, pads)).astype(np.int32)).to(device)
    if hub:
        src[torch.from_numpy(rng.choice(n_real, hub, replace=False)).to(
            device)] = 7
    d_out = torch.from_numpy(rng.standard_normal((T, H, C)).astype(
        np.float32)).to(device)
    cnt = torch.tensor(n_real + pads, dtype=torch.int32, device=device)
    return d_out, xs, att, src, dst, cnt


def _grad_refs(d_out, xs, att, src, dst, cnt, T):
    """The plain backward in f32 on the card, on the inputs as the kernels
    read them (the output gradient rounded to xs's type; pads weigh 0),
    and the same on absolute values: (d_xs, d_att) and their sums of
    |terms|."""
    a = att.nan_to_num()
    g = d_out.to(xs.dtype).float()
    ref = W._weighted_segment_sum_backward_plain(g, xs.float(), a, src, dst,
                                                 cnt, T)
    mag = W._weighted_segment_sum_backward_plain(g.abs(), xs.float().abs(),
                                                 a.abs(), src, dst, cnt, T)
    return ref, mag


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", GRAD_CASES)
def test_weighted_backward_matches_plain(cuda_device, case, dtype):
    """The kernel backward against the plain one in f32 on the same card
    tensors: the products are the same f32 numbers, so d_att and d_xs
    differ by summation order only (1e-4 + 1e-5 of the sum of |terms|),
    and bf16 d_xs also by its one final rounding (2^-8 relative). Dropped
    edges get d_att 0, rows no real edge reaches d_xs 0; one call a
    backward, no host sync, two calls bit-identical."""
    E, T, N, n_real, H, C, kind, hub = case
    args = _grad_case(*case, dtype, cuda_device)
    b0 = W.weighted_segment_sum.backward
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        d_xs, d_att = W.weighted_segment_sum_backward(*args, T)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert W.weighted_segment_sum.backward == b0 + 1
    assert d_xs.dtype == dtype and d_xs.shape == (N, H, C)
    assert d_att.dtype == torch.float32 and d_att.shape == (E, H)
    (ref_xs, ref_att), (mag_xs, mag_att) = _grad_refs(*args, T)
    err = (d_att - ref_att).abs()
    assert bool((err <= 1e-4 + 1e-5 * mag_att).all()), float(err.max())
    err = (d_xs.float() - ref_xs).abs()
    tol = 1e-4 + 1e-5 * mag_xs
    if dtype == torch.bfloat16:
        tol = tol + 2.0**-8 * ref_xs.abs()
    assert bool((err <= tol).all()), float(err.max())
    cnt = int(args[-1])
    real = (torch.arange(E, device=cuda_device) < cnt) & (args[4] < T)
    assert bool((d_att[~real] == 0).all())
    reached = torch.zeros(N, dtype=torch.bool, device=cuda_device)
    reached[args[3][real].long()] = True
    assert bool((d_xs[~reached] == 0).all())
    again = W.weighted_segment_sum_backward(*args, T)
    assert torch.equal(again[0], d_xs) and torch.equal(again[1], d_att)


def test_weighted_backward_one_gradient(cuda_device):
    """Either gradient alone is the same as from the call that takes both."""
    args = _grad_case(*GRAD_CASES[1], torch.bfloat16, cuda_device)
    both = W.weighted_segment_sum_backward(*args, 300)
    only_xs = W.weighted_segment_sum_backward(*args, 300, need_att=False)
    only_att = W.weighted_segment_sum_backward(*args, 300, need_xs=False)
    assert only_xs[1] is None and torch.equal(only_xs[0], both[0])
    assert only_att[0] is None and torch.equal(only_att[1], both[1])


def test_weighted_backward_rejects_bad_inputs(cuda_device):
    d_out = torch.zeros(2, 1, 4, device=cuda_device)
    xs = torch.zeros(8, 1, 4, device=cuda_device)
    att = torch.zeros(8, 1, device=cuda_device)
    i32 = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    bwd = W.weighted_segment_sum_backward
    with pytest.raises(TypeError):
        bwd(d_out, xs, att.bfloat16(), i32, i32, 8, 2)
    with pytest.raises(TypeError):
        bwd(d_out, xs, att, i32.long(), i32, 8, 2)
    with pytest.raises(TypeError):
        bwd(d_out, xs.half(), att, i32, i32, 8, 2)
    with pytest.raises(TypeError):
        bwd(d_out.int(), xs, att, i32, i32, 8, 2)
    with pytest.raises(ValueError):
        bwd(d_out, xs, att[:4], i32, i32, 8, 2)
    with pytest.raises(ValueError):
        bwd(d_out[:1], xs, att, i32, i32, 8, 2)
    with pytest.raises(ValueError):
        bwd(d_out.cpu(), xs, att, i32, i32, 8, 2)


def test_weighted_backward_writes_nothing_edge_wide(cuda_device):
    """At E = 2M and 4 heads of 128 (bf16), the backward's rise of
    ``max_memory_allocated`` stays under one [E, H * C] bf16 tensor."""
    E, T, N, H, C = 2_000_000, 100_000, 200_000, 4, 128
    g = torch.Generator(device=cuda_device).manual_seed(0)
    dst = torch.sort(torch.randint(0, T, (E,), generator=g,
                                   device=cuda_device, dtype=torch.int32))[0]
    src = torch.randint(0, N, (E,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    xs = torch.randn(N, H, C, generator=g, device=cuda_device).bfloat16()
    att = torch.rand(E, H, generator=g, device=cuda_device)
    d_out = torch.randn(T, H, C, generator=g, device=cuda_device)
    cnt = torch.tensor(E, dtype=torch.int32, device=cuda_device)
    W.weighted_segment_sum_backward(d_out, xs, att, src, dst, cnt, T)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = W.weighted_segment_sum_backward(d_out, xs, att, src, dst, cnt, T)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    assert out[0].shape == (N, H, C)
    assert rise < E * H * C * 2, rise


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_gatskip_step_on_card_matches_reference(cuda_device, dtype):
    """GATSkip's training forward and backward on the card (4 heads, the
    multi-head weighted sum once a layer forward) against the plain float32
    reference (``tests/reference_gatskip.py``) on the card, dropout 0: the
    log-probabilities, the loss and every parameter's gradient, at the CPU
    test's tolerances (``test_torch_gatskip.py``: float32 summation order;
    bfloat16 rounding)."""
    from salient_plusplus_tpu_torch.data import synthetic
    from salient_plusplus_tpu_torch.models import make_model
    from salient_plusplus_tpu_torch.sampling.batch import BatchSpec
    from salient_plusplus_tpu_torch.sampling.cpp import NativeSampler
    from salient_plusplus_tpu_torch.train.step import (decode_batch,
                                                       gather_features)
    from tests import reference_gatskip as ref
    from tests.test_torch_gatskip import TOLERANCE

    torch.backends.cuda.matmul.allow_tf32 = False
    g = synthetic.planted_partition("cuda-gatskip", num_nodes=3000,
                                    num_classes=6, avg_degree=10,
                                    num_features=24, seed=4)
    b = decode_batch(NativeSampler(np.asarray(g.rowptr),
                                   np.asarray(g.col)).sample(
        BatchSpec.worst_case(128, [6, 4, 3]),
        np.sort(g.split_idx["train"][:128]), rng_seed=2,
        y_global=np.asarray(g.y, np.int32)).to(cuda_device))
    model = make_model("GATSkip", 24, 10, 6, 3, dropout=0.0, dtype=dtype,
                       generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(1)
        for i in range(3):
            for k in ("conv", "skip"):
                getattr(model, f"{k}{i}").bias.uniform_(-0.5, 0.5,
                                                        generator=gen)
    model.to(cuda_device).train()
    feats = torch.from_numpy(np.asarray(g.x, np.float32)).to(cuda_device)
    ws, mh = W.weighted_segment_sum.launches, W.weighted_segment_sum.multihead
    wb = W.weighted_segment_sum.backward
    logp = model(gather_features(feats, b), b, training=True)
    ns = int(b.seed_count)
    loss = torch.nn.functional.nll_loss(logp[:ns], b.y[:ns].long())
    loss.backward()
    torch.cuda.synchronize()
    assert W.weighted_segment_sum.launches == ws + 3
    assert W.weighted_segment_sum.multihead == mh + 3
    assert W.weighted_segment_sum.backward == wb + 3
    ls = [int(v) for v in b.level_sizes]
    hops = [(e.src[:int(e.count)].long(), e.dst[:int(e.count)].long())
            for e in b.edges]
    want_logp, want_loss, want = ref.loss_and_grads(
        {k: p.detach() for k, p in model.named_parameters()},
        feats.index_select(0, b.n_id[:ls[3]].long()), hops,
        [ls[2], ls[1], ls[0]], b.y[:ns].long())
    tol = TOLERANCE[dtype]
    assert float((logp[:ns].detach() - want_logp).abs().max()) < tol["logp"]
    assert abs(float(loss.detach()) - float(want_loss)) < tol["loss"]
    for k, p in model.named_parameters():
        rel = float((p.grad - want[k]).norm() / want[k].norm().clamp_min(
            1e-12))
        assert rel < tol["grad"], (k, rel)


def _cold_trainer(device, **kw):
    from salient_plusplus_tpu_torch.config import RunConfig
    from salient_plusplus_tpu_torch.data import synthetic
    from salient_plusplus_tpu_torch.train.loop import Trainer

    g = synthetic.planted_partition("cuda-cold", num_nodes=6000,
                                    num_classes=6, avg_degree=10,
                                    num_features=24, seed=5)
    cfg = RunConfig(train_batch_size=256, train_fanouts=[6, 4, 3],
                    hidden_features=64, num_layers=3, num_workers=2,
                    calibration_batches=2, dropout=0.0,
                    compute_dtype="float32", seed=1, **kw)
    return Trainer(cfg, g, device=device)


def _first_batch(trainer):
    from salient_plusplus_tpu_torch.train.pipeline import DeviceFeeder

    trainer.train_sampler.set_epoch(trainer.shuffler.get_idx(0), 0)
    it = iter(trainer.train_sampler)
    batch = next(DeviceFeeder(it, trainer.device, depth=1))
    it.close()
    return batch


def test_cold_overlay_on_card_matches_plain(cuda_device):
    """The cold overlay of ``gather_features`` (K1 as a sorted placement
    of the batch's cold rows, one K3 for the hot prefix) on the card equals
    the CPU's plain version and the all-in-memory gather bit for bit."""
    from salient_plusplus_tpu_torch.train.step import (decode_batch,
                                                       gather_features)

    t = _cold_trainer(cuda_device, hbm_fraction=0.5, gsrc_mode="off")
    b = decode_batch(_first_batch(t))
    assert int(b.cold_count) > 0
    k1, k3 = S.sorted_segment_sum_mxu.launches, G.pallas_gather_rows.launches
    x = gather_features(t.features, b)
    torch.cuda.synchronize()
    assert (S.sorted_segment_sum_mxu.launches - k1,
            G.pallas_gather_rows.launches - k3) == (1, 1)
    x_cpu = gather_features(t.features.cpu(), b.to("cpu"))
    assert torch.equal(x.cpu().view(torch.int16), x_cpu.view(torch.int16))
    full = _cold_trainer("cpu", hbm_fraction=1.0).features
    assert torch.equal(x_cpu.view(torch.int16),
                       full[b.n_id.long().cpu()].view(torch.int16))


def test_fp8_decode_on_card_matches_cpu(cuda_device):
    from salient_plusplus_tpu_torch.parallel.exchange import (
        fp8_decode_rows, fp8_encode_rows_np)

    x = np.random.default_rng(2).standard_normal((4096, 128)).astype(
        np.float32) * 7
    payload, scale = fp8_encode_rows_np(x)
    p, s = torch.from_numpy(payload), torch.from_numpy(scale)
    for dt in (torch.bfloat16, torch.float32):
        got = fp8_decode_rows(p.to(cuda_device), s.to(cuda_device), dt)
        assert torch.equal(got.cpu(), fp8_decode_rows(p, s, dt))


@pytest.mark.parametrize("mode", ["gsrc", "overlay", "cache", "fp8"])
def test_cold_step_on_card_matches_cpu(cuda_device, mode):
    """One train step at hbm_fraction 0.5 from the same weights and batch
    on the card (pinned cold buffers) and on the CPU (float32, TF32 off,
    dropout 0): cold rows written into the slack region (gsrc), overlaid
    by K1 (gsrc off), placed in cache slots, or decoded from fp8 into the
    slack. Loss within 1e-5, each gradient within 1e-3 relative
    (Frobenius) error, as the other card-vs-CPU steps."""
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = {"gsrc": {}, "overlay": {"gsrc_mode": "off"},
          "cache": {"cold_cache_slots": 1024},
          "fp8": {"cold_fp8": True}}[mode]
    out = {}
    sd = None
    for dev in ("cpu", cuda_device):
        t = _cold_trainer(dev, hbm_fraction=0.5, **kw)
        if sd is None:
            sd = {k: v.clone() for k, v in t.state.model.state_dict().items()}
        t.state.model.load_state_dict(sd)
        loss = float(t.run_step(_first_batch(t)))
        out[str(dev)] = (loss, {k: p.grad.detach().cpu() for k, p in
                                t.state.model.named_parameters()})
    (lc, gc), (lg, gg) = out["cpu"], out[str(cuda_device)]
    assert abs(lc - lg) < 1e-5, (lc, lg)
    for k in gc:
        rel = float((gg[k] - gc[k]).norm() / gc[k].norm().clamp_min(1e-12))
        assert rel < 1e-3, (k, rel)


def test_vip_device_on_card_matches_cpu(cuda_device):
    """``vip_analytical_device`` on the card against the same function on
    the CPU and the float64 numpy recurrence (JAX's tolerance, rtol 5e-3,
    atol 5e-5: the card's index_add_ adds in another order)."""
    from salient_plusplus_tpu_torch.caching import vip
    from salient_plusplus_tpu_torch.data import synthetic

    g = synthetic.powerlaw_graph(name="vip", num_nodes=20000, avg_degree=10,
                                 num_features=8, num_classes=4, seed=1)
    pids = (np.arange(g.num_nodes) * 2 // g.num_nodes).astype(np.int32)
    tipp = vip.partitionwise_train_idx(pids, g.split_idx["train"])
    args = (g.rowptr, g.col, tipp, 512, [15, 10, 5])
    card = vip.vip_analytical_device(*args, edge_chunk=1 << 14,
                                     device=cuda_device)
    cpu = vip.vip_analytical_device(*args, edge_chunk=1 << 14, device="cpu")
    ref = vip.vip_analytical(*args)
    for a, b, c in zip(card, cpu, ref):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-5)
        np.testing.assert_allclose(a, c, rtol=5e-3, atol=5e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_assemble_features_world1_nccl(cuda_device, dtype):
    """``assemble_features`` in a world-1 NCCL group equals ``table[n_id]``
    bit for bit (every id is local), with zero rows past the count and the
    hot prefix; K3 launches twice, three times with a cache; the fp8 wire
    codec on the card equals it on the CPU."""
    import socket

    import torch.distributed as dist

    from salient_plusplus_tpu_torch.parallel import exchange as X

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        rng = np.random.default_rng(5)
        V, n, N_cap = 50000, 20000, 24000
        table = torch.from_numpy(rng.standard_normal((V, 128)).astype(
            np.float32)).to(dtype).to(cuda_device)
        n_id = torch.from_numpy(rng.integers(0, V, N_cap).astype(
            np.int32)).to(cuda_device)
        count = torch.tensor(n, device=cuda_device)
        offs = torch.tensor([0, V], device=cuda_device)
        want = table[n_id.long()]
        want[n:] = 0
        cache = X.DeviceCache(torch.arange(0, V, 7, device=cuda_device),
                              table[::7].contiguous())
        for kw, k3 in (({}, 2), ({"cache": cache}, 3), ({"wire_fp8": True}, 2)):
            before = G.pallas_gather_rows.launches
            x, st = X.assemble_features(table, n_id, count, offs, 256, **kw)
            torch.cuda.synchronize()
            assert G.pallas_gather_rows.launches - before == k3
            assert torch.equal(x, want)
            assert (int(st.num_local), int(st.num_remote),
                    int(st.num_cached), int(st.num_overflow),
                    float(st.sent_bytes)) == (n, 0, 0, 0, 0.0)
        x, st = X.assemble_features(table[:V // 2].contiguous(), n_id, count,
                                    offs, 256, hot_size=V // 2)
        hot = want.clone()
        hot[n_id.long() >= V // 2] = 0
        assert torch.equal(x, hot)
        assert int(st.num_local) == int((n_id[:n] < V // 2).sum())
        rows = table[n_id.long()[:4096]].view(1, 4096, 128)
        on_card = X.fp8_wire_decode(X.fp8_wire_encode(rows), dtype)
        on_cpu = X.fp8_wire_decode(X.fp8_wire_encode(rows.cpu()), dtype)
        assert torch.equal(on_card.cpu(), on_cpu)
        assert torch.equal(X._fp8_wire_exchange(rows), on_card)
    finally:
        dist.destroy_process_group()


def _world1_group(backend="nccl"):
    """A world-1 process group on a free local port (120 s timeout)."""
    import datetime
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))


def _dist_graph_cfg(**kw):
    from salient_plusplus_tpu_torch.config import RunConfig
    from salient_plusplus_tpu_torch.data import synthetic

    g = synthetic.planted_partition(name="dp", num_nodes=4096, num_classes=4,
                                    avg_degree=8, num_features=16, seed=21)
    base = dict(train_batch_size=128, train_fanouts=[4, 3, 2],
                batchwise_test_fanouts=[5, 5, 5], final_test_fanouts=[5, 5, 5],
                hidden_features=32, num_layers=3, lr=0.01, num_workers=2,
                calibration_batches=2, seed=3, dropout=0.0)
    base.update(kw)
    return g, RunConfig(**base)


def test_dist_trainer_world1_nccl_epoch(cuda_device):
    """The data-parallel trainer in a world-1 NCCL group on the card and
    in a gloo subgroup on the CPU, from the same seed: one epoch each,
    epoch losses within rtol 2e-2 (bf16, as the CPU parity tests), no
    exchange overflow, batchwise and sharded layerwise valid accuracy
    above twice chance and within 0.02 of each other."""
    import torch.distributed as dist

    from salient_plusplus_tpu_torch.train.dist_loop import DistributedTrainer

    g, cfg = _dist_graph_cfg()
    _world1_group()
    try:
        gloo = dist.new_group([0], backend="gloo")
        res = []
        for d, group in ((torch.device("cpu"), gloo), (cuda_device, None)):
            tr = DistributedTrainer(cfg, g, np.zeros(g.num_nodes, np.int32),
                                    group=group, device=d)
            m = tr.train_epoch(0)
            res.append((m, tr.evaluate("valid"),
                        tr.evaluate_layerwise(("valid",))["valid"]))
        (mc, ac, lc), (mg, ag, lg) = res
        assert mg["overflow"] == mc["overflow"] == 0
        assert mg["iters"] == mc["iters"] and mg["local"] == mc["local"]
        np.testing.assert_allclose(mg["loss"], mc["loss"], rtol=2e-2)
        assert min(ac, ag, lc, lg) > 0.5
        assert abs(ag - ac) <= 0.02 and abs(lg - lc) <= 0.02
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("tier", ["all_on_card", "owner_cold_fp8"])
def test_dist_step_launches(cuda_device, tier):
    """A 3-layer SAGE step of the data-parallel trainer launches K1 4
    times (the mirrored hops, forward and backward), K2 once (layer 0
    from the assembled frontier) and K3 twice (the exchange's served and
    local rows); the owner-served cold tier adds no kernel (its overlay
    is an index_copy_)."""
    import collections

    import torch.distributed as dist

    from salient_plusplus_tpu_torch.train.dist_loop import DistributedTrainer

    kw = ({} if tier == "all_on_card" else
          dict(hbm_fraction=0.5, cold_mode="owner", cold_fp8=True))
    g, cfg = _dist_graph_cfg(**kw)
    _world1_group()
    try:
        tr = DistributedTrainer(cfg, g, np.zeros(g.num_nodes, np.int32),
                                device=cuda_device)
        feed, feeder = tr.epoch_feed(0)
        wrappers = (S.sorted_segment_sum_mxu, A.fused_gather_segment_sum,
                    G.pallas_gather_rows)
        before = [w.launches for w in wrappers]
        issued = collections.deque()
        for _ in range(3):
            batch = next(feeder)
            if tier != "all_on_card":
                batch = tr._with_cold_rows(batch, feed, issued, tr.cold_r_cap)
                assert batch.cold_rows is not None
            loss, ex = tr.run_step(batch)
            assert torch.isfinite(loss)
        torch.cuda.synchronize()
        got = [(w.launches - b) / 3 for w, b in zip(wrappers, before)]
        assert got == [4, 1, 2], got
        feed.it.close()
    finally:
        dist.destroy_process_group()


def test_readiness_drill_on_card(cuda_device, tmp_path):
    """The readiness drill at 20k nodes with products widths (100
    features, 47 classes, fanouts 15,10,5, batch 1024), stage 4 in a
    child on the card: every stage reports its peak RSS, the losses are
    finite and the child launched K1, K2 and K3."""
    from salient_plusplus_tpu_torch.utils.readiness_drill import run_drill

    rep = run_drill(nodes=20_000, parts=2, epochs=1, root=str(tmp_path),
                    final_test_mode="layerwise")
    assert all(st["peak_rss_gb"] > 0 for st in rep["stages"].values())
    assert np.isfinite(rep["results"][0]["losses"]).all()
    assert min(rep["launches"].values()) > 0, rep["launches"]
    assert rep["max_memory_allocated"] > 0 and rep["layerwise_s"] > 0
