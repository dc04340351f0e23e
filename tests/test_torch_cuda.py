"""The port's CUDA kernels (K1 sorted segment sum, K2 fused gather +
segment sum, K3 row gather) against their plain versions, on the card.

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
tolerances; K3 copies bytes and must be exact.
"""

import numpy as np
import pytest
import torch

from salient_plusplus_tpu_torch.ops import pallas_aggregate as A
from salient_plusplus_tpu_torch.ops import pallas_gather as G
from salient_plusplus_tpu_torch.ops import sorted_segment as S

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
