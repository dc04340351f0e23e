"""The port's CUDA kernels (K1 sorted segment sum, K2 fused gather +
segment sum, K3 row gather) against their plain versions, on the card.

Run on a machine with an NVIDIA GPU:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(``--noconftest``: tests/conftest.py sets up JAX, which a GPU host need
not have; this file imports nothing of it.)

Whether a card exists is decided inside the ``cuda_device`` fixture, so
every test collects everywhere and skips without a card.

Tolerances: float32 sums differ from ``index_add_`` (atomics on the
card) only in summation order. That error grows with the terms a segment
sums, so each output may differ by 1e-4 plus 1e-6 times the sum of the
absolute values of its terms (a 2400-edge hub row of unit normals sums to
about 50 and may differ by ~1e-4). For bfloat16 vals both accumulate the
same bf16 inputs in float32, compared at rtol 1e-2. K2 sums the same rows
as K1 and is held to the same tolerances; K3 copies bytes and must be
exact.
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


def _case(E, F, T, n_real, pad, seed=0, hub=False):
    rng = np.random.default_rng(seed)
    if hub:
        ids = np.concatenate([np.zeros(int(n_real * 0.8), np.int32),
                              np.sort(rng.integers(1, T, n_real
                                                   - int(n_real * 0.8)))])
    else:
        ids = np.sort(rng.integers(0, T, n_real))
    ids = np.concatenate([ids, np.full(E - n_real, pad)]).astype(np.int32)
    vals = rng.standard_normal((E, F)).astype(np.float32)
    vals[n_real:] = 333.0  # garbage in pads must not leak
    return torch.from_numpy(vals), torch.from_numpy(ids)


CASES = [
    # (E, F, T, n_real, pad id, hub)
    (1024, 64, 128, 900, 128, False),
    (2048, 100, 384, 1737, 384, False),
    (512, 8, 128, 0, 128, False),           # no real edges
    (1024, 12, 256, 800, 640, False),       # pads above num_segments
    (4096, 16, 256, 3000, 256, True),       # hub + empty segments
    (20000, 300, 5000, 19000, 5000, False),  # F beyond one 256-column pass
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain(cuda_device, case, dtype):
    E, F, T, n_real, pad, hub = case
    vals, ids = _case(E, F, T, n_real, pad, hub=hub)
    vals = vals.to(cuda_device, dtype)
    ids = ids.to(cuda_device)
    n0 = S.sorted_segment_sum_mxu.launches
    got = S.sorted_segment_sum_mxu(vals, ids, T)
    torch.cuda.synchronize()
    assert S.sorted_segment_sum_mxu.launches == n0 + 1
    ref = S._sorted_segment_sum_plain(vals, ids, T)
    assert got.dtype == torch.float32 and got.shape == (T, F)
    if dtype == torch.float32:
        allowed = 1e-4 + 1e-6 * S._sorted_segment_sum_plain(vals.abs(), ids, T)
        err = (got - ref).abs()
        assert bool((err <= allowed).all()), float(err.max())
    else:
        torch.testing.assert_close(got, ref, atol=1e-2, rtol=1e-2)


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
    E, F, T, n_real, pad, hub = case
    rng = np.random.default_rng(7)
    _, dst = _case(E, F, T, n_real, pad, hub=hub)
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
    ref = A._fused_gather_segment_sum_plain(emb, src, dst, count, T)
    assert got.dtype == torch.float32 and got.shape == (T, F)
    if dtype == torch.float32:
        allowed = 1e-4 + 1e-6 * A._fused_gather_segment_sum_plain(
            emb.abs(), src, dst, count, T)
        err = (got - ref).abs()
        assert bool((err <= allowed).all()), float(err.max())
    else:
        torch.testing.assert_close(got, ref, atol=1e-2, rtol=1e-2)


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
