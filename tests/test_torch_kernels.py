"""The plain versions of the port's row gather (K3, ``ops/pallas_gather``)
and fused gather + segment sum (K2, ``ops/pallas_aggregate``) against the
JAX package's Pallas kernels in interpret mode, on the CPU.

The shapes are those of tests/test_pallas.py. K3 copies rows, so it must
be exact (f32 and bf16). K2 sums the same f32 rows in another order:
tolerance 1e-5, as the JAX suite holds its own kernel. The port's K2 masks
edges past ``count`` itself (JAX builds tile pointers for that), which is
checked with real-looking ``dst`` values written past ``count``.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salient_plusplus_tpu.ops import mxu_segment as M
from salient_plusplus_tpu.ops.pallas_aggregate import (
    _fused_bwd, fused_gather_segment_sum as j_fused, make_tile_starts)
from salient_plusplus_tpu.ops.pallas_gather import pallas_gather_rows as j_gather

from salient_plusplus_tpu_torch.ops import pallas_aggregate as A
from salient_plusplus_tpu_torch.ops import pallas_gather as G
from salient_plusplus_tpu_torch.ops import segment as TS
from salient_plusplus_tpu_torch.ops import sorted_segment as S
from salient_plusplus_tpu_torch.sampling.batch import EdgeBlock

torch.set_num_threads(1)


@pytest.mark.parametrize("N,F,n,block,dtype,seed", [
    (1000, 128, 512, 256, np.float32, 0),      # test_pallas.py:9-15
    (300, 256, 128, 128, jnp.bfloat16, 1),     # test_pallas.py:18-25
])
def test_plain_k3_matches_jax_kernel(N, F, n, block, dtype, seed):
    rng = np.random.default_rng(seed)
    table = jnp.asarray(rng.normal(size=(N, F)), dtype)
    idx = rng.integers(0, N, size=n).astype(np.int32)
    ref = np.asarray(j_gather(table, jnp.asarray(idx), block=block,
                              interpret=True), np.float32)
    tt = torch.from_numpy(np.array(table, np.float32))
    if dtype == jnp.bfloat16:
        tt = tt.to(torch.bfloat16)   # exact: the values are bf16 already
    n0 = G.pallas_gather_rows.launches
    got = G.pallas_gather_rows(tt, torch.from_numpy(idx))
    assert G.pallas_gather_rows.launches == n0   # plain: no launch
    assert got.dtype == tt.dtype and got.shape == (n, F)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    # the dispatch behind the feature assembly is the same function
    assert torch.equal(TS.gather_rows(tt, torch.from_numpy(idx)), got)


def _k2_case(N, F, T, E_real, chunk, dst_hi, seed):
    rng = np.random.default_rng(seed)
    E_pad = ((E_real + chunk - 1) // chunk + 1) * chunk
    emb = rng.normal(size=(N, F)).astype(np.float32)
    src = np.zeros(E_pad, np.int32)
    dst = np.full(E_pad, T, np.int32)
    src[:E_real] = rng.integers(0, N, E_real)
    dst[:E_real] = np.sort(rng.integers(0, dst_hi, E_real))
    return emb, src, dst


@pytest.mark.parametrize("N,F,T,E_real,chunk,t_tile,dst_hi,seed", [
    (500, 128, 128, 900, 128, 32, 128, 0),   # test_pallas.py:28-50
    (64, 128, 64, 40, 64, 16, 16, 1),        # test_pallas.py:53-74
])
def test_plain_k2_matches_jax_kernel(N, F, T, E_real, chunk, t_tile, dst_hi,
                                     seed):
    emb, src, dst = _k2_case(N, F, T, E_real, chunk, dst_hi, seed)
    ts = make_tile_starts(jnp.asarray(dst), jnp.int32(E_real), T,
                          t_tile=t_tile)
    ref = np.asarray(j_fused(jnp.asarray(emb), jnp.asarray(src),
                             jnp.asarray(dst), ts, T, t_tile=t_tile,
                             chunk=chunk, r=4, interpret=True))
    count = torch.tensor(E_real, dtype=torch.int32)
    got = A.fused_gather_segment_sum(torch.from_numpy(emb),
                                     torch.from_numpy(src),
                                     torch.from_numpy(dst), count, T)
    assert got.dtype == torch.float32 and got.shape == (T, F)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_plain_k2_drops_edges_past_count_and_pads():
    """Real-looking dst values past ``count``, pad src ids that are no row
    of the table, pad dst above num_segments: none of them counts."""
    emb, src, dst = _k2_case(500, 12, 128, 900, 128, 128, 2)
    rng = np.random.default_rng(9)
    count = 700
    dst[count:900] = np.sort(rng.integers(0, 128, 200))
    dst[900:] = 640
    src[900:] = 2**31 - 1
    expect = np.zeros((128, 12), np.float32)
    np.add.at(expect, dst[:count], emb[src[:count]])
    for c in (count, torch.tensor(count, dtype=torch.int32)):
        got = A.fused_gather_segment_sum(torch.from_numpy(emb),
                                         torch.from_numpy(src),
                                         torch.from_numpy(dst), c, 128)
        np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5,
                                   atol=1e-5)


def test_fused_op_grad_matches_jax_bwd():
    """test_pallas.py:77-107: the op's backward is JAX's ``_fused_bwd``."""
    rng = np.random.default_rng(3)
    N, F, T, E = 96, 8, 64, 200
    src = rng.integers(0, N, E).astype(np.int32)
    dst = np.sort(rng.integers(0, T, E)).astype(np.int32)
    g = rng.normal(size=(T, F)).astype(np.float32)
    proto = jnp.zeros((N, 0), jnp.float32)
    (ref, _, _, _) = _fused_bwd(T, 64, (proto, jnp.asarray(src),
                                        jnp.asarray(dst), jnp.int32(E)),
                                jnp.asarray(g))
    emb = torch.from_numpy(rng.normal(size=(N, F)).astype(np.float32)
                           ).requires_grad_(True)
    out = A.fused_segment_sum_op(emb, torch.from_numpy(src),
                                 torch.from_numpy(dst), E, T)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(emb.grad.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    # the dispatch gives the op for a 2-d table and declines otherwise
    again = A.maybe_fused_segment_sum(emb.detach(), torch.from_numpy(src),
                                      torch.from_numpy(dst), E, T)
    torch.testing.assert_close(again, out.detach())
    assert A.maybe_fused_segment_sum(emb.detach()[None], torch.from_numpy(
        src), torch.from_numpy(dst), E, T) is None


@pytest.mark.parametrize("mean", [True, False])
def test_spmm_agg_nomirror_over_a_table_matches_jax(mean):
    """The no-mirror hop with global src ids into a larger table (gsrc
    mode): port spmm_agg (K2's plain version) against JAX spmm_agg with
    the MXU kernel in interpret mode, forward and gradient, 2e-4."""
    rng = np.random.default_rng(11)
    N, F, T, E, count = 700, 12, 128, 1024, 811
    src = rng.integers(0, N, E).astype(np.int32)
    dst = np.concatenate([np.sort(rng.integers(0, T, count)),
                          np.full(E - count, T)]).astype(np.int32)
    src[count:] = 0
    x = rng.standard_normal((N, F)).astype(np.float32)
    w = rng.standard_normal((T, F)).astype(np.float32)
    M.use_mxu_spmm(True, interpret=True)
    try:
        je = EdgeBlock(src=jnp.asarray(src), dst=jnp.asarray(dst),
                       count=jnp.int32(count))
        j_out = M.spmm_agg(jnp.asarray(x), je, T, mean=mean)
        j_grad = jax.grad(lambda v: (M.spmm_agg(v, je, T, mean=mean)
                                     * w).sum())(jnp.asarray(x))
    finally:
        M.use_mxu_spmm(None, interpret=False)
    te = EdgeBlock(src=torch.from_numpy(src), dst=torch.from_numpy(dst),
                   count=torch.tensor(count, dtype=torch.int32))
    xt = torch.from_numpy(x).requires_grad_(True)
    t_out = S.spmm_agg(xt, te, T, mean=mean)
    (t_out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_grad),
                               atol=2e-4, rtol=2e-4)


def test_new_wrappers_refuse_other_devices():
    """Only a CPU tensor takes a plain version; anything but CUDA raises."""
    t = torch.zeros(4, 3, device="meta")
    i = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        G.pallas_gather_rows(t, i)
    with pytest.raises(ValueError):
        A.fused_gather_segment_sum(t, i, i, 4, 2)


def test_segment_kernels_hash_their_shared_header(monkeypatch):
    """K1, K2, GAT's weighted sum and its gradients, and GAT's edge softmax
    include csrc/segment_common.cuh: the header is on nvcc's include path
    and joins each library's hash, so an edited header rebuilds all five
    (nothing is compiled here)."""
    from salient_plusplus_tpu_torch.native import build

    seen = {}
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "_build", lambda stem, srcs, cmd_for: seen
                        .setdefault(stem, (srcs, cmd_for("OUT"))))
    for name in ("sorted_segment_sum", "fused_gather_segment_sum",
                 "weighted_segment_sum", "weighted_segment_grad",
                 "edge_softmax"):
        build.kernel_lib_path(name)
        srcs, cmd = seen[f"sptpu_{name}"]
        assert srcs[0].endswith(f"csrc/{name}.cu") and cmd[-1] == srcs[0]
        assert any(s.endswith("csrc/segment_common.cuh") for s in srcs)
        assert cmd[cmd.index("-I") + 1] == build._CSRC


def test_weighted_kernel_entry_point_matches_its_argtypes():
    """The C entry point of csrc/weighted_segment_sum.cu takes the
    wrapper's ctypes arguments and the stream, pointers as void* and sizes
    as int64_t (nothing is compiled here)."""
    import re

    from salient_plusplus_tpu_torch.native import build
    from salient_plusplus_tpu_torch.ops import weighted_segment as W

    with open(f"{build._CSRC}/weighted_segment_sum.cu") as f:
        params = re.search(r"int sptpu_weighted_segment_sum\(([^)]*)\)",
                           f.read()).group(1).split(",")
    kinds = {ctypes.c_void_p: "void*", ctypes.c_int: "int",
             ctypes.c_int64: "int64_t"}
    want = [kinds[t] for t in W._ARGTYPES] + ["void*"]
    got = [re.sub(r"\s+", " ", p).replace("const ", "").strip()
           .rsplit(" ", 1)[0].replace(" *", "*") for p in params]
    assert got == want
    assert "weighted_segment_sum" in build.KERNELS


def test_weighted_grad_entry_point_matches_its_argtypes():
    """The C entry point of csrc/weighted_segment_grad.cu takes the
    backward wrapper's ctypes arguments and the stream (nothing is
    compiled here)."""
    import re

    from salient_plusplus_tpu_torch.native import build
    from salient_plusplus_tpu_torch.ops import weighted_segment as W

    with open(f"{build._CSRC}/weighted_segment_grad.cu") as f:
        params = re.search(r"int sptpu_weighted_segment_grad\(([^)]*)\)",
                           f.read()).group(1).split(",")
    kinds = {ctypes.c_void_p: "void*", ctypes.c_int: "int",
             ctypes.c_int64: "int64_t"}
    want = [kinds[t] for t in W._GRAD_ARGTYPES] + ["void*"]
    got = [re.sub(r"\s+", " ", p).replace("const ", "").strip()
           .rsplit(" ", 1)[0].replace(" *", "*") for p in params]
    assert got == want
    assert "weighted_segment_grad" in build.KERNELS


@pytest.mark.parametrize("entry,argtypes", [
    ("edge_softmax", "_ARGTYPES"),
    ("edge_softmax_backward", "_GRAD_ARGTYPES")])
def test_edge_softmax_entry_points_match_their_argtypes(entry, argtypes):
    """The two C entry points of csrc/edge_softmax.cu (forward and
    backward, one library) take their wrapper's ctypes arguments and the
    stream, floats as float (nothing is compiled here)."""
    import re

    from salient_plusplus_tpu_torch.native import build
    from salient_plusplus_tpu_torch.ops import edge_softmax as ES

    with open(f"{build._CSRC}/edge_softmax.cu") as f:
        params = re.search(rf"int sptpu_{entry}\(([^)]*)\)",
                           f.read()).group(1).split(",")
    kinds = {ctypes.c_void_p: "void*", ctypes.c_int: "int",
             ctypes.c_int64: "int64_t", ctypes.c_float: "float"}
    want = [kinds[t] for t in getattr(ES, argtypes)] + ["void*"]
    got = [re.sub(r"\s+", " ", p).replace("const ", "").strip()
           .rsplit(" ", 1)[0].replace(" *", "*") for p in params]
    assert got == want
    assert "edge_softmax" in build.KERNELS


def test_split_scratch_matches_the_kernels_slice():
    """The wrappers size K1's and K2's scratch by the header's kSlice:
    two f32 rows of round_up(F, 4) per slice."""
    import re

    from salient_plusplus_tpu_torch.native import build

    with open(f"{build._CSRC}/segment_common.cuh") as f:
        k_slice = int(re.search(r"kSlice = (\d+);", f.read()).group(1))
    assert A._SLICE_EDGES == k_slice
    for E, F in ((0, 8), (1, 12), (k_slice, 128), (k_slice + 1, 13)):
        s = A._split_scratch(E, F, "cpu")
        assert s.dtype == torch.float32
        assert s.numel() == 2 * -(-E // k_slice) * (-(-F // 4) * 4)
