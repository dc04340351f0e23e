"""GAT in the port against the JAX package, on the CPU: the four softmax
ops of ``ops/segment.py``, the edge softmax's entry (``ops/
edge_softmax.py``: its plain chain), ``GATConv`` forward and gradients, the
attention block ``ops/gat_agg.py`` against JAX's block and its
hand-derived backward, ``GATConv`` with and without the hop's mirror, and
the block's fused weighted sum (``ops/weighted_segment.py``) against a
loop, JAX's block and the gather → multiply → segment sum it replaces.

Inputs are made with numpy from a seed and handed to both packages. The
JAX package's Pallas kernels run in interpret mode, as its own tests run
them. Tolerances (float32): the softmaxes sum in another order than the
JAX package's scans, 1e-5 (the JAX suite's own bound between its two
softmax layouts); conv outputs and attention-block results 2e-4 (the
reference-parity tolerance); gradients 1e-3, since they chain several
reductions summed in other orders (the JAX suite holds its own custom VJP
to its autodiff at 3e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salient_plusplus_tpu.models.layers import GATConv as JGATConv
from salient_plusplus_tpu.ops import gat_agg as jgat
from salient_plusplus_tpu.ops import mxu_segment as M
from salient_plusplus_tpu.ops import segment as jseg
from salient_plusplus_tpu.sampling.batch import EdgeBlock as JEdgeBlock

from salient_plusplus_tpu_torch import weights
from salient_plusplus_tpu_torch.models.layers import GATConv
from salient_plusplus_tpu_torch.ops import edge_softmax as tes
from salient_plusplus_tpu_torch.ops import gat_agg as tgat
from salient_plusplus_tpu_torch.ops import segment as tseg
from salient_plusplus_tpu_torch.ops import weighted_segment as tws
from salient_plusplus_tpu_torch.ops.sorted_segment import sorted_segment_sum
from salient_plusplus_tpu_torch.sampling.batch import EdgeBlock
from tests.test_gat_agg import _hop

torch.set_num_threads(1)
SOFTMAX_TOL, TOL, GRAD_TOL = 1e-5, 2e-4, 1e-3


@pytest.fixture(autouse=True)
def _interpret_mode():
    M.use_mxu_spmm(True, interpret=True)
    yield
    M.use_mxu_spmm(None, interpret=False)


# (E, T, n_real, H, pad above T): empty targets, pads at T and above it,
# no real edges at all
SOFTMAX_CASES = [(512, 96, 430, 4, 0), (256, 64, 200, 1, 37),
                 (128, 32, 0, 2, 0), (300, 200, 150, 3, 5)]


def _softmax_case(E, T, n_real, H, above, seed=0):
    rng = np.random.default_rng(seed + E + n_real)
    dst = np.sort(rng.integers(0, T, n_real)).astype(np.int32)
    dst = np.concatenate([dst, np.full(E - n_real, T + above, np.int32)])
    logits = (rng.standard_normal((E, H)) * 3).astype(np.float32)
    self_logit = (rng.standard_normal((T, H)) * 3).astype(np.float32)
    return dst, logits, self_logit


def _both(fn_j, fn_t, *arrays):
    """fn_j on jnp arrays, fn_t on torch tensors, both as numpy."""
    j = jax.jit(fn_j)(*map(jnp.asarray, arrays))
    t = fn_t(*map(torch.from_numpy, arrays))
    to_np = lambda o: (tuple(np.asarray(v) for v in o)  # noqa: E731
                       if isinstance(o, tuple) else (np.asarray(o),))
    return to_np(j), to_np(t)


@pytest.mark.parametrize("case", SOFTMAX_CASES)
@pytest.mark.parametrize("op", ["masked_segment_max", "sorted_segment_softmax",
                                "masked_segment_softmax",
                                "segment_softmax_self"])
def test_softmax_ops_match_jax(case, op):
    E, T, n_real, H, above = case
    dst, logits, self_logit = _softmax_case(*case)
    cnt = np.array(n_real, np.int32)
    if op == "segment_softmax_self":
        def call(mod, lg, d, c, sl):
            return mod.segment_softmax_self(lg, d, c, T, sl,
                                            return_stats=True)
        args = (logits, dst, cnt, self_logit)
    else:
        def call(mod, lg, d, c):
            return getattr(mod, op)(lg, d, c, T)
        args = (logits, dst, cnt)
    js, ts = _both(lambda *a: call(jseg, *a), lambda *a: call(tseg, *a),
                   *args)
    assert len(js) == len(ts)
    for j, t in zip(js, ts):
        assert t.shape == j.shape and t.dtype == j.dtype
        np.testing.assert_allclose(t, j, rtol=SOFTMAX_TOL, atol=SOFTMAX_TOL)
    if op != "masked_segment_max":
        assert np.all(ts[0][n_real:] == 0)   # pad edges: attention 0
    if op == "segment_softmax_self":
        empty = np.bincount(dst[:n_real], minlength=T + 1)[:T] == 0
        np.testing.assert_allclose(ts[1][empty], 1.0)


def test_one_dim_softmax_matches_jax():
    dst, logits, _ = _softmax_case(*SOFTMAX_CASES[0])
    lg = logits[:, 0].copy()
    js, ts = _both(lambda a, d: jseg.sorted_segment_softmax(a, d, 430, 96),
                   lambda a, d: tseg.sorted_segment_softmax(a, d, 430, 96),
                   lg, dst)
    np.testing.assert_allclose(ts[0], js[0], rtol=SOFTMAX_TOL,
                               atol=SOFTMAX_TOL)


def test_segment_softmax_self_gradients_match_jax():
    E, T, n_real, H, above = SOFTMAX_CASES[1]
    dst, logits, self_logit = _softmax_case(*SOFTMAX_CASES[1])
    rng = np.random.default_rng(9)
    wa = rng.standard_normal((E, H)).astype(np.float32)
    ws = rng.standard_normal((T, H)).astype(np.float32)

    def jloss(lg, sl):
        a, s = jseg.segment_softmax_self(lg, jnp.asarray(dst), n_real, T, sl)
        return (a * wa).sum() + (s * ws).sum()

    gj = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(logits),
                                         jnp.asarray(self_logit))
    lg = torch.from_numpy(logits).requires_grad_(True)
    sl = torch.from_numpy(self_logit).requires_grad_(True)
    a, s = tseg.segment_softmax_self(lg, torch.from_numpy(dst), n_real, T, sl)
    ((a * torch.from_numpy(wa)).sum() + (s * torch.from_numpy(ws)).sum()
     ).backward()
    for j, t in zip(gj, (lg.grad, sl.grad)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


# ------------------------------------------------------------ edge_softmax
@pytest.mark.parametrize("case", SOFTMAX_CASES)
def test_edge_softmax_entry_matches_jax(case):
    """The edge softmax's entry on the CPU (the plain chain it keeps there)
    against JAX's leaky ReLU of the gathered logit terms and its
    ``segment_softmax_self``: att, self_att and the gradients of a_src and
    a_dst, with pads at T and above it, empty targets and a hop with no
    real edges."""
    E, T, n_real, H, above = case
    dst, _, _ = _softmax_case(*case)
    rng = np.random.default_rng(E + H)
    N = T + 40
    src = rng.integers(0, N, E).astype(np.int32)
    a_s, wa = (rng.standard_normal((n, H)).astype(np.float32)
               for n in (N, E))
    a_d, ws = (rng.standard_normal((T, H)).astype(np.float32)
               for _ in range(2))

    def jf(a_s, a_d):
        lg = jax.nn.leaky_relu(a_s[src] + a_d[np.minimum(dst, T - 1)], 0.2)
        sl = jax.nn.leaky_relu(a_s[:T] + a_d, 0.2)
        return jseg.segment_softmax_self(lg, jnp.asarray(dst), n_real, T, sl)

    def jloss(a_s, a_d):
        a, s = jf(a_s, a_d)
        return (a * wa).sum() + (s * ws).sum()

    jout = jax.jit(jf)(a_s, a_d)
    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1)))(a_s, a_d)
    ts, td = (torch.from_numpy(a).requires_grad_(True) for a in (a_s, a_d))
    out = tes.edge_softmax(ts, td, torch.from_numpy(src),
                           torch.from_numpy(dst), n_real, T, 0.2)
    for t, j in zip(out, jout):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=SOFTMAX_TOL, atol=SOFTMAX_TOL)
    assert np.all(out[0].detach().numpy()[n_real:] == 0)
    ((out[0] * torch.from_numpy(wa)).sum()
     + (out[1] * torch.from_numpy(ws)).sum()).backward()
    for name, t, j in (("a_src", ts.grad, jgrads[0]),
                       ("a_dst", td.grad, jgrads[1])):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


def test_edge_softmax_kernels_refuse_cpu_tensors():
    """The kernel wrappers launch or raise: CPU tensors are refused before
    any build or launch, and the CPU entry counts no launch."""
    a = torch.zeros(8, 2)
    i32 = torch.zeros(8, dtype=torch.int32)
    cnt = torch.tensor(8, dtype=torch.int32)
    before = (tes.edge_softmax.launches, tes.edge_softmax.backward)
    with pytest.raises(ValueError):
        tes.edge_softmax_forward(a, a[:2], i32, i32, cnt, 2, 0.2)
    with pytest.raises(ValueError):
        tes.edge_softmax_backward(a, a[:2], a, a[:2], i32, i32, cnt, a,
                                  a[:2], 2, 0.2)
    tes.edge_softmax(a, a[:2], i32, i32, cnt, 2, 0.2)
    assert (tes.edge_softmax.launches, tes.edge_softmax.backward) == before


# ---------------------------------------------------------------- GATConv
def _conv_hop(E=512, T=96, N=300, n_real=450, seed=3):
    rng = np.random.default_rng(seed)
    src, dst, msrc, mdst = _hop(rng, E, T, N, n_real)
    x = rng.standard_normal((N, 24)).astype(np.float32)
    g = rng.standard_normal((T, 16)).astype(np.float32)
    return src, dst, msrc, mdst, x, g, n_real


def _jax_conv(heads, C):
    return JGATConv(C, heads=heads, use_bias=False, dtype=jnp.float32)


def _jax_init(jconv, jeb, xj, T, seed):
    """flax params as numpy (jitted: the eager scans take ~20 s)."""
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k, xx: jconv.init(k, xx, xx[:T], jeb, T))(
            jax.random.key(seed), xj)["params"])


@pytest.mark.parametrize("heads,C", [(1, 16), (2, 8)])
def test_gatconv_forward_and_gradients_match_jax(heads, C):
    """Against the JAX conv through its plain reference (XLA segment sums,
    the kernel off): the interpreted Pallas kernel under autodiff takes
    half a minute a case here, and the attention block below holds the
    port to it."""
    M.use_mxu_spmm(False)
    src, dst, msrc, mdst, x, g, n = _conv_hop()
    T = g.shape[0]
    jconv = _jax_conv(heads, C)
    jeb = JEdgeBlock(src=jnp.asarray(src), dst=jnp.asarray(dst),
                     count=jnp.int32(n))
    xj = jnp.asarray(x)
    params = _jax_init(jconv, jeb, xj, T, 0)

    def jloss(p, xx):
        return (jconv.apply({"params": p}, xx, xx[:T], jeb, T) * g).sum()

    jout = np.asarray(jax.jit(lambda p, xx: jconv.apply(
        {"params": p}, xx, xx[:T], jeb, T))(params, xj))
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, xj)

    conv = GATConv(24, C, heads=heads, dtype=torch.float32)
    conv.load_state_dict(weights.params_from_jax(params))
    xt = torch.from_numpy(x).requires_grad_(True)
    eb = EdgeBlock(src=torch.from_numpy(src), dst=torch.from_numpy(dst),
                   count=torch.tensor(n, dtype=torch.int32))
    out = conv(xt, xt[:T], eb, T)
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=TOL, atol=TOL)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    want = weights.params_from_jax(jax.tree_util.tree_map(np.asarray, jgp))
    for k, p in conv.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)


def test_gatconv_weight_names_carry_both_ways():
    jconv = _jax_conv(2, 8)
    src, dst, msrc, mdst, x, g, n = _conv_hop()
    jeb = JEdgeBlock(src=jnp.asarray(src), dst=jnp.asarray(dst),
                     count=jnp.int32(n))
    xj = jnp.asarray(x)
    params = _jax_init(jconv, jeb, xj, 96, 1)
    conv = GATConv(24, 8, heads=2, dtype=torch.float32)
    sd = weights.params_from_jax(params)
    assert set(sd) == set(conv.state_dict()) == {
        "lin_src.weight", "att_src", "att_dst"}
    conv.load_state_dict(sd)
    back = weights.params_to_jax(conv.state_dict())
    for k in ("att_src", "att_dst"):
        assert back[k].shape == (1, 2, 8)
        np.testing.assert_array_equal(back[k], params[k])
    np.testing.assert_array_equal(back["lin_src"]["kernel"],
                                  params["lin_src"]["kernel"])


# -------------------------------------------------------- gat_attention_agg
AGG_CASES = [(512, 128, 256, 450, 2, 8),
             (1024, 256, 384, 1024, 4, 4),   # no pads
             (512, 128, 256, 0, 1, 16)]      # all pads (self loops only)


def _agg_inputs(E, T, N, n_real, H, C):
    rng = np.random.default_rng(E + n_real)
    src, dst, msrc, mdst = _hop(rng, E, T, N, n_real)
    xs = rng.standard_normal((N, H, C)).astype(np.float32)
    xt = rng.standard_normal((T, H, C)).astype(np.float32)
    a_s = rng.standard_normal((N, H)).astype(np.float32)
    a_d = rng.standard_normal((T, H)).astype(np.float32)
    g = rng.standard_normal((T, H, C)).astype(np.float32)
    return (src, dst, msrc, mdst), (xs, xt, a_s, a_d), g


def _torch_grads(fn, floats, g):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in floats]
    out = fn(*ts)
    (out.float() * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _port_autodiff(T, idx, n):
    """The port's attention block, as GATConv calls it."""
    src, dst = torch.from_numpy(idx[0]), torch.from_numpy(idx[1])
    return lambda xs, xt, a_s, a_d: tgat.gat_attention_agg_autodiff(
        T, 0.2, xs, xt, a_s, a_d, src, dst, n)


@pytest.mark.parametrize("case", AGG_CASES)
def test_gat_attention_agg_matches_jax(case):
    """The port's block, forward and all four gradients, against JAX's
    ``gat_attention_agg`` and its hand-derived backward over the
    src-sorted mirror."""
    E, T, N, n_real, H, C = case
    idx, floats, g = _agg_inputs(*case)
    ji = tuple(map(jnp.asarray, idx))

    def jf(xs, xt, a_s, a_d):
        return jgat.gat_attention_agg(T, 0.2, xs, xt, a_s, a_d, ji[0], ji[1],
                                      jnp.int32(n_real), ji[2], ji[3])

    jargs = tuple(map(jnp.asarray, floats))
    jout = np.asarray(jax.jit(jf)(*jargs))
    jg = jax.jit(jax.grad(lambda *a: (jf(*a) * g).sum(),
                          argnums=(0, 1, 2, 3)))(*jargs)
    out, grads = _torch_grads(_port_autodiff(T, idx, n_real), floats, g)
    np.testing.assert_allclose(out, jout, rtol=TOL, atol=TOL)
    for name, t, j in zip(("xs", "xt", "a_src", "a_dst"), grads, jg):
        np.testing.assert_allclose(t, np.asarray(j), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("case", AGG_CASES)
def test_gat_attention_agg_bf16_runs(case):
    """bf16 rows and f32 logits, as GATConv's f32 attention parameters
    give them; pads, no pads and a hop of pads only."""
    E, T, N, n_real, H, C = case
    idx, floats, g = _agg_inputs(*case)
    xs, xt, a_s, a_d = (torch.from_numpy(a) for a in floats)
    xs = xs.bfloat16().requires_grad_(True)
    xt = xt.bfloat16().requires_grad_(True)
    a_s, a_d = a_s.requires_grad_(True), a_d.requires_grad_(True)
    out = _port_autodiff(T, idx, n_real)(xs, xt, a_s, a_d)
    assert out.dtype == torch.bfloat16 and out.shape == (T, H, C)
    out.float().sum().backward()
    assert xs.grad.dtype == torch.bfloat16 and a_s.grad.dtype == torch.float32
    for t in (xs, xt, a_s, a_d):
        assert torch.isfinite(t.grad.float()).all()


def test_gatconv_ignores_the_mirror(monkeypatch):
    """The port has one attention block and reads no switch: with the JAX
    package's opt-in for its hand-derived backward set, GATConv gives
    bit-identical output and gradients on a hop with and without its
    src-sorted mirror, and GAT's specs still do not mirror the outer
    hop."""
    from salient_plusplus_tpu_torch.models import mirror_all_specs
    from salient_plusplus_tpu_torch.sampling.batch import BatchSpec

    monkeypatch.setenv("SPTPU_GAT_CUSTOM_VJP", "1")
    assert not mirror_all_specs("GAT", BatchSpec.worst_case(
        32, [4, 3]))[0].mirror_all
    src, dst, msrc, mdst, x, g, n = _conv_hop(seed=5)
    T = g.shape[0]
    hop = dict(src=torch.from_numpy(src), dst=torch.from_numpy(dst),
               count=torch.tensor(n, dtype=torch.int32))
    conv = GATConv(24, 16, dtype=torch.float32,
                   generator=torch.Generator().manual_seed(0))
    res = []
    for eb in (EdgeBlock(**hop), EdgeBlock(**hop, msrc=torch.from_numpy(
            msrc), mdst=torch.from_numpy(mdst))):
        conv.zero_grad()
        xt = torch.from_numpy(x).requires_grad_(True)
        out = conv(xt, xt[:T], eb, T)
        (out * torch.from_numpy(g)).sum().backward()
        res.append([out.detach()] + [t.grad.clone() for t in
                                     (xt, *conv.parameters())])
    for a, b in zip(*res):
        assert torch.equal(a, b)


# ------------------------------------------------------ the weighted sum
# AGG_CASES with their pads at T, then tight buckets (pads above T): (E, T,
# N, n_real, H, C, pads above T)
WEIGHTED_CASES = ([(*c, 0) for c in AGG_CASES]
                  + [(512, 64, 256, 400, 1, 16, 7),
                     (768, 96, 200, 500, 2, 12, 3),
                     # GATSkip's last layer in small: 4 heads of 7, F = 28
                     # not a multiple of 8
                     (640, 80, 300, 560, 4, 7, 5)])


def _weighted_inputs(E, T, N, n_real, H, C, above):
    idx, floats, g = _agg_inputs(E, T, N, n_real, H, C)
    idx[1][n_real:] += above
    return idx, floats, g


def _loop_weighted(xs, att, src, dst, n_real, T):
    """The weighted sum edge by edge in float64: real edges below n_real
    with dst below T."""
    out = np.zeros((T,) + xs.shape[1:])
    for e in range(n_real):
        if dst[e] < T:
            out[dst[e]] += att[e][:, None] * xs[src[e]].astype(np.float64)
    return out


@pytest.mark.parametrize("case", WEIGHTED_CASES)
def test_weighted_segment_sum_plain_matches_loop(case):
    """The plain version drops edges past count (here with real-looking
    dst values, src ids that are no row and NaN weights) and pads at or
    above T."""
    E, T, N, n_real, H, C, above = case
    (src, dst, _, _), (xs, *_), _ = _weighted_inputs(*case)
    rng = np.random.default_rng(E + H)
    att = rng.random((E, H)).astype(np.float32)
    want = _loop_weighted(xs, att, src, dst, n_real, T)
    dst, src, att = dst.copy(), src.copy(), att.copy()
    dst[n_real:] = rng.integers(0, T, E - n_real)
    src[n_real:] = 2**31 - 1
    att[n_real:] = np.nan
    got = tws.weighted_segment_sum(*map(torch.from_numpy, (xs, att, src,
                                                           dst)),
                                   torch.tensor(n_real, dtype=torch.int32), T)
    assert got.dtype == torch.float32 and got.shape == (T, H, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", WEIGHTED_CASES)
def test_gat_block_forward_with_weighted_sum_matches_jax(case):
    """GATConv's default block, whose weighted sum is the fused op, against
    the JAX package's ``gat_agg`` forward (its Pallas segment sum
    interpreted), pads at T and above it."""
    E, T, N, n_real, H, C, above = case
    idx, floats, _ = _weighted_inputs(*case)
    ji = tuple(map(jnp.asarray, idx))
    jout = np.asarray(jax.jit(
        lambda xs, xt, a_s, a_d: jgat.gat_attention_agg(
            T, 0.2, xs, xt, a_s, a_d, ji[0], ji[1], jnp.int32(n_real),
            ji[2], ji[3]))(*map(jnp.asarray, floats)))
    out = _port_autodiff(T, idx, n_real)(*map(torch.from_numpy, floats))
    np.testing.assert_allclose(out.numpy(), jout, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", WEIGHTED_CASES)
def test_weighted_segment_sum_gradients_match_three_ops(case):
    """The op's forward and gradients against autograd through the gather
    → multiply → sorted segment sum it replaces (pad edges weigh 0, as the
    softmax leaves them)."""
    E, T, N, n_real, H, C, above = case
    (src, dst, _, _), (xs, *_), g = _weighted_inputs(*case)
    att = np.random.default_rng(E + H).random((E, H)).astype(np.float32)
    att[n_real:] = 0
    src, dst = torch.from_numpy(src), torch.from_numpy(dst)

    def three_ops(x, a):
        msg = x.reshape(N, H * C).index_select(0, src).view(E, H, C)
        msg = (msg * a[:, :, None]).reshape(E, H * C)
        return sorted_segment_sum(T, msg, dst).view(T, H, C)

    def fused(x, a):
        return tws.weighted_segment_sum_op(x, a, src, dst, n_real, T)

    out, grads = _torch_grads(fused, (xs, att), g)
    ref, ref_grads = _torch_grads(three_ops, (xs, att), g)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    for name, a, b in zip(("xs", "att"), grads, ref_grads):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("case", WEIGHTED_CASES)
def test_src_order_sorts_real_edges_stably_pads_last(case):
    """The backward's src order: every real edge once, keys its src and
    nondecreasing, ties in edge order, the dropped edges (past count, with
    src ids that are no row; dst at or above T) last with key N."""
    E, T, N, n_real, H, C, above = case
    (src, dst, _, _), _, _ = _weighted_inputs(*case)
    rng = np.random.default_rng(E + 1)
    src, dst = src.copy(), dst.copy()
    src[n_real:] = 2**31 - 1
    dst[n_real:] = rng.integers(0, T, E - n_real)
    keys, perm = tws._src_order(torch.from_numpy(src), torch.from_numpy(dst),
                                torch.tensor(n_real, dtype=torch.int32), T, N)
    keys, perm = keys.numpy(), perm.numpy()
    real = (np.arange(E) < n_real) & (dst < T)
    assert keys.dtype == np.int32 and perm.dtype == np.int64
    assert sorted(perm.tolist()) == list(range(E))
    k = int(real.sum())
    assert np.array_equal(np.sort(perm[:k]), np.flatnonzero(real))
    assert np.array_equal(keys[:k], src[perm[:k]])
    assert (keys[k:] == N).all()
    assert (np.diff(keys.astype(np.int64)) >= 0).all()
    ties = keys[1:] == keys[:-1]
    assert (perm[1:][ties] > perm[:-1][ties]).all()
