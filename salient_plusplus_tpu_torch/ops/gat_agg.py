"""GAT attention aggregation with a hand-derived backward (counterpart of
the JAX package's ``ops/gat_agg.py``, with its public names).

    fwd:  z    = leaky_relu(a_src[src] + a_dst[dst])            (H-wide)
          att  = softmax_per_target(z ∪ z_self)
          out  = segsum_dst(att · xs[src]) + self_att · xt
                 (the fused weighted gather + segment sum)
          residuals: per-target (m, D), the softmax max and denominator,
          plus self_att and the f32 out.
    bwd:  S    = <g, out> per (target, head): the softmax-backward sum
                 collapses to a dot, since Σ att·datt = <g, out>.
          attention is recomputed in src-sorted mirror order from (m, D):
          att_m = exp(z_m - m[mdst]) / D[mdst], all gathers, so
          d_xs    = segsum_msrc(att_m · g[mdst])                (K1)
          d_a_src = segsum_msrc(dz_m)                 (sorted, H-wide)
          d_a_dst = segsum_mdst(dz_m)       (unsorted, only H-wide)

The forward's weighted sum is ``ops/weighted_segment.py`` (a CUDA kernel
that reads each ``xs[src]`` row, scales it by the edge's f32 attention in
registers and sums it by target: no [E, H·C] tensor is written); the
backward's d_xs is the sorted segment-sum kernel K1 over the mirror; the
H-wide sums are ``index_add_`` (the JAX package's are XLA scatters, not
Pallas kernels). It needs the hop's src-sorted mirror (``msrc``/``mdst``).

``gat_attention_agg_autodiff`` is the same block as autograd
differentiates it (GATConv's default path): the same fused weighted sum
forward, whose backward is two hand-written kernels on the card
(``weighted_segment_sum_backward``: the attention's gradient in dst
order, the rows' gradient summed by src over a stable device sort, nothing
[E, H·C]-wide written) and the gather and ``index_add_`` on the CPU. The
custom block is off by default, as in the JAX package, whose TPU
measurement found its backward slower than the autodiff one:
``SPTPU_GAT_CUSTOM_VJP=1`` turns it on.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from .segment import masked_segment_sum, segment_softmax_self, valid_mask
from .sorted_segment import sorted_segment_sum_mxu
from .weighted_segment import weighted_segment_sum, weighted_segment_sum_op


def gat_custom_agg_enabled() -> bool:
    """The JAX package's opt-in for this block: ``SPTPU_GAT_CUSTOM_VJP=1``."""
    return os.environ.get("SPTPU_GAT_CUSTOM_VJP", "") == "1"


def _dlrelu(x, ns):
    return torch.where(x > 0, 1.0, ns)


class _GatAttentionAgg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, xt, a_src, a_dst, src, dst, count, msrc, mdst,
                out_cap: int, ns: float):
        T = out_cap
        # pad dst is out_cap (or above it in a tight bucket): it reads a real
        # row, and the softmax masks the edge
        raw = (a_src.index_select(0, src)
               + a_dst.index_select(0, dst.clamp(max=T - 1)))
        z = F.leaky_relu(raw, ns)
        z_self = F.leaky_relu(a_src[:T] + a_dst, ns)
        att, self_att, m_t, d_t = segment_softmax_self(
            z, dst, count, T, z_self, return_stats=True)
        out32 = weighted_segment_sum(xs, att.float(), src, dst, count, T)
        out32 = out32 + self_att[:, :, None] * xt.float()
        ctx.ns = ns
        ctx.save_for_backward(m_t, d_t, self_att, out32, xs, xt, a_src,
                              a_dst, count, msrc, mdst)
        return out32.to(xs.dtype)

    @staticmethod
    def backward(ctx, d_out):
        (m_t, d_t, self_att, out32, xs, xt, a_src, a_dst, count, msrc,
         mdst) = ctx.saved_tensors
        ns = ctx.ns
        T = out32.shape[0]
        N, H, C = xs.shape
        E = msrc.shape[0]
        g = d_out.float()

        # the softmax backward's segment sum, collapsed: <g_t, out_t>
        s_t = (g * out32).sum(-1)

        # the self-loop leg
        d_xt = (g * self_att[:, :, None]).to(xt.dtype)
        dself_att = (g * xt.float()).sum(-1)
        raw_self = a_src[:T] + a_dst
        draw_self = self_att * (dself_att - s_t) * _dlrelu(raw_self, ns)

        # the mirror pass: attention recomputed from (m, D), every wide sum
        # over the src-sorted msrc; the four target-side operands ride one
        # [E, 4H] gather. Mirror pads (msrc = in_cap, mdst = 0) are clamped
        # and masked
        mm = valid_mask(E, count)[:, None]
        ms = msrc.clamp(max=N - 1)
        md = mdst.clamp(max=T - 1)
        st = torch.cat([a_dst, m_t, d_t, s_t], 1).index_select(0, md)
        a_dst_m, m_m, d_m, s_m = st.split(H, dim=1)
        raw_m = a_src.index_select(0, ms) + a_dst_m
        z_m = F.leaky_relu(raw_m, ns)
        att_m = torch.where(mm, torch.exp(z_m - m_m) / d_m, 0.0)
        g_m = g.reshape(T, H * C).to(xs.dtype).index_select(0, md)
        g_m = g_m.view(E, H, C)
        d_msg = att_m[:, :, None].to(xs.dtype) * g_m
        d_xs = sorted_segment_sum_mxu(d_msg.reshape(E, H * C), msrc, N)
        d_xs = d_xs.view(N, H, C).to(xs.dtype)

        xs_m = xs.reshape(N, H * C).index_select(0, ms).view(E, H, C)
        datt_m = (g_m.float() * xs_m.float()).sum(-1)
        dz_m = att_m * (datt_m - s_m)
        draw_m = dz_m * _dlrelu(raw_m, ns)

        d_a_src = masked_segment_sum(draw_m, msrc, count, N)
        d_a_src[:T] += draw_self
        d_a_dst = masked_segment_sum(draw_m, md, count, T) + draw_self
        return (d_xs, d_xt, d_a_src.to(a_src.dtype), d_a_dst.to(a_dst.dtype),
                None, None, None, None, None, None, None)


def gat_attention_agg(out_cap: int, negative_slope: float, xs, xt, a_src,
                      a_dst, src, dst, count, msrc, mdst):
    """out[t] = Σ_{e: dst_e=t} att_e · xs[src_e] + self_att_t · xt[t].

    xs: [N_in, H, C] (bf16 or f32), xt: [T, H, C]; a_src: [N_in, H] f32
    per-source logit term, a_dst: [T, H]; src/dst the target-grouped
    sorted COO (pads: dst >= out_cap), count its real edges (a 0-d int32
    tensor), msrc/mdst its src-sorted mirror (pads: msrc >= N_in). Self
    loops are always included. Returns [T, H, C] in xs.dtype."""
    count = torch.as_tensor(count, dtype=torch.int32, device=src.device)
    return _GatAttentionAgg.apply(xs, xt, a_src, a_dst, src, dst, count,
                                  msrc, mdst, out_cap, negative_slope)


def gat_attention_agg_autodiff(out_cap: int, negative_slope: float, xs, xt,
                               a_src, a_dst, src, dst, count,
                               mean_heads: bool = False):
    """The function of ``gat_attention_agg``, differentiated by autograd
    (no mirror needed). The logits take ``a_src``'s dtype, the softmax runs
    in f32, the weighted sum multiplies the f32 attention into each row in
    f32; returns [T, H, C] in xs.dtype. ``mean_heads`` (PyG's
    ``concat=False``): the self term is added and the heads averaged on the
    weighted sum's f32 output, then cast once; returns [T, C]."""
    T = out_cap
    ns = negative_slope
    # pad dst is out_cap (or above it in a tight bucket): it reads a real
    # row, and the softmax gives the edge attention 0
    logits = F.leaky_relu(a_src.index_select(0, src)
                          + a_dst.index_select(0, dst.clamp(max=T - 1)), ns)
    self_logit = F.leaky_relu(a_src[:T] + a_dst, ns)
    att, self_att = segment_softmax_self(logits.float(), dst, count, T,
                                         self_logit.float())
    out = weighted_segment_sum_op(xs, att, src, dst, count, T)
    if mean_heads:
        return (out + xt.float() * self_att[:, :, None]).mean(1).to(xs.dtype)
    return out.to(xs.dtype) + xt * self_att.to(xs.dtype)[:, :, None]
