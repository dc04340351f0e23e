"""GAT attention aggregation (counterpart of the JAX package's
``ops/gat_agg.py``), differentiated by autograd:

    z    = leaky_relu(a_src[src] + a_dst[dst])            (H-wide)
    att  = softmax_per_target(z ∪ z_self)                 (f32)
    out  = segsum_dst(att · xs[src]) + self_att · xt

The logits and the softmax are ``ops/edge_softmax.py`` and the weighted
sum ``ops/weighted_segment.py``: hand-written kernels forward and backward
on the card (the edge softmax's pair uses no scatter or sort, the weighted
sum's writes no [E, H·C] tensor), and plain torch on the CPU. The block
needs no src-sorted mirror.

The tests hold it, forward and all four gradients, to the JAX package's
``gat_attention_agg`` and its hand-derived backward (the attention
recomputed over the src-sorted mirror from the softmax's per-target max
and denominator), which stays the reference.
"""

from __future__ import annotations

from .edge_softmax import edge_softmax
from .weighted_segment import weighted_segment_sum_op


def gat_attention_agg_autodiff(out_cap: int, negative_slope: float, xs, xt,
                               a_src, a_dst, src, dst, count,
                               mean_heads: bool = False):
    """out[t] = Σ_{e: dst_e=t} att_e · xs[src_e] + self_att_t · xt[t].

    xs: [N_in, H, C] (bf16 or f32), xt: [T, H, C]; a_src: [N_in, H]
    per-source logit term, a_dst: [T, H]; src/dst the target-grouped
    sorted COO (pads: dst >= out_cap), count its real edges. Self loops
    are always included. The softmax runs in f32 (its logits summed in f32
    on the card, in ``a_src``'s dtype on the CPU), the weighted sum
    multiplies the f32 attention into each row in f32; returns [T, H, C]
    in xs.dtype. ``mean_heads`` (PyG's
    ``concat=False``): the self term is added and the heads averaged on the
    weighted sum's f32 output, then cast once; returns [T, C]."""
    T = out_cap
    att, self_att = edge_softmax(a_src, a_dst, src, dst, count, T,
                                 negative_slope)
    out = weighted_segment_sum_op(xs, att, src, dst, count, T)
    if mean_heads:
        return (out + xt.float() * self_att[:, :, None]).mean(1).to(xs.dtype)
    return out.to(xs.dtype) + xt * self_att.to(xs.dtype)[:, :, None]
