"""GAT attention aggregation (counterpart of the JAX package's
``ops/gat_agg.py``), differentiated by autograd:

    z    = leaky_relu(a_src[src] + a_dst[dst])            (H-wide)
    att  = softmax_per_target(z ∪ z_self)                 (f32)
    out  = segsum_dst(att · xs[src]) + self_att · xt

The weighted sum is ``ops/weighted_segment.py``: hand-written kernels
forward and backward on the card, which write no [E, H·C] tensor, and
plain torch on the CPU. The H-wide logits and the softmax are plain
torch. The block needs no src-sorted mirror.

The tests hold it, forward and all four gradients, to the JAX package's
``gat_attention_agg`` and its hand-derived backward (the attention
recomputed over the src-sorted mirror from the softmax's per-target max
and denominator), which stays the reference.
"""

from __future__ import annotations

import torch.nn.functional as F

from .segment import segment_softmax_self
from .weighted_segment import weighted_segment_sum_op


def gat_attention_agg_autodiff(out_cap: int, negative_slope: float, xs, xt,
                               a_src, a_dst, src, dst, count,
                               mean_heads: bool = False):
    """out[t] = Σ_{e: dst_e=t} att_e · xs[src_e] + self_att_t · xt[t].

    xs: [N_in, H, C] (bf16 or f32), xt: [T, H, C]; a_src: [N_in, H]
    per-source logit term, a_dst: [T, H]; src/dst the target-grouped
    sorted COO (pads: dst >= out_cap), count its real edges. Self loops
    are always included. The logits take ``a_src``'s dtype, the softmax
    runs in f32, the weighted sum multiplies the f32 attention into each
    row in f32; returns [T, H, C] in xs.dtype. ``mean_heads`` (PyG's
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
