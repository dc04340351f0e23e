"""Masked segment ops over padded edge lists, in plain torch (counterpart
of the JAX package's ``ops/segment.py``).

A hop's padded COO (EdgeBlock) is reduced target-wise with the padding
masked by an iota-vs-count comparison; padded edges are routed to an extra
row ``num_segments`` that is dropped. These are the oracles the kernel paths
(ops/sorted_segment.py; for GAT's attention softmax ops/edge_softmax.py)
are checked against, and the narrow reductions of ARMA's normalisation.
``gather_rows`` dispatches to the row-gather kernel.

The JAX package takes its sorted-layout softmaxes as segmented associative
scans, because scatters are slow on a TPU. That is a TPU device and is not
carried over: here every softmax is ``scatter_reduce("amax")``,
``index_add_`` and gathers, with the JAX package's guards (masked logits
are ``-finfo.max``, never ``-inf``; denominators are floored at 1e-16;
pad edges get attention 0). Only the results have to match; the sums run
in another order. GAT's attention takes none of them on the card: there
it launches the kernel pair of ``ops/edge_softmax.py``, and
``segment_softmax_self`` is its CPU path and oracle.
"""

from __future__ import annotations

import torch

from .pallas_gather import pallas_gather_rows


def valid_mask(length: int, count, device=None) -> torch.Tensor:
    """[length] bool: True for slots < count (count may be a 0-d tensor)."""
    if isinstance(count, torch.Tensor):
        device = count.device
    return torch.arange(length, device=device) < count


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``x[idx]`` of a 2-d table by int32 ids: the row-gather
    kernel (``ops/pallas_gather.py``) on a CUDA tensor, its plain version
    on a CPU tensor (the JAX package's ``gather_rows_auto``)."""
    return pallas_gather_rows(x, idx)


def _safe_dst(dst: torch.Tensor, count, num_segments: int) -> torch.Tensor:
    """int64 dst with every dropped edge (``e >= count`` or ``dst[e] >=
    num_segments``) routed to the extra row ``num_segments``."""
    keep = (valid_mask(dst.shape[0], count, dst.device)
            & (dst < num_segments))
    return torch.where(keep, dst.long(), num_segments)


def _real_rows(src: torch.Tensor, dst: torch.Tensor, count,
               num_segments: int):
    """(ids, rows) of a gathering segment sum: ``_safe_dst``'s ids, and
    src with every dropped edge routed to row 0, so no pad src (which need
    not be a row) is used as an index."""
    ids = _safe_dst(dst, count, num_segments)
    return ids, torch.where(ids < num_segments, src.long(), 0)


def masked_segment_sum(values: torch.Tensor, dst: torch.Tensor, count,
                       num_segments: int) -> torch.Tensor:
    """out[dst[e]] += values[e] for real edges (e < count); [T, ...]."""
    safe = _safe_dst(dst, count, num_segments)
    out = values.new_zeros((num_segments + 1,) + values.shape[1:])
    return out.index_add_(0, safe, values)[:num_segments]


def segment_degrees_sorted(dst: torch.Tensor, count,
                           num_segments: int) -> torch.Tensor:
    """Per-target in-degree of a nondecreasing dst array (padding ==
    num_segments): searchsorted + diff, no scatter."""
    safe = _safe_dst(dst, count, num_segments).to(torch.int32)
    bounds = torch.arange(num_segments + 1, dtype=torch.int32,
                          device=dst.device)
    rowptr = torch.searchsorted(safe, bounds, right=False)
    return torch.diff(rowptr)


def masked_segment_mean(values: torch.Tensor, dst: torch.Tensor, count,
                        num_segments: int) -> torch.Tensor:
    """Mean aggregation; zero for targets with no edges (PyG semantics)."""
    safe = _safe_dst(dst, count, num_segments)
    ones = valid_mask(dst.shape[0], count, dst.device).to(values.dtype)
    deg = values.new_zeros(num_segments + 1).index_add_(0, safe, ones)
    s = masked_segment_sum(values, dst, count, num_segments)
    deg = deg[:num_segments].clamp_min(1)
    if values.dim() > 1:
        deg = deg[:, None]
    return s / deg


def _index_like(idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """[E] ids broadcast to ``values``' shape (scatter_reduce's index)."""
    return idx.view((-1,) + (1,) * (values.dim() - 1)).expand_as(values)


def _seg_max(values: torch.Tensor, safe: torch.Tensor,
             num_segments: int) -> torch.Tensor:
    """[num_segments + 1, ...] max of ``values`` by ``safe`` ids; rows that
    no id reaches are ``-finfo.max``."""
    neg = torch.finfo(values.dtype).min
    out = values.new_full((num_segments + 1,) + values.shape[1:], neg)
    return out.scatter_reduce(0, _index_like(safe, values), values, "amax")


def _has_edge(safe: torch.Tensor, num_segments: int) -> torch.Tensor:
    """[num_segments] bool: the segment has a real edge."""
    n = torch.zeros(num_segments + 1, dtype=torch.int32, device=safe.device)
    return n.index_add_(0, safe, torch.ones_like(safe, dtype=torch.int32)
                        )[:num_segments] > 0


def masked_segment_max(values: torch.Tensor, dst: torch.Tensor, count,
                       num_segments: int, neutral=None) -> torch.Tensor:
    """Max aggregation; targets with no edges get ``neutral`` (default 0)."""
    safe = _safe_dst(dst, count, num_segments)
    out = _seg_max(values, safe, num_segments)[:num_segments]
    has = _has_edge(safe, num_segments)
    has = has.view((-1,) + (1,) * (values.dim() - 1))
    return torch.where(has, out, 0 if neutral is None else neutral)


def masked_segment_softmax(logits: torch.Tensor, dst: torch.Tensor, count,
                           num_segments: int) -> torch.Tensor:
    """Per-target softmax over incoming edges; [E] or [E, H], pad edges 0.
    Sorted and unsorted dst take the same path (the JAX package's
    ``sorted_dst`` layout hint has no counterpart)."""
    safe = _safe_dst(dst, count, num_segments)
    real = (safe < num_segments).view((-1,) + (1,) * (logits.dim() - 1))
    lg = torch.where(real, logits, torch.finfo(logits.dtype).min)
    # the max only shifts the exponent: no gradient flows through it
    seg_max = _seg_max(lg.detach(), safe, num_segments)
    ex = torch.where(real, torch.exp(lg - seg_max[safe]), 0)
    denom = torch.zeros_like(seg_max).index_add_(0, safe, ex)
    return ex / denom.clamp_min(1e-16)[safe]


def sorted_segment_softmax(logits: torch.Tensor, dst: torch.Tensor, count,
                           num_segments: int) -> torch.Tensor:
    """The softmax over target-grouped edges (the JAX package's scan
    formulation; the same function as ``masked_segment_softmax``)."""
    return masked_segment_softmax(logits, dst, count, num_segments)


def segment_softmax_self(logits: torch.Tensor, dst: torch.Tensor, count,
                         num_segments: int, self_logit: torch.Tensor,
                         return_stats: bool = False):
    """Per-target softmax over incoming edges plus one implicit self-loop
    logit per target (PyG's GATConv with ``add_self_loops=True``).

    logits: [E, H]; self_logit: [T, H]. Returns (att [E, H], self_att
    [T, H]) with pad edges 0 and empty targets ``self_att`` 1; with
    ``return_stats`` also (m_t, D_t), the per-target max and denominator
    from which ``att_e = exp(z_e - m_t) / D_t`` for any edge order (the
    residuals of the JAX package's hand-derived GAT block)."""
    T = num_segments
    safe = _safe_dst(dst, count, T)
    real = (safe < T)[:, None]
    neg = torch.finfo(logits.dtype).min
    lg = torch.where(real, logits, neg)
    # the maxima only shift exponents, which cancel in every output: they
    # carry no gradient
    seg_max = _seg_max(lg.detach(), safe, T)
    ex = torch.where(real, torch.exp(lg - seg_max[safe]), 0)
    den = torch.zeros_like(seg_max).index_add_(0, safe, ex)[:T]
    he = _has_edge(safe, T)[:, None]
    M_t = torch.where(he, seg_max[:T], neg)
    S_t = torch.where(he, den, 0)
    m_t = torch.maximum(M_t, self_logit.detach())
    scale_t = torch.where(he, torch.exp(M_t - m_t), 0)
    self_ex = torch.exp(self_logit - m_t)
    D_t = (S_t * scale_t + self_ex).clamp_min(1e-16)
    self_att = self_ex / D_t
    # per-edge attention rescaled to the self-inclusive normaliser
    c_t = scale_t / D_t
    c_pad = torch.cat([c_t, torch.zeros_like(c_t[:1])])
    att = ex * c_pad[safe]
    if return_stats:
        return att, self_att, m_t, D_t
    return att, self_att
