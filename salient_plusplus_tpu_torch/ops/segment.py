"""Masked segment ops over padded edge lists, in plain torch (counterpart
of the JAX package's ``ops/segment.py``).

A hop's padded COO (EdgeBlock) is reduced target-wise with the padding
masked by an iota-vs-count comparison; padded edges are routed to an extra
row ``num_segments`` that is dropped. These are the oracles the kernel path
(ops/sorted_segment.py) is checked against, and the aggregation of layers
that have no kernel yet. ``gather_rows`` dispatches to the row-gather
kernel.
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
