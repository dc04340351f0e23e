from .edge_softmax import edge_softmax as _edge_softmax
from .pallas_aggregate import (
    fused_gather_segment_sum, fused_segment_sum_op, maybe_fused_segment_sum,
)
from .pallas_gather import pallas_gather_rows
from .segment import (
    gather_rows, masked_segment_mean, masked_segment_sum,
    segment_degrees_sorted, valid_mask,
)
from .sorted_segment import sorted_segment_sum, sorted_segment_sum_mxu, spmm_agg
from .weighted_segment import weighted_segment_sum, weighted_segment_sum_op

__all__ = [
    "fused_gather_segment_sum", "fused_segment_sum_op",
    "maybe_fused_segment_sum", "pallas_gather_rows",
    "gather_rows", "masked_segment_mean", "masked_segment_sum",
    "segment_degrees_sorted", "valid_mask",
    "sorted_segment_sum", "sorted_segment_sum_mxu", "spmm_agg",
    "weighted_segment_sum", "weighted_segment_sum_op", "launch_counts",
]


def launch_counts() -> dict:
    """Each CUDA kernel's launches so far in this process, by wrapper
    (K1, K2, K3 and GAT's weighted sum, and of the weighted sum's the
    multi-head ones apart, and its backward's calls; GAT's edge softmax
    and its backward); the plain versions that run on the CPU count
    none."""
    return {"sorted_segment_sum": sorted_segment_sum_mxu.launches,
            "fused_gather_segment_sum": fused_gather_segment_sum.launches,
            "gather_rows": pallas_gather_rows.launches,
            "weighted_segment_sum": weighted_segment_sum.launches,
            "weighted_segment_sum.multihead": weighted_segment_sum.multihead,
            "weighted_segment_sum.backward": weighted_segment_sum.backward,
            "edge_softmax": _edge_softmax.launches,
            "edge_softmax.backward": _edge_softmax.backward}
