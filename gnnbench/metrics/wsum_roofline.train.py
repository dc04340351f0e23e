"""wsum_roofline.train: GAT's multi-head weighted gather + segment sum
(``csrc/weighted_segment_sum.cu``, ``weighted_slice_pass<..., true>``):
its share of its roofline over the profiled window, in %: the least time
its calls could take (``models/<model>.py``'s ``wsum`` calls: each real
edge's row, ids and weights read once, the float32 output written once,
at 3.35 TB/s, or its float32 operations at 67 TFLOP/s, whichever is
longer; ``arith.bound_s``), over the profiler's time for its kernels. A
``combine_pass`` launch counts with the slice pass before it. Moves
``train_edges_per_s``.
"""

from gnnbench.readers import roofline

PHASE = "train"
FAMILY = "wsum"
KERNELS = r"weighted_slice_pass<[^>]*,\s*true>"


def read(r):
    return roofline(r, PHASE, FAMILY)
