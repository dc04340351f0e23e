"""k1_roofline.score: K1 sorted segment sum
(``csrc/sorted_segment_sum.cu``): its share of its roofline over the
profiled window, in %: the least time its calls could take (bytes at
3.35 TB/s or float32 adds at 67 TFLOP/s, whichever is longer;
``arith``), over the profiler's time for its kernels. The kernels are
named by ``KERNELS``; a ``combine_pass`` launch counts with the
``slice_pass`` before it. Moves ``score_nodes_per_s``.
"""

from gnnbench.readers import roofline

PHASE = "score"
FAMILY = "k1"
KERNELS = r"slice_pass<[^>]*,\s*false>"


def read(r):
    return roofline(r, PHASE, FAMILY)
