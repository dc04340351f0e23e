"""k3_roofline.train: K3 row gather (``csrc/gather_rows.cu``): its share of
its roofline over the profiled window, in %: the least time its calls
could take (bytes at 3.35 TB/s or float32 adds at 67 TFLOP/s, whichever
is longer; ``arith``), over the profiler's time for its kernels. The
kernels are named by ``KERNELS``; a ``combine_pass`` launch counts with
the ``slice_pass`` before it. Moves ``train_edges_per_s``.
"""

from gnnbench.readers import roofline

PHASE = "train"
FAMILY = "k3"
KERNELS = r"gather_rows_kernel"


def read(r):
    return roofline(r, PHASE, FAMILY)
