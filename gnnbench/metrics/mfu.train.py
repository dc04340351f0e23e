"""mfu.train: the whole step's share of the card's bf16 peak (989 TFLOP/s),
in %: the FLOPs each window step needs (``models/<model>.py``
``step_flops``: products at real row counts, aggregation adds, nothing
recomputed) over the window's seconds. Moves ``train_edges_per_s``.
"""

from gnnbench.readers import mfu

PHASE = "train"


def read(r):
    return mfu(r, PHASE)
