"""mfu.score: the whole batch's share of the card's bf16 peak (989
TFLOP/s), in %: the FLOPs each window batch needs (``models/<model>.py``
``step_flops``: products at real row counts, aggregation adds, nothing
recomputed) over the window's seconds. Moves ``score_nodes_per_s``.
"""

from gnnbench.readers import mfu

PHASE = "score"


def read(r):
    return mfu(r, PHASE)
