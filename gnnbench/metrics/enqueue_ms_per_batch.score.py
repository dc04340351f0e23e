"""enqueue_ms_per_batch.score: host milliseconds a batch spends in the call
into the program's step (``train/step.py``, ``models/``, ``ops/``: eager
dispatch), mean over the window, on the harness's clock. Moves
``score_nodes_per_s``.
"""

from gnnbench.readers import mean_ms

PHASE = "score"


def read(r):
    if r.phase != PHASE:
        return None
    return mean_ms(r.enqueue_s)
