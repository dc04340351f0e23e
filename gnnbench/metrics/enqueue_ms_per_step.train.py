"""enqueue_ms_per_step.train: host milliseconds a step spends in the call
into the program's step (``train/step.py``, ``models/``, ``ops/``: eager
dispatch), mean over the window, on the harness's clock. Moves
``train_edges_per_s``.
"""

from gnnbench.readers import mean_ms

PHASE = "train"


def read(r):
    if r.phase != PHASE:
        return None
    return mean_ms(r.enqueue_s)
