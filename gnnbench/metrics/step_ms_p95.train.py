"""step_ms_p95.train: the 95th percentile (nearest rank) of the
milliseconds between the starts of consecutive steps on the card's
compute stream (CUDA events recorded as each step is enqueued), over the
window of the traced run. Moves ``train_edges_per_s``.
"""

from gnnbench.readers import p95_ms

PHASE = "train"


def read(r):
    return p95_ms(r, PHASE)
