"""batch_ms_p95.score: the 95th percentile (nearest rank) of the
milliseconds between the starts of consecutive batchs on the card's
compute stream (CUDA events recorded as each batch is enqueued), over
the window of the traced run. Moves ``score_nodes_per_s``.
"""

from gnnbench.readers import p95_ms

PHASE = "score"


def read(r):
    return p95_ms(r, PHASE)
