"""device_idle_share.score: the share of the profiled window in which no
operation ran on the card, in %: 1 - (union of device operation
intervals) / window, from ``torch.profiler``. Moves
``score_nodes_per_s``.
"""

from gnnbench.readers import idle_share

PHASE = "score"


def read(r):
    return idle_share(r, PHASE)
