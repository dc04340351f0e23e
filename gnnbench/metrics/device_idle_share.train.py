"""device_idle_share.train: the share of the profiled window in which no
operation ran on the card, in %: 1 - (union of device operation
intervals) / window, from ``torch.profiler``. Moves
``train_edges_per_s``.
"""

from gnnbench.readers import idle_share

PHASE = "train"


def read(r):
    return idle_share(r, PHASE)
