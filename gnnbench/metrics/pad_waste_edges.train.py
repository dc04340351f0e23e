"""pad_waste_edges.train: the share of padded edge slots that hold no real
edge over the pool, in %: the program's ``SamplerStats.edge_waste``
over the pool's batches (each against its own bucket's caps). Moves
``train_edges_per_s``.
"""

PHASE = "train"


def read(r):
    if r.phase != PHASE or getattr(r, "pool", None) is None:
        return None
    return 100.0 * r.pool.stats.edge_waste()
