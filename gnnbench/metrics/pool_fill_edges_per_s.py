"""pool_fill_edges_per_s: real edges of every batch the program's
sampler (``native/sampler.cpp`` through ``sampling/sampler.py``'s
``FastSampler`` threads) handed out while filling the pool, those the
pool passed over included, over the host seconds of the fill. Moves
``setup_s``.
"""

def read(r):
    p = getattr(r, "pool", None)
    if p is None or p.fill_s <= 0:
        return None
    return p.sampled_edges / p.fill_s
