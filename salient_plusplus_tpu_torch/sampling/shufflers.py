"""Seeded epoch shufflers (the JAX package's ``sampling/shufflers.py``).

The permutation of an epoch comes from (initial_seed, epoch) through
numpy's PRNG on the host, so both packages shuffle alike, and every rank
derives the same global permutation without communicating.
"""

from __future__ import annotations

import numpy as np


class Shuffler:
    """Single-host: full permutation each epoch."""

    def __init__(self, idx: np.ndarray, initial_seed: int = 2147483647):
        self.idx = np.asarray(idx, dtype=np.int64)
        self.initial_seed = initial_seed

    def get_idx(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.initial_seed + epoch)
        return self.idx[rng.permutation(len(self.idx))]


class DistributedShuffler(Shuffler):
    """The same global permutation on every rank; each takes its 1/world
    slice. The slices are ceil(n / world) long, so trailing ranks may get
    fewer seeds; equal iteration counts are enforced by the caller
    (``GraphData.get_num_iterations``)."""

    def __init__(self, idx: np.ndarray, world_size: int, rank: int,
                 initial_seed: int = 2147483647):
        super().__init__(idx, initial_seed)
        self.world_size = world_size
        self.rank = rank

    def get_idx(self, epoch: int) -> np.ndarray:
        perm = super().get_idx(epoch)
        chunk = -(-len(perm) // self.world_size)
        return perm[self.rank * chunk:(self.rank + 1) * chunk]


class FederatedDistributedShuffler(Shuffler):
    """Each rank shuffles only its own partition's seeds: no seed crosses
    ranks, and under contiguous-range partitioning the seeds' features are
    local."""

    def __init__(self, local_idx: np.ndarray,
                 initial_seed: int = 2147483647):
        super().__init__(local_idx, initial_seed)
