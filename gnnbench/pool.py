"""The pool: batches the program's own sampler fills during set-up, which
the window replays through the program's feeder.

``fill`` runs the program's ``FastSampler`` over a fixed list of seeds
with enough buffer sets for every batch the pool keeps, so its worker
threads sample the whole pool at once into pinned host memory and then
stop. ``Replay``
hands those buffer sets out in order, cycling, to the program's
``DeviceFeeder``; the sets are never written again, so its recycling is a
no-op. ``sampled`` and ``meta`` read a buffer set back as plain arrays
for the reference and for the arithmetic.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .models.common import Sampled


@dataclass
class Pool:
    batches: list          # the program's buffer sets, in order
    seeds: list            # the seed ids of each batch
    fill_s: float          # host seconds the fill took
    sampled: int           # batches the sampler handed out in the fill
    sampled_edges: int     # their real edges
    stats: object          # SamplerStats of the pool's batches

    @property
    def real_edges(self) -> int:
        return self.stats.real_edges

    @property
    def outside(self) -> int:
        """Batches outside the program's tight bucket."""
        return self.stats.batches - self.stats.tight_batches

    def edges_of(self, i: int) -> int:
        return int(self.batches[i % len(self.batches)].edge_counts.sum())

    def seeds_of(self, i: int) -> int:
        return int(self.batches[i % len(self.batches)].seed_count[0])


def fill(sampler, seeds: np.ndarray, batch_size: int, order_seed: int,
         keep: Optional[Tuple[int, int]] = None) -> Pool:
    """Sample batches of ``seeds`` in order with the program's sampler
    ``sampler`` (a tail short of ``batch_size`` is dropped). Without
    ``keep`` the pool holds every batch; with ``keep = (tight, outside)``
    it holds the first ``tight`` batches that fit the program's tight
    bucket and the first ``outside`` that do not, and the others are
    handed back to the sampler. The pool holds its batches in an order
    drawn from ``order_seed``."""
    n = len(seeds) // batch_size
    if n < 1:
        raise ValueError(f"{len(seeds)} seeds make no batch of {batch_size}")
    want = n if keep is None else sum(keep)
    idx = np.asarray(seeds[: n * batch_size], np.int64)
    sampler.set_epoch(idx, 0)
    sampler.cfg.max_batches_in_flight = want
    t0 = time.perf_counter()
    it = iter(sampler)
    kept, room = [], None if keep is None else list(keep)
    try:
        for i in range(n):
            if len(kept) == want:
                break
            b = next(it)
            if room is not None:
                kind = 0 if b.bucket is not None else 1
                if room[kind] == 0:
                    it.recycle(b)
                    continue
                room[kind] -= 1
            kept.append((i, b))
    finally:
        it.close()
    fill_s = time.perf_counter() - t0
    if len(kept) < want:
        raise ValueError(f"{n} batches of the split hold no pool of "
                         f"{keep} (tight, outside the tight bucket)")
    # the pool's own padding account, as the program's SamplerStats keeps
    # one for the batches it hands out
    stats = type(it.stats)()
    for _, b in kept:
        eff = b.bucket or b.spec
        stats.batches += 1
        stats.real_nodes += int(b.level_sizes[-1])
        stats.real_edges += int(b.edge_counts.sum())
        stats.padded_nodes += eff.total_node_cap
        stats.padded_edges += sum(eff.edge_caps)
        stats.tight_batches += int(b.bucket is not None)
    order = np.random.default_rng(int(order_seed)).permutation(want)
    return Pool(batches=[kept[i][1] for i in order],
                seeds=[idx[kept[i][0] * batch_size:
                           (kept[i][0] + 1) * batch_size] for i in order],
                fill_s=fill_s, sampled=it.stats.batches,
                sampled_edges=it.stats.real_edges, stats=stats)


class Replay:
    """The pool's buffer sets in order, cycling, as the iterator the
    program's ``DeviceFeeder`` takes."""

    def __init__(self, pool: Pool):
        self.pool = pool
        self.taken = 0

    def __iter__(self):
        return self

    def __next__(self):
        b = self.pool.batches[self.taken % len(self.pool.batches)]
        self.taken += 1
        return b

    def recycle(self, bufs) -> None:
        """The pool's sets are never rewritten: nothing to hand back."""


def sampled(bufs, num_nodes: int) -> Sampled:
    """The batch in a buffer set as the reference reads it. With global
    layer-0 sources (``bufs.gsrc``) the outermost hop's src holds global
    ids; they go back to frontier positions (-1 where one is missing,
    which the sampler check reports)."""
    L = bufs.spec.num_hops
    ls = [int(v) for v in bufs.level_sizes]
    n_id = bufs.n_id[: ls[L]].astype(np.int64)
    hops = []
    for h in range(L):
        a = int(bufs.edge_offsets[h])
        c = int(bufs.edge_counts[h])
        src = bufs.edge_src[a:a + c].astype(np.int64)
        dst = bufs.edge_dst[a:a + c].astype(np.int64)
        if h == L - 1 and bufs.gsrc is not None:
            inv = np.full(num_nodes, -1, np.int64)
            inv[n_id] = np.arange(n_id.shape[0])
            src = inv[src]
        hops.append((torch.from_numpy(src), torch.from_numpy(dst)))
    ns = ls[0]
    return Sampled(
        n_id=torch.from_numpy(n_id), level_sizes=ls, hops=hops,
        seeds=torch.from_numpy(n_id[:ns].copy()),
        y=torch.from_numpy(bufs.y[:ns].astype(np.int64)),
        caps=tuple((bufs.bucket or bufs.spec).node_caps),
        fanouts=tuple(bufs.spec.fanouts))


def meta(bufs, device) -> dict:
    """The sizes the arithmetic reads: real level sizes and edge counts
    (sampling order), the caps of the bucket the batch ran in, and the
    distinct table rows of the outermost hop's real sources."""
    L = bufs.spec.num_hops
    a = int(bufs.edge_offsets[L - 1])
    c = int(bufs.edge_counts[L - 1])
    outer = torch.from_numpy(bufs.edge_src[a:a + c]).to(device)
    return {"level_sizes": [int(v) for v in bufs.level_sizes],
            "edge_counts": [int(v) for v in bufs.edge_counts],
            "caps": tuple((bufs.bucket or bufs.spec).node_caps),
            "distinct_outer_src": int(torch.unique(outer).numel())}
