"""Pure-numpy reference sampler (counterpart of the JAX package's
``sampling/oracle.py``): the test oracle and the ``OracleSampler`` train
path.

Per hop, every node of the *cumulative* frontier samples up to ``fanout``
distinct neighbours uniformly without replacement (fanout < 0 = take
all); newly seen neighbours are appended to the frontier in first-seen
order. The native sampler follows the same semantics with another RNG
stream, so a second, independent sampler can cross-check the native
sampling, padding and step end to end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .batch import BatchSpec, EdgeBlock, PaddedBatch


@dataclass
class SampleResult:
    """Unpadded multilayer sample (sampling order)."""

    n_id: np.ndarray                  # int32 [n_L]
    level_sizes: List[int]            # [L+1]
    hops: List[Tuple[np.ndarray, np.ndarray]]  # per hop (dst, src) int32
    dropped_nodes: int = 0
    dropped_edges: int = 0


def _sample_row(neighbors: np.ndarray, fanout: int, rng: np.random.Generator):
    """Uniform without replacement; take-all when deg<=fanout or fanout<0."""
    deg = len(neighbors)
    if fanout < 0 or deg <= fanout:
        return neighbors
    return neighbors[rng.choice(deg, size=fanout, replace=False)]


def multilayer_sample_np(
    rowptr: np.ndarray,
    col: np.ndarray,
    seeds: np.ndarray,
    fanouts: Sequence[int],
    rng: Optional[np.random.Generator] = None,
    node_caps: Optional[Sequence[int]] = None,
    edge_caps: Optional[Sequence[int]] = None,
) -> SampleResult:
    rng = rng or np.random.default_rng(0)
    n_id: List[int] = [int(s) for s in seeds]
    n_id_map = {int(s): i for i, s in enumerate(seeds)}
    if len(n_id_map) != len(n_id):
        raise ValueError("duplicate seeds")
    level_sizes = [len(n_id)]
    hops = []
    dropped_nodes = dropped_edges = 0

    for h, fanout in enumerate(fanouts):
        frontier_size = len(n_id)
        node_cap = node_caps[h + 1] if node_caps is not None else None
        edge_cap = edge_caps[h] if edge_caps is not None else None
        dsts: List[int] = []
        srcs: List[int] = []
        for i in range(frontier_size):
            n = n_id[i]
            row = col[rowptr[n]:rowptr[n + 1]]
            for c in _sample_row(row, fanout, rng):
                c = int(c)
                j = n_id_map.get(c)
                if j is None:
                    if node_cap is not None and len(n_id) >= node_cap:
                        dropped_nodes += 1
                        continue
                    j = len(n_id)
                    n_id_map[c] = j
                    n_id.append(c)
                if edge_cap is not None and len(dsts) >= edge_cap:
                    dropped_edges += 1
                    continue
                dsts.append(i)
                srcs.append(j)
        hops.append((np.asarray(dsts, np.int32), np.asarray(srcs, np.int32)))
        level_sizes.append(len(n_id))

    return SampleResult(
        n_id=np.asarray(n_id, np.int32),
        level_sizes=level_sizes,
        hops=hops,
        dropped_nodes=dropped_nodes,
        dropped_edges=dropped_edges,
    )


def pad_sample(sample: SampleResult, spec: BatchSpec,
               y_global: np.ndarray) -> PaddedBatch:
    """Pad an unpadded sample into the static bucket + slice labels (CPU
    tensors; no mirrors, so every hop aggregates without one)."""
    L = spec.num_hops
    if len(sample.hops) != L:
        raise ValueError(f"{len(sample.hops)} hops for a {L}-hop spec")
    n = len(sample.n_id)
    if n > spec.total_node_cap:
        raise ValueError(f"{n} nodes exceed the cap {spec.total_node_cap}")
    n_id = np.zeros(spec.total_node_cap, np.int32)
    n_id[:n] = sample.n_id

    edges = []
    for h in reversed(range(L)):  # processing order
        dst, src = sample.hops[h]
        cap = spec.edge_caps[h]
        e = len(dst)
        if e > cap:
            raise ValueError(f"hop {h}: {e} edges exceed the cap {cap}")
        psrc = np.zeros(cap, np.int32)
        # dst padding = out-level cap: keeps dst nondecreasing and
        # self-dropping in segment reductions (as the native sampler pads)
        pdst = np.full(cap, spec.node_caps[h], np.int32)
        psrc[:e] = src
        pdst[:e] = dst
        edges.append(EdgeBlock(src=torch.from_numpy(psrc),
                               dst=torch.from_numpy(pdst),
                               count=torch.tensor(e, dtype=torch.int32)))

    seed_count = sample.level_sizes[0]
    y = np.zeros(spec.seed_cap, np.int32)
    y[:seed_count] = y_global[sample.n_id[:seed_count]]

    return PaddedBatch(
        n_id=torch.from_numpy(n_id),
        level_sizes=torch.tensor(sample.level_sizes, dtype=torch.int32),
        edges=tuple(edges),
        y=torch.from_numpy(y),
        seed_count=torch.tensor(seed_count, dtype=torch.int32),
        overflow=torch.tensor([sample.dropped_nodes, sample.dropped_edges],
                              dtype=torch.int32),
        spec=spec,
    )
