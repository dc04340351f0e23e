"""Partition-contiguous, VIP-ordered vertex relabeling (counterpart of the
JAX package's ``data/reorder.py``; numpy, host only).

Vertices are relabeled so (a) each partition owns a contiguous id range,
which makes the partition directory a searchsorted
(``RangePartitionBook``), and (b) within each partition the ids run by
descending VIP weight, so the hottest rows form a prefix that can stay on
the device. With ``equal_shards`` every range is padded to one length (a
multiple of ``align``), so the feature table splits into equal shards;
the pad ids are ghost vertices with no edges that are never sampled. The
outputs equal the JAX package's.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .dataset import GraphData, PartitionedGraphData, SPLIT_NAMES


def reorder_graph(
    graph: GraphData,
    partition_ids: np.ndarray,
    vip_weights: Optional[np.ndarray] = None,
    align: int = 128,
    equal_shards: bool = True,
) -> Tuple[PartitionedGraphData, List[np.ndarray], np.ndarray]:
    """Returns (partitioned dataset view, per-partition x shards, old→new id
    map). ``vip_weights`` is one V-vector: each partition orders its own
    vertices by it."""
    V = graph.num_nodes
    k = int(partition_ids.max()) + 1
    if vip_weights is None:
        vip_weights = np.zeros(V, np.float32)

    # global sort: (partition asc, vip desc, id asc) → new order
    order = np.lexsort((np.arange(V), -vip_weights.astype(np.float64),
                        partition_ids))
    part_sizes = np.bincount(partition_ids, minlength=k)
    if equal_shards:
        v_pad = int(-(-int(part_sizes.max()) // align) * align)
    else:
        v_pad = None

    # new id for old vertex; ghosts occupy the tail of each padded range
    old2new = np.empty(V, np.int64)
    new_starts = (np.arange(k) * v_pad if equal_shards
                  else np.concatenate([[0], np.cumsum(part_sizes)[:-1]]))
    sorted_parts = partition_ids[order]
    for p in range(k):
        members = order[sorted_parts == p]
        old2new[members] = new_starts[p] + np.arange(len(members))

    V_new = int(k * v_pad) if equal_shards else V
    part_offsets = (np.arange(k + 1, dtype=np.int64) * v_pad
                    if equal_shards
                    else np.concatenate([[0], np.cumsum(part_sizes)]))

    # permute the CSR symmetrically into the new id space, vectorized (an
    # edge-wise lexsort; a per-node loop would take hours at papers100M
    # scale)
    deg = np.diff(graph.rowptr)
    new_deg = np.zeros(V_new, np.int64)
    new_deg[old2new] = deg
    new_rowptr = np.zeros(V_new + 1, np.int64)
    np.cumsum(new_deg, out=new_rowptr[1:])
    src_new = np.repeat(old2new, deg)
    dst_new = old2new[graph.col]
    order_e = np.lexsort((dst_new, src_new))
    new_col = dst_new[order_e].astype(np.int32)

    new_y = np.full(V_new, -1, np.int32)
    new_y[old2new] = graph.y.astype(np.int32)

    new_split = {s: np.sort(old2new[graph.split_idx[s]])
                 for s in SPLIT_NAMES}
    split_idx_parts = {}
    for p in range(k):
        lo, hi = part_offsets[p], part_offsets[p + 1]
        split_idx_parts[p] = {
            s: idx[(idx >= lo) & (idx < hi)] for s, idx in new_split.items()
        }

    x_shards = []
    F = graph.num_features
    for p in range(k):
        lo, hi = part_offsets[p], part_offsets[p + 1]
        shard = np.zeros((hi - lo, F), graph.x.dtype)
        olds = np.flatnonzero(partition_ids == p)
        shard[old2new[olds] - lo] = graph.x[olds]
        x_shards.append(shard)

    pg = PartitionedGraphData(
        name=f"{graph.name}-reordered-k{k}",
        rowptr=new_rowptr, col=new_col,
        x=x_shards[0], y=new_y, split_idx=new_split,
        num_classes=graph.num_classes,
        rank=0, num_parts=k, part_offsets=part_offsets,
        split_idx_parts=split_idx_parts,
    )
    return pg, x_shards, old2new


def reorder_and_save(graph: GraphData, partition_ids: np.ndarray,
                     root: str, vip_weights: Optional[np.ndarray] = None,
                     align: int = 128) -> str:
    """Relabel, shard and save in the on-disk partitioned format."""
    pg, x_shards, _ = reorder_graph(graph, partition_ids, vip_weights, align)
    return pg.save_partitioned(root, x_shards)


def hot_order_graph(
    graph: GraphData,
    weights: Optional[np.ndarray] = None,
) -> Tuple[GraphData, np.ndarray]:
    """Single-host hot-prefix relabeling: sort all vertices by descending
    access weight, so ``x[:V*f]`` is the hottest prefix (the precondition
    of the ``hbm_fraction`` split). ``weights`` defaults to the analytic
    VIP access probability of training at batch 1024, fanouts [15, 10, 5].

    Returns (relabeled GraphData, old→new id map).
    """
    if weights is None:
        from ..caching.vip import vip_analytical

        weights = vip_analytical(graph.rowptr, graph.col,
                                 [graph.split_idx["train"]],
                                 1024, [15, 10, 5])[0]
    pg, x_shards, old2new = reorder_graph(
        graph, np.zeros(graph.num_nodes, np.int32),
        np.asarray(weights, np.float64), equal_shards=False)
    g = GraphData(
        name=f"{graph.name}-hotordered",
        rowptr=pg.rowptr, col=pg.col, x=x_shards[0], y=pg.y,
        split_idx=pg.split_idx, num_classes=graph.num_classes)
    return g, old2new
