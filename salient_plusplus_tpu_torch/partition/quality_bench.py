"""Partition-quality benchmark: the heuristic against random partitioning
and METIS where ``pymetis`` is installed (counterpart of the JAX package's
``partition/quality_bench.py``; host only).

Measures the BFS-grow + refinement heuristic of ``partitioner.py``, with
and without its multilevel coarsening, by cut fraction and 4-constraint
imbalance (the reference's METIS setup: run_4constraint_partition.py:
24-37, partitioners/partition.py:67-81 with ubvec 1.001). The labels are
the JAX package's (one native partitioner), so the figures are too.

Usage: python -m salient_plusplus_tpu_torch.partition.quality_bench [V] [k]
       [powerlaw,planted]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def run(num_nodes: int = 200_000, k: int = 8, seed: int = 0,
        kind: str = "powerlaw") -> dict:
    """kind: "powerlaw" (an expander: little structure for any
    partitioner, METIS included, to find; the floor) or "planted"
    (communities: the ability to find real cuts)."""
    from ..data import synthetic
    from . import (get_4d_node_weights, multiconstraint_partition,
                   partition_quality, random_partition)

    if kind == "powerlaw":
        g = synthetic.powerlaw_graph(
            name=f"pq-{num_nodes}", num_nodes=num_nodes, avg_degree=15,
            num_features=8, num_classes=16, seed=seed)
    else:
        g = synthetic.planted_partition(
            name=f"pqp-{num_nodes}", num_nodes=num_nodes,
            num_classes=4 * k, avg_degree=15, num_features=8, seed=seed)
    w = get_4d_node_weights(g.num_nodes, g.rowptr, g.split_idx["train"],
                            g.split_idx["valid"])
    out = {"kind": kind, "num_nodes": num_nodes,
           "num_edges": int(g.num_edges), "k": k}

    t0 = time.perf_counter()
    labels = multiconstraint_partition(g.rowptr, g.col, k, w, seed=seed)
    out["heuristic"] = partition_quality(g.rowptr, g.col, labels, w)
    out["heuristic"]["seconds"] = round(time.perf_counter() - t0, 2)

    t0 = time.perf_counter()
    flat = multiconstraint_partition(g.rowptr, g.col, k, w, seed=seed,
                                     multilevel=False)
    out["flat"] = partition_quality(g.rowptr, g.col, flat, w)
    out["flat"]["seconds"] = round(time.perf_counter() - t0, 2)

    # another seed than the generator's: same-seed integer draws correlate
    # with the planted community assignment
    out["random"] = partition_quality(
        g.rowptr, g.col, random_partition(g.num_nodes, k, seed + 991), w)

    try:
        import pymetis

        adj = [g.col[g.rowptr[i]:g.rowptr[i + 1]].tolist()
               for i in range(g.num_nodes)]
        t0 = time.perf_counter()
        _, ml = pymetis.part_graph(k, adjacency=adj)
        out["metis"] = partition_quality(
            g.rowptr, g.col, np.asarray(ml, np.int32), w)
        out["metis"]["seconds"] = round(time.perf_counter() - t0, 2)
    except ImportError:
        out["metis"] = None

    out["heuristic_vs_random_cut_ratio"] = round(
        out["heuristic"]["cut_fraction"] / out["random"]["cut_fraction"], 4)
    return out


if __name__ == "__main__":
    V = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    kinds = sys.argv[3].split(",") if len(sys.argv) > 3 else ["powerlaw",
                                                              "planted"]
    print(json.dumps({kind: run(V, k, kind=kind) for kind in kinds},
                     indent=2))
