"""Multi-constraint graph partitioning (counterpart of the JAX package's
``partition/partitioner.py``; numpy and the native library, no device).

The reference balances 4-constraint node weights [is_train, is_valid,
is_other, degree] across partitions with METIS while cutting few edges.
METIS is not available, so the native library (``native/sampler.cpp``)
provides the same contract: multilevel heavy-edge coarsening, a BFS-grown
initial partition and capacity-safe label-propagation refinement, or the
flat single-level edition. Both packages call the same C source with the
same arguments, so the same graph, weights, ``k``, ``seed``,
``imbalance`` and ``refine_passes`` give the same labels in both. If
pymetis is installed it is used instead.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np


def get_4d_node_weights(num_nodes: int, rowptr: np.ndarray,
                        train_idx: np.ndarray, valid_idx: np.ndarray
                        ) -> np.ndarray:
    """[V, 4] weights: is_train, is_valid, is_other, degree."""
    w = np.zeros((num_nodes, 4), np.float64)
    w[train_idx, 0] = 1
    w[valid_idx, 1] = 1
    w[:, 2] = 1
    w[train_idx, 2] = 0
    w[valid_idx, 2] = 0
    w[:, 3] = np.diff(rowptr)
    return w


def random_partition(num_nodes: int, k: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, k, size=num_nodes).astype(np.int32)


def contiguous_partition(num_nodes: int, k: int) -> np.ndarray:
    return (np.arange(num_nodes, dtype=np.int64) * k // num_nodes
            ).astype(np.int32)


def multiconstraint_partition(
    rowptr: np.ndarray, col: np.ndarray, k: int,
    node_weights: Optional[np.ndarray] = None,
    imbalance: float = 1.05, seed: int = 0, refine_passes: int = 4,
    multilevel: bool = True,
) -> np.ndarray:
    """k-way multi-constraint partition labels [V] (int32).

    ``imbalance`` multiplies each constraint's mean load into its cap (the
    METIS ubvec analog). ``multilevel`` (default) runs the
    coarsen/partition/refine pipeline; False the flat BFS + label-prop
    heuristic. Without ``node_weights`` the constraints are [1, degree].
    """
    V = len(rowptr) - 1
    if node_weights is None:
        node_weights = np.stack(
            [np.ones(V), np.diff(rowptr)], axis=1).astype(np.float64)
    try:
        import pymetis  # optional

        adj = [col[rowptr[i]:rowptr[i + 1]].tolist() for i in range(V)]
        _, labels = pymetis.part_graph(k, adjacency=adj)
        return np.asarray(labels, np.int32)
    except ImportError:
        pass
    caps = node_weights.sum(axis=0) / k * imbalance + node_weights.max(axis=0)
    return _native_partition(rowptr, col, k, node_weights, caps, seed,
                             refine_passes, multilevel=multilevel)


def _native_partition(rowptr, col, k, weights, caps, seed,
                      refine_passes, multilevel=True) -> np.ndarray:
    """``sptpu_partition_ml`` (coarsening stops at ``max(2048, 128k)``
    vertices) or the flat ``sptpu_partition``. The arrays go over as
    contiguous int64 / int32 / float64 and the seed as ``seed or 1``."""
    from ..sampling.cpp import get_lib

    lib = get_lib()
    V = len(rowptr) - 1
    rowptr = np.ascontiguousarray(rowptr, np.int64)
    col = np.ascontiguousarray(col, np.int32)
    weights = np.ascontiguousarray(weights, np.float64)
    caps = np.ascontiguousarray(caps, np.float64)
    labels = np.empty(V, np.int32)
    common = (
        rowptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        col.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        V, k, weights.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        weights.shape[1], caps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        seed or 1, refine_passes)
    out = labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    if multilevel:
        lib.sptpu_partition_ml(*common, max(2048, 128 * k), out)
    else:
        lib.sptpu_partition(*common, out)
    return labels


def partition_quality(rowptr, col, labels, node_weights=None) -> dict:
    """Cut fraction + per-constraint imbalance diagnostics."""
    V = len(rowptr) - 1
    rows = np.repeat(np.arange(V, dtype=np.int32),
                     np.diff(rowptr).astype(np.int64))
    cut = (labels[rows] != labels[col]).sum()
    out = {"cut_fraction": float(cut / max(len(col), 1))}
    if node_weights is not None:
        k = int(labels.max()) + 1
        loads = np.zeros((k, node_weights.shape[1]))
        np.add.at(loads, labels, node_weights)
        mean = node_weights.sum(axis=0) / k
        out["max_imbalance"] = float(
            np.max(loads / np.maximum(mean, 1e-12)))
    return out
