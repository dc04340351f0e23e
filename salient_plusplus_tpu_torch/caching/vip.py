"""Vertex Inclusion Probability (VIP) estimators and cache generation
(counterpart of the JAX package's ``caching/vip.py``).

Every estimator returns, per partition, a V-length weight vector: the
higher the weight, the likelier that partition's sampler touches the
vertex, so the more its feature row is worth caching there. The analytic
model is the per-hop recurrence over the symmetric graph

    p_hop[v] ← 1 − exp( Σ_{u∈N(v)} log(1 − min(1, fanout/deg(u))·p_hop[u]) )
    p_total  ← 1 − Π_hops (1 − p_hop)

seeded with p_hop = minibatch/|train_p| on partition p's training
vertices. The numpy estimators are the JAX package's, so both give the
same weights and the same cached ids. ``vip_analytical_device`` runs the
float32 recurrence in torch on a device, streaming the edges in chunks.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

VIP_SCHEMES = (
    "vip-analytical", "vip-analytical-device", "vip-simulation",
    "vip-analytical-taylor", "vip-analytical-cascade",
    "vip-analytical-taylor-cascade", "random-multiwalk", "shuffle",
    "degree-reachable", "num-paths-reachable", "halo-1hop", "random-walk",
    "oracle", "degree",
)


def vertex_indegrees(rowptr: np.ndarray) -> np.ndarray:
    return np.diff(rowptr)


def _edge_rows(rowptr: np.ndarray) -> np.ndarray:
    V = len(rowptr) - 1
    return np.repeat(np.arange(V, dtype=np.int32),
                     np.diff(rowptr).astype(np.int64))


def partitionwise_train_idx(partition_ids: np.ndarray,
                            train_idx: np.ndarray) -> List[np.ndarray]:
    """Split global train ids by owning partition."""
    k = int(partition_ids.max()) + 1
    owner = partition_ids[train_idx]
    return [train_idx[owner == p] for p in range(k)]


def vip_analytical(rowptr: np.ndarray, col: np.ndarray,
                   train_idx_per_partition: Sequence[np.ndarray],
                   minibatch_size: int,
                   fanouts: Sequence[int],
                   taylor: bool = False, cascade: bool = False,
                   init_scale: Optional[float] = None) -> List[np.ndarray]:
    """Analytical VIP weights, numpy float64, returned as float32.

    taylor:  first-order approximation 1−exp(−Σ tw·p) of the exact
             1−exp(Σ log(1−tw·p)) recurrence.
    cascade: hop h also inherits hop h−1's probability (a vertex stays in
             the frontier once reached).
    init_scale: seed probability override (random-multiwalk uses 1/|train|
             instead of minibatch/|train|).

    The hop-0 seed probability is not folded into p_total, only the L
    neighbour hops are: the weights rank remote accesses, and a
    partition's own train seeds are local by construction.
    """
    V = len(rowptr) - 1
    deg = vertex_indegrees(rowptr).astype(np.float64)
    rows = _edge_rows(rowptr)
    p_total_out = []
    for train_idx in train_idx_per_partition:
        p_hop = np.zeros(V, np.float64)
        if len(train_idx):
            p_hop[train_idx] = (init_scale if init_scale is not None
                                else minibatch_size / len(train_idx))
        p_not = np.ones(V, np.float64)
        for fanout in fanouts:
            with np.errstate(divide="ignore", invalid="ignore"):
                tw = np.minimum(1.0, fanout / deg)
            tw = np.nan_to_num(tw, nan=1.0, posinf=1.0)
            if taylor:
                s = np.bincount(rows, weights=tw[col] * p_hop[col],
                                minlength=V)
                if cascade:
                    s = s + p_hop
                p_hop = 1.0 - np.exp(-s)
            else:
                with np.errstate(divide="ignore"):
                    logs = np.log(
                        np.maximum(1.0 - tw[col] * p_hop[col], 1e-300))
                logsum = np.bincount(rows, weights=logs, minlength=V)
                if cascade:
                    logsum = logsum + np.log(
                        np.maximum(1.0 - p_hop, 1e-300))
                p_hop = 1.0 - np.exp(logsum)
            p_not *= 1.0 - p_hop
        p_total_out.append((1.0 - p_not).astype(np.float32))
    return p_total_out


def vip_analytical_device(rowptr: np.ndarray, col: np.ndarray,
                          train_idx_per_partition: Sequence[np.ndarray],
                          minibatch_size: int, fanouts: Sequence[int],
                          edge_chunk: int = 1 << 22,
                          device=None) -> List[np.ndarray]:
    """The analytic recurrence in float32 on ``device`` (None: CUDA, which
    raises without a card); returns numpy like ``vip_analytical``.

    ``rowptr``, ``col`` and the degrees go to the device once. Each hop
    streams the edges in chunks of ``edge_chunk``: a chunk's source rows
    are found on the device as ``searchsorted(rowptr, edge_id, right) - 1``
    (so no E-length row array exists on either side), its terms
    ``log(max(1 - tw[c]·p[c], 1e-30))`` are formed, and ``index_add_``
    adds them into the per-row log-sum. ``tw = min(1, fanout/deg)``, 1
    where the degree is 0. The adds of one row land in an order the device
    chooses, so on a card the last bits of the float32 sums vary from run
    to run.
    """
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    V = len(rowptr) - 1
    E = len(col)
    rowptr_d = torch.as_tensor(np.asarray(rowptr, np.int64), device=dev)
    col_d = torch.as_tensor(np.asarray(col, np.int32), device=dev).long()
    deg_d = (rowptr_d[1:] - rowptr_d[:-1]).to(torch.float32)

    def one_hop(p_hop: torch.Tensor, fanout: float) -> torch.Tensor:
        tw = torch.clamp(fanout / deg_d.clamp_min(1e-30), max=1.0)
        tw = torch.where(deg_d > 0, tw, torch.ones_like(tw))
        q = tw * p_hop  # per-vertex factor; terms read it at the edge's col
        logsum = torch.zeros(V, dtype=torch.float32, device=dev)
        for lo in range(0, E, edge_chunk):
            e = torch.arange(lo, min(lo + edge_chunk, E), device=dev)
            rows = torch.searchsorted(rowptr_d, e, right=True) - 1
            c = col_d[lo:lo + edge_chunk]
            logsum.index_add_(0, rows,
                              torch.log(torch.clamp(1.0 - q[c], min=1e-30)))
        return 1.0 - torch.exp(logsum)

    out = []
    for train_idx in train_idx_per_partition:
        p_hop = np.zeros(V, np.float32)
        if len(train_idx):
            p_hop[train_idx] = minibatch_size / len(train_idx)
        p_hop = torch.as_tensor(p_hop, device=dev)
        p_not = torch.ones(V, dtype=torch.float32, device=dev)
        for fanout in fanouts:
            p_hop = one_hop(p_hop, float(fanout))
            p_not = p_not * (1.0 - p_hop)
        out.append((1.0 - p_not).cpu().numpy())
    return out


def vip_simulation(rowptr: np.ndarray, col: np.ndarray,
                   train_idx_per_partition: Sequence[np.ndarray],
                   minibatch_size: int, fanouts: Sequence[int],
                   num_epochs: int = 2, seed: int = 0) -> List[np.ndarray]:
    """Empirical VIP: run the real sampler and count vertex accesses."""
    from .simulate import simulate_vertex_accesses

    return simulate_vertex_accesses(rowptr, col, train_idx_per_partition,
                                    fanouts, minibatch_size, num_epochs,
                                    seed=seed)


def vip_proxy_degree_reachable(rowptr, col, train_idx_per_partition,
                               num_hops: int) -> List[np.ndarray]:
    """deg(v) if v is within num_hops of the partition's train set else 0."""
    V = len(rowptr) - 1
    deg = vertex_indegrees(rowptr)
    rows = _edge_rows(rowptr)
    out = []
    for train_idx in train_idx_per_partition:
        reach = np.zeros(V, np.int64)
        reach[train_idx] = 1
        for _ in range(num_hops):
            s = np.bincount(rows, weights=reach[col].astype(np.float64),
                            minlength=V)
            reach = (s != 0).astype(np.int64)
        out.append((reach * deg).astype(np.float32))
    return out


def vip_proxy_num_paths_reachable(rowptr, col, train_idx_per_partition,
                                  num_hops: int) -> List[np.ndarray]:
    """Cumulative path counts from the train set."""
    V = len(rowptr) - 1
    rows = _edge_rows(rowptr)
    out = []
    for train_idx in train_idx_per_partition:
        num_paths = np.zeros(V, np.float64)
        num_paths[train_idx] = 1
        for _ in range(num_hops):
            num_paths = num_paths + np.bincount(
                rows, weights=num_paths[col], minlength=V)
        out.append(num_paths.astype(np.float32))
    return out


def vip_proxy_degree_1hop(rowptr, col, train_idx_per_partition
                          ) -> List[np.ndarray]:
    """1-hop halo indicator: the endpoints of the edges whose source row is
    a train vertex."""
    V = len(rowptr) - 1
    rows = _edge_rows(rowptr)
    out = []
    for train_idx in train_idx_per_partition:
        in_train = np.zeros(V, bool)
        in_train[train_idx] = True
        halo = np.zeros(V, bool)
        halo[col[in_train[rows]]] = True
        out.append(halo.astype(np.float32))
    return out


def vip_randomwalk(rowptr, col, train_idx_per_partition,
                   fanouts: Sequence[int]) -> List[np.ndarray]:
    """Random-walk probability accumulation."""
    V = len(rowptr) - 1
    deg = vertex_indegrees(rowptr).astype(np.float64)
    rows = _edge_rows(rowptr)
    with np.errstate(divide="ignore"):
        tw = 1.0 / deg
    tw[~np.isfinite(tw)] = 0.0
    out = []
    for train_idx in train_idx_per_partition:
        p = np.zeros(V, np.float64)
        if len(train_idx):
            p[train_idx] = 1.0 / len(train_idx)
        for _ in range(len(fanouts)):
            p = p + np.bincount(rows, weights=tw[col] * p[col], minlength=V)
        out.append(p.astype(np.float32))
    return out


def argsort_vip(vip_weights_per_partition) -> List[np.ndarray]:
    """Partition-wise vertex ids in descending VIP order (stable)."""
    return [np.argsort(-w, kind="stable") for w in vip_weights_per_partition]


def get_lambda_vip_cache(
    rowptr: np.ndarray, col: np.ndarray,
    partition_ids: np.ndarray, train_idx: np.ndarray,
    fanouts: Sequence[int], minibatch_size: int,
    scheme: str = "vip-analytical",
    actual_vertex_accesses: Optional[List[np.ndarray]] = None,
    num_iter_simulation: int = 2,
    device=None,
) -> Callable[[float], List[np.ndarray]]:
    """λ(replication_factor) → per-partition cached vertex ids. Own-partition
    vertices are zeroed before the argsort, so caches hold only remote
    rows. ``device`` is where ``vip-analytical-device`` runs (None: CUDA);
    the other schemes run on the host."""
    V = len(partition_ids)
    k = int(partition_ids.max()) + 1
    tipp = partitionwise_train_idx(partition_ids, train_idx)

    if scheme == "vip-analytical":
        w = vip_analytical(rowptr, col, tipp, minibatch_size, fanouts)
    elif scheme == "vip-analytical-taylor":
        w = vip_analytical(rowptr, col, tipp, minibatch_size, fanouts,
                           taylor=True)
    elif scheme == "vip-analytical-cascade":
        w = vip_analytical(rowptr, col, tipp, minibatch_size, fanouts,
                           cascade=True)
    elif scheme == "vip-analytical-taylor-cascade":
        w = vip_analytical(rowptr, col, tipp, minibatch_size, fanouts,
                           taylor=True, cascade=True)
    elif scheme == "random-multiwalk":
        # the exact recurrence seeded with 1/|train|
        w = [vip_analytical(rowptr, col, [ti], minibatch_size, fanouts,
                            init_scale=1.0 / max(len(ti), 1))[0]
             for ti in tipp]
    elif scheme == "shuffle":
        # random-permutation baseline
        rng = np.random.default_rng(0)
        w = [rng.random(V).astype(np.float32) for _ in range(k)]
    elif scheme == "vip-analytical-device":
        w = vip_analytical_device(rowptr, col, tipp, minibatch_size, fanouts,
                                  device=device)
    elif scheme == "vip-simulation":
        w = vip_simulation(rowptr, col, tipp, minibatch_size, fanouts,
                           num_iter_simulation)
    elif scheme == "degree-reachable":
        w = vip_proxy_degree_reachable(rowptr, col, tipp, len(fanouts))
    elif scheme == "num-paths-reachable":
        w = vip_proxy_num_paths_reachable(rowptr, col, tipp, len(fanouts))
    elif scheme == "halo-1hop":
        w = vip_proxy_degree_1hop(rowptr, col, tipp)
    elif scheme == "random-walk":
        w = vip_randomwalk(rowptr, col, tipp, fanouts)
    elif scheme == "degree":
        deg = vertex_indegrees(rowptr).astype(np.float32)
        w = [deg.copy() for _ in range(k)]
    elif scheme == "oracle":
        if actual_vertex_accesses is None:
            raise ValueError("the oracle scheme needs actual_vertex_accesses")
        w = [np.array(a, np.float32) for a in actual_vertex_accesses]
    else:
        raise ValueError(f"Invalid caching scheme: {scheme}")

    for p in range(k):
        w[p] = w[p].copy()
        w[p][partition_ids == p] = 0
    order = argsort_vip(w)

    def cached_idx(replication_factor: float) -> List[np.ndarray]:
        size = int(V * replication_factor / k)
        return [order[p][:size].copy() for p in range(k)]

    return cached_idx
