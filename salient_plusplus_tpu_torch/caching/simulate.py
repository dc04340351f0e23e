"""Communication-volume simulation: the distributed accounting without a
cluster (counterpart of the JAX package's ``caching/simulate.py``; host
only).

Each partition's sampler runs in one process, its vertex accesses are
counted, and the accounting identity

    total == internal + cross + cache_hits

is the oracle every cache strategy is evaluated against. The port's
native sampler, seeds and calibration are the JAX package's, so both
count the same accesses.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..sampling.batch import BatchSpec
from ..sampling.cpp import NativeSampler
from ..sampling.sampler import batch_seed, split_seeds


def simulate_vertex_accesses(
    rowptr: np.ndarray, col: np.ndarray,
    train_idx_per_partition: Sequence[np.ndarray],
    fanouts: Sequence[int], minibatch_size: int, num_epochs: int = 1,
    seed: int = 0, spec: Optional[BatchSpec] = None,
) -> List[np.ndarray]:
    """Run the real sampler over each partition's seed set; count each
    vertex's accesses an epoch."""
    V = len(rowptr) - 1
    native = NativeSampler(np.asarray(rowptr, np.int64),
                           np.asarray(col, np.int32))
    if spec is None:
        from ..train.loop import calibrate_spec

        pool = np.concatenate([t for t in train_idx_per_partition if len(t)])
        spec = calibrate_spec(native, pool, minibatch_size, list(fanouts),
                              num_batches=6, safety=1.5, seed=seed)

    def _run(run_spec):
        accesses = []
        dropped = 0
        rng = np.random.default_rng(seed)
        for part, train_idx in enumerate(train_idx_per_partition):
            acc = np.zeros(V, np.int64)
            for epoch in range(num_epochs):
                perm = rng.permutation(len(train_idx))
                for bno, seeds in enumerate(
                        split_seeds(train_idx[perm], minibatch_size)):
                    b = native.sample(run_spec, np.asarray(seeds),
                                      rng_seed=batch_seed(seed, epoch, bno))
                    dropped += int(b.overflow[0]) + int(b.overflow[1])
                    n = int(b.level_sizes[-1])
                    np.add.at(acc, b.n_id[:n].numpy(), 1)
            accesses.append(acc / max(num_epochs, 1))
        return accesses, dropped

    # never count on truncated batches: a spec overflow drops vertices and
    # under-reports cross traffic, so grow the caps and run again
    for _ in range(4):
        accesses, dropped = _run(spec)
        if not dropped:
            break
        spec = spec.grown()
    else:
        warnings.warn(
            f"simulate_vertex_accesses: {dropped} accesses still dropped "
            "after 3 spec growths; volumes are a lower bound", stacklevel=2)
    return accesses


def evaluate_communication_volume(
    vertex_accesses_per_partition: Sequence[np.ndarray],
    partition_ids: np.ndarray,
    cached_idx_per_partition: Optional[Sequence[np.ndarray]] = None,
) -> Dict[str, int]:
    """Classify vertex accesses into internal / cross / cache_hits; the
    three must add up to every access."""
    k = len(vertex_accesses_per_partition)
    # accumulate in float (epoch-averaged accesses are fractional for
    # num_epochs > 1); a per-bucket int() would break the identity
    internal = cross = hits = 0.0
    for part in range(k):
        acc = np.asarray(vertex_accesses_per_partition[part], np.float64)
        local_mask = partition_ids == part
        cache_mask = np.zeros_like(local_mask)
        if cached_idx_per_partition is not None:
            cache_mask[np.asarray(cached_idx_per_partition[part],
                                  np.int64)] = True
        i = float(acc[local_mask].sum())
        c = float(acc[~local_mask & ~cache_mask].sum())
        h = float(acc[~local_mask & cache_mask].sum())
        if not np.isclose(float(acc.sum()), i + c + h):
            raise AssertionError(
                f"partition {part}: accesses {acc.sum()} != internal {i} + "
                f"cross {c} + cache_hits {h}")
        internal += i
        cross += c
        hits += h
    out = {"internal": int(round(internal)), "cross": int(round(cross)),
           "cache_hits": int(round(hits))}
    out["total"] = out["internal"] + out["cross"] + out["cache_hits"]
    return out


def run_replication_sweep(
    rowptr, col, partition_ids, train_idx, fanouts, minibatch_size,
    schemes: Sequence[str] = ("vip-analytical", "degree", "random-walk"),
    replication_factors: Sequence[float] = (0.0, 0.01, 0.05, 0.1, 0.2),
    num_epochs: int = 1, seed: int = 0,
) -> Dict[str, Dict[float, Dict[str, int]]]:
    """Scheme × replication-factor communication-volume sweep."""
    from .vip import get_lambda_vip_cache, partitionwise_train_idx

    tipp = partitionwise_train_idx(partition_ids, train_idx)
    accesses = simulate_vertex_accesses(rowptr, col, tipp, fanouts,
                                        minibatch_size, num_epochs, seed)
    results: Dict[str, Dict[float, Dict[str, int]]] = {}
    for scheme in schemes:
        lam = get_lambda_vip_cache(rowptr, col, partition_ids, train_idx,
                                   fanouts, minibatch_size, scheme=scheme,
                                   actual_vertex_accesses=accesses)
        results[scheme] = {}
        for alpha in replication_factors:
            cached = lam(alpha) if alpha > 0 else None
            results[scheme][alpha] = evaluate_communication_volume(
                accesses, partition_ids, cached)
    return results


def tabulate_comm_results(results) -> str:
    """Human-readable sweep table."""
    lines = [f"{'scheme':22s} {'alpha':>6s} {'total':>12s} {'internal':>12s} "
             f"{'cross':>12s} {'cache_hits':>12s} {'cross%':>7s}"]
    for scheme, by_alpha in results.items():
        for alpha, d in by_alpha.items():
            pct = 100.0 * d["cross"] / max(d["total"], 1)
            lines.append(
                f"{scheme:22s} {alpha:6.2f} {d['total']:12d} "
                f"{d['internal']:12d} {d['cross']:12d} "
                f"{d['cache_hits']:12d} {pct:6.2f}%")
    return "\n".join(lines)
