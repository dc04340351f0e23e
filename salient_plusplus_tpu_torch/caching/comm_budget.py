"""Feature-communication budget of the exchange (counterpart of the JAX
package's ``caching/comm_budget.py``; host only).

Per step each rank sends ``world · r_cap`` ids (4 B) and receives
``world · r_cap`` rows (``wire_row_bytes`` each): ``parallel/exchange.py``
builds exactly these buffers, so the wire volume is a fixed shape, not a
statistic. VIP caching shrinks it through the cache-aware ``r_cap``.

    comm_share = wire_bytes_per_step / link_rate / step_time

The link rates are NVIDIA's published peaks (data sheets), not
measurements, and the port assumes the exchange reaches them with no
overlap with compute; a real all_to_all reaches less than the peak, so a
share computed here is a lower bound on the time the wire takes. The
default step time is the port's own measured SAGE step at the bench shape
(``chip_smoke.py`` phase 5).

The CLI measures the post-cache ``r_cap`` on a real or synthetic graph
and prints a JSON budget table.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

# published peak rates, bytes/s each way
LINK_RATES = {
    # NVLink 4 on an H100 SXM: 900 GB/s in total, 450 GB/s each way
    "nvlink": 450e9,
    # one 400 Gb/s NDR InfiniBand NIC
    "nic": 50e9,
}
# the port's SAGE step at the bench shape (batch 1024, fanouts 15,10,5,
# hidden 256, 1M-node power-law graph): 13.96 ms, chip_smoke.py phase 5 on
# an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 5)
STEP_TIME_S = 13.96e-3


@dataclass
class BudgetRow:
    alpha: float            # replication factor (fraction of V/k cached)
    r_cap: int              # post-cache per-destination request budget
    wire_bytes_per_step: int
    comm_share_nvlink: float  # fraction of step time at LINK_RATES["nvlink"]
    comm_share_nic: float     # fraction of step time at LINK_RATES["nic"]
    sim_cross_per_batch: float  # simulator-predicted remote fetches/batch


def wire_bytes_per_step(world: int, r_cap: int, num_features: int,
                        row_bytes: Optional[int] = None,
                        wire_fp8: bool = False) -> int:
    """Wire volume of one training step on one rank: the id request
    all_to_all ([world, r_cap] int32) plus the row response all_to_all
    ([world, r_cap, F], bf16, or fp8 with a float32 row scale)."""
    if row_bytes is None:
        row_bytes = (num_features + 4) if wire_fp8 else 2 * num_features
    return world * r_cap * (4 + row_bytes)


def comm_share(wire_bytes: int, step_time_s: float,
               link_bytes_per_s: float) -> float:
    """Fraction of the step spent moving the exchange payload, assuming no
    overlap with compute."""
    return (wire_bytes / link_bytes_per_s) / step_time_s


def measure_budget(
    graph,
    partition_labels: np.ndarray,
    alphas: Sequence[float] = (0.0, 0.01, 0.05, 0.10),
    fanouts: Sequence[int] = (15, 10, 5),
    batch_size: int = 1024,
    step_time_s: float = STEP_TIME_S,
    seed: int = 0,
    scheme: str = "vip-analytical",
    link_rates: Dict[str, float] = LINK_RATES,
) -> List[BudgetRow]:
    """The post-cache ``r_cap`` at each replication factor, without
    devices: probe-sample batches, classify the remote frontier ids against
    the α-sized VIP cache, take the worst per-destination count × 1.3
    rounded up to 128 (the trainer's calibration rule), and cross-check
    against the comm-volume simulator. ``link_rates`` needs the keys
    "nvlink" and "nic"."""
    from .simulate import (
        evaluate_communication_volume, simulate_vertex_accesses)
    from .vip import get_lambda_vip_cache, partitionwise_train_idx
    from ..data.reorder import reorder_graph
    from ..sampling.cpp import NativeSampler
    from ..train.loop import calibrate_spec

    world = int(partition_labels.max()) + 1
    pg, _, _ = reorder_graph(graph, partition_labels, equal_shards=True)
    native = NativeSampler(np.asarray(pg.rowptr, np.int64),
                           np.asarray(pg.col, np.int32))
    offs = np.asarray(pg.part_offsets, np.int64)
    pids = np.searchsorted(offs[1:], np.arange(pg.num_nodes),
                           side="right").astype(np.int32)
    train = pg.split_idx["train"]
    spec = calibrate_spec(native, train, batch_size, list(fanouts),
                          num_batches=8, seed=seed)
    lam = get_lambda_vip_cache(pg.rowptr, pg.col, pids, train,
                               list(fanouts), batch_size * world,
                               scheme=scheme)
    rng = np.random.default_rng(seed + 5)
    probes = []
    for i in range(8):
        take = min(spec.seed_cap, len(train))
        seeds = np.sort(rng.choice(train, take, replace=False))
        b = native.sample(spec, seeds, rng_seed=50 + i)
        probes.append(b.n_id[: int(b.level_sizes[-1])].numpy())

    # simulator cross-check: per-epoch vertex accesses are α-independent,
    # classified per α against the same cache the exchange would use
    tipp = partitionwise_train_idx(pids, train)
    accesses = simulate_vertex_accesses(pg.rowptr, pg.col, tipp,
                                        list(fanouts), batch_size,
                                        seed=seed)
    n_batches = sum(max(1, -(-len(t) // batch_size)) for t in tipp)

    rows = []
    # the response ships rows padded to 128 features, as the trainers pad
    # the table (data/dataset.pad_feature_dim)
    F = int(-(-pg.num_features // 128) * 128)
    for alpha in alphas:
        cached = lam(alpha) if alpha > 0 else [
            np.zeros(0, np.int64) for _ in range(world)]
        num = min(len(c) for c in cached)
        cache_sets = [np.sort(np.asarray(c[:num], np.int64))
                      for c in cached]
        worst = 128
        for ids in probes:
            owner = np.searchsorted(offs[1:], ids, side="right")
            for d in range(world):
                remote = owner != d
                if num:
                    pos = np.searchsorted(cache_sets[d], ids)
                    pos = np.clip(pos, 0, num - 1)
                    remote &= cache_sets[d][pos] != ids
                cnt = np.bincount(owner[remote], minlength=world)
                cnt[d] = 0
                worst = max(worst, int(cnt.max()))
        r_cap = int(-(-int(worst * 1.3) // 128) * 128)
        wb = wire_bytes_per_step(world, r_cap, F)
        vol = evaluate_communication_volume(
            accesses, pids, cache_sets if num else None)
        rows.append(BudgetRow(
            alpha=float(alpha), r_cap=r_cap, wire_bytes_per_step=wb,
            comm_share_nvlink=round(comm_share(
                wb, step_time_s, link_rates["nvlink"]), 6),
            comm_share_nic=round(comm_share(
                wb, step_time_s, link_rates["nic"]), 6),
            sim_cross_per_batch=round(vol["cross"] / n_batches, 1),
        ))
    return rows


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="feature-communication budget of the exchange")
    ap.add_argument("dataset", help="synth:... or powerlaw:... spec, or a "
                    "dataset directory name")
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--alphas", default="0,0.01,0.05,0.1")
    ap.add_argument("--fanouts", default="15,10,5")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--step_ms", type=float, default=STEP_TIME_S * 1e3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from ..config import RunConfig
    from ..driver import load_full_dataset
    from ..partition import multiconstraint_partition

    if args.dataset.startswith("powerlaw:"):
        from ..data import synthetic

        kv = dict(p.split("=") for p in args.dataset[9:].split(",") if p)
        g = synthetic.powerlaw_graph(
            name="powerlaw-budget", num_nodes=int(kv.get("V", 1_000_000)),
            avg_degree=int(kv.get("deg", 15)),
            num_features=int(kv.get("F", 100)),
            num_classes=int(kv.get("C", 47)), seed=int(kv.get("seed", 0)))
    else:
        g = load_full_dataset(RunConfig(), args.dataset)
    labels = multiconstraint_partition(g.rowptr, g.col, args.parts, seed=0)
    rows = measure_budget(
        g, labels,
        alphas=[float(a) for a in args.alphas.split(",")],
        fanouts=[int(f) for f in args.fanouts.split(",")],
        batch_size=args.batch, step_time_s=args.step_ms * 1e-3)
    out = {"dataset": args.dataset, "world": args.parts,
           "batch": args.batch, "step_ms": args.step_ms,
           "num_features": int(-(-g.num_features // 128) * 128),
           "num_nodes": int(g.num_nodes), "num_edges": int(g.num_edges),
           "rows": [asdict(r) for r in rows]}
    s = json.dumps(out, indent=2)
    print(s)
    if args.out:
        with open(args.out, "w") as f:
            f.write(s)
    return out


if __name__ == "__main__":
    main()
