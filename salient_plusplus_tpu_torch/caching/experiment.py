"""Communication-volume experiment CLI (counterpart of the JAX package's
``caching/experiment.py``; host only): sweep cache scheme × replication
factor, write the results as JSON, and tabulate them.

Usage:
    python -m salient_plusplus_tpu_torch.caching.experiment <dataset> \
        [--parts K] [--fanouts 15,10,5] [--minibatch 1024] \
        [--schemes vip-analytical,degree] [--epochs 1] [--out results.json]
    python -m salient_plusplus_tpu_torch.caching.experiment --parse results.json
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("dataset", nargs="?", default=None)
    p.add_argument("--dataset_root", default="datasets")
    p.add_argument("--parts", type=int, default=4)
    p.add_argument("--fanouts", default="15,10,5")
    p.add_argument("--minibatch", type=int, default=1024)
    p.add_argument("--schemes",
                   default="vip-analytical,vip-simulation,degree,random-walk")
    p.add_argument("--replication", default="0,0.01,0.05,0.1,0.2,0.5,1.0")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="comm_results.json")
    p.add_argument("--parse", default=None,
                   help="tabulate an existing results file and exit")
    args = p.parse_args(argv)

    from .simulate import tabulate_comm_results

    if args.parse:
        with open(args.parse) as f:
            raw = json.load(f)
        results = {s: {float(a): d for a, d in by.items()}
                   for s, by in raw.items()}
        print(tabulate_comm_results(results))
        return results

    from ..config import RunConfig
    from ..driver import load_full_dataset
    from ..partition import multiconstraint_partition
    from .simulate import run_replication_sweep

    cfg = RunConfig(dataset_root=args.dataset_root)
    graph = load_full_dataset(cfg, args.dataset or "synth:V=50000")
    labels = multiconstraint_partition(graph.rowptr, graph.col, args.parts,
                                       seed=args.seed)
    results = run_replication_sweep(
        graph.rowptr, graph.col, labels, graph.split_idx["train"],
        [int(f) for f in args.fanouts.split(",")], args.minibatch,
        schemes=tuple(args.schemes.split(",")),
        replication_factors=tuple(
            float(a) for a in args.replication.split(",")),
        num_epochs=args.epochs, seed=args.seed)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(tabulate_comm_results(results))
    return results


if __name__ == "__main__":
    main()
