"""Offline partitioning and reordering CLI (counterpart of the JAX
package's ``partition/cli.py``; host only).

Computes a k-way multi-constraint partition, the VIP weights of each
partition's training (unless ``--disable_vip``), and writes the
contiguous-range, VIP-ordered dataset ``<name>-reordered-k{K}`` that the
driver trains from. The files equal the JAX package's.

Usage:
    python -m salient_plusplus_tpu_torch.partition.cli <dataset> --parts 8 \
        [--dataset_root datasets] [--out_root datasets] \
        [--fanouts 15,10,5] [--minibatch 1024] [--disable_vip] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("dataset")
    p.add_argument("--dataset_root", default="datasets")
    p.add_argument("--out_root", default="datasets")
    p.add_argument("--parts", type=int, required=True)
    p.add_argument("--fanouts", default="15,10,5")
    p.add_argument("--minibatch", type=int, default=1024)
    p.add_argument("--disable_vip", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_labels", action="store_true",
                   help="also write <name>-<k>.labels.npy")
    args = p.parse_args(argv)

    from ..caching.vip import partitionwise_train_idx, vip_analytical
    from ..config import RunConfig
    from ..data.reorder import reorder_and_save
    from ..driver import load_full_dataset
    from . import (
        get_4d_node_weights, multiconstraint_partition, partition_quality)

    cfg = RunConfig(dataset_root=args.dataset_root)
    graph = load_full_dataset(cfg, args.dataset)
    w = get_4d_node_weights(graph.num_nodes, graph.rowptr,
                            graph.split_idx["train"],
                            graph.split_idx["valid"])
    labels = multiconstraint_partition(graph.rowptr, graph.col, args.parts,
                                       w, seed=args.seed)
    q = partition_quality(graph.rowptr, graph.col, labels, w)
    print(f"partition quality: {q}")
    if args.save_labels:
        np.save(os.path.join(args.out_root,
                             f"{graph.name}-{args.parts}.labels.npy"),
                labels)

    vip = None
    if not args.disable_vip:
        fanouts = [int(f) for f in args.fanouts.split(",")]
        tipp = partitionwise_train_idx(labels, graph.split_idx["train"])
        per_part = vip_analytical(graph.rowptr, graph.col, tipp,
                                  args.minibatch, fanouts)
        # each partition orders its own vertices by its own weights
        vip = np.zeros(graph.num_nodes, np.float32)
        for part, wp in enumerate(per_part):
            mask = labels == part
            vip[mask] = wp[mask]
    path = reorder_and_save(graph, labels, args.out_root, vip)
    print(f"wrote {path}")
    with open(os.path.join(path, "partition_quality.json"), "w") as f:
        json.dump(q, f)
    return path


if __name__ == "__main__":
    main()
