"""The seeded graph every cell runs on, made on the device from ``--seed``.

A frozen part of the yardstick: later changes to the program do not move
it. It follows the program's ``data/synthetic.py::powerlaw_graph`` in
spirit (a heavy-tailed, symmetrised CSR with random features, labels and
splits) but is vectorised and runs on the card, so a graph at
ogbn-products' published sizes takes seconds instead of minutes.

Model (Chung-Lu): node ``v`` has weight ``(rank(v) + offset) ** -a``,
ranks a random permutation of the ids; each undirected edge draws both
ends by weight. Self-loops and repeats are dropped and more edges drawn
until there are exactly ``num_undirected_edges``; a random subset cuts any
excess. ``offset`` is solved so that the heaviest node's expected degree
is ``max_expected_degree``. Every edge is stored both ways, each CSR row
sorted by neighbour id.

Features are standard normal, rounded to float16 (the on-disk format of
the program's datasets); labels are uniform over the classes; the splits
are a random partition of the ids with the published sizes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch


@dataclass
class SeededGraph:
    """Host arrays in the program's dataset layout."""

    rowptr: np.ndarray          # int64 [V + 1]
    col: np.ndarray             # int32 [E], rows sorted
    x: np.ndarray               # float16 [V, F]
    y: np.ndarray               # int32 [V]
    split_idx: Dict[str, np.ndarray]
    num_classes: int

    @property
    def num_nodes(self) -> int:
        return self.rowptr.shape[0] - 1


def _offset_for(V: int, a: float, two_m: float, max_deg: float,
                device) -> float:
    """The rank offset at which the heaviest node's expected degree
    ``two_m * w0 / sum(w)`` equals ``max_deg`` (bisection; the ratio falls
    as the offset grows)."""
    r = torch.arange(V, dtype=torch.float64, device=device)
    lo, hi = 0.0, float(V)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        w = (r + mid).pow(-a)
        if float(two_m * w[0] / w.sum()) > max_deg:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def generator(seed: int, device) -> torch.Generator:
    """The device generator of ``seed`` (any whole number)."""
    return torch.Generator(device=device).manual_seed(
        int(seed) % (2**63 - 1))


def make_graph(spec: dict, seed: int, device) -> SeededGraph:
    """The graph of a configuration's ``graph`` group for ``seed``."""
    V = int(spec["num_nodes"])
    M = int(spec["num_undirected_edges"])
    F = int(spec["num_features"])
    C = int(spec["num_classes"])
    a = float(spec["degree_exponent"])
    g = generator(seed, device)
    off = _offset_for(V, a, 2.0 * M, float(spec["max_expected_degree"]),
                      device)
    rank = torch.randperm(V, generator=g, device=device)
    w = (rank.to(torch.float64) + off).pow(-a)
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    del w, rank

    keys = torch.empty(0, dtype=torch.int64, device=device)
    while keys.numel() < M:
        n = int((M - keys.numel()) * 1.1) + 1024
        ends = torch.searchsorted(
            cdf, torch.rand(2, n, generator=g, device=device,
                            dtype=torch.float64)).clamp_(max=V - 1)
        u, v = ends[0], ends[1]
        keep = u != v
        lo = torch.minimum(u, v)[keep]
        hi = torch.maximum(u, v)[keep]
        keys = torch.unique(torch.cat([keys, lo * V + hi]))
    if keys.numel() > M:
        pick = torch.randperm(keys.numel(), generator=g, device=device)[:M]
        keys = keys[pick]
    del cdf
    lo, hi = keys // V, keys % V
    del keys
    directed = torch.sort(torch.cat([lo * V + hi, hi * V + lo])).values
    del lo, hi
    row = directed // V
    col = (directed % V).to(torch.int32)
    del directed
    deg = torch.bincount(row, minlength=V)
    del row
    rowptr = torch.zeros(V + 1, dtype=torch.int64, device=device)
    torch.cumsum(deg, 0, out=rowptr[1:])

    x = torch.randn(V, F, generator=g, device=device).to(torch.float16)
    y = torch.randint(0, C, (V,), generator=g, device=device,
                      dtype=torch.int32)
    perm = torch.randperm(V, generator=g, device=device)
    sizes = spec["split"]
    n_tr, n_va = int(sizes["train"]), int(sizes["valid"])
    if n_tr + n_va + int(sizes["test"]) != V:
        raise ValueError(f"split sizes {sizes} do not add up to {V} nodes")
    split = {"train": perm[:n_tr], "valid": perm[n_tr:n_tr + n_va],
             "test": perm[n_tr + n_va:]}
    split_idx = {k: torch.sort(v).values.cpu().numpy().astype(np.int64)
                 for k, v in split.items()}
    return SeededGraph(rowptr=rowptr.cpu().numpy(), col=col.cpu().numpy(),
                       x=x.cpu().numpy(), y=y.cpu().numpy(),
                       split_idx=split_idx, num_classes=C)
