"""How ``correct`` is decided: the sampled batches held to the graph, and
the numbers that set the program's results beside the plain reference's.

Every number compared is a gap that is 0 when the program and the
reference agree, held to its limit from ``limits/<workload>.json``. The
sampler check counts faults, with the limit 0.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

from .models.common import Sampled


class GraphIndex:
    """The graph's edges as sorted keys ``row * V + col`` on the device, to
    look sampled edges up in."""

    def __init__(self, rowptr, col, device):
        self.V = rowptr.shape[0] - 1
        rp = torch.from_numpy(rowptr).to(device)
        self.deg = torch.diff(rp)
        rows = torch.repeat_interleave(
            torch.arange(self.V, device=device), self.deg)
        self.keys = rows * self.V + torch.from_numpy(col).to(device).long()

    def has(self, keys: torch.Tensor) -> torch.Tensor:
        if self.keys.numel() == 0:
            return torch.zeros_like(keys, dtype=torch.bool)
        pos = torch.searchsorted(self.keys, keys).clamp_(
            max=self.keys.numel() - 1)
        return self.keys[pos] == keys


def sampler_faults(g: GraphIndex, s: Sampled, seeds: torch.Tensor,
                   labels: torch.Tensor) -> int:
    """Faults of one sampled batch against the graph it was sampled from:
    the seeds and their labels; the frontier holds distinct nodes, each
    new one the source of an edge of the hop that found it; every sampled
    edge is an edge of the graph, within its levels, never repeated; each
    target has min(fanout, degree) of them. Tensors on one device."""
    ls, n_id = s.level_sizes, s.n_id
    faults = int(n_id.numel() != ls[-1])
    faults += int(torch.unique(n_id).numel() != n_id.numel())
    ns = ls[0]
    faults += int(not torch.equal(torch.sort(n_id[:ns]).values,
                                  torch.sort(seeds).values))
    faults += int((s.y != labels[n_id[:ns]]).sum())
    for h, (src, dst) in enumerate(s.hops):
        T, N = ls[h], ls[h + 1]
        ok = (src >= 0) & (src < N) & (dst >= 0) & (dst < T)
        faults += int((~ok).sum())
        src, dst = src[ok], dst[ok]
        keys = n_id[dst] * g.V + n_id[src]
        faults += int((~g.has(keys)).sum())
        faults += int(keys.numel() - torch.unique(keys).numel())
        got = torch.bincount(dst, minlength=T)[:T]
        want = g.deg[n_id[:T]]
        f = s.fanouts[h]
        if f >= 0:
            want = want.clamp(max=f)
        faults += int((got != want).sum())
        seen = torch.zeros(N, dtype=torch.bool, device=src.device)
        seen[src] = True
        faults += int((~seen[T:N]).sum())
    return faults


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              leaves: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's | |got| - |want| | over max(|want|, the median leaf's
    |want|), over ``leaves`` (all by default)."""
    names = list(want if leaves is None else leaves)
    gn = {k: float(torch.linalg.vector_norm(got[k].float())) for k in names}
    wn = {k: float(torch.linalg.vector_norm(want[k].float())) for k in names}
    med = float(torch.tensor(list(wn.values())).median())
    return {k: abs(gn[k] - wn[k]) / max(wn[k], med, 1e-30) for k in names}


def leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             leaves: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(got, want, leaves).values())


def widest_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| over ``want``'s rows (``got`` may hold
    padding rows after them)."""
    return float((got[: want.shape[0]].float() - want).abs().max())


def moving_leaves(first_grads: Dict[str, torch.Tensor],
                  share: float = 1e-3) -> list:
    """Leaves whose first gradient in the reference is at least ``share``
    of the median leaf's: the others move under Adam by rounding alone."""
    n = {k: float(torch.linalg.vector_norm(g)) for k, g in
         first_grads.items()}
    med = float(torch.tensor(list(n.values())).median())
    return [k for k, v in n.items() if v >= share * med]


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> dict:
    """Each number beside its limit; a number missing or not finite
    fails."""
    out = {}
    for name, limit in limits.items():
        v = values.get(name)
        ok = v is not None and v == v and abs(v) != float("inf") \
            and v <= limit
        out[name] = {"value": v, "limit": limit, "ok": bool(ok)}
    return out
