"""The cold-cache policy of ``cold_cache_slots -1`` (counterpart of the JAX
package's ``train/cold_policy.py``).

The device cold-row cache cuts the cold tier's host→device bytes, but it
costs host work per batch; it pays only where the link, not the device,
bounds the run. One measurable signal decides: the link's host→device
credit against the run's projected demand.

Model (every input measurable before the first training step):

- projected no-cache demand at an assumed device-bound rate T edges/s:
      demand = T / edges_per_batch * bytes_per_batch
  where bytes_per_batch = base (indices, labels, mirrors) + cold payload
  (cold_cap rows x row bytes);
- the cache turns HIT rows into zero wire bytes; with a near-uniform cold
  access stream a slot fraction s cuts the cold payload by ~s;
- enable the cache iff demand exceeds the credit; size the slots so the
  residual demand fits inside the credit with margin. On a fast link the
  plan is 0 slots.

``ColdCachePlan`` and ``plan_cold_cache`` are the JAX package's.
``measure_h2d_credit`` differs from it on purpose: it copies from pinned
memory, as the feeder ships, and takes the best of three spaced bursts
(the JAX probe takes one burst from pageable memory).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class ColdCachePlan:
    slots: int                      # 0 = cache off
    projected_demand_mbs: float     # no-cache demand at the assumed rate
    residual_demand_mbs: float      # projected demand with `slots` active
    credit_mbs: float               # the measured link credit used
    reason: str                     # one-line verdict


def plan_cold_cache(credit_mbs: float,
                    chip_rate_eps: float,
                    edges_per_batch: float,
                    base_bytes_per_batch: float,
                    cold_bytes_per_batch: float,
                    cold_tail_rows: int,
                    margin: float = 0.8,
                    align: int = 128) -> ColdCachePlan:
    """Decide cache slots from the measured link credit.

    ``margin`` discounts the credit. ``cold_bytes_per_batch`` is the
    no-cache cold payload (cold_cap x wire row bytes); ``cold_tail_rows``
    the total cold-tail size (the slot-count clamp and the hit-rate
    denominator)."""
    per_batch = base_bytes_per_batch + cold_bytes_per_batch
    batches_per_s = chip_rate_eps / max(edges_per_batch, 1.0)
    demand = batches_per_s * per_batch / 1e6
    budget = credit_mbs * margin
    if demand <= budget or cold_bytes_per_batch <= 0:
        return ColdCachePlan(
            0, round(demand, 1), round(demand, 1), credit_mbs,
            f"no-cache demand {demand:.0f} MB/s fits credit "
            f"{credit_mbs:.0f}x{margin}: the cache would only add host "
            "cost")
    # required cut of the cold payload so residual demand fits budget;
    # hit rate ~= slot fraction (near-uniform residual stream)
    cold_mbs = batches_per_s * cold_bytes_per_batch / 1e6
    base_mbs = demand - cold_mbs
    need_cut = (demand - budget) / max(cold_mbs, 1e-9)
    s = min(1.0, max(0.0, need_cut))
    slots = min(int(cold_tail_rows),
                int(-(-s * cold_tail_rows // align) * align))
    residual = base_mbs + cold_mbs * (1 - slots / max(cold_tail_rows, 1))
    return ColdCachePlan(
        slots, round(demand, 1), round(residual, 1), credit_mbs,
        f"no-cache demand {demand:.0f} MB/s exceeds credit "
        f"{credit_mbs:.0f}x{margin}: link-bound; "
        f"{slots} slots (~{slots / max(cold_tail_rows, 1):.0%} of tail) "
        f"project residual {residual:.0f} MB/s")


_BURSTS, _GAP_S = 3, 0.2


def measure_h2d_credit(device, mb: int = 32) -> Optional[float]:
    """Host→device rate (MB/s) of a ``mb`` MB copy from pinned memory, the
    best of three copies spaced 0.2 s apart, each bracketed by
    ``torch.cuda.synchronize``. None on a CPU device (no link)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    src = torch.randint(0, 255, (mb << 20,), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(7)
                        ).pin_memory()
    dst = torch.empty_like(src, device=device)
    dst[:1 << 20].copy_(src[:1 << 20])  # allocation and handshake
    best = 0.0
    for i in range(_BURSTS):
        if i:
            time.sleep(_GAP_S)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize(device)
        best = max(best, mb / max(time.perf_counter() - t0, 1e-9))
    return best
