"""Host-managed device-resident cold-row cache (host cold tier, gsrc
mode); a copy of the JAX package's ``sampling/cold_cache.py``.

The slack region of the device feature table (rows [hot_cutoff,
hot_cutoff + slots)) becomes a persistent cache of cold rows. The host
keeps the id→slot map and decides placement; per batch only the MISS rows
ride host→device, hit rows are already resident. Cold frontier ids are
remapped to ``hot_cutoff + slot`` by the sampler's gsrc rewrite, so the
step reads one table through one gather.

Why the host owns the policy: eviction must never touch a slot that an
in-flight batch still references. Assignment runs serially in batch
CONSUMPTION order (FastSamplerIter.__next__), and the device runs the
per-batch slack writes in stream order on the compute stream, so a slot
evicted for batch k+1 is rewritten only after batch k's step has read it.

Eviction is clock/round-robin over slots, skipping slots the current
batch hits (evicting a same-batch hit would corrupt it).
"""

from __future__ import annotations

import numpy as np


class HostColdCache:
    """id→slot map over the cold id space [0, num_cold_ids), ``slots``
    device rows. Slot values returned by :meth:`assign` are final: the
    caller ships miss rows to exactly those slots before the batch's step
    runs. -1 marks a dropped id (no slot available / over the per-batch
    miss budget): the caller points it at the permanent zero row and
    counts it like a dropped cold row."""

    def __init__(self, num_cold_ids: int, slots: int):
        if slots <= 0:
            raise ValueError(f"slots={slots}: must be positive")
        self.num_cold_ids = int(num_cold_ids)
        self.slots = int(min(slots, num_cold_ids))
        self.slot_of = np.full(self.num_cold_ids, -1, np.int32)
        self.id_at = np.full(self.slots, -1, np.int64)
        self.clock = 0
        self.hits = 0
        self.misses = 0
        self.dropped = 0

    def grow(self, slots: int):
        """Extend the slot space (between epochs only: callers guarantee
        no in-flight batches). Existing assignments keep their slots."""
        slots = int(min(slots, self.num_cold_ids))
        if slots <= self.slots:
            return
        self.id_at = np.concatenate(
            [self.id_at, np.full(slots - self.slots, -1, np.int64)])
        self.slots = slots

    def reset_epoch_stats(self):
        out = (self.hits, self.misses, self.dropped)
        self.hits = self.misses = self.dropped = 0
        return out

    def assign(self, cold_ids: np.ndarray, max_new: int):
        """Slots for this batch's unique cold ids (order = frontier order).

        Returns (slot int32 [n] with -1 for dropped, miss bool [n]: True
        where the row must be shipped this batch). At most ``max_new``
        misses get fresh slots (the miss-buffer budget); hits never
        evict, and eviction skips this batch's hit slots.
        """
        n = len(cold_ids)
        slot = self.slot_of[cold_ids].copy()
        miss = slot < 0
        nm = int(miss.sum())
        self.hits += n - nm
        take = min(nm, max_new)
        if take:
            # clock-ordered candidate slots, skipping this batch's hits
            blocked = np.zeros(self.slots, bool)
            hs = slot[~miss]
            blocked[hs[hs >= 0]] = True
            order = np.concatenate([np.arange(self.clock, self.slots),
                                    np.arange(0, self.clock)])
            avail = order[~blocked[order]][:take]
            take = len(avail)
            if take:
                self.clock = int((avail[-1] + 1) % self.slots)
                evicted = self.id_at[avail]
                live = evicted >= 0
                self.slot_of[evicted[live]] = -1
                midx = np.flatnonzero(miss)[:take]
                ids_new = cold_ids[midx]
                self.id_at[avail] = ids_new
                self.slot_of[ids_new] = avail
                slot[midx] = avail
        shipped = min(nm, take)
        self.misses += shipped
        self.dropped += nm - shipped
        # entries still -1 are dropped; miss marks only the shipped ones
        miss = miss & (slot >= 0)
        return slot, miss


def miss_rung(count: int, top: int, rungs: int = 5, align: int = 128) -> int:
    """Smallest bucket ≥ count from a /2 ladder below ``top`` (a few
    miss-buffer sizes, so a batch ships little more than its misses).
    Returns ``top`` when count exceeds every smaller rung."""
    sizes = [max(align, -(-int(top >> k) // align) * align)
             for k in range(rungs - 1, -1, -1)]
    for s in sizes:
        if count <= s:
            return s
    return max(top, align)
