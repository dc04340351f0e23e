"""Timing and region statistics (the JAX package's ``utils/timing.py``).

Region timing is wall-clock on the host; a region that must include device
work passes ``sync`` (e.g. ``torch.cuda.synchronize``), called before the
region closes. Per-epoch aggregation skips the first (warm-up) epoch.
"""

from __future__ import annotations

import statistics
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional


class Timer:
    """Context-manager wall timer (the reference's fast_trainer/utils.py:
    381-404). ``callback(name, seconds)`` is called when the block ends."""

    def __init__(self, name: str = "", callback: Optional[Callable] = None):
        self.name = name
        self.callback = callback
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.callback:
            self.callback(self.name, self.elapsed)
        return False

    def stop(self) -> float:
        self.elapsed = time.perf_counter() - self._t0
        return self.elapsed


class RuntimeStats:
    """Named-region epoch statistics with first-epoch exclusion."""

    def __init__(self, skip_first_epoch: bool = True):
        self.skip_first_epoch = skip_first_epoch
        self.epoch_region_totals: List[Dict[str, float]] = []
        self._current: Dict[str, float] = defaultdict(float)
        self.enabled = True

    @contextmanager
    def region(self, name: str, sync=None):
        """Time a region; ``sync`` (e.g. torch.cuda.synchronize) is
        called before closing the region so device work is included."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                sync()
            self._current[name] += time.perf_counter() - t0

    def add(self, name: str, dur: float):
        if self.enabled:
            self._current[name] += dur

    def end_epoch(self):
        self.epoch_region_totals.append(dict(self._current))
        self._current = defaultdict(float)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """mean/stdev per region over epochs (first excluded if >1 epoch)."""
        rows = self.epoch_region_totals
        if self.skip_first_epoch and len(rows) > 1:
            rows = rows[1:]
        names = sorted({k for r in rows for k in r})
        out = {}
        for n in names:
            vals = [r.get(n, 0.0) for r in rows]
            out[n] = {
                "mean": statistics.fmean(vals) if vals else 0.0,
                "stdev": statistics.stdev(vals) if len(vals) > 1 else 0.0,
            }
        return out

    def report(self) -> str:
        lines = [f"{'region':24s} {'mean(s)':>10s} {'stdev':>10s}"]
        for n, s in self.summary().items():
            lines.append(f"{n:24s} {s['mean']:10.4f} {s['stdev']:10.4f}")
        return "\n".join(lines)
