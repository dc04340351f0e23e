"""DataCollector: npz dumps of per-epoch batch data for offline analysis
(counterpart of the JAX package's ``utils/data_collector.py``), laid out
as ``collected_data_<timestamp>/epoch<N>/rank<r>_<name>.npz``. Disabled
unless enabled explicitly."""

from __future__ import annotations

import os
import time
from typing import Any, Optional

import numpy as np
import torch


def _np(v: Any) -> np.ndarray:
    """A tensor (on any device), a list of them, or array-like, as numpy."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, (list, tuple)) and v and isinstance(v[0], torch.Tensor):
        return torch.stack([t.detach().cpu() for t in v]).numpy()
    return np.asarray(v)


class DataCollector:
    def __init__(self, root: str = ".", rank: int = 0, enabled: bool = False,
                 tag: Optional[str] = None):
        self.enabled = enabled
        self.rank = rank
        self.epoch = 0
        if enabled:
            tag = tag or time.strftime("%Y%m%d_%H%M%S")
            self.dir = os.path.join(root, f"collected_data_{tag}")
            os.makedirs(self.dir, exist_ok=True)

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if self.enabled:
            os.makedirs(os.path.join(self.dir, f"epoch{epoch}"),
                        exist_ok=True)

    def collect(self, name: str, **arrays: Any):
        """Write ``arrays`` (device tensors are read back) to one npz."""
        if not self.enabled:
            return
        path = os.path.join(self.dir, f"epoch{self.epoch}",
                            f"rank{self.rank}_{name}.npz")
        np.savez_compressed(path, **{k: _np(v) for k, v in arrays.items()})
