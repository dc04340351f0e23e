"""RangePartitionBook: the directory of a contiguous-range partitioned
dataset (counterpart of the JAX package's ``data/partition_book.py``).

The dataset is relabeled so each partition owns a contiguous id range, so
every directory operation is a searchsorted, a subtraction or a range
test. The same object serves numpy arrays (the host sampler's side) and
torch tensors (the device's side): a torch tensor of ids is answered with
torch operations on its own device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class RangePartitionBook:
    part_offsets: np.ndarray  # int [k+1]; partition p owns [off[p], off[p+1])

    @property
    def num_parts(self) -> int:
        return len(self.part_offsets) - 1

    def nid2partid(self, nids):
        """Owning partition of each id, in the ids' dtype."""
        if isinstance(nids, torch.Tensor):
            # torch.searchsorted wants both operands in one dtype
            offs = torch.as_tensor(np.asarray(self.part_offsets, np.int64),
                                   device=nids.device)
            return torch.searchsorted(offs[1:], nids.to(torch.int64),
                                      right=True).to(nids.dtype)
        return np.searchsorted(self.part_offsets[1:], nids, side="right"
                               ).astype(nids.dtype if hasattr(nids, "dtype")
                                        else np.int32)

    def nid2localnid(self, nids, part_id: int):
        return nids - int(self.part_offsets[part_id])

    def nid_is_local(self, nids, part_id: int):
        lo, hi = (int(self.part_offsets[part_id]),
                  int(self.part_offsets[part_id + 1]))
        return (nids >= lo) & (nids < hi)

    def partid2nids(self, part_id: int, device=None):
        """The ids partition ``part_id`` owns: numpy, or a torch tensor on
        ``device`` when one is given."""
        lo, hi = (int(self.part_offsets[part_id]),
                  int(self.part_offsets[part_id + 1]))
        if device is not None:
            return torch.arange(lo, hi, dtype=torch.int64, device=device)
        return np.arange(lo, hi, dtype=np.int64)

    def part_sizes(self) -> np.ndarray:
        return np.diff(self.part_offsets)
