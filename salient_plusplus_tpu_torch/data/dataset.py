"""On-disk graph dataset layer (numpy; counterpart of the JAX package's
``data/dataset.py``).

A graph is a directory of .npy arrays plus meta.json. The graph structure is
a symmetrized CSR (int64 rowptr, int32 col); features are row-major float16
on disk; splits are int64 index arrays. The format is the JAX package's, so
either package loads what the other saved.

A partitioned dataset (k disjoint vertex partitions, relabeled so each owns
a contiguous id range, ``data/reorder.py``) stores the graph structure once
and one feature shard ``x{p}.npy`` per partition, so a rank loads only its
own rows.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

SPLIT_NAMES = ("train", "valid", "test")


def pad_feature_dim(x: np.ndarray, align: int = 128) -> np.ndarray:
    """Zero-pad the feature dimension to a multiple of ``align``.

    The JAX package pads to the TPU's 128 lanes and infers layer 0's
    weight shape from the padded table; the port pads the same way so the
    layer-0 weights have one shape in both packages and carry across 1:1.
    Zero columns are accuracy-neutral.
    """
    pad = (-x.shape[1]) % align
    if pad == 0:
        return x
    return np.pad(np.asarray(x), ((0, 0), (0, pad)))


@dataclass
class GraphData:
    """A full (unpartitioned) graph dataset resident in host memory."""

    name: str
    rowptr: np.ndarray          # int64 [V+1]
    col: np.ndarray             # int32 [E]
    x: np.ndarray               # float16/float32 [V, F] row-major
    y: np.ndarray               # int32 [V] (-1 for unlabeled)
    split_idx: Dict[str, np.ndarray]   # int64 index arrays
    num_classes: int

    @property
    def num_nodes(self) -> int:
        return self.rowptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return int(self.col.shape[0])

    @property
    def num_features(self) -> int:
        return int(self.x.shape[1])

    def degrees(self) -> np.ndarray:
        return np.diff(self.rowptr)

    def validate(self) -> None:
        V = self.num_nodes
        if not (self.rowptr[0] == 0 and self.rowptr[-1] == self.num_edges):
            raise ValueError("rowptr does not span col")
        if not np.all(np.diff(self.rowptr) >= 0):
            raise ValueError("rowptr is not nondecreasing")
        if self.col.dtype != np.int32:
            raise ValueError(f"col dtype {self.col.dtype}, expected int32")
        if self.x.shape[0] != V or self.y.shape[0] != V:
            raise ValueError("x/y row count differs from the node count")
        if self.num_edges and not (0 <= self.col.min()
                                   and self.col.max() < V):
            raise ValueError("col holds ids outside [0, V)")

    # --- on-disk format -------------------------------------------------
    def save(self, root: str) -> str:
        path = os.path.join(root, self.name)
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "rowptr.npy"), self.rowptr)
        np.save(os.path.join(path, "col.npy"), self.col)
        np.save(os.path.join(path, "x.npy"), self.x)
        np.save(os.path.join(path, "y.npy"), self.y)
        for s in SPLIT_NAMES:
            np.save(os.path.join(path, f"split_{s}.npy"), self.split_idx[s])
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"name": self.name, "num_classes": self.num_classes}, f)
        return path

    @classmethod
    def load(cls, root: str, name: str, mmap: bool = True) -> "GraphData":
        path = os.path.join(root, name)
        mode = "r" if mmap else None
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return cls(
            name=meta["name"],
            rowptr=np.load(os.path.join(path, "rowptr.npy"), mmap_mode=mode),
            col=np.load(os.path.join(path, "col.npy"), mmap_mode=mode),
            x=np.load(os.path.join(path, "x.npy"), mmap_mode=mode),
            y=np.load(os.path.join(path, "y.npy"), mmap_mode=mode),
            split_idx={
                s: np.load(os.path.join(path, f"split_{s}.npy"))
                for s in SPLIT_NAMES
            },
            num_classes=meta["num_classes"],
        )

    def get_num_iterations(self, global_minibatch_size: int) -> Dict[str, int]:
        """Global iteration count per split: ceil(split size / global
        minibatch), at least 1. Every rank must run the same number of
        steps an epoch, or the collectives deadlock."""
        return {
            s: max(1, -(-len(self.split_idx[s]) // global_minibatch_size))
            for s in SPLIT_NAMES
        }


@dataclass
class PartitionedGraphData(GraphData):
    """Contiguous-range partitioned dataset; each rank holds one x-shard.

    Partition p owns the ids [part_offsets[p], part_offsets[p+1]); within a
    partition the ids run by descending VIP weight, so the hot rows form a
    prefix. ``x`` is only this rank's shard.
    """

    rank: int = 0
    num_parts: int = 1
    part_offsets: np.ndarray = field(
        default_factory=lambda: np.zeros(2, np.int64))
    split_idx_parts: Optional[Dict[int, Dict[str, np.ndarray]]] = None

    @property
    def local_offset(self) -> int:
        return int(self.part_offsets[self.rank])

    @property
    def num_local_nodes(self) -> int:
        return int(self.part_offsets[self.rank + 1]
                   - self.part_offsets[self.rank])

    def save_partitioned(self, root: str, x_shards) -> str:
        """Save the shared structure once and every partition's shard."""
        path = os.path.join(root, self.name)
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "rowptr.npy"), self.rowptr)
        np.save(os.path.join(path, "col.npy"), self.col)
        np.save(os.path.join(path, "y.npy"), self.y)
        np.save(os.path.join(path, "part_offsets.npy"), self.part_offsets)
        for s in SPLIT_NAMES:
            np.save(os.path.join(path, f"split_{s}.npy"), self.split_idx[s])
        for p, xs in enumerate(x_shards):
            np.save(os.path.join(path, f"x{p}.npy"), xs)
        for p, splits in (self.split_idx_parts or {}).items():
            for s, idx in splits.items():
                np.save(os.path.join(path, f"split_{s}_part{p}.npy"), idx)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(
                {
                    "name": self.name,
                    "num_classes": self.num_classes,
                    "num_parts": self.num_parts,
                    "num_features": int(x_shards[0].shape[1]),
                },
                f,
            )
        return path

    @classmethod
    def load_partitioned(cls, root: str, name: str, rank: int,
                         mmap: bool = True) -> "PartitionedGraphData":
        path = os.path.join(root, name)
        mode = "r" if mmap else None
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        k = meta["num_parts"]
        split_idx_parts = {}
        for p in range(k):
            sp = {}
            for s in SPLIT_NAMES:
                f_ = os.path.join(path, f"split_{s}_part{p}.npy")
                if os.path.exists(f_):
                    sp[s] = np.load(f_)
            if sp:
                split_idx_parts[p] = sp
        return cls(
            name=meta["name"],
            rowptr=np.load(os.path.join(path, "rowptr.npy"), mmap_mode=mode),
            col=np.load(os.path.join(path, "col.npy"), mmap_mode=mode),
            x=np.load(os.path.join(path, f"x{rank}.npy"), mmap_mode=mode),
            y=np.load(os.path.join(path, "y.npy"), mmap_mode=mode),
            split_idx={
                s: np.load(os.path.join(path, f"split_{s}.npy"))
                for s in SPLIT_NAMES
            },
            num_classes=meta["num_classes"],
            rank=rank,
            num_parts=k,
            part_offsets=np.load(os.path.join(path, "part_offsets.npy")),
            split_idx_parts=split_idx_parts or None,
        )


def symmetrize_csr(rowptr: np.ndarray, col: np.ndarray, num_nodes: int):
    """Return the CSR of the symmetrized simple graph (dedup, both dirs).
    O(E log E) via sort-unique on packed keys."""
    src = np.repeat(np.arange(num_nodes, dtype=np.int64), np.diff(rowptr))
    dst = col.astype(np.int64)
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    keep = u != v  # drop self-loops
    u, v = u[keep], v[keep]
    keys = u * num_nodes + v
    keys = np.unique(keys)
    u = (keys // num_nodes).astype(np.int64)
    v = (keys % num_nodes).astype(np.int32)
    new_rowptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.add.at(new_rowptr, u + 1, 1)
    np.cumsum(new_rowptr, out=new_rowptr)
    return new_rowptr, v
