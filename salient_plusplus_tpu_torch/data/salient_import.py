"""Convert a SALIENT++ on-disk dataset into the port's format (counterpart
of the JAX package's ``data/salient_import.py``).

The reference stores datasets as directories of ``.pt`` tensors
(rowptr.pt, col.pt, x.pt, y.pt, split_idx_*.pt: driver/dataset.py:85-142;
partitioned directories add part_offsets.pt and one x{rank}.pt a rank,
:184-215). A user moving from SALIENT++ converts once with this module;
the output is the on-disk format that both packages read.
"""

from __future__ import annotations

import os

import numpy as np

from .dataset import SPLIT_NAMES, GraphData, PartitionedGraphData


def _load_pt(path):
    """A ``.pt`` file as numpy (a tensor) or as saved (dicts of tensors and
    plain values; ``weights_only`` refuses anything else)."""
    import torch

    t = torch.load(path, map_location="cpu", weights_only=True)
    return t.numpy() if hasattr(t, "numpy") else t


def import_salient_dataset(src_dir: str, name: str, out_root: str
                           ) -> GraphData:
    """Convert an unpartitioned SALIENT(++) FastDataset directory and save
    it under ``out_root`` as ``name``."""
    def p(f):
        return os.path.join(src_dir, f)

    rowptr = _load_pt(p("rowptr.pt")).astype(np.int64)
    col = _load_pt(p("col.pt")).astype(np.int32)
    x = np.ascontiguousarray(_load_pt(p("x.pt")))
    y = np.nan_to_num(_load_pt(p("y.pt")).reshape(-1), nan=-1).astype(np.int32)
    split_idx = {}
    for s in SPLIT_NAMES:
        for cand in (f"split_idx_{s}.pt", f"{s}_idx.pt"):
            if os.path.exists(p(cand)):
                split_idx[s] = _load_pt(p(cand)).astype(np.int64)
                break
        else:
            raise FileNotFoundError(f"missing split file for '{s}' in {src_dir}")
    g = GraphData(name=name, rowptr=rowptr, col=col, x=x, y=y,
                  split_idx=split_idx, num_classes=int(y.max()) + 1)
    g.validate()
    g.save(out_root)
    return g


def import_salient_partitioned(src_dir: str, name: str, out_root: str):
    """Convert a SALIENT++ DisjointPartFeatReorderedDataset directory (the
    per-field ``.pt`` files of reformat_and_save / reorder_and_save,
    driver/dataset.py:223-268, 270-369: rowptr/col/y, the split_idx and
    split_idx_parts dicts, part_offsets, the x{rank}.pt shards, meta_info)
    into the partitioned on-disk format
    (``PartitionedGraphData.save_partitioned``). Returns the saved path."""
    def p(f):
        return os.path.join(src_dir, f)

    def as_np(v, dtype=None):
        a = v.numpy() if hasattr(v, "numpy") else np.asarray(v)
        return a.astype(dtype) if dtype is not None else a

    num_parts = int(_load_pt(p("num_parts.pt")))
    rowptr = as_np(_load_pt(p("rowptr.pt")), np.int64)
    col = as_np(_load_pt(p("col.pt")), np.int32)
    y = np.nan_to_num(as_np(_load_pt(p("y.pt"))).reshape(-1),
                      nan=-1).astype(np.int32)
    part_offsets = as_np(_load_pt(p("part_offsets.pt")), np.int64)
    split_idx = {s: as_np(v, np.int64)
                 for s, v in _load_pt(p("split_idx.pt")).items()}
    split_idx_parts = {
        int(r): {s: as_np(v, np.int64) for s, v in d.items()}
        for r, d in _load_pt(p("split_idx_parts.pt")).items()
    }
    meta = _load_pt(p("meta_info.pt"))
    num_classes = int(meta.get("num classes", int(y.max()) + 1))
    x_shards = [np.ascontiguousarray(as_np(_load_pt(p(f"x{r}.pt"))))
                for r in range(num_parts)]
    pg = PartitionedGraphData(
        name=name, rowptr=rowptr, col=col, x=x_shards[0], y=y,
        split_idx=split_idx, num_classes=num_classes, rank=0,
        num_parts=num_parts, part_offsets=part_offsets,
        split_idx_parts=split_idx_parts)
    return pg.save_partitioned(out_root, x_shards)
