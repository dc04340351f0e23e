"""OGB and MAG240 ingest (counterpart of the JAX package's ``data/ogb.py``;
needs the ``ogb`` package and its download).

The reference's FastDataset.from_ogb preprocessing (driver/dataset.py:
29-142): a symmetrized CSR, fp16 row-major features, int labels and the
split index arrays, written in the port's on-disk format
(``GraphData.save``), which is the JAX package's. Without ``ogb`` use a
synthetic graph, a converted dataset directory, or
``salient_plusplus_tpu_torch.data.salient_import`` to convert a
SALIENT++-format dataset.
"""

from __future__ import annotations

import os

import numpy as np

from .dataset import GraphData, symmetrize_csr


def _coo_to_csr(src: np.ndarray, dst: np.ndarray, V: int):
    """COO edge list → CSR at ingest scale (MAG240 has 1.3G directed
    edges): degrees by ``bincount`` and one stable argsort. Returns
    (int64 rowptr, int32 col) sorted by source."""
    rowptr = np.zeros(V + 1, np.int64)
    rowptr[1:] = np.bincount(src, minlength=V)
    np.cumsum(rowptr, out=rowptr)
    order = np.argsort(src, kind="stable")
    return rowptr, dst[order].astype(np.int32)


def load_ogb(name: str, root: str, cache: bool = True) -> GraphData:
    """An ``ogbn-*`` node property dataset, converted and (with ``cache``)
    saved under ``root`` as ``name`` with dashes turned to underscores."""
    try:
        from ogb.nodeproppred import NodePropPredDataset
    except ImportError as e:
        raise ImportError(
            "OGB ingest requires the 'ogb' package (not installed in this "
            "environment). Use a synthetic dataset ('synth:V=...'), a "
            "pre-converted dataset directory, or "
            "salient_plusplus_tpu_torch.data.salient_import to convert a "
            "SALIENT++-format dataset.") from e

    ds = NodePropPredDataset(name=name, root=os.path.join(root, "_ogb_raw"))
    split = ds.get_idx_split()
    g, labels = ds[0]
    V = g["num_nodes"]
    src = g["edge_index"][0].astype(np.int64)
    dst = g["edge_index"][1].astype(np.int64)
    rowptr, col = _coo_to_csr(src, dst, V)
    rowptr, col = symmetrize_csr(rowptr, col, V)

    x = np.ascontiguousarray(g["node_feat"], dtype=np.float16)
    y = np.nan_to_num(labels.reshape(-1), nan=-1).astype(np.int32)
    out = GraphData(
        name=name.replace("-", "_"),
        rowptr=rowptr, col=col, x=x, y=y,
        split_idx={k: np.asarray(v, np.int64).reshape(-1)
                   for k, v in split.items()},
        num_classes=int(y.max()) + 1,
    )
    out.validate()
    if cache:
        out.save(root)
    return out


def import_mag240(edge_index: np.ndarray, x: np.ndarray, y: np.ndarray,
                  split_idx: dict, num_classes: int = 153) -> GraphData:
    """Pre-extracted MAG240 arrays in the port's format.

    The reference's FastDataset.import_mag240 (driver/dataset.py:43-57):
    the homogeneous paper-cites-paper component of MAG240M, fp16 row-major
    features, float labels with NaN → -1 then int, a symmetrized CSR.
    Takes arrays rather than the ``ogb.lsc`` dataset, so any offline
    extraction of the LSC data (and a test's fixture) can use it.
    """
    src = np.asarray(edge_index[0], np.int64)
    dst = np.asarray(edge_index[1], np.int64)
    V = int(x.shape[0])
    rowptr, col = _coo_to_csr(src, dst, V)
    rowptr, col = symmetrize_csr(rowptr, col, V)

    y = np.asarray(y).reshape(-1)
    if np.issubdtype(y.dtype, np.floating):
        y = np.nan_to_num(y, nan=-1.0)
    y = y.astype(np.int32)
    out = GraphData(
        name="MAG240",
        rowptr=rowptr, col=col,
        x=np.ascontiguousarray(x, dtype=np.float16), y=y,
        split_idx={k: np.asarray(v, np.int64).reshape(-1)
                   for k, v in split_idx.items()},
        num_classes=num_classes,
    )
    out.validate()
    return out


def load_mag240(root: str, cache: bool = True) -> GraphData:
    """MAG240M (LSC), its paper-citation component; needs ``ogb`` and the
    LSC download. MAG240M's test-dev labels are hidden, so, as in the
    reference's distribution, the back half of ``valid`` is held out as
    ``test``."""
    try:
        from ogb.lsc import MAG240MDataset
    except ImportError as e:
        raise ImportError(
            "MAG240 ingest requires the 'ogb' package (not installed in "
            "this environment). Use import_mag240 with pre-extracted "
            "arrays, a synthetic dataset, or "
            "salient_plusplus_tpu_torch.data.salient_import.") from e

    ds = MAG240MDataset(root=os.path.join(root, "_ogb_raw"))
    edge_index = ds.edge_index("paper", "cites", "paper")
    x = ds.paper_feat          # memory-mapped float16 [num_papers, 768]
    y = ds.paper_label         # float, NaN where unlabeled
    train = np.asarray(ds.get_idx_split("train"), np.int64)
    valid = np.asarray(ds.get_idx_split("valid"), np.int64)
    split = {"train": train, "valid": valid[: len(valid) // 2],
             "test": valid[len(valid) // 2:]}
    out = import_mag240(edge_index, np.asarray(x), y, split,
                        num_classes=int(ds.num_classes))
    if cache:
        out.save(root)
    return out
