"""Layerwise full-graph inference sharded by rank (counterpart of the JAX
package's ``train/dist_inference.py``).

Each rank computes the next layer's rows of its own contiguous id range,
chunk by chunk: a chunk's full 1-hop expansion is sampled on the host, its
frontier rows of the previous layer are assembled through the feature
exchange (``parallel/exchange.py``; remote rows from their owners), and
the model's layer core maps them to the chunk's rows. Every layer stays
sharded, O(V/k) rows a device. It needs every partition's rows on its
device (hbm_fraction 1); the trainer scores batchwise otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.inference import LocalEngine, run_layerwise_zoo
from ..parallel.exchange import assemble_features
from ..sampling.batch import BatchSpec
from ..sampling.cpp import BatchBuffers, NativeSampler


class ShardedEngine(LocalEngine):
    """``run_layerwise_zoo``'s propagation engine over the trainer's group.

    The caps are exact, not probed: chunks are fixed id ranges, so the
    worst chunk's edge count and the most remote neighbours one chunk
    asks of one owner are computed up front over every partition (so
    every rank computes the same caps) and no chunk can overflow. Each
    rank runs the same number of chunks (the partitions have one size),
    so the exchange's collectives line up across the group.
    """

    def __init__(self, trainer, chunk: int = 2048, align: int = 128):
        if trainer.hot_size is not None:
            raise ValueError("sharded layerwise inference needs every "
                             "partition's rows on its device")
        self.tr = trainer
        S = trainer.part_size
        chunk = int(min(chunk, S))
        rowptr = np.asarray(trainer.pg.rowptr)
        col = np.asarray(trainer.pg.col)
        offs = trainer.part_offsets
        deg = np.diff(rowptr)
        worst_e, worst_r = 0, align
        for d in range(trainer.world):
            lo, hi = int(offs[d]), int(offs[d + 1])
            for s in range(lo, hi, chunk):
                e = min(s + chunk, hi)
                worst_e = max(worst_e, int(deg[s:e].sum()))
                nb = np.unique(col[rowptr[s]:rowptr[e]])
                owner = np.searchsorted(offs[1:], nb, side="right")
                rem = owner != d
                if rem.any():
                    worst_r = max(worst_r, int(np.bincount(
                        owner[rem], minlength=trainer.world).max()))

        def al(v):
            return int(-(-v // align) * align)

        self.r_cap = al(worst_r)
        self.spec = BatchSpec((-1,), chunk, (chunk, al(chunk + worst_e)
                                             + align), (al(worst_e) + align,))
        self.native = NativeSampler(np.asarray(rowptr, np.int64),
                                    np.asarray(col, np.int32))
        self.chunk_size = chunk
        self.device = trainer.device
        self.bufs = BatchBuffers(self.spec)
        self.lo = int(offs[trainer.rank])
        # LocalEngine.chunk samples the seeds [s, min(s + chunk, V)): here
        # V is the end of this rank's id range
        self.V = self.lo + S

    def propagate(self, core, emb: torch.Tensor, feat_out: int
                  ) -> torch.Tensor:
        """One exact layer of this rank's rows: ``emb`` is its [S, F]
        shard of the previous layer, the result its [S, feat_out] shard
        in ``emb.dtype``."""
        tr = self.tr
        out = torch.empty(tr.part_size, feat_out, dtype=emb.dtype,
                          device=emb.device)
        for s in range(self.lo, self.V, self.chunk_size):
            n_id, edge, n = self.chunk(s)
            x, _ = assemble_features(emb, n_id, n_id.shape[0],
                                     tr.part_offsets_dev, self.r_cap,
                                     group=tr.group)
            out[s - self.lo:s - self.lo + n] = core(x, edge, n).to(out.dtype)
        return out


def layerwise_inference_spmd(trainer, chunk: int = 2048) -> torch.Tensor:
    """Exact final-layer log-probabilities (float32) of this rank's rows,
    [S, C], from the trainer's model; the rows of rank r are the global
    ids ``[part_offsets[r], part_offsets[r + 1])``."""
    eng = ShardedEngine(trainer, chunk=chunk)
    return run_layerwise_zoo(trainer.cfg.model_name, trainer.state.model,
                             trainer.features, eng)
