"""Layer-wise full-graph inference (counterpart of the JAX package's
``models/inference.py``).

Every node's representation is computed one layer at a time from *all*
its edges, instead of per-seed multi-hop sampling. Each chunk of seeds
``[s, s + chunk)`` is one native-sampler full expansion (fanout -1); its
frontier rows are gathered from the previous layer's embeddings with the
row-gather kernel (K3), the layer core aggregates them through the
no-mirror hop (the fused gather + segment-sum kernel, K2), and the chunk's
rows are written into the next layer's embedding matrix.

Served here: SAGE, SAGEClassic, GIN, JKNet, SAGEResInception, GAT, GCN
and GATSkip (each layer's conv plus its skip projection of the chunk's own
rows, the last conv's heads averaged, as its forward has them).
BatchNorm layers run off the trained running statistics (the model is put
in ``eval()`` mode). GAT's chunk hop has no mirror: its message sum is the
sorted segment-sum kernel (K1); GCN's is K2, as every other model's. ARMA
is broken in the reference itself and raises, as in the JAX package. The
functions take the port's model, not flax params.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.segment import gather_rows
from ..sampling.batch import BatchSpec, EdgeBlock
from ..sampling.cpp import BatchBuffers, NativeSampler
from .modules import MODELS

# not served layerwise by the JAX package either: the trainer scores it
# batchwise
UNSERVED = ("ARMA",)
SUPPORTED = tuple(m for m in MODELS if m not in UNSERVED)


def _chunk_spec(rowptr: np.ndarray, chunk: int, align: int = 128) -> BatchSpec:
    """Static caps for 1-hop full-expansion chunks: the worst chunk's total
    degree bounds the edge cap; frontier ≤ chunk + edges."""
    V = len(rowptr) - 1
    deg = np.diff(rowptr)
    worst_edges = 0
    for s in range(0, V, chunk):
        worst_edges = max(worst_edges, int(deg[s:s + chunk].sum()))
    e_cap = int(-(-worst_edges // align) * align) + align
    n_cap = int(-(-(chunk + worst_edges) // align) * align) + align
    return BatchSpec((-1,), chunk, (chunk, n_cap), (e_cap,))


class LocalEngine:
    """Single-device chunked full-expansion propagation."""

    def __init__(self, graph_rowptr, graph_col, chunk: int,
                 device: torch.device):
        self.V = len(graph_rowptr) - 1
        self.native = NativeSampler(np.asarray(graph_rowptr, np.int64),
                                    np.asarray(graph_col, np.int32))
        self.spec = _chunk_spec(np.asarray(graph_rowptr), chunk)
        self.chunk_size = chunk
        self.device = torch.device(device)
        self.bufs = BatchBuffers(self.spec)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        # a pinned copy: the sampler buffers are rewritten by the next
        # chunk while this one's copy may still be in flight. No copy
        # waits for the device, so the host samples the next chunk while
        # the card works on this one
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def chunk(self, s: int):
        """(n_id, edge, n) of the chunk of seeds ``[s, s + n)`` on the
        device: its full 1-hop expansion, seeds first in n_id."""
        b = self.bufs
        n = min(self.chunk_size, self.V - s)
        self.native.sample_into(b, np.arange(s, s + n, dtype=np.int64),
                                rng_seed=1)
        if b.overflow.any():
            raise RuntimeError(f"chunk at {s} overflowed its caps "
                               f"{self.spec}: {b.overflow.tolist()}")
        # only the real frontier and edges are shipped: every n_id is then
        # a node id (the sampler zero-fills the pads) and dst is sorted
        n_front, n_edges = int(b.level_sizes[1]), int(b.edge_counts[0])
        edge = EdgeBlock(
            src=self._to_device(b.edge_src[:n_edges]),
            dst=self._to_device(b.edge_dst[:n_edges]),
            count=self._to_device(np.array(n_edges, np.int32)))
        return self._to_device(b.n_id[:n_front]), edge, n

    def propagate(self, core, emb: torch.Tensor, feat_out: int
                  ) -> torch.Tensor:
        """One full-graph layer: ``core(x, edge, n)`` maps the gathered
        frontier rows ``x`` of a chunk of ``n`` seeds (its first ``n``
        rows) and the chunk's hop to the seeds' ``n`` output rows, written
        to ``out[s:s + n]`` of a [V, feat_out] matrix in ``emb.dtype``."""
        out = torch.empty(self.V, feat_out, dtype=emb.dtype,
                          device=emb.device)
        for s in range(0, self.V, self.chunk_size):
            n_id, edge, n = self.chunk(s)
            x = gather_rows(emb, n_id)
            out[s:s + n] = core(x, edge, n).to(out.dtype)
        return out


def layerwise_inference(model_name: str, model: nn.Module, graph_rowptr,
                        graph_col, x_all: torch.Tensor, chunk: int = 4096
                        ) -> torch.Tensor:
    """Final-layer log-probabilities [V, C] (float32) for every node of the
    graph, on ``x_all``'s device, from the port's trained ``model``."""
    eng = LocalEngine(graph_rowptr, graph_col, chunk, x_all.device)
    return run_layerwise_zoo(model_name, model, x_all, eng)


def _finish(x: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(x.to(torch.float32), dim=-1)


@torch.no_grad()
def run_layerwise_zoo(model_name: str, model: nn.Module,
                      x_all: torch.Tensor, eng) -> torch.Tensor:
    """Model-zoo dispatch for layerwise inference over a propagation
    engine (``eng.propagate`` runs one full-graph layer). The model runs in
    ``eval()`` mode and is put back in its mode afterwards."""
    if model_name in UNSERVED:
        raise NotImplementedError(
            f"layerwise inference not implemented for {model_name} "
            "(ARMA is broken in the reference itself, driver/main.py:93)")
    if model_name not in SUPPORTED:
        raise ValueError(f"unknown model {model_name!r}")
    was_training = model.training
    model.eval()
    try:
        return _zoo(model_name, model, x_all, eng)
    finally:
        model.train(was_training)


def _zoo(model_name, model, x_all, eng):
    L = model.num_layers
    propagate = eng.propagate
    convs = [getattr(model, f"conv{i}") for i in range(L)]
    emb = x_all

    if model_name in ("SAGE", "SAGEClassic", "GAT"):
        for i, conv in enumerate(convs):
            def core(x, edge, n, conv=conv, last=i == L - 1):
                h = conv(x, x[:n], edge, n)
                return h if last else torch.relu(h)

            emb = propagate(core, emb, conv.out_features)
        return _finish(emb)

    if model_name == "GATSkip":
        for i, conv in enumerate(convs):
            def core(x, edge, n, conv=conv, skip=getattr(model, f"skip{i}"),
                     last=i == L - 1):
                h = conv(x, x[:n], edge, n) + skip(x[:n])
                return h if last else F.elu(h)

            emb = propagate(core, emb, conv.out_features)
        return _finish(emb)

    if model_name == "GCN":
        for i, conv in enumerate(convs):
            bn = None if i == L - 1 else getattr(model, f"bn{i}")

            def core(x, edge, n, conv=conv, bn=bn):
                h = conv(x, edge, n)
                return h if bn is None else torch.relu(bn(h))

            emb = propagate(core, emb, conv.out_features)
        return _finish(emb)

    if model_name == "GIN":
        for conv in convs:
            def core(x, edge, n, conv=conv):
                return conv(x, x[:n], edge, n)

            emb = propagate(core, emb, conv.out_features)
        return _finish(model.lin2(torch.relu(model.lin1(emb))))

    bns = [getattr(model, f"bn{i}") for i in range(L)]
    if model_name == "JKNet":
        pooled = None  # JK 'max' mode as a running maximum: O(V·H)
        for conv, bn in zip(convs, bns):
            def core(x, edge, n, conv=conv, bn=bn):
                return torch.relu(bn(conv(x, x[:n], edge, n)))

            emb = propagate(core, emb, conv.out_features)
            pooled = emb if pooled is None else torch.maximum(pooled, emb)
        return _finish(model.lin(pooled))

    # SAGEResInception
    emb = x_all.to(model.dtype)
    collect = [emb]
    for i, (conv, bn) in enumerate(zip(convs, bns)):
        def core(x, edge, n, conv=conv, bn=bn):
            return F.leaky_relu(bn(conv(x, x[:n], edge, n)), 0.01)

        h_all = propagate(core, emb, conv.out_features)
        collect.append(h_all)
        emb = h_all + (model.res0(emb) if i == 0 else emb)
    return _finish(model.mlp(torch.cat(collect, dim=-1)))
