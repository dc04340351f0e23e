"""The model zoo (counterpart of the JAX package's ``models/modules.py``).

All eight models of the JAX package's zoo: SAGE, SAGEClassic, GIN, JKNet,
SAGEResInception, GAT, GCN and ARMA.

Call convention: ``model(x, batch, training=..., generator=...)`` (plus
``features=`` for the models whose layer 0 can read the table: SAGE,
SAGEClassic, GIN) returns float32 log-probabilities [seed_cap,
num_classes]; only rows < batch.seed_count are valid. ``training`` turns
dropout on and ``generator`` draws its masks. BatchNorm follows the
module's mode: ``model.train()`` takes batch statistics and updates the
running ones, ``model.eval()`` reads them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..sampling.batch import PaddedBatch
from .layers import (
    ARMAConv, GATConv, GCNConv, GINConv, MLP, MaskedBatchNorm, SAGEConv,
    _lecun_dense, dropout,
)


def _check_layers(model, batch: PaddedBatch) -> int:
    L = batch.num_layers
    if L != model.num_layers:
        raise ValueError(f"batch has {L} hops, model {model.num_layers}")
    return L


class _GNNBase(nn.Module):
    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, num_layers: int, dropout: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.in_features = in_features
        self.hidden_features = hidden_features
        self.out_features = out_features
        self.num_layers = num_layers
        self.dropout = dropout
        self.dtype = dtype

    def _final(self, x: torch.Tensor, batch: PaddedBatch) -> torch.Tensor:
        """Slice to seed rows, float32 log_softmax."""
        out = x[: batch.spec.seed_cap].to(torch.float32)
        return torch.log_softmax(out, dim=-1)


def _layer0_inputs(x, batch: PaddedBatch, features, out_cap, dtype):
    """(msg_source, edge) for layer 0.

    With ``features`` (the device table) and ``batch.gsrc`` present, layer
    0 aggregates straight from the global table via global src ids, so the
    trainer gathers only the level-(L-1) prefix of the frontier. Raw
    features carry no gradient, so this hop needs no mirror."""
    e0 = batch.edges[0]
    if features is not None and batch.gsrc is not None:
        f = features if features.dtype == dtype else features.to(dtype)
        return f, e0
    return x, e0


class SAGE(_GNNBase):
    """3-layer default GraphSAGE, bias-free convs."""

    use_bias = False

    def __init__(self, *args, generator: Optional[torch.Generator] = None,
                 **kw):
        super().__init__(*args, **kw)
        L = self.num_layers
        for i in range(L):
            fin = self.in_features if i == 0 else self.hidden_features
            fout = self.out_features if i == L - 1 else self.hidden_features
            # named conv{i}, as the flax params are (weights.py)
            self.add_module(f"conv{i}", SAGEConv(
                fin, fout, use_bias=self.use_bias, dtype=self.dtype,
                generator=generator))

    def forward(self, x, batch: PaddedBatch, training: bool = False,
                features=None, generator: Optional[torch.Generator] = None):
        x = x.to(self.dtype)
        L = _check_layers(self, batch)
        for i in range(L):
            _, out_cap = batch.layer_caps(i)
            x_target = x[:out_cap]
            if i == 0:
                x, edge = _layer0_inputs(x, batch, features, out_cap,
                                         self.dtype)
            else:
                edge = batch.edges[i]
            x = getattr(self, f"conv{i}")(x, x_target, edge, out_cap)
            if i != L - 1:
                x = torch.relu(x)
                x = dropout(x, self.dropout, training, generator)
        return self._final(x, batch)


class SAGEClassic(SAGE):
    """SAGE with default-bias convs."""

    use_bias = True


class GIN(_GNNBase):
    """GIN with 2-layer BN MLPs per conv + 2-layer head."""

    def __init__(self, *args, generator: Optional[torch.Generator] = None,
                 **kw):
        super().__init__(*args, **kw)
        H = self.hidden_features
        for i in range(self.num_layers):
            self.add_module(f"conv{i}", GINConv(
                self.in_features if i == 0 else H, H, dtype=self.dtype,
                generator=generator))
        self.lin1 = _lecun_dense(H, H, self.dtype, generator)
        self.lin2 = _lecun_dense(H, self.out_features, self.dtype, generator)

    def forward(self, x, batch: PaddedBatch, training: bool = False,
                features=None, generator: Optional[torch.Generator] = None):
        x = x.to(self.dtype)
        L = _check_layers(self, batch)
        for i in range(L):
            _, out_cap = batch.layer_caps(i)
            x_target = x[:out_cap]
            if i == 0:
                x, edge = _layer0_inputs(x, batch, features, out_cap,
                                         self.dtype)
            else:
                edge = batch.edges[i]
            x = getattr(self, f"conv{i}")(x, x_target, edge, out_cap,
                                          batch.level_sizes[L - i - 1])
        x = torch.relu(self.lin1(x))
        x = dropout(x, self.dropout, training, generator)
        return self._final(self.lin2(x), batch)


class JKNet(_GNNBase):
    """Jumping-knowledge net, max-pool mode."""

    def __init__(self, *args, generator: Optional[torch.Generator] = None,
                 **kw):
        super().__init__(*args, **kw)
        H = self.hidden_features
        for i in range(self.num_layers):
            self.add_module(f"conv{i}", SAGEConv(
                self.in_features if i == 0 else H, H, use_bias=False,
                dtype=self.dtype, generator=generator))
            self.add_module(f"bn{i}", MaskedBatchNorm(H, self.dtype))
        self.lin = _lecun_dense(H, self.out_features, self.dtype, generator)

    def forward(self, x, batch: PaddedBatch, training: bool = False,
                generator: Optional[torch.Generator] = None):
        x = x.to(self.dtype)
        L = _check_layers(self, batch)
        end_cap = batch.spec.node_caps[0]
        xs = []
        for i in range(L):
            _, out_cap = batch.layer_caps(i)
            x = getattr(self, f"conv{i}")(x, x[:out_cap], batch.edges[i],
                                          out_cap)
            x = getattr(self, f"bn{i}")(x, batch.level_sizes[L - i - 1])
            x = dropout(torch.relu(x), self.dropout, training, generator)
            xs.append(x[:end_cap])
        x = torch.stack(xs).amax(0)   # JK 'max' mode
        return self._final(self.lin(x), batch)


class SAGEResInception(_GNNBase):
    """Residual + inception SAGE with BN and an MLP head over concatenated
    per-hop outputs. Dropout 0.1 throughout; the first residual is a
    Linear(in→hidden), later ones identity; the head is MLP(in + hidden·L
    → 2·out → out) of plain Linears (end_up_with_fc)."""

    inner_dropout = 0.1

    def __init__(self, *args, generator: Optional[torch.Generator] = None,
                 **kw):
        super().__init__(*args, **kw)
        H, L = self.hidden_features, self.num_layers
        for i in range(L):
            self.add_module(f"conv{i}", SAGEConv(
                self.in_features if i == 0 else H, H, use_bias=False,
                dtype=self.dtype, generator=generator))
            self.add_module(f"bn{i}", MaskedBatchNorm(H, self.dtype))
        self.res0 = _lecun_dense(self.in_features, H, self.dtype, generator)
        self.mlp = MLP(self.in_features + H * L, 2 * self.out_features,
                       self.out_features, 2, act="leakyrelu", bn=True,
                       end_up_with_fc=True, dtype=self.dtype,
                       generator=generator)

    def forward(self, x, batch: PaddedBatch, training: bool = False,
                generator: Optional[torch.Generator] = None):
        x = x.to(self.dtype)
        L = _check_layers(self, batch)
        end_cap = batch.spec.node_caps[0]

        def drop(v):
            return dropout(v, self.inner_dropout, training, generator)

        x = drop(x)
        collect = [x[:end_cap]]
        for i in range(L):
            _, out_cap = batch.layer_caps(i)
            x_target = x[:out_cap]
            h = getattr(self, f"conv{i}")(drop(x), drop(x_target),
                                          batch.edges[i], out_cap)
            h = getattr(self, f"bn{i}")(h, batch.level_sizes[L - i - 1])
            h = drop(F.leaky_relu(h, 0.01))
            collect.append(h[:end_cap])
            x = h + (self.res0(x_target) if i == 0 else x_target)
        out = self.mlp(torch.cat(collect, dim=-1), batch.level_sizes[0])
        return self._final(out, batch)


class GAT(_GNNBase):
    """Single-head GAT, bias-free convs."""

    def __init__(self, *args, generator: Optional[torch.Generator] = None,
                 **kw):
        super().__init__(*args, **kw)
        L = self.num_layers
        for i in range(L):
            fin = self.in_features if i == 0 else self.hidden_features
            fout = self.out_features if i == L - 1 else self.hidden_features
            self.add_module(f"conv{i}", GATConv(fin, fout, heads=1,
                                                dtype=self.dtype,
                                                generator=generator))

    def forward(self, x, batch: PaddedBatch, training: bool = False,
                generator: Optional[torch.Generator] = None):
        x = x.to(self.dtype)
        L = _check_layers(self, batch)
        for i in range(L):
            _, out_cap = batch.layer_caps(i)
            x = getattr(self, f"conv{i}")(x, x[:out_cap], batch.edges[i],
                                          out_cap)
            if i != L - 1:
                x = dropout(torch.relu(x), self.dropout, training, generator)
        return self._final(x, batch)


class GCN(_GNNBase):
    """GCN with normalize=False, bias-free convs and masked BN between
    layers. As in the reference (which passes the full x), each conv's
    output keeps the input row count, zero above ``out_cap``; BN sees the
    in-level's valid rows. A conv reads only the rows of its hop's input
    level, so the mirrored backward drops the mirror's pads (msrc = that
    level's cap) instead of adding them into the row past it."""

    def __init__(self, *args, generator: Optional[torch.Generator] = None,
                 **kw):
        super().__init__(*args, **kw)
        L = self.num_layers
        for i in range(L):
            fin = self.in_features if i == 0 else self.hidden_features
            fout = self.out_features if i == L - 1 else self.hidden_features
            self.add_module(f"conv{i}", GCNConv(fin, fout, dtype=self.dtype,
                                                generator=generator))
            if i != L - 1:
                self.add_module(f"bn{i}", MaskedBatchNorm(fout, self.dtype))

    def forward(self, x, batch: PaddedBatch, training: bool = False,
                generator: Optional[torch.Generator] = None):
        x = x.to(self.dtype)
        L = _check_layers(self, batch)
        for i in range(L):
            in_cap, out_cap = batch.layer_caps(i)
            h = getattr(self, f"conv{i}")(x[:in_cap], batch.edges[i],
                                          out_cap)
            x = torch.cat([h, h.new_zeros(in_cap - out_cap, h.shape[1])])
            if i != L - 1:
                x = getattr(self, f"bn{i}")(x, batch.level_sizes[L - i])
                x = dropout(torch.relu(x), self.dropout, training, generator)
        return self._final(x, batch)


class ARMA(_GNNBase):
    """ARMA_1 stack (flagged broken in the reference; provided for API
    parity, as in the JAX package). The last conv keeps the hidden width,
    as the reference's does, so the log-softmax runs over ``hidden``
    columns."""

    def __init__(self, *args, generator: Optional[torch.Generator] = None,
                 **kw):
        super().__init__(*args, **kw)
        H = self.hidden_features
        for i in range(self.num_layers):
            self.add_module(f"conv{i}", ARMAConv(
                self.in_features if i == 0 else H, H, dropout=self.dropout,
                dtype=self.dtype, generator=generator))

    def forward(self, x, batch: PaddedBatch, training: bool = False,
                generator: Optional[torch.Generator] = None):
        x = x.to(self.dtype)
        L = _check_layers(self, batch)
        for i in range(L):
            _, out_cap = batch.layer_caps(i)
            x = getattr(self, f"conv{i}")(x, batch.edges[i], out_cap,
                                          training, generator)
            if i != L - 1:
                x = dropout(torch.relu(x), self.dropout, training, generator)
        return self._final(x, batch)


MODEL_REGISTRY = {"SAGE": SAGE, "SAGEClassic": SAGEClassic, "GIN": GIN,
                  "JKNet": JKNet, "SAGEResInception": SAGEResInception,
                  "GAT": GAT, "GCN": GCN, "ARMA": ARMA}


def make_model(name: str, in_features: int, hidden_features: int,
               out_features: int, num_layers: int, dropout: float = 0.5,
               dtype: torch.dtype = torch.bfloat16,
               generator: Optional[torch.Generator] = None) -> nn.Module:
    """Build a model of the zoo on the CPU with float32 parameters;
    ``generator`` draws the initial weights."""
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {name!r}")
    return MODEL_REGISTRY[name](in_features, hidden_features, out_features,
                                num_layers, dropout=dropout, dtype=dtype,
                                generator=generator)
