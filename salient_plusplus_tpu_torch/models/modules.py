"""The model zoo (counterpart of the JAX package's ``models/modules.py``).

All eight models of the JAX package's zoo: SAGE, SAGEClassic, GIN, JKNet,
SAGEResInception, GAT, GCN and ARMA (``MODEL_REGISTRY``), and the port's
own GATSkip, PyG's ogbn-products GAT; ``make_model`` builds any of them
(``MODELS``).

Call convention: ``model(x, batch, training=..., generator=...)`` (plus
``features=`` for the models whose layer 0 can read the table) returns
float32 log-probabilities [seed_cap, num_classes]; only rows <
batch.seed_count are valid. ``training`` turns dropout on and
``generator`` draws its masks. BatchNorm follows the module's mode:
``model.train()`` takes batch statistics and updates the running ones,
``model.eval()`` reads them.

Each class declares beside its ``forward`` what the specs, the trainers
and layerwise inference read of it: ``reads_table_at_layer0`` (layer 0
can aggregate straight from the device table: gsrc mode, ``features=``),
``mirrors_outer_hop`` (the outermost hop needs its src-sorted mirror:
``mirror_all_specs``) and ``layerwise(x_all, propagate)``, its full-graph
plan, one ``propagate`` a layer (``models/inference.py``; ``None``: not
served). A model is added here: its class and its name in ``MODELS``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..sampling.batch import BatchSpec, PaddedBatch
from ..utils.timing import span
from .layers import (
    ARMAConv, Dense, GATConv, GCNConv, GINConv, MLP, MaskedBatchNorm,
    SAGEConv, _lecun_dense, dropout,
)


def _check_layers(model, batch: PaddedBatch) -> int:
    L = batch.num_layers
    if L != model.num_layers:
        raise ValueError(f"batch has {L} hops, model {model.num_layers}")
    return L


def _log_probs(x: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(x.to(torch.float32), dim=-1)


class _GNNBase(nn.Module):
    reads_table_at_layer0 = False
    mirrors_outer_hop = False
    layerwise = None

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
        return _log_probs(x[: batch.spec.seed_cap])

    def _convs(self):
        return [getattr(self, f"conv{i}") for i in range(self.num_layers)]


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
    reads_table_at_layer0 = True

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

    def layerwise(self, x_all, propagate):
        L = self.num_layers
        emb = x_all
        for i, conv in enumerate(self._convs()):
            def core(x, edge, n, conv=conv, last=i == L - 1):
                h = conv(x, x[:n], edge, n)
                return h if last else torch.relu(h)

            emb = propagate(core, emb, conv.out_features)
        return _log_probs(emb)


class SAGEClassic(SAGE):
    """SAGE with default-bias convs."""

    use_bias = True


class GIN(_GNNBase):
    """GIN with 2-layer BN MLPs per conv + 2-layer head."""

    reads_table_at_layer0 = True

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

    def layerwise(self, x_all, propagate):
        emb = x_all
        for conv in self._convs():
            def core(x, edge, n, conv=conv):
                return conv(x, x[:n], edge, n)

            emb = propagate(core, emb, conv.out_features)
        return _log_probs(self.lin2(torch.relu(self.lin1(emb))))


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

    def layerwise(self, x_all, propagate):
        emb, pooled = x_all, None   # JK 'max' mode, running: O(V·H)
        for i, conv in enumerate(self._convs()):
            def core(x, edge, n, conv=conv, bn=getattr(self, f"bn{i}")):
                return torch.relu(bn(conv(x, x[:n], edge, n)))

            emb = propagate(core, emb, conv.out_features)
            pooled = emb if pooled is None else torch.maximum(pooled, emb)
        return _log_probs(self.lin(pooled))


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

    def layerwise(self, x_all, propagate):
        emb = x_all.to(self.dtype)
        collect = [emb]
        for i, conv in enumerate(self._convs()):
            def core(x, edge, n, conv=conv, bn=getattr(self, f"bn{i}")):
                return F.leaky_relu(bn(conv(x, x[:n], edge, n)), 0.01)

            h_all = propagate(core, emb, conv.out_features)
            collect.append(h_all)
            emb = h_all + (self.res0(emb) if i == 0 else emb)
        return _log_probs(self.mlp(torch.cat(collect, dim=-1)))


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

    layerwise = SAGE.layerwise   # each conv, then ReLU


class GATSkip(_GNNBase):
    """PyG's ogbn-products GAT (``examples/ogbn_products_gat.py``; the OGB
    leaderboard's "GAT (NeighborSampling)", 751,574 parameters at 100
    features, hidden 128 and 47 classes): ``heads`` heads a conv with
    bias, concatenated (heads x hidden) below the last layer and averaged
    in it, and a Linear skip with bias from the targets' rows:

        x = GATConv_i((x, x[:T])) + skip_i(x[:T])
        x = dropout(elu(x))                     (not after the last layer)

    ``hidden_features`` is the width of one head. Under a profiler each
    skip projection and its add is the span ``gat.skip``."""

    heads = 4

    def __init__(self, *args, generator: Optional[torch.Generator] = None,
                 **kw):
        super().__init__(*args, **kw)
        L, Hd = self.num_layers, self.heads
        wide = Hd * self.hidden_features
        for i in range(L):
            fin = self.in_features if i == 0 else wide
            last = i == L - 1
            self.add_module(f"conv{i}", GATConv(
                fin, self.out_features if last else self.hidden_features,
                heads=Hd, dtype=self.dtype, generator=generator,
                concat=not last, use_bias=True))
            self.add_module(f"skip{i}", Dense(
                fin, self.out_features if last else wide, True, self.dtype,
                generator))

    def forward(self, x, batch: PaddedBatch, training: bool = False,
                generator: Optional[torch.Generator] = None):
        x = x.to(self.dtype)
        L = _check_layers(self, batch)
        for i in range(L):
            _, out_cap = batch.layer_caps(i)
            x_target = x[:out_cap]
            h = getattr(self, f"conv{i}")(x, x_target, batch.edges[i],
                                          out_cap)
            with span("gat.skip"):
                x = h + getattr(self, f"skip{i}")(x_target)
            if i != L - 1:
                x = dropout(F.elu(x), self.dropout, training, generator)
        return self._final(x, batch)

    def layerwise(self, x_all, propagate):
        L = self.num_layers
        emb = x_all
        for i, conv in enumerate(self._convs()):
            def core(x, edge, n, conv=conv, skip=getattr(self, f"skip{i}"),
                     last=i == L - 1):
                h = conv(x, x[:n], edge, n) + skip(x[:n])
                return h if last else F.elu(h)

            emb = propagate(core, emb, conv.out_features)
        return _log_probs(emb)


class GCN(_GNNBase):
    """GCN with normalize=False, bias-free convs and masked BN between
    layers. As in the reference (which passes the full x), each conv's
    output keeps the input row count, zero above ``out_cap``; BN sees the
    in-level's valid rows. A conv reads only the rows of its hop's input
    level, so the mirrored backward drops the mirror's pads (msrc = that
    level's cap) instead of adding them into the row past it."""

    mirrors_outer_hop = True

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

    def layerwise(self, x_all, propagate):
        L = self.num_layers
        emb = x_all
        for i, conv in enumerate(self._convs()):
            bn = None if i == L - 1 else getattr(self, f"bn{i}")

            def core(x, edge, n, conv=conv, bn=bn):
                h = conv(x, edge, n)
                return h if bn is None else torch.relu(bn(h))

            emb = propagate(core, emb, conv.out_features)
        return _log_probs(emb)


class ARMA(_GNNBase):
    """ARMA_1 stack (flagged broken in the reference; provided for API
    parity, as in the JAX package). The last conv keeps the hidden width,
    as the reference's does, so the log-softmax runs over ``hidden``
    columns."""

    mirrors_outer_hop = True
    layerwise = None   # not served, as in the JAX package: scored batchwise

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
# and the port's own, which the JAX package's zoo does not have
MODELS = {**MODEL_REGISTRY, "GATSkip": GATSkip}


def model_class(name: str) -> type:
    """The zoo's class of ``name``; a name outside the zoo raises."""
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}")
    return MODELS[name]


def make_model(name: str, in_features: int, hidden_features: int,
               out_features: int, num_layers: int, dropout: float = 0.5,
               dtype: torch.dtype = torch.bfloat16,
               generator: Optional[torch.Generator] = None) -> nn.Module:
    """Build a model of the zoo on the CPU with float32 parameters;
    ``generator`` draws the initial weights."""
    return model_class(name)(in_features, hidden_features, out_features,
                             num_layers, dropout=dropout, dtype=dtype,
                             generator=generator)


def mirror_all_specs(model_name: str, spec: BatchSpec,
                     tight: Optional[BatchSpec] = None):
    """A calibrated (spec, tight) pair with the model's
    ``mirrors_outer_hop`` as their ``mirror_all`` (the JAX package's rule,
    so specs stay identical)."""
    if model_class(model_name).mirrors_outer_hop:
        spec = dataclasses.replace(spec, mirror_all=True)
        if tight is not None:
            tight = dataclasses.replace(tight, mirror_all=True)
    return spec, tight
