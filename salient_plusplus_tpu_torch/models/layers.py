"""Graph convolution layers over padded bipartite COO hops (counterpart of
the JAX package's ``models/layers.py``).

A layer takes the input-level features ``x`` [in_cap, F], the hop's
EdgeBlock (src→x rows, dst→target rows) and the static target row
capacity ``out_cap``; padded rows flow through as finite garbage and are
masked at the loss.

Precision as in the JAX package: float32 parameters, bfloat16 compute
(each Dense casts its input and weight to the compute dtype), float32
log_softmax at the end. Modules are named as the flax ones are, so
``weights.py`` carries parameters and batch statistics by name.
"""

from __future__ import annotations

from typing import Optional

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gat_agg import gat_attention_agg_autodiff
from ..ops.segment import gather_rows, masked_segment_sum, valid_mask
from ..ops.sorted_segment import spmm_agg
from ..sampling.batch import EdgeBlock
from ..utils.timing import span


def _agg(x: torch.Tensor, edge: EdgeBlock, out_cap: int, mean: bool):
    """Gather-and-aggregate one hop: the sorted segment-sum kernel on a
    CUDA tensor (scatter-free forward, mirrored backward), its plain
    version on a CPU tensor."""
    return spmm_agg(x, edge, out_cap, mean=mean)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``nn.Dropout`` semantics with an explicit generator: keep with
    probability 1-p and scale kept values by 1/(1-p)."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class Dense(nn.Module):
    """flax ``nn.Dense`` semantics: float32 ``weight`` [out, in] (the flax
    kernel transposed), zero bias, computed in ``dtype``. The init is
    xavier-uniform, as the JAX package's convs ask, or with ``lecun`` flax's
    default (a normal truncated at two deviations, variance 1/in)."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool,
                 dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None,
                 lecun: bool = False):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        if lecun:
            # flax's truncated_normal rescales by the truncated deviation
            std = math.sqrt(1.0 / in_features) / .87962566103423978
            nn.init.trunc_normal_(self.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
        else:
            nn.init.xavier_uniform_(self.weight, generator=generator)
        self.bias = (nn.Parameter(torch.zeros(out_features))
                     if use_bias else None)

    @property
    def out_features(self) -> int:
        return self.weight.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


def _dense(in_features, feat, use_bias, dtype, generator=None) -> Dense:
    return Dense(in_features, feat, use_bias, dtype, generator)


def _lecun_dense(in_features, feat, dtype, generator=None) -> Dense:
    """flax ``nn.Dense(feat)`` with its defaults: bias, lecun-normal."""
    return Dense(in_features, feat, True, dtype, generator, lecun=True)


class SAGEConv(nn.Module):
    """GraphSAGE mean-aggregation conv (PyG SAGEConv semantics:
    out = lin_l(mean_{j∈N(i)} x_j) + lin_r(x_i); bias only in lin_l)."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = False, dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin_l = _dense(in_features, features, use_bias, dtype, generator)
        self.lin_r = _dense(in_features, features, False, dtype, generator)

    @property
    def out_features(self) -> int:
        return self.lin_l.out_features

    def forward(self, x, x_target, edge: EdgeBlock, out_cap: int):
        agg = _agg(x, edge, out_cap, mean=True)
        return self.lin_l(agg) + self.lin_r(x_target)


class GATConv(nn.Module):
    """Graph attention conv, PyG GATConv semantics with ``add_self_loops=
    True``: on the reference's bipartite hop every target also attends to
    itself (input row i < T is target i under the prefix convention). By
    default the heads are concatenated and there is no bias, as the zoo's
    GAT builds it; ``concat=False`` averages the heads (on the weighted
    sum's f32 output, before the cast) and ``use_bias`` adds PyG's bias
    (zeros at init) after the concatenation or the average.

    The attention block (``ops/gat_agg.py::gat_attention_agg_autodiff``):
    the attention logits and the self-inclusive softmax as one op
    (``ops/edge_softmax.py``: a kernel pair on the card, no scatter or
    sort), the weighted message sum by the fused weighted gather + segment
    sum (``ops/weighted_segment.py``: no [E, H·C] messages, nor in its
    backward's two kernels) and the self term; autograd does the rest. It
    reads no src-sorted mirror: a hop that carries one gives the same
    result. Under a profiler the block is the span ``gat.attention``; the
    projections stay outside it."""

    def __init__(self, in_features: int, features: int, heads: int = 1,
                 negative_slope: float = 0.2,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None,
                 concat: bool = True, use_bias: bool = False):
        super().__init__()
        self.heads, self.features = heads, features
        self.concat = concat
        self.negative_slope = negative_slope
        self.dtype = dtype
        self.lin_src = _dense(in_features, heads * features, False, dtype,
                              generator)
        # flax's xavier_uniform of a [1, H, C] kernel: fan_in H, fan_out C
        a = math.sqrt(6.0 / (heads + features))
        self.att_src = nn.Parameter(
            torch.empty(1, heads, features).uniform_(-a, a,
                                                     generator=generator))
        self.att_dst = nn.Parameter(
            torch.empty(1, heads, features).uniform_(-a, a,
                                                     generator=generator))
        self.bias = (nn.Parameter(torch.zeros(self.out_features))
                     if use_bias else None)

    @property
    def out_features(self) -> int:
        return self.heads * self.features if self.concat else self.features

    def forward(self, x, x_target, edge: EdgeBlock, out_cap: int):
        H, C = self.heads, self.features
        xs = self.lin_src(x).view(-1, H, C)
        xt = self.lin_src(x_target).view(-1, H, C)
        alpha_src = (xs * self.att_src.to(self.dtype)).sum(-1)   # [N_in, H]
        alpha_dst = (xt * self.att_dst.to(self.dtype)).sum(-1)   # [T, H]
        with span("gat.attention"):
            out = gat_attention_agg_autodiff(
                out_cap, self.negative_slope, xs, xt, alpha_src, alpha_dst,
                edge.src, edge.dst, edge.count, mean_heads=not self.concat)
        out = out.reshape(-1, self.out_features).to(self.dtype)
        if self.bias is not None:
            out = out + self.bias.to(self.dtype)
        return out


class GCNConv(nn.Module):
    """PyG GCNConv with normalize=False, bias=False, as the reference
    builds it: out = Σ_{j∈N(i)} (x W)_j over the hop. With the hop's mirror
    (GCN's specs mirror every hop) the sum runs K1 forward by dst and K1
    backward by msrc; without one (layerwise inference), K2."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin = _dense(in_features, features, False, dtype, generator)

    @property
    def out_features(self) -> int:
        return self.lin.out_features

    def forward(self, x, edge: EdgeBlock, out_rows: int):
        h = self.lin(x)
        return _agg(h, edge, out_rows, mean=False).to(h.dtype)


class ARMAConv(nn.Module):
    """ARMA_1 conv (1 stack, 1 layer, unshared weights), the JAX package's
    documented equation: out = relu(norm_adj · (x W) + dropout(x) V) over
    the input node set, with symmetric degree normalisation on the batch
    subgraph. Degrees are summed in the compute dtype, as there (a bf16
    count is exact up to 256). The scaled projection is gathered by the
    row-gather kernel (K3, differentiable) and summed by ``index_add_``;
    rows past ``out_rows`` are zero before the root term."""

    def __init__(self, in_features: int, features: int, dropout: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout, self.dtype = dropout, dtype
        self.w = _dense(in_features, features, False, dtype, generator)
        self.v = _dense(in_features, features, False, dtype, generator)

    @property
    def out_features(self) -> int:
        return self.w.out_features

    def forward(self, x, edge: EdgeBlock, out_rows: int,
                training: bool = False,
                generator: Optional[torch.Generator] = None):
        ones = valid_mask(edge.dst.shape[0], edge.count).to(self.dtype)
        deg_dst = masked_segment_sum(ones, edge.dst, edge.count, out_rows)
        deg_src = masked_segment_sum(ones, edge.src, edge.count, x.shape[0])
        inv_sqrt_dst = torch.rsqrt(deg_dst.clamp_min(1.0))
        inv_sqrt_src = torch.rsqrt(deg_src.clamp_min(1.0))
        h = self.w(x)
        msg = gather_rows(h * inv_sqrt_src[:, None], edge.src)
        prop = masked_segment_sum(msg, edge.dst, edge.count, out_rows)
        prop = prop * inv_sqrt_dst[:, None]
        root = self.v(dropout(x, self.dropout, training, generator))
        out = torch.cat([prop, prop.new_zeros(x.shape[0] - out_rows,
                                              prop.shape[1])])
        return torch.relu(out + root)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid row prefix only (the JAX package's
    ``MaskedBatchNorm``): in ``train()`` mode mean and variance are taken
    over rows < ``valid_count`` (all rows when it is None) and update the
    running statistics; in ``eval()`` mode the running statistics are
    used. Torch's conventions: momentum 0.1 (flax's decay 0.9), eps 1e-5,
    an unbiased running variance (n = the valid count). ``scale``/``bias``
    are float32 parameters, ``mean``/``var`` float32 buffers, as the flax
    names are."""

    momentum = 0.1
    eps = 1e-5

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, valid_count=None) -> torch.Tensor:
        xf = x.to(torch.float32)
        if not self.training:
            mean, var = self.mean, self.var
        else:
            if valid_count is None:
                n = torch.tensor(float(x.shape[0]), device=x.device)
                mean = xf.mean(0)
                var = ((xf - mean) ** 2).mean(0)
            else:
                m = valid_mask(x.shape[0], valid_count).to(torch.float32)
                n = m.sum().clamp_min(1.0)
                mean = (xf * m[:, None]).sum(0) / n
                var = (((xf - mean) ** 2) * m[:, None]).sum(0) / n
            with torch.no_grad():
                unbiased = var * n / (n - 1.0).clamp_min(1.0)
                self.mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.var.mul_(1 - self.momentum).add_(
                    self.momentum * unbiased)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias
        return y.to(self.dtype)


class MLP(nn.Module):
    """The reference's MLP helper (JAX ``models/layers.py::MLP``): Linear
    (+ masked BN)(+ activation) stacks named fc{i} / bn{i};
    ``end_up_with_fc`` builds no BN and no activation at all."""

    def __init__(self, in_features: int, hidden_dim: int, embed_dim: int,
                 num_layers: int, act: str = "relu", bn: bool = False,
                 end_up_with_fc: bool = False, use_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        self.act = {"relu": torch.relu,
                    "leakyrelu": lambda v: F.leaky_relu(v, 0.01)}[act.lower()]
        self.end_up_with_fc = end_up_with_fc
        self.bn = bn and not end_up_with_fc
        d_in = in_features
        for i in range(num_layers):
            d_out = embed_dim if i == num_layers - 1 else hidden_dim
            self.add_module(f"fc{i}", _dense(d_in, d_out, use_bias, dtype,
                                             generator))
            if self.bn:
                self.add_module(f"bn{i}", MaskedBatchNorm(d_out, dtype))
            d_in = d_out

    def forward(self, x, valid_count=None):
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
            if self.end_up_with_fc:
                continue
            if self.bn:
                x = getattr(self, f"bn{i}")(x, valid_count)
            x = self.act(x)
        return x


class GINConv(nn.Module):
    """Graph isomorphism conv: mlp((1+eps)·x_i + Σ_{j∈N(i)} x_j), the MLP
    the reference wraps in every GINConv: Linear → masked BN → ReLU →
    Linear → ReLU (fc0, bn, fc1)."""

    def __init__(self, in_features: int, features: int, eps: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.eps = eps
        self.fc0 = _dense(in_features, features, True, dtype, generator)
        self.bn = MaskedBatchNorm(features, dtype)
        self.fc1 = _dense(features, features, True, dtype, generator)

    @property
    def out_features(self) -> int:
        return self.fc1.out_features

    def forward(self, x, x_target, edge: EdgeBlock, out_cap: int,
                valid_count=None):
        agg = _agg(x, edge, out_cap, mean=False)
        h = (1.0 + self.eps) * x_target + agg.to(x.dtype)
        h = torch.relu(self.bn(self.fc0(h), valid_count))
        return torch.relu(self.fc1(h))
