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

from ..ops.segment import valid_mask
from ..ops.sorted_segment import spmm_agg
from ..sampling.batch import EdgeBlock


def _agg(x: torch.Tensor, edge: EdgeBlock, out_cap: int, mean: bool):
    """Gather-and-aggregate one hop: the sorted segment-sum kernel on a
    CUDA tensor (scatter-free forward, mirrored backward), its plain
    version on a CPU tensor."""
    return spmm_agg(x, edge, out_cap, mean=mean)


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
