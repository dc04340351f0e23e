"""Single-head GAT without bias, as the reference's model zoo defines it
(PyG's GATConv, concatenated heads, self-loops added): for each layer i,
over the hop it consumes, with xs = W_i · h over the hop's input rows,

    a_src[j] = <xs[j], att_src>,  a_dst[t] = <xs[t], att_dst>
    z[j->t]  = leaky_relu(a_src[j] + a_dst[t], 0.2)
    att      = softmax over {j in N(t)} and t itself
    out[t]   = sum_j att[j->t] xs[j] + att[t->t] xs[t]

then ReLU between layers (dropout only in training) and log-softmax over
the seeds. Target t's own row is input row t (the frontier's prefix
rule). The plain reference scores in float32; beside it, the model's
kernel calls and FLOPs for one scoring batch.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .. import arith
from .common import (Sampled, elem_bytes, rounding, segment_sum,
                     xavier_bound)

NEGATIVE_SLOPE = 0.2


def param_shapes(cfg: dict, in_width: int) -> Dict[str, tuple]:
    L, H, C = cfg["num_layers"], cfg["hidden_features"], \
        cfg["graph"]["num_classes"]
    out = {}
    for i in range(L):
        fin = in_width if i == 0 else H
        fout = C if i == L - 1 else H
        out[f"conv{i}.lin_src.weight"] = (fout, fin)
        out[f"conv{i}.att_src"] = (1, 1, fout)
        out[f"conv{i}.att_dst"] = (1, 1, fout)
    return out


def init_bounds(shapes: Dict[str, tuple]) -> Dict[str, float]:
    return {k: (xavier_bound(s[1], s[0]) if len(s) == 2
                else xavier_bound(s[1], s[2])) for k, s in shapes.items()}


def forward(W: Dict[str, torch.Tensor], feats: torch.Tensor, s: Sampled,
            cfg: dict, masks=None, precision: str = "float32"):
    """Log-probabilities of the seeds [level_sizes[0], C] (scoring: no
    dropout)."""
    q = rounding(precision)
    L, Fw = cfg["num_layers"], feats.shape[1]
    ls = s.level_sizes
    h = feats.index_select(0, s.n_id)
    for i in range(L):
        hop = L - 1 - i
        src, dst = s.hops[hop]
        T = ls[hop]
        w = W[f"conv{i}.lin_src.weight"]
        if i == 0:
            w = w[:, :Fw]
        xs = q(q(h) @ q(w).T)
        a_s = q(xs @ q(W[f"conv{i}.att_src"].reshape(-1)))
        a_d = q(xs[:T] @ q(W[f"conv{i}.att_dst"].reshape(-1)))
        z = F.leaky_relu(a_s[src] + a_d[dst], NEGATIVE_SLOPE)
        z_self = F.leaky_relu(a_s[:T] + a_d, NEGATIVE_SLOPE)
        m = z_self.clone().scatter_reduce_(0, dst, z, reduce="amax")
        e = torch.exp(z - m[dst])
        e_self = torch.exp(z_self - m)
        den = e_self.index_add(0, dst, e)
        out = segment_sum(xs, src, dst, T, weight=e) + e_self[:, None] \
            * xs[:T]
        h = out / den[:, None]
        if i != L - 1:
            h = torch.relu(h)
    # the logits leave the last layer in the compute precision
    return torch.log_softmax(q(h[: ls[0]]), dim=-1)


def kernel_calls(meta: dict, phase: str, cfg: dict) -> Dict[str, list]:
    """(bytes, ops) of the K1 and K3 calls of one scoring batch, counting
    only the work the configuration needs: rows of ``num_features``
    values in the compute precision, whatever width the program pads its
    table to, and real rows, not the bucket's caps. K3 gathers the whole
    frontier (a batch short of its cap also reads the pad row); K1 sums
    each layer's weighted messages by target, at the layer's output
    width."""
    if phase != "score":
        raise ValueError(f"GAT's kernel calls are stated for scoring, not "
                         f"{phase!r}")
    L, H, C = cfg["num_layers"], cfg["hidden_features"], \
        cfg["graph"]["num_classes"]
    Fw, eb = cfg["graph"]["num_features"], elem_bytes(cfg)
    caps, ls, ec = meta["caps"], meta["level_sizes"], meta["edge_counts"]
    N = ls[L]
    k3 = [arith.k3_call(N + (1 if caps[L] > N else 0), N, Fw * eb)]
    k1 = [arith.k1_call(ec[L - 1 - i], ls[L - 1 - i],
                        C if i == L - 1 else H, eb) for i in range(L)]
    return {"k1": k1, "k3": k3}


def step_flops(meta: dict, phase: str, cfg: dict) -> int:
    """FLOPs one scoring batch needs at its real sizes, per layer: the
    projection of the hop's input rows (2 m k n), the two attention dot
    products a row, five a logit for the edge and self logits (add,
    leaky ReLU, max, exponent, normaliser), and two an element of each
    weighted message and of the self term. The program projects the
    targets' rows a second time; that recomputation is not counted."""
    if phase != "score":
        raise ValueError(f"GAT's FLOPs are stated for scoring, not "
                         f"{phase!r}")
    L, H, C = cfg["num_layers"], cfg["hidden_features"], \
        cfg["graph"]["num_classes"]
    Fw = cfg["graph"]["num_features"]
    ls, ec = meta["level_sizes"], meta["edge_counts"]
    total = 0
    for i in range(L):
        hop = L - 1 - i
        fin = Fw if i == 0 else H
        fout = C if i == L - 1 else H
        N, T, E = ls[hop + 1], ls[hop], ec[hop]
        total += arith.matmul_flops(N, fin, fout)
        total += 2 * N * fout + 2 * T * fout
        total += 5 * (E + T) + 2 * (E + T) * fout
    return total
