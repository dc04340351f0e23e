"""PyG's ogbn-products GAT (examples/ogbn_products_gat.py; the OGB
leaderboard's "GAT (NeighborSampling)"): H heads a layer (the
configuration's ``heads``, 4), each conv with its bias, concatenated (H x
hidden) below the last layer and averaged in it, and a Linear skip with
bias from the targets' rows. For each layer i, over the hop it consumes,
with xs = W_i · h over the hop's input rows viewed as [N, H, C]:

    a_src[j, h] = <xs[j, h], att_src[h]>,  a_dst[t, h] = <xs[t, h], att_dst[h]>
    z[j->t, h]  = leaky_relu(a_src[j, h] + a_dst[t, h], 0.2)
    att         = softmax over {j in N(t)} and t itself, per head
    g[t, h]     = sum_j att[j->t, h] xs[j, h] + att[t->t, h] xs[t, h]
    out[t]      = concat_h g[t, h]  (mean_h g[t, h] in the last layer)
    x[t]        = out[t] + bias_i + S_i · h[t] + s_i

then ELU and dropout between layers, log-softmax and the mean NLL over the
seeds at the end. Target t's own row is input row t (the frontier's prefix
rule), and self-loops are added as the port's GATConv adds them: PyG also
drops sampled edges j -> t with j == t first, which the seeded graph does
not hold. The plain reference runs it in float32 on the sampled subgraph
and trains it with Adam by hand; beside it, the model's kernel calls for
the rooflines and its FLOPs for ``mfu``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from .. import arith
from .common import (CHUNK_EDGES, Sampled, adam_update, dropout_masks,
                     elem_bytes, rounding, xavier_bound)
from .sage import loss_of

NEGATIVE_SLOPE = 0.2


def _widths(cfg: dict, i: int):
    """(heads, a head's width C, concatenated, the layer's output width)
    of layer i."""
    L, Hd, C = cfg["num_layers"], cfg["hidden_features"], \
        cfg["graph"]["num_classes"]
    heads = cfg["heads"]
    if i == L - 1:
        return heads, C, False, C
    return heads, Hd, True, heads * Hd


def param_shapes(cfg: dict, in_width: int) -> Dict[str, tuple]:
    """The program's parameter names and shapes; ``in_width`` is the
    feature width the program's first layer takes (it pads the
    features). The configuration's ``heads`` has to be the program's
    class constant ``GATSkip.heads``."""
    from salient_plusplus_tpu_torch.models.modules import GATSkip

    if cfg["heads"] != GATSkip.heads:
        raise ValueError(f"the configuration's heads {cfg['heads']} are not "
                         f"the program's GATSkip.heads {GATSkip.heads}")
    out = {}
    for i in range(cfg["num_layers"]):
        fin = in_width if i == 0 else cfg["heads"] * cfg["hidden_features"]
        Hn, C, _, fout = _widths(cfg, i)
        out[f"conv{i}.lin_src.weight"] = (Hn * C, fin)
        out[f"conv{i}.att_src"] = (1, Hn, C)
        out[f"conv{i}.att_dst"] = (1, Hn, C)
        out[f"conv{i}.bias"] = (fout,)
        out[f"skip{i}.weight"] = (fout, fin)
        out[f"skip{i}.bias"] = (fout,)
    return out


def init_bounds(shapes: Dict[str, tuple]) -> Dict[str, float]:
    """Weights xavier-uniform (attention vectors: fan_in the heads, fan_out
    their width); each bias 1 / sqrt(fan_in) of its layer, as torch's
    Linear draws its bias."""
    out = {}
    for k, s in shapes.items():
        if len(s) == 2:
            out[k] = xavier_bound(s[1], s[0])
        elif len(s) == 3:
            out[k] = xavier_bound(s[1], s[2])
        else:
            layer = k.rsplit(".", 1)[0]
            w = shapes[f"{layer}.lin_src.weight" if layer.startswith("conv")
                       else f"{layer}.weight"]
            out[k] = 1.0 / math.sqrt(w[1])
    return out


def dropout_shapes(cfg: dict, s: Sampled) -> List[tuple]:
    """The program draws one mask a hidden layer at its bucket's cap."""
    L, W = cfg["num_layers"], cfg["heads"] * cfg["hidden_features"]
    return [(s.caps[L - 1 - i], W) for i in range(L - 1)]


def _head_sum(xs: torch.Tensor, w: torch.Tensor, src: torch.Tensor,
              dst: torch.Tensor, T: int) -> torch.Tensor:
    """out[t, h] = sum over edges e with dst[e] == t of w[e, h] xs[src[e],
    h] in float32, gathering at most CHUNK_EDGES rows at once."""
    out = xs.new_zeros((T,) + tuple(xs.shape[1:]))
    for a in range(0, src.shape[0], CHUNK_EDGES):
        msg = xs.index_select(0, src[a:a + CHUNK_EDGES]) \
            * w[a:a + CHUNK_EDGES, :, None]
        out = out.index_add(0, dst[a:a + CHUNK_EDGES], msg)
    return out


def forward(W: Dict[str, torch.Tensor], feats: torch.Tensor, s: Sampled,
            cfg: dict, masks=None, precision: str = "float32"):
    """Log-probabilities of the seeds [level_sizes[0], C]."""
    q = rounding(precision)
    L, Fw = cfg["num_layers"], feats.shape[1]
    ls = s.level_sizes
    h = feats.index_select(0, s.n_id)
    for i in range(L):
        hop = L - 1 - i
        src, dst = s.hops[hop]
        T = ls[hop]
        Hn, C, concat, _ = _widths(cfg, i)
        w, sw = W[f"conv{i}.lin_src.weight"], W[f"skip{i}.weight"]
        if i == 0:
            w, sw = w[:, :Fw], sw[:, :Fw]
        hq = q(h)
        xs = q(hq @ q(w).T).view(-1, Hn, C)
        a_s = q((xs * q(W[f"conv{i}.att_src"])).sum(-1))
        a_d = q((xs[:T] * q(W[f"conv{i}.att_dst"])).sum(-1))
        z = F.leaky_relu(a_s[src] + a_d[dst], NEGATIVE_SLOPE)
        z_self = F.leaky_relu(a_s[:T] + a_d, NEGATIVE_SLOPE)
        m = z_self.detach().clone().scatter_reduce_(
            0, dst[:, None].expand(-1, Hn), z.detach(), reduce="amax")
        e = torch.exp(z - m[dst])
        e_self = torch.exp(z_self - m)
        den = e_self.index_add(0, dst, e)
        g = (_head_sum(xs, e, src, dst, T)
             + e_self[:, :, None] * xs[:T]) / den[:, :, None]
        out = g.reshape(T, Hn * C) if concat else g.mean(1)
        h = q(out) + W[f"conv{i}.bias"] + hq[:T] @ q(sw).T \
            + W[f"skip{i}.bias"]
        if i != L - 1:
            h = F.elu(h)
            if masks is not None:
                h = h * masks[i][:T]
    # the logits leave the last layer in the compute precision
    return torch.log_softmax(q(h[: ls[0]]), dim=-1)


def train_reference(W0: Dict[str, torch.Tensor], feats: torch.Tensor,
                    batches: List[Sampled], cfg: dict, seed: int,
                    precision: str = "float32", half_batch: bool = False,
                    start=None):
    """Train from ``W0`` on ``batches``, one Adam step each, as the
    program's configuration states (dropout on); ``start`` and the return
    value as ``sage.train_reference``'s."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in W0.items()}
    if start is None:
        m = {k: torch.zeros_like(v) for k, v in W0.items()}
        v2 = {k: torch.zeros_like(v) for k, v in W0.items()}
        adam0, step0 = 0, 0
    else:
        m0, v0, adam0, step0 = start
        m = {k: m0[k].clone() for k in W0}
        v2 = {k: v0[k].clone() for k in W0}
    losses, first_grads, first_logp = [], None, None
    for t, s in enumerate(batches):
        masks = dropout_masks(seed, step0 + t, dropout_shapes(cfg, s),
                              cfg["dropout"], feats.device)
        logp = forward(params, feats, s, cfg, masks, precision)
        keep = (s.level_sizes[0] // 2) if half_batch else None
        loss = loss_of(logp, s.y, keep)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        losses.append(loss.item())
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
            first_logp = logp.detach()
        del logp, loss
        adam_update(params, grads, m, v2, adam0 + t + 1, cfg["lr"])
    return losses, first_grads, {k: p.detach() for k, p in params.items()}, \
        first_logp


def wsum_call(distinct_rows: int, n_real: int, num_segments: int,
              heads: int, width: int, eb: int) -> tuple:
    """The weighted gather + segment sum (``csrc/weighted_segment_sum.cu``)
    over ``heads`` heads of ``width``: reads each distinct source row of a
    real edge once (heads x width values), each real edge's 8 bytes of ids
    and its f32 weight a head, writes the float32 [num_segments, heads x
    width] output once; a multiply and an add an element of a real edge's
    row."""
    F_ = heads * width
    return (distinct_rows * F_ * eb + n_real * (8 + 4 * heads)
            + 4 * num_segments * F_, 2 * n_real * F_)


def distinct_src(meta: dict, hop: int, L: int) -> int:
    """Distinct source rows of ``hop``'s real edges: counted for the
    outermost hop; for an inner hop at least the rows new at level hop + 1
    (each entered the frontier as a source of this hop), the count the
    batch's sizes give without its edges."""
    ls = meta["level_sizes"]
    if hop == L - 1:
        return meta["distinct_outer_src"]
    return ls[hop + 1] - ls[hop]


def kernel_calls(meta: dict, phase: str, cfg: dict) -> Dict[str, list]:
    """(bytes, ops) of the K3 and weighted-sum calls of one step, counting
    only the work the configuration needs: rows of ``num_features`` values
    in the compute precision and real rows, not the bucket's caps. K3
    gathers the whole frontier (a batch short of its cap also reads the
    pad row); the weighted sum runs once a layer forward (its backward is
    gathers and ``index_add_``, no kernel of its own) and reads each
    distinct source row once (``distinct_src``)."""
    L = cfg["num_layers"]
    Fw, eb = cfg["graph"]["num_features"], elem_bytes(cfg)
    caps, ls, ec = meta["caps"], meta["level_sizes"], meta["edge_counts"]
    N = ls[L]
    k3 = [arith.k3_call(N + (1 if caps[L] > N else 0), N, Fw * eb)]
    wsum = [wsum_call(distinct_src(meta, L - 1 - i, L), ec[L - 1 - i],
                      ls[L - 1 - i], *_widths(cfg, i)[:2], eb)
            for i in range(L)]
    return {"k3": k3, "wsum": wsum}


def step_flops(meta: dict, phase: str, cfg: dict) -> int:
    """FLOPs one step needs at its real sizes, per layer: the projection of
    the hop's input rows and the skip projection of its targets' rows (2 m
    k n each), the two attention dot products a row and head, five a logit
    for the edge and self logits (add, leaky ReLU, max, exponent,
    normaliser), and two an element of each weighted message and of the
    self term. In training the backward doubles the projections (weights
    and inputs), except that layer 0's inputs (the features) take no
    gradient, and doubles the attention in every layer (its rows are a
    projection's output). The program projects the targets' rows a second
    time; that recomputation is not counted."""
    L = cfg["num_layers"]
    Fw = cfg["graph"]["num_features"]
    ls, ec = meta["level_sizes"], meta["edge_counts"]
    total = 0
    for i in range(L):
        hop = L - 1 - i
        fin = Fw if i == 0 else cfg["heads"] * cfg["hidden_features"]
        Hn, C, _, fout = _widths(cfg, i)
        HC = Hn * C
        N, T, E = ls[hop + 1], ls[hop], ec[hop]
        dense = arith.matmul_flops(N, fin, HC) + arith.matmul_flops(
            T, fin, fout)
        att = 2 * N * HC + 2 * T * HC + 5 * (E + T) * Hn \
            + 2 * (E + T) * HC
        if phase == "train":
            dense *= 2 if i == 0 else 3
            att *= 3
        total += dense + att
    return total
