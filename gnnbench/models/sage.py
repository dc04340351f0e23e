"""GraphSAGE (mean aggregation, no bias), as the reference's flagship model
is defined: for each layer i, over the hop it consumes,

    out[t] = W_l,i · mean_{j in N(t)} h[j] + W_r,i · h[t]

then ReLU and dropout between layers, log-softmax and the mean NLL over the
seeds at the end (PyG's SAGEConv; SALIENT's SAGE). The plain reference
runs it in float32 on the sampled subgraph, and trains it with Adam by
hand. Beside it, what one step of the model asks of the card: its
kernel calls for the rooflines and its FLOPs for ``mfu``.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from .. import arith
from .common import (Sampled, adam_update, degrees, dropout_masks,
                     elem_bytes, rounding, segment_sum, xavier_bound)


def param_shapes(cfg: dict, in_width: int) -> Dict[str, tuple]:
    """The program's parameter names and shapes; ``in_width`` is the
    feature width the program's first layer takes (it pads the features)."""
    L, H, C = cfg["num_layers"], cfg["hidden_features"], \
        cfg["graph"]["num_classes"]
    out = {}
    for i in range(L):
        fin = in_width if i == 0 else H
        fout = C if i == L - 1 else H
        out[f"conv{i}.lin_l.weight"] = (fout, fin)
        out[f"conv{i}.lin_r.weight"] = (fout, fin)
    return out


def init_bounds(shapes: Dict[str, tuple]) -> Dict[str, float]:
    return {k: xavier_bound(s[1], s[0]) for k, s in shapes.items()}


def dropout_shapes(cfg: dict, s: Sampled) -> List[tuple]:
    """The program draws one mask a hidden layer at its bucket's cap."""
    L, H = cfg["num_layers"], cfg["hidden_features"]
    return [(s.caps[L - 1 - i], H) for i in range(L - 1)]


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
        wl, wr = W[f"conv{i}.lin_l.weight"], W[f"conv{i}.lin_r.weight"]
        if i == 0:
            wl, wr = wl[:, :Fw], wr[:, :Fw]
        hq = q(h)
        agg = segment_sum(hq, src, dst, T) \
            / degrees(dst, T).clamp_min(1.0)[:, None]
        h = q(agg) @ q(wl).T + hq[:T] @ q(wr).T
        if i != L - 1:
            h = torch.relu(h)
            if masks is not None:
                h = h * masks[i][:T]
    # the logits leave the last layer in the compute precision
    return torch.log_softmax(q(h[: ls[0]]), dim=-1)


def loss_of(logp: torch.Tensor, y: torch.Tensor,
            keep_rows=None) -> torch.Tensor:
    """Mean NLL over the seeds (``keep_rows``: over those rows only)."""
    nll = F.nll_loss(logp, y, reduction="none")
    if keep_rows is not None:
        nll = nll[:keep_rows]
    return nll.mean()


def train_reference(W0: Dict[str, torch.Tensor], feats: torch.Tensor,
                    batches: List[Sampled], cfg: dict, seed: int,
                    precision: str = "float32", half_batch: bool = False,
                    start=None):
    """Train from ``W0`` on ``batches``, one Adam step each, as the
    program's configuration states (dropout on). ``start`` = (m, v,
    adam_steps, step) continues from the program's state: Adam's moments
    and step count, and the program's step counter, which seeds dropout;
    by default Adam starts fresh at step 0. Returns the losses, the
    first step's gradients, the weights after every step, and the first
    step's log-probabilities."""
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
        adam_update(params, grads, m, v2, adam0 + t + 1, cfg["lr"])
    return losses, first_grads, {k: p.detach() for k, p in params.items()}, \
        first_logp


def kernel_calls(meta: dict, phase: str, cfg: dict) -> Dict[str, list]:
    """(bytes, ops) of every K1, K2 and K3 call of one step of this model
    (the program's SAGE with global layer-0 sources), counting only the
    work the configuration needs: rows of ``num_features`` values in the
    compute precision, whatever width the program pads its table to, and
    real rows, not the bucket's caps. K3 gathers layer 0's targets (the
    level-(L-1) prefix of the frontier; a batch short of its cap also reads
    the pad row), K2 sums layer 0 straight from the table, K1 sums each
    inner hop forward (by target) and, in training, backward (by source,
    over the mirror)."""
    L, H = cfg["num_layers"], cfg["hidden_features"]
    Fw, eb = cfg["graph"]["num_features"], elem_bytes(cfg)
    caps, ls, ec = meta["caps"], meta["level_sizes"], meta["edge_counts"]
    T = ls[L - 1]
    k3 = [arith.k3_call(T + (1 if caps[L - 1] > T else 0), T, Fw * eb)]
    k2 = [arith.k2_call(meta["distinct_outer_src"], ec[L - 1], T, Fw, eb)]
    k1 = []
    for hop in range(L - 1):
        k1.append(arith.k1_call(ec[hop], ls[hop], H, eb))
        if phase == "train":
            k1.append(arith.k1_call(ec[hop], ls[hop + 1], H, eb))
    return {"k1": k1, "k2": k2, "k3": k3}


def step_flops(meta: dict, phase: str, cfg: dict) -> int:
    """FLOPs one step needs at its real sizes: per layer two products of
    the targets' rows (2 m k n each) and one add an edge and feature; in
    training the backward doubles each (weights and inputs), except that
    layer 0's inputs (the features) take no gradient. Nothing recomputed
    is counted."""
    L, H, C = cfg["num_layers"], cfg["hidden_features"], \
        cfg["graph"]["num_classes"]
    Fw = cfg["graph"]["num_features"]
    ls, ec = meta["level_sizes"], meta["edge_counts"]
    total = 0
    for i in range(L):
        hop = L - 1 - i
        fin = Fw if i == 0 else H
        fout = C if i == L - 1 else H
        dense = 2 * arith.matmul_flops(ls[hop], fin, fout)
        agg = ec[hop] * fin
        if phase == "train":
            # weight gradients always; input gradients past layer 0
            dense *= 2 if i == 0 else 3
            agg *= 1 if i == 0 else 2
        total += dense + agg
    return total
