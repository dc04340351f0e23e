"""A plain float32 reference of GATSkip, PyG's ogbn-products GAT
(``examples/ogbn_products_gat.py``; the OGB leaderboard's "GAT
(NeighborSampling)", 751,574 parameters at 100 features, 4 heads of 128
and 47 classes): its forward pass, its mean NLL loss and the loss's
gradients, in plain ``torch`` ops. It imports neither the JAX package nor
the PyTorch port, so it runs wherever ``torch`` does.

For layer i of L, over the hop (src -> dst) it consumes, with the input
rows h [N, F] and the hop's T targets the first T of them:

    xs      = h W_i^T, viewed [N, H, C]
    a_src   = <xs, att_src_i>,  a_dst = <xs[:T], att_dst_i>       [., H]
    z       = leaky_relu(a_src[src] + a_dst[dst], 0.2)
    att     = softmax of z per target and head, over its edges and itself
    g[t]    = sum_e att_e xs[src_e] + att_self[t] xs[t]           [T, H, C]
    out     = concat of the heads (H C wide) for i < L - 1, their mean
              (C wide) for the last
    x       = out + bias_i + h[:T] S_i^T + s_i                    (the skip)
    x       = dropout(elu(x), 0.5)             (not after the last layer)

and log_softmax over the seeds (the last layer's targets) at the end.

Departures from PyG, all as the port's GATConv has them:
- self-loops are added by the prefix rule: target t attends to input row
  t, its own row; PyG's ``add_self_loops`` also first removes sampled edges
  whose local source and target ids are equal, which this does not;
- the targets' rows are projected by the same weight as the sources'
  (PyG shares ``lin`` when ``in_channels`` is an int, so this is PyG's
  too) and attention dropout is 0, as the example sets it;
- dropout takes the masks given (``masks[i]`` multiplies layer i's [T,
  H C] rows, already scaled by 1 / (1 - p)), so that a caller can draw
  them as the program does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HEADS = 4
NEGATIVE_SLOPE = 0.2


def num_params(in_features: int, hidden: int, out: int,
               num_layers: int) -> int:
    """The model's parameter count from its equations."""
    total = 0
    for i in range(num_layers):
        fin = in_features if i == 0 else HEADS * hidden
        last = i == num_layers - 1
        C = out if last else hidden
        fout = out if last else HEADS * hidden
        total += fin * HEADS * C + 2 * HEADS * C + fout   # conv
        total += fin * fout + fout                         # skip
    return total


def gat_layer(params: Dict[str, torch.Tensor], i: int, h: torch.Tensor,
              src: torch.Tensor, dst: torch.Tensor, T: int,
              concat: bool) -> torch.Tensor:
    """Layer i's conv output (before the skip): [T, H C] with ``concat``,
    else the heads' mean [T, C]."""
    w = params[f"conv{i}.lin_src.weight"]
    C = w.shape[0] // HEADS
    xs = (h @ w.T).view(-1, HEADS, C)
    a_s = (xs * params[f"conv{i}.att_src"]).sum(-1)
    a_d = (xs[:T] * params[f"conv{i}.att_dst"]).sum(-1)
    z = F.leaky_relu(a_s[src] + a_d[dst], NEGATIVE_SLOPE)
    z_self = F.leaky_relu(a_s[:T] + a_d, NEGATIVE_SLOPE)
    m = z_self.detach().clone().scatter_reduce_(
        0, dst[:, None].expand(-1, HEADS), z.detach(), reduce="amax")
    e = torch.exp(z - m[dst])
    e_self = torch.exp(z_self - m)
    den = e_self.index_add(0, dst, e)
    msg = xs.index_select(0, src) * e[:, :, None]
    g = (xs.new_zeros(T, HEADS, C).index_add(0, dst, msg)
         + e_self[:, :, None] * xs[:T]) / den[:, :, None]
    out = g.reshape(T, HEADS * C) if concat else g.mean(1)
    return out + params[f"conv{i}.bias"]


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
            hops: Sequence[Tuple[torch.Tensor, torch.Tensor]],
            targets: Sequence[int],
            masks: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Log-probabilities [targets[-1], C] of the seeds. ``x`` [N_0, F]: the
    input rows of layer 0; ``hops[i] = (src, dst)`` the real edges layer i
    consumes (int64, src into layer i's input rows, dst < targets[i]);
    ``targets[i]`` layer i's targets, the first rows of its input. The
    first layer's weights may be wider than ``x`` (the port pads its
    features): only their first F columns are read."""
    L = len(hops)
    h = x.float()
    for i, ((src, dst), T) in enumerate(zip(hops, targets)):
        p = dict(params)
        if i == 0:
            for k in (f"conv{i}.lin_src.weight", f"skip{i}.weight"):
                p[k] = params[k][:, : h.shape[1]]
        last = i == L - 1
        h = gat_layer(p, i, h, src, dst, T, concat=not last) \
            + h[:T] @ p[f"skip{i}.weight"].T + p[f"skip{i}.bias"]
        if not last:
            h = F.elu(h)
            if masks is not None:
                h = h * masks[i][:T]
    return torch.log_softmax(h, dim=-1)


def loss_and_grads(params: Dict[str, torch.Tensor], x: torch.Tensor,
                   hops, targets, y: torch.Tensor, masks=None):
    """(log-probabilities, the mean NLL over the seeds, each parameter's
    gradient of it), all float32."""
    leaves = {k: v.detach().float().clone().requires_grad_(True)
              for k, v in params.items()}
    logp = forward(leaves, x, hops, targets, masks)
    loss = F.nll_loss(logp, y)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return logp.detach(), loss.detach(), dict(zip(leaves, grads))
