"""Train and eval steps (counterpart of the JAX package's ``train/step.py``).

Forward → masked NLL → backward → Adam, run eagerly on the batch's device.
Masked-loss convention: the model output is [seed_cap, C] log-probs and
only rows < seed_count are real; the loss is the mean NLL over real rows.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.segment import gather_rows, valid_mask
from ..sampling.batch import PaddedBatch
from .state import TrainState


def gather_features(features: torch.Tensor,
                    batch: PaddedBatch) -> torch.Tensor:
    """All-in-memory frontier gather ``features[n_id]`` (the row-gather
    kernel on the card). ``n_id`` is clamped, so no index is ever out of
    range. The host cold tier waits for slice 3."""
    idx = batch.n_id.clamp(max=features.shape[0] - 1)
    return gather_rows(features, idx)


def decode_batch(batch: PaddedBatch) -> PaddedBatch:
    """Materialize wire-compressed fields (ddeg → dst, packed halves →
    int32) once per step; downstream code sees plain int32 sorted COO."""
    batch = batch.decoded_n_id()
    if all(e.ddeg is None and e.src_lo is None for e in batch.edges):
        return batch
    return dataclasses.replace(batch, edges=tuple(
        e.decoded(e.cap) for e in batch.edges))


def _x_and_extra(features: torch.Tensor, batch: PaddedBatch,
                 global_msg0: bool):
    """Frontier features + model kwargs for one step. With global_msg0
    (the batch carries gsrc), layer 0 aggregates straight from the table,
    so only the level-(L-1) prefix of the frontier is gathered."""
    if global_msg0 and batch.gsrc is not None:
        L = batch.spec.num_hops
        pref_cap = batch.spec.node_caps[L - 1]  # n_id is already prefix-only
        idx = batch.n_id[:pref_cap].clamp(max=features.shape[0] - 1)
        return gather_rows(features, idx), {"features": features}
    return gather_features(features, batch), {}


def masked_nll(logp: torch.Tensor, y: torch.Tensor,
               seed_count: torch.Tensor) -> torch.Tensor:
    cap = logp.shape[0]
    mask = valid_mask(cap, seed_count).to(torch.float32)
    nll = -logp.gather(1, y.long()[:, None])[:, 0]
    return (nll * mask).sum() / seed_count.to(torch.float32).clamp_min(1)


def train_step(state: TrainState, features: torch.Tensor,
               batch: PaddedBatch, global_msg0: bool = False) -> torch.Tensor:
    """One optimizer step on a device-resident batch; returns the loss as
    a detached device scalar (reading it is the caller's choice)."""
    batch = decode_batch(batch)
    gen = state.dropout_generator_for_step()
    model = state.model
    model.train()
    x, extra = _x_and_extra(features, batch, global_msg0)
    out = model(x, batch, training=True, generator=gen, **extra)
    loss = masked_nll(out, batch.y, batch.seed_count)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return loss.detach()


@torch.no_grad()
def eval_step(state: TrainState, features: torch.Tensor, batch: PaddedBatch,
              global_msg0: bool = False):
    """Batchwise eval: (correct, total) over seed rows, device scalars."""
    batch = decode_batch(batch)
    model = state.model
    model.eval()
    x, extra = _x_and_extra(features, batch, global_msg0)
    out = model(x, batch, training=False, **extra)
    pred = out.argmax(-1).to(torch.int32)
    mask = valid_mask(out.shape[0], batch.seed_count)
    correct = (mask & (pred == batch.y)).sum()
    return correct, batch.seed_count.to(torch.int64)
