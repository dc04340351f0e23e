"""Train and eval steps (counterpart of the JAX package's ``train/step.py``).

Forward → masked NLL → backward → Adam, run eagerly on the batch's device.
Masked-loss convention: the model output is [seed_cap, C] log-probs and
only rows < seed_count are real; the loss is the mean NLL over real rows.

Under a profiler a train step is the span ``step.train`` holding, in
order, ``step.decode``, ``step.gather`` (the frontier gather),
``step.forward``, ``step.loss``, ``step.backward`` and ``step.optimizer``;
an eval step is ``step.eval`` holding ``step.decode``, ``step.gather``,
``step.forward`` and ``step.score``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.segment import gather_rows, valid_mask
from ..ops.sorted_segment import _sorted_degrees, sorted_segment_sum_mxu
from ..parallel.exchange import fp8_decode_rows
from ..sampling.batch import PaddedBatch
from ..utils.timing import span
from .state import TrainState


def _cold_rows(batch: PaddedBatch, dtype) -> torch.Tensor:
    """The batch's cold rows in ``dtype`` (fp8 payloads decoded)."""
    if batch.cold_scale is not None:
        return fp8_decode_rows(batch.cold_rows, batch.cold_scale, dtype)
    return batch.cold_rows.to(dtype)


def gather_features(features: torch.Tensor,
                    batch: PaddedBatch) -> torch.Tensor:
    """Frontier gather ``features[n_id]`` (the row-gather kernel K3 on the
    card) with the host cold tier's overlay.

    ``n_id`` is clamped, so no index is ever out of range. With a hot/cold
    split ``features`` holds only the hot prefix; the cold frontier rows
    arrive in the batch (gathered by a sampler thread) and replace the
    clamped rows. ``cold_pos`` is ascending (the sampler scans the
    frontier in order) with pads above every row, so the overlay is a
    sorted placement: one call of the segment-sum kernel K1 puts each row
    in its slot (one row a segment, so the f32 sum is the row itself) and
    a searchsorted-diff gives the presence mask; pads are dropped."""
    idx = batch.n_id.clamp(max=features.shape[0] - 1)
    x = gather_rows(features, idx)
    if batch.cold_rows is None:
        return x
    T = x.shape[0]
    placed = sorted_segment_sum_mxu(_cold_rows(batch, x.dtype),
                                    batch.cold_pos, T)
    mask = _sorted_degrees(batch.cold_pos, T) > 0
    return torch.where(mask[:, None], placed.to(x.dtype), x)


def write_cold_rows(features: torch.Tensor, batch: PaddedBatch,
                    slack_at: Optional[int]) -> None:
    """Write the batch's cold rows into the device table's slack region,
    in place, on the current stream (so in stream order before the step
    that reads them). ``slack_at`` (the plain gsrc cold tier): the rows
    go contiguously to ``[slack_at, slack_at + cap)``. None (the cold-row
    cache): each miss row goes to its slot ``cold_pos``; the pads (2^30)
    are clamped to the table's last row, the cache's permanent zero row,
    and write zeros there."""
    rows = _cold_rows(batch, features.dtype)
    if slack_at is not None:
        features[slack_at:slack_at + rows.shape[0]].copy_(rows)
        return
    pos = batch.cold_pos.clamp(max=features.shape[0] - 1).long()
    features.index_copy_(0, pos, rows)


def strip_cold(batch: PaddedBatch) -> PaddedBatch:
    return batch.replace(cold_rows=None, cold_pos=None, cold_scale=None,
                         cold_count=None)


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
               batch: PaddedBatch, global_msg0: bool = False,
               fold_cold: bool = False,
               fold_slack_at: Optional[int] = None) -> torch.Tensor:
    """One optimizer step on a device-resident batch; returns the loss as
    a detached device scalar (reading it is the caller's choice).

    ``fold_cold`` (cold_fold_update): the step's first operation writes
    the batch's cold rows into ``features`` in place (``write_cold_rows``:
    contiguously at ``fold_slack_at``, or, when that is None, to the
    cache slots)."""
    with span("step.train"):
        if fold_cold:
            write_cold_rows(features, batch, fold_slack_at)
            batch = strip_cold(batch)
        with span("step.decode"):
            batch = decode_batch(batch)
        gen = state.dropout_generator_for_step()
        model = state.model
        model.train()
        with span("step.gather"):
            x, extra = _x_and_extra(features, batch, global_msg0)
        with span("step.forward"):
            out = model(x, batch, training=True, generator=gen, **extra)
        with span("step.loss"):
            loss = masked_nll(out, batch.y, batch.seed_count)
        with span("step.backward"):
            # launches nothing (the gradients go to None); it has to come
            # before the backward, and the gradients stay readable after
            # the step
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with span("step.optimizer"):
            state.optimizer.step()
        state.step += 1
        return loss.detach()


@torch.no_grad()
def eval_step(state: TrainState, features: torch.Tensor, batch: PaddedBatch,
              global_msg0: bool = False):
    """Batchwise eval: (correct, total) over seed rows, device scalars."""
    with span("step.eval"):
        with span("step.decode"):
            batch = decode_batch(batch)
        model = state.model
        model.eval()
        with span("step.gather"):
            x, extra = _x_and_extra(features, batch, global_msg0)
        with span("step.forward"):
            out = model(x, batch, training=False, **extra)
        with span("step.score"):
            pred = out.argmax(-1).to(torch.int32)
            mask = valid_mask(out.shape[0], batch.seed_count)
            correct = (mask & (pred == batch.y)).sum()
        return correct, batch.seed_count.to(torch.int64)
