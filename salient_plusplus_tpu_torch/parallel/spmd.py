"""Data-parallel train and eval steps over a ``torch.distributed`` group
(counterpart of the JAX package's ``parallel/spmd.py``).

One process a GPU, as in the reference: each rank runs its own batch
through the model; the step then averages what data parallelism must
agree on, in ONE ``all_reduce`` over a flat float32 buffer holding every
gradient, the loss and every BatchNorm running statistic, divided by the
group's size. The normalisation itself used the rank's own batch, as in
the JAX package, whose ``pmean`` of the stats follows the update. No
``DistributedDataParallel``: it broadcasts rank 0's buffers instead of
averaging them, and its bucketed hooks would interleave with the
exchange's collectives inside the forward.

Feature modes:
  - "replicated": the whole table on every rank; the lookup is the
    single-card gather (with its cold overlay).
  - "partitioned": the table is row-sharded by contiguous id ranges, one
    shard a rank; the lookup is ``assemble_features`` (two
    ``all_to_all_single`` calls, K3 for its row gathers), then the cold
    rows of the batch, if any, are written over their frontier slots.

Dropout differs by rank and reproduces across runs: each rank's
generator is seeded from ``step_seed(step_seed(seed, step), rank)``, as
the JAX package folds the step and then the rank into its dropout key.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.segment import valid_mask
from ..sampling.batch import PaddedBatch
from ..train.state import TrainState, step_seed
from ..train.step import decode_batch, gather_features, masked_nll
from .exchange import DeviceCache, ExchangeStats, assemble_features
from .exchange import fp8_decode_rows


def overlay_rows(x: torch.Tensor, pos: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """``x`` with ``rows[i]`` written at frontier slot ``pos[i]``; slots at
    or past ``x.shape[0]`` (the pads) are dropped, as the JAX package's
    ``x.at[pos].set(rows, mode="drop")``. ``pos`` need not be sorted (the
    owner-served layout is by owner). The pads are clamped to one sink row
    past the end, which is cut off: an index out of range would assert on
    CUDA."""
    n = x.shape[0]
    out = torch.cat([x, x.new_zeros(1, x.shape[1])])
    out.index_copy_(0, pos.long().clamp(max=n), rows.to(x.dtype))
    return out[:n]


def lookup_features(features: torch.Tensor, batch: PaddedBatch,
                    feature_mode: str, part_offsets: torch.Tensor,
                    r_cap: int, cache: Optional[DeviceCache] = None,
                    hot_size: Optional[int] = None, wire_fp8: bool = False,
                    group=None
                    ) -> Tuple[torch.Tensor, Optional[ExchangeStats]]:
    """The frontier rows of a decoded batch and this rank's ExchangeStats
    (None in replicated mode)."""
    if feature_mode == "replicated":
        return gather_features(features, batch), None
    x, stats = assemble_features(
        features, batch.n_id, batch.level_sizes[-1], part_offsets, r_cap,
        cache, hot_size=hot_size, wire_fp8=wire_fp8, group=group)
    if batch.cold_pos is not None and batch.cold_rows is not None:
        rows = batch.cold_rows
        if batch.cold_scale is not None:
            rows = fp8_decode_rows(rows, batch.cold_scale, x.dtype)
        x = overlay_rows(x, batch.cold_pos, rows)
    return x, stats


def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])


def _unflat_into(flat: torch.Tensor, tensors: List[torch.Tensor]) -> None:
    o = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[o:o + n].view_as(t))
        o += n


def broadcast_model(model: torch.nn.Module, group=None) -> None:
    """Every parameter and buffer of ``model`` set to the group's rank 0
    copy, in one broadcast."""
    ts = list(model.parameters()) + [b for b in model.buffers()
                                     if b.is_floating_point()]
    flat = _flat([t.detach() for t in ts])
    src = 0 if group is None else dist.get_global_rank(group, 0)
    dist.broadcast(flat, src, group=group)
    with torch.no_grad():
        _unflat_into(flat, [t.data for t in ts])


def train_step(state: TrainState, features: torch.Tensor,
               batch: PaddedBatch, feature_mode: str = "partitioned",
               part_offsets: Optional[torch.Tensor] = None, r_cap: int = 1024,
               cache: Optional[DeviceCache] = None,
               hot_size: Optional[int] = None, wire_fp8: bool = False,
               group=None) -> Tuple[torch.Tensor, Optional[ExchangeStats]]:
    """One data-parallel optimizer step on this rank's device batch.

    Returns the group's mean loss (a detached device scalar) and this
    rank's ExchangeStats (None in replicated mode); the caller sums the
    stats over steps and reduces them over the group when it reads them.
    """
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    batch = decode_batch(batch)
    gen = state.dropout_generator.manual_seed(
        step_seed(step_seed(state.seed, state.step), rank))
    model = state.model
    model.train()
    x, ex = lookup_features(features, batch, feature_mode, part_offsets,
                            r_cap, cache, hot_size, wire_fp8, group)
    out = model(x, batch, training=True, generator=gen)
    loss = masked_nll(out, batch.y, batch.seed_count)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    stats = [b for b in model.buffers() if b.is_floating_point()]
    grads = [p.grad for p in params]
    flat = _flat(grads + [loss.detach()[None]] + stats)
    dist.all_reduce(flat, group=group)
    flat /= world
    ng = sum(g.numel() for g in grads)
    _unflat_into(flat[:ng], grads)
    state.optimizer.step()
    # the running statistics are averaged after the update, as in JAX
    with torch.no_grad():
        _unflat_into(flat[ng + 1:], stats)
    state.step += 1
    return flat[ng].detach(), ex


@torch.no_grad()
def eval_step(state: TrainState, features: torch.Tensor, batch: PaddedBatch,
              feature_mode: str = "partitioned",
              part_offsets: Optional[torch.Tensor] = None, r_cap: int = 1024,
              cache: Optional[DeviceCache] = None,
              hot_size: Optional[int] = None, wire_fp8: bool = False,
              group=None) -> torch.Tensor:
    """This rank's (correct, total, exchange overflow) as an int64 device
    tensor [3]; the caller sums it over batches and the group. Overflowed
    remote rows come back as zeros, so an accuracy read with overflow > 0
    ran on corrupted features and the caller must recalibrate."""
    batch = decode_batch(batch)
    model = state.model
    model.eval()
    x, ex = lookup_features(features, batch, feature_mode, part_offsets,
                            r_cap, cache, hot_size, wire_fp8, group)
    out = model(x, batch, training=False)
    pred = out.argmax(-1).to(torch.int32)
    mask = valid_mask(out.shape[0], batch.seed_count)
    correct = (mask & (pred == batch.y)).sum()
    overflow = (ex.num_overflow if ex is not None
                else torch.zeros((), dtype=torch.int64, device=x.device))
    return torch.stack([correct.to(torch.int64),
                        batch.seed_count.to(torch.int64),
                        overflow.to(torch.int64)])


def shard_features_by_partition(x_shards) -> Tuple[np.ndarray, np.ndarray]:
    """Pad per-partition shards to one row count: (the padded table
    [world · V_pad, F], part_offsets [world + 1] of the padded id space).
    A rank keeps rows ``[rank · V_pad, (rank + 1) · V_pad)``. Callers
    relabel graph ids into the padded space (``data/reorder.py`` does)."""
    world = len(x_shards)
    v_pad = max(s.shape[0] for s in x_shards)
    padded = np.zeros((world * v_pad, x_shards[0].shape[1]),
                      x_shards[0].dtype)
    for i, s in enumerate(x_shards):
        padded[i * v_pad:i * v_pad + s.shape[0]] = s
    return padded, np.arange(world + 1, dtype=np.int32) * v_pad
