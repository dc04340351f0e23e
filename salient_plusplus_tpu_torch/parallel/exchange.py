"""Distributed feature assembly over partitioned features, and the fp8 row
codec (counterpart of the JAX package's ``parallel/exchange.py``).

Each rank holds the feature rows of one contiguous id range. To assemble a
batch's frontier ``x[n_id]`` a rank

  1. finds each id's owner by a searchsorted over the partition offsets,
  2. classes it local, cached (a sorted VIP cache of remote rows) or
     remote,
  3. packs the remote ids per owner into a fixed ``[world, r_cap]``
     request buffer with one argsort, so no counts travel and no size is
     read back to the host,
  4. sends the ids with one ``all_to_all_single``, serves the rows it owns
     for every requester, and gets its rows back with a second one,
  5. puts every row in frontier order through the inverse of the packing
     permutation; local and cached rows are gathered on the rank.

Requests past ``r_cap`` for one owner are counted as overflow and come
back as zero rows. The row gathers run the port's K3 kernel
(``ops/pallas_gather.py``) on the card and its plain version on the CPU.

fp8 codec: rows are scaled to an amax of 448, the largest finite e4m3
value, and cast; each row keeps its float32 amax (the dequant scale is
``amax / 448``). torch's float32 → ``float8_e4m3fn`` cast rounds to
nearest even, as ml_dtypes' does, so the bytes equal the JAX package's.
The two differ only above |464|, where torch saturates to 448 and
ml_dtypes gives NaN; rows scaled to amax 448 never reach it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.pallas_gather import pallas_gather_rows

_FP8_MAX = 448.0  # float8_e4m3fn largest finite


class DeviceCache(NamedTuple):
    """A rank's VIP cache: sorted global ids of remote vertices and their
    feature rows."""

    vertices: torch.Tensor   # int [C], sorted
    features: torch.Tensor   # [C, F]


class ExchangeStats(NamedTuple):
    num_local: torch.Tensor
    num_cached: torch.Tensor
    num_remote: torch.Tensor
    num_overflow: torch.Tensor
    sent_bytes: torch.Tensor  # float32: the feature payload this rank sends


def sorted_isin(sorted_ref: torch.Tensor, ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(membership mask, position) of ``ids`` in the sorted ``sorted_ref``;
    the position is clamped into the array. Both are searched as int64
    (``torch.searchsorted`` wants one dtype)."""
    ref = sorted_ref.to(torch.int64)
    q = ids.to(torch.int64)
    pos = torch.searchsorted(ref, q).clamp(0, ref.shape[0] - 1)
    return ref[pos] == q, pos


def wire_row_bytes(num_features: int, dtype, wire_fp8: bool) -> int:
    """Bytes a feature row takes on the wire: fp8 ships one byte an
    element plus the float32 row amax."""
    if wire_fp8:
        return num_features + 4
    return num_features * torch.empty((), dtype=dtype).element_size()


def fp8_encode_rows_np(x: np.ndarray):
    """Host-side one-time fp8 (e4m3) row encoding: (uint8 payload [N, F],
    float32 dequant scale [N]). Decode with :func:`fp8_decode_rows`."""
    xf = np.asarray(x, np.float32)
    amax = np.abs(xf).max(axis=1)
    # masked divide (np.where would still evaluate _FP8_MAX / 0 and warn)
    q_scale = np.ones_like(amax, np.float32)
    np.divide(_FP8_MAX, amax, out=q_scale, where=amax > 0)
    scaled = torch.from_numpy(np.ascontiguousarray(xf * q_scale[:, None]))
    payload = scaled.to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    return payload, (amax / _FP8_MAX).astype(np.float32)


def fp8_decode_rows(rows_u8: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """Decode :func:`fp8_encode_rows_np` payloads on the tensors' device:
    the bytes as e4m3, to float32, times the row scale, then ``dtype``."""
    rows = rows_u8.view(torch.float8_e4m3fn).to(torch.float32)
    return (rows * scale[:, None]).to(dtype)


def fp8_wire_encode(rows: torch.Tensor) -> torch.Tensor:
    """Rows [..., F] → the fp8 wire [..., F + 4] uint8: each row scaled so
    its amax maps to 448 and cast to e4m3, then the 4 bytes of its float32
    amax."""
    x = rows.to(torch.float32)
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, _FP8_MAX / amax, torch.ones_like(amax))
    rows8 = (x * scale).to(torch.float8_e4m3fn).view(torch.uint8)
    return torch.cat([rows8, amax.view(torch.uint8)], dim=-1)


def fp8_wire_decode(wire: torch.Tensor, dtype) -> torch.Tensor:
    """The fp8 wire [..., F + 4] → rows [..., F] in ``dtype``: e4m3 to
    float32 times ``amax · (1/448)``. The reciprocal is rounded to float32
    first: XLA compiles the JAX package's ``amax / 448`` into that
    multiply, so the port computes the same bits."""
    f = wire.shape[-1] - 4
    rows = wire[..., :f].contiguous().view(torch.float8_e4m3fn)
    amax = wire[..., f:].contiguous().view(torch.float32)
    return (rows.to(torch.float32) * (amax * (1.0 / _FP8_MAX))).to(dtype)


def _fp8_wire_exchange(served: torch.Tensor, group=None) -> torch.Tensor:
    """The row all_to_all with per-row fp8 (e4m3) compression: the rows
    and their amax bytes go in one uint8 collective. Zero rows stay
    exact."""
    wire = fp8_wire_encode(served)
    recv = torch.empty_like(wire)
    dist.all_to_all_single(recv, wire, group=group)
    return fp8_wire_decode(recv, served.dtype)


def assemble_features(
    local_shard: torch.Tensor,
    n_id: torch.Tensor,
    frontier_count,
    part_offsets: torch.Tensor,
    r_cap: int,
    cache: Optional[DeviceCache] = None,
    hot_size: Optional[int] = None,
    wire_fp8: bool = False,
    group=None,
) -> Tuple[torch.Tensor, ExchangeStats]:
    """``x[n_id]`` over partitioned features: [N_cap, F] rows in
    ``local_shard``'s dtype, zero past ``frontier_count``, and this rank's
    ExchangeStats.

    local_shard: [V_local, F] this rank's rows (on the rank's device).
    n_id: [N_cap] global frontier ids, any integer dtype.
    frontier_count: the real frontier size, an int or a 0-d tensor; it is
        never read back to the host.
    part_offsets: [world + 1] partition offsets; ``world`` must be the
        group's size, and this rank owns partition ``dist.get_rank(group)``.
    r_cap: the fixed per-owner request budget.
    hot_size: each shard holds only the first ``hot_size`` rows of its
        partition; frontier ids past a partition's hot prefix are cold,
        left out of the exchange and its counts, and come back as zeros
        (the caller overlays them).
    wire_fp8: the response rows travel as fp8 with a float32 row amax.

    The sort key ``dest * (N_cap + 1) + slot`` is built in int64, so
    ``world * (N_cap + 1)`` has no int32 limit. Several non-remote or
    overflowing ids write the sink slot ``world * r_cap`` of the request
    buffer; the slot is dropped.
    """
    dev = local_shard.device
    N_cap = n_id.shape[0]
    F = local_shard.shape[1]
    world = part_offsets.numel() - 1
    if world != dist.get_world_size(group):
        raise ValueError(f"{world} partitions, but the group has "
                         f"{dist.get_world_size(group)} ranks")
    my = dist.get_rank(group)
    offs = part_offsets.to(device=dev, dtype=torch.int64)
    ids = n_id.to(device=dev, dtype=torch.int64)
    my_off = offs[my]
    last_row = local_shard.shape[0] - 1

    idx = torch.arange(N_cap, device=dev)
    valid = idx < frontier_count
    owner = torch.searchsorted(offs[1:].contiguous(), ids, right=True)
    if hot_size is not None:
        # ids at or past offs[-1] (pads) own no partition: clamp the take
        local_off = ids - offs[owner.clamp(max=world - 1)]
        valid = valid & (local_off < hot_size)
    is_local = (owner == my) & valid
    if cache is not None:
        hit, cache_pos = sorted_isin(cache.vertices, ids)
        is_cached = hit & valid & ~is_local
    else:
        is_cached = torch.zeros_like(valid)
    is_remote = valid & ~is_local & ~is_cached

    # ---- pack the remote ids per owner (one argsort) ----
    dest = torch.where(is_remote, owner, world)          # non-remote last
    order = torch.argsort(dest * (N_cap + 1) + idx)      # keys are unique
    dest_sorted = dest[order]
    counts = torch.zeros(world + 1, dtype=torch.int64, device=dev
                         ).index_add_(0, dest, torch.ones_like(dest))[:world]
    start = torch.cat([counts.new_zeros(1), counts.cumsum(0)[:-1]])
    pos_sorted = idx - start[dest_sorted.clamp(max=world - 1)]
    in_bounds = (dest_sorted < world) & (pos_sorted < r_cap)
    sink = world * r_cap
    flat_slot_sorted = torch.where(in_bounds, dest_sorted * r_cap + pos_sorted,
                                   sink)
    req_flat = torch.full((sink + 1,), -1, dtype=torch.int32, device=dev)
    req_flat.scatter_(0, flat_slot_sorted,
                      torch.where(in_bounds, ids[order], -1).to(torch.int32))
    req = req_flat[:-1].view(world, r_cap)
    # inverse mapping: frontier slot → flat response index
    resp_slot = torch.empty(N_cap, dtype=torch.int64, device=dev)
    resp_slot.scatter_(0, order, flat_slot_sorted)
    num_overflow = is_remote.sum() - in_bounds.sum()

    # ---- id exchange ----
    req_recv = torch.empty_like(req)
    dist.all_to_all_single(req_recv, req, group=group)
    # ---- serve my rows to each requester ----
    serve_valid = (req_recv >= 0).view(-1, 1)
    lrows = (req_recv.view(-1).to(torch.int64) - my_off).clamp(0, last_row)
    served = pallas_gather_rows(local_shard, lrows.to(torch.int32))
    served = torch.where(serve_valid, served, 0).view(world, r_cap, F)
    # ---- row exchange back ----
    if wire_fp8:
        resp = _fp8_wire_exchange(served, group)
    else:
        resp = torch.empty_like(served)
        dist.all_to_all_single(resp, served, group=group)
    resp_flat = torch.cat([resp.view(sink, F), resp.new_zeros(1, F)])

    # ---- the frontier in order ----
    local_rows = (ids - my_off).clamp(0, last_row).to(torch.int32)
    x = torch.where(is_local[:, None],
                    pallas_gather_rows(local_shard, local_rows),
                    resp_flat[resp_slot])
    if cache is not None:
        x_cache = pallas_gather_rows(cache.features,
                                     cache_pos.to(torch.int32))
        x = torch.where(is_cached[:, None], x_cache, x)
    x = torch.where(valid[:, None], x, 0)

    bytes_per_row = wire_row_bytes(F, local_shard.dtype, wire_fp8)
    stats = ExchangeStats(
        num_local=is_local.sum(),
        num_cached=is_cached.sum(),
        num_remote=is_remote.sum(),
        num_overflow=num_overflow,
        # float32, as in the JAX package: rows × bytes a row overflows
        # int32 at ~5e5 rows of 4 KB, and 2^-24 relative error is nothing
        # for a byte counter
        sent_bytes=serve_valid.sum().to(torch.float32) * bytes_per_row,
    )
    return x, stats
