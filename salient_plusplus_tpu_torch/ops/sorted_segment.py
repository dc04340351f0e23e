"""Sorted segment sums and the scatter-free aggregation built on them.

Counterpart of the JAX package's ``ops/mxu_segment.py``, with its public
names. There, ``sorted_segment_sum_mxu`` runs the Pallas TPU kernel
``_segment_kernel``: a one-hot MXU matmul over 512-edge DMA chunks and
128-target tiles, a design that answers the TPU's slow scatters. That
design is not carried over. Here the same function is the hand-written
CUDA kernel ``csrc/sorted_segment_sum.cu`` (design in
``csrc/segment_common.cuh``, shared with K2): the edges are cut into
slices of 64, each summed in order by a group of lanes with 16-byte
loads; segments that cross a slice edge leave partial rows in a scratch
buffer that a second pass sums in a fixed order (no atomics).

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor runs
``_sorted_segment_sum_plain``. There is no fallback between the two.

The sampler emits each hop sorted by target (``dst`` nondecreasing, pads ==
num_segments) and a src-sorted mirror (``msrc``/``mdst``), so ``spmm_agg``
never scatters:

    fwd:  msg = x[src]            (row gather)
          out = segsum(msg, dst)  (kernel, dst-sorted)
    bwd:  h   = (d_out/deg)[mdst] (row gather)
          d_x = segsum(h, msrc)   (kernel, src-sorted mirror)

A hop without a mirror runs the fused gather + segment sum instead
(``ops/pallas_aggregate.py``).
"""

from __future__ import annotations

import ctypes

import torch

from ..native.build import launch_kernel
from .pallas_aggregate import (_DTYPE_CODE, _split_scratch,
                               fused_segment_sum_op)

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64]


def _sorted_segment_sum_plain(vals: torch.Tensor, ids: torch.Tensor,
                              num_segments: int) -> torch.Tensor:
    """Plain torch version of the kernel: f32 ``index_add_`` over the edges
    whose ids are below ``num_segments`` (the rest land in a dropped row)."""
    keep = ids.long().clamp(max=num_segments)
    out = torch.zeros(num_segments + 1, vals.shape[1], dtype=torch.float32,
                      device=vals.device)
    return out.index_add_(0, keep, vals.float())[:num_segments]


def sorted_segment_sum_mxu(vals: torch.Tensor, ids: torch.Tensor,
                           num_segments: int) -> torch.Tensor:
    """Segment sum of ``vals`` [E, F] (bf16 or f32) by nondecreasing
    ``ids`` [E] int32; every id >= ``num_segments`` is dropped. Returns
    float32 [num_segments, F]. The name is the JAX package's; no MXU is
    involved."""
    if vals.device.type == "cpu" and ids.device.type == "cpu":
        return _sorted_segment_sum_plain(vals, ids, num_segments)
    if vals.device.type != "cuda":
        raise ValueError(f"sorted_segment_sum_mxu: unsupported device "
                         f"{vals.device}")
    if ids.device != vals.device:
        raise ValueError(f"ids on {ids.device}, vals on {vals.device}")
    if vals.dtype not in _DTYPE_CODE:
        raise TypeError(f"vals dtype {vals.dtype}: bfloat16 or float32")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids dtype {ids.dtype}: int32")
    if vals.dim() != 2 or ids.dim() != 1 or ids.shape[0] != vals.shape[0]:
        raise ValueError(f"shapes vals {tuple(vals.shape)} ids "
                         f"{tuple(ids.shape)}: expected [E, F] and [E]")
    if not (vals.is_contiguous() and ids.is_contiguous()):
        raise ValueError("vals and ids must be contiguous")
    E, F = vals.shape
    out = torch.empty(num_segments, F, dtype=torch.float32,
                      device=vals.device)
    if num_segments == 0 or F == 0:
        return out
    scratch = _split_scratch(E, F, vals.device)
    launch_kernel("sorted_segment_sum", _ARGTYPES, vals.device,
                  vals.data_ptr(), _DTYPE_CODE[vals.dtype], ids.data_ptr(), E,
                  num_segments, F, out.data_ptr(), scratch.data_ptr(),
                  scratch.numel())
    sorted_segment_sum_mxu.launches += 1
    return out


sorted_segment_sum_mxu.launches = 0


def _sorted_degrees(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment counts of a nondecreasing int32 id array (pads >=
    num_segments): searchsorted + diff, no scatter."""
    bounds = torch.arange(num_segments + 1, dtype=torch.int32,
                          device=ids.device)
    return torch.diff(torch.searchsorted(ids, bounds, out_int32=True))


def _spmm_finish(s, x, dst, out_cap: int, mean: bool):
    """Mean division (by the sorted in-degrees) and the cast to x.dtype of
    a hop's f32 segment sum ``s``."""
    deg = None
    if mean:
        deg = _sorted_degrees(dst, out_cap).clamp_min(1).to(torch.float32)
        s = s / deg[:, None]
    return s.to(x.dtype), deg


class _SpmmAgg(torch.autograd.Function):
    """Mirrored aggregation: the backward is the same kernel over the
    hop's src-sorted mirror (``_spmm_fwd``/``_spmm_bwd`` of the JAX
    package)."""

    @staticmethod
    def forward(ctx, x, src, dst, msrc, mdst, out_cap: int, mean: bool):
        s = sorted_segment_sum_mxu(x.index_select(0, src), dst, out_cap)
        out, deg = _spmm_finish(s, x, dst, out_cap, mean)
        ctx.mean = mean
        ctx.in_cap = x.shape[0]
        ctx.x_dtype = x.dtype
        ctx.save_for_backward(msrc, mdst, *(() if deg is None else (deg,)))
        return out

    @staticmethod
    def backward(ctx, d_out):
        msrc, mdst = ctx.saved_tensors[:2]
        g = d_out.to(torch.float32)
        if ctx.mean:
            g = g / ctx.saved_tensors[2][:, None]
        h = g.to(ctx.x_dtype).index_select(0, mdst)
        d_x = sorted_segment_sum_mxu(h, msrc, ctx.in_cap).to(ctx.x_dtype)
        return d_x, None, None, None, None, None, None


def _spmm_agg_nomirror(out_cap: int, mean: bool, x, src, dst, count):
    """Aggregation of a hop without a mirror (the outermost one, and every
    hop of layerwise inference): the fused gather + segment sum (K2), which
    reads ``x[src]`` without materialising it. Its backward, reached only
    by models that differentiate a projection of the raw input, is the
    op's plain ``index_add_`` (the JAX package's is an XLA scatter, not a
    Pallas kernel), through the mean division and the cast."""
    s = fused_segment_sum_op(x, src, dst, count, out_cap)
    return _spmm_finish(s, x, dst, out_cap, mean)[0]


class _SortedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, ids, num_segments: int):
        ctx.num_segments = num_segments
        ctx.vals_dtype = vals.dtype
        ctx.save_for_backward(ids)
        return sorted_segment_sum_mxu(vals, ids, num_segments)

    @staticmethod
    def backward(ctx, d_out):
        (ids,) = ctx.saved_tensors
        T = ctx.num_segments
        real = ids < T
        d_vals = d_out.to(ctx.vals_dtype).index_select(
            0, ids.clamp(max=T - 1))
        return torch.where(real[:, None], d_vals, 0), None, None


def sorted_segment_sum(num_segments: int, vals, ids):
    """Differentiable segment sum of pre-gathered per-edge values (sorted
    ids, pads >= num_segments): kernel forward, masked-gather backward."""
    return _SortedSegmentSum.apply(vals, ids, num_segments)


def spmm_agg(x: torch.Tensor, edge, out_cap: int, mean: bool = True):
    """Aggregate ``x[src]`` per target over one hop's sorted COO. With a
    src-sorted mirror (``edge.msrc``), the gradient w.r.t. x runs the same
    kernel over the mirror; without one, the backward is ``index_add_``."""
    if edge.msrc is not None:
        return _SpmmAgg.apply(x, edge.src, edge.dst, edge.msrc, edge.mdst,
                              out_cap, mean)
    return _spmm_agg_nomirror(out_cap, mean, x, edge.src, edge.dst,
                              edge.count)
