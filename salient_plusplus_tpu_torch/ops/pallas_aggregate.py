"""Fused gather + sorted segment sum (counterpart of the JAX package's
``ops/pallas_aggregate.py``, with its public names).

    out[t] = sum over e < count with dst[e] == t of emb[src[e]]

without materialising ``emb[src]``. There, ``fused_gather_segment_sum``
runs the Pallas TPU kernel ``_kernel``: per 64-target tile, index chunks
DMA'd to SMEM and a ring of row DMAs from HBM, accumulated in VMEM. The
tiles, index chunks and DMA ring (``tile_starts``, ``t_tile``, ``chunk``,
``r``) are TPU devices and are not carried over. Here the same function is
the hand-written CUDA kernel ``csrc/fused_gather_segment_sum.cu`` (design
in ``csrc/segment_common.cuh``, shared with K1): the real edges (below
``count``, read on the device) are cut into slices of 64, each walked in
order by a group of lanes that reads each ``emb[src[e]]`` row straight
from the table in 16-byte loads; segments that cross a slice edge leave
partial rows in a scratch buffer that a second pass sums in a fixed order.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor runs
``_fused_gather_segment_sum_plain``. There is no fallback between the two.

Its dominant use is an aggregation that needs no gradient: the outermost
hop over the raw feature table (training's layer 0) and every hop of
layerwise inference (``ops/sorted_segment.py::_SpmmAggNoMirror``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..native.build import launch_kernel
from .segment import _real_rows, _safe_dst

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
# kSlice of csrc/segment_common.cuh (edges a worker of K1 and K2 owns); the
# kernels refuse a scratch sized for a larger one
_SLICE_EDGES = 64


def _split_scratch(E: int, F: int, device) -> torch.Tensor:
    """K1's and K2's scratch: two f32 partial rows (F rounded up to 4) per
    slice of ``_SLICE_EDGES`` edges, for the segments that cross a slice
    edge. Uninitialised: the kernels read only what they wrote."""
    slices = -(-E // _SLICE_EDGES)
    return torch.empty(2 * slices * (-(-F // 4) * 4), dtype=torch.float32,
                       device=device)


def _fused_gather_segment_sum_plain(emb: torch.Tensor, src: torch.Tensor,
                                    dst: torch.Tensor, count,
                                    num_segments: int) -> torch.Tensor:
    """Plain torch version of the kernel: row gather, then f32
    ``index_add_`` over the real edges. Dropped edges read row 0, so no pad
    src (which need not be a valid row) is ever used as an index."""
    ids, rows = _real_rows(src, dst, count, num_segments)
    out = torch.zeros(num_segments + 1, emb.shape[1], dtype=torch.float32,
                      device=emb.device)
    return out.index_add_(0, ids, emb.index_select(0, rows).float()
                          )[:num_segments]


def fused_gather_segment_sum(emb: torch.Tensor, src: torch.Tensor,
                             dst: torch.Tensor, count,
                             num_segments: int) -> torch.Tensor:
    """Segment sum of the rows ``emb[src[e]]`` ([N, F] bf16 or f32) by
    ``dst`` [E] int32, nondecreasing over the first ``count`` edges (a 0-d
    int32 tensor or an int); edges ``>= count`` and ids ``>= num_segments``
    are dropped and their ``src`` never read. Returns float32
    [num_segments, F]."""
    if emb.device.type == "cpu" and src.device.type == "cpu":
        return _fused_gather_segment_sum_plain(emb, src, dst, count,
                                               num_segments)
    if emb.device.type != "cuda":
        raise ValueError(f"fused_gather_segment_sum: unsupported device "
                         f"{emb.device}")
    if not isinstance(count, torch.Tensor):
        count = torch.tensor(count, dtype=torch.int32, device=emb.device)
    for name, t in (("src", src), ("dst", dst), ("count", count)):
        if t.device != emb.device:
            raise ValueError(f"{name} on {t.device}, emb on {emb.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} dtype {t.dtype}: int32")
    if emb.dtype not in _DTYPE_CODE:
        raise TypeError(f"emb dtype {emb.dtype}: bfloat16 or float32")
    if (emb.dim() != 2 or src.dim() != 1 or src.shape != dst.shape
            or count.numel() != 1):
        raise ValueError(f"shapes emb {tuple(emb.shape)} src "
                         f"{tuple(src.shape)} dst {tuple(dst.shape)} count "
                         f"{tuple(count.shape)}: expected [N, F], [E], [E] "
                         f"and one value")
    if not (emb.is_contiguous() and src.is_contiguous()
            and dst.is_contiguous()):
        raise ValueError("emb, src and dst must be contiguous")
    F = emb.shape[1]
    out = torch.empty(num_segments, F, dtype=torch.float32,
                      device=emb.device)
    if num_segments == 0 or F == 0:
        return out
    scratch = _split_scratch(src.shape[0], F, emb.device)
    launch_kernel("fused_gather_segment_sum", _ARGTYPES, emb.device,
                  emb.data_ptr(), _DTYPE_CODE[emb.dtype], src.data_ptr(),
                  dst.data_ptr(), count.data_ptr(), src.shape[0],
                  num_segments, F, out.data_ptr(), scratch.data_ptr(),
                  scratch.numel())
    fused_gather_segment_sum.launches += 1
    return out


fused_gather_segment_sum.launches = 0


def _scatter_bwd(g: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                 count, num_rows: int) -> torch.Tensor:
    """Transpose of the fused aggregation: ``d_emb[src[e]] += g[dst[e]]``
    over the real edges, by ``index_add_`` in g's dtype (the JAX package's
    ``_fused_bwd`` is an XLA scatter, not a Pallas kernel)."""
    ids = _safe_dst(dst, count, g.shape[0])
    # dropped edges read an appended zero row and land in a dropped row
    g_pad = torch.cat([g, g.new_zeros((1, g.shape[1]))])
    d_emb = g.new_zeros((num_rows + 1, g.shape[1]))
    return d_emb.index_add_(0, torch.where(ids < g.shape[0], src.long(),
                                           num_rows),
                            g_pad.index_select(0, ids))[:num_rows]


class _FusedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, src, dst, count, num_segments: int):
        ctx.num_rows = emb.shape[0]
        ctx.emb_dtype = emb.dtype
        ctx.save_for_backward(src, dst, count)
        return fused_gather_segment_sum(emb, src, dst, count, num_segments)

    @staticmethod
    def backward(ctx, g):
        src, dst, count = ctx.saved_tensors
        d_emb = _scatter_bwd(g.to(ctx.emb_dtype), src, dst, count,
                             ctx.num_rows)
        return d_emb, None, None, None, None


def fused_segment_sum_op(emb, src, dst, count, num_segments: int):
    """Differentiable fused aggregation (sorted-dst layout): kernel forward,
    ``index_add_`` backward."""
    count = torch.as_tensor(count, dtype=torch.int32, device=src.device)
    return _FusedSegmentSum.apply(emb, src, dst, count, num_segments)


def maybe_fused_segment_sum(values_src_emb, src, dst, count,
                            num_segments: int) -> Optional[torch.Tensor]:
    """The fused aggregation where the shapes qualify (a 2-d table), else
    None: the caller gathers and segment-sums itself."""
    if values_src_emb.dim() != 2:
        return None
    return fused_segment_sum_op(values_src_emb, src, dst, count,
                                num_segments)
