"""Row gather ``out[i] = table[idx[i]]`` (counterpart of the JAX package's
``ops/pallas_gather.py``, with its public names).

There, ``pallas_gather_rows`` runs the Pallas TPU kernel ``_gather_kernel``:
one program per block of 256 rows, double-buffered row DMAs from HBM into
VMEM, addresses from scalar-prefetched indices. The block and the padding
of ``idx`` to it are TPU devices and are not carried over. Here the same
function is the hand-written CUDA kernel ``csrc/gather_rows.cu``: one warp
per output row copies the row as bytes (16-byte vectors where the row
width and both pointers allow), so any dtype works.

Its targets are the feature assembly ``features[n_id]`` of a train step,
the per-chunk gather of layerwise inference and ARMA's gather of the
scaled projection ``h * deg_src^-1/2``, which needs a gradient: on the
card the kernel runs inside a ``torch.autograd.Function`` whose backward
adds the incoming rows back with ``index_add_``.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor runs
``_gather_rows_plain``. There is no fallback between the two. Every index
must lie in ``[0, table.shape[0])``: the kernel does not check, so callers
clamp (``train/step.py``) or pass ids that are real by construction.
"""

from __future__ import annotations

import ctypes

import torch

from ..native.build import launch_kernel

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_void_p]


def _gather_rows_plain(table: torch.Tensor, idx: torch.Tensor
                       ) -> torch.Tensor:
    """Plain torch version of the kernel."""
    return table.index_select(0, idx)


def _launch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Check the inputs and launch the kernel into a fresh output."""
    if table.device.type != "cuda":
        raise ValueError(f"pallas_gather_rows: unsupported device "
                         f"{table.device}")
    if idx.device != table.device:
        raise ValueError(f"idx on {idx.device}, table on {table.device}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx dtype {idx.dtype}: int32")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"shapes table {tuple(table.shape)} idx "
                         f"{tuple(idx.shape)}: expected [N, F] and [n]")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    out = torch.empty(idx.shape[0], table.shape[1], dtype=table.dtype,
                      device=table.device)
    row_bytes = table.shape[1] * table.element_size()
    if out.numel() == 0:
        return out
    launch_kernel("gather_rows", _ARGTYPES, table.device, table.data_ptr(),
                  idx.data_ptr(), idx.shape[0], row_bytes, out.data_ptr())
    pallas_gather_rows.launches += 1
    return out


class _GatherRows(torch.autograd.Function):
    """The kernel forward; the backward is the transpose of the gather,
    ``index_add_`` of the incoming rows into a zero [N, F] table in f32,
    cast to the table's dtype (XLA's transpose of ``take`` in the JAX
    package: no Pallas kernel)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.num_rows = table.shape[0]
        ctx.table_dtype = table.dtype
        ctx.save_for_backward(idx)
        return _launch(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        d = torch.zeros(ctx.num_rows, g.shape[1], dtype=torch.float32,
                        device=g.device)
        d.index_add_(0, idx.long(), g.float())
        return d.to(ctx.table_dtype), None


def pallas_gather_rows(table: torch.Tensor, idx: torch.Tensor
                       ) -> torch.Tensor:
    """``table[idx]`` for a 2-d table of any dtype and int32 ``idx`` [n],
    differentiable in ``table`` on both devices. The name is the JAX
    package's; no Pallas is involved."""
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return _gather_rows_plain(table, idx)
    return _GatherRows.apply(table, idx)


pallas_gather_rows.launches = 0
