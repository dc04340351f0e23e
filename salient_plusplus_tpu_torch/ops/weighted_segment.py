"""GAT's attention-weighted message sum, fused:

    out[t, h, :] = sum over e < count with dst[e] == t of
                   att[e, h] * xs[src[e], h, :]

without the [E, H * C] messages ``xs[src]`` and their scaled copy that a
gather, a broadcast multiply and the sorted segment sum would write. It
replaces no TPU kernel: the JAX package (``ops/gat_agg.py``) takes the
three steps. On a CUDA tensor it is the hand-written kernel
``csrc/weighted_segment_sum.cu`` (K2's edge slices, ``csrc/
segment_common.cuh``, with an f32 weight an edge and head); on a CPU tensor
``_weighted_segment_sum_plain``. There is no fallback between the two.

``weighted_segment_sum_op`` is differentiable. Its backward,
``weighted_segment_sum_backward``, writes nothing [E, H * C]-wide either:
on a CUDA tensor the hand-written kernels of ``csrc/
weighted_segment_grad.cu`` take ``d_att`` (each real edge's dot of its
target's output gradient with its ``xs[src]`` row, per head) in the
forward's dst order, and ``d_xs`` (the weighted gradient rows summed by
src) in src order, the forward's slice pass with the roles swapped over
the real edges stably sorted by src on the device (``_src_order``; each
sorted edge's dst and weights read through the permutation). On a
CPU tensor ``_weighted_segment_sum_backward_plain`` does what autograd did
through the three steps: the output gradient gathered by dst, its dot
with ``xs[src]``, the weighted rows summed over src by ``index_add_``.
Under a profiler the backward is the span ``gat.attention.backward`` (on
autograd's thread, as ``step.backward`` is).

``weighted_segment_sum.launches`` counts every launch of the forward
kernel, ``weighted_segment_sum.multihead`` those of them with more than
one head (``weighted_slice_pass<..., true>``), and
``weighted_segment_sum.backward`` every backward on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..native.build import launch_kernel
from ..utils.timing import span
from .pallas_aggregate import _DTYPE_CODE, _split_scratch
from .segment import _real_rows, _safe_dst

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64]
_GRAD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  *[ctypes.c_void_p] * 6, *[ctypes.c_int64] * 5,
                  *[ctypes.c_void_p] * 3, ctypes.c_int64]


def _weighted_segment_sum_plain(xs: torch.Tensor, att: torch.Tensor,
                                src: torch.Tensor, dst: torch.Tensor, count,
                                num_segments: int) -> torch.Tensor:
    """Plain torch version of the kernel: row gather, the product with the
    weight in f32, f32 ``index_add_`` over the real edges."""
    N, H, C = xs.shape
    ids, rows = _real_rows(src, dst, count, num_segments)
    msg = xs.index_select(0, rows).float() * att.float()[:, :, None]
    out = torch.zeros(num_segments + 1, H, C, dtype=torch.float32,
                      device=xs.device)
    return out.index_add_(0, ids, msg)[:num_segments]


def _checked_count(xs, att, src, dst, count) -> torch.Tensor:
    """The kernels' inputs checked (device, dtype, shape, contiguity);
    returns ``count`` as a one-value int32 tensor on xs's device."""
    if xs.device.type != "cuda":
        raise ValueError(f"weighted_segment_sum: unsupported device "
                         f"{xs.device}")
    if not isinstance(count, torch.Tensor):
        count = torch.tensor(count, dtype=torch.int32, device=xs.device)
    for name, t in (("att", att), ("src", src), ("dst", dst),
                    ("count", count)):
        if t.device != xs.device:
            raise ValueError(f"{name} on {t.device}, xs on {xs.device}")
    for name, t in (("src", src), ("dst", dst), ("count", count)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} dtype {t.dtype}: int32")
    if xs.dtype not in _DTYPE_CODE:
        raise TypeError(f"xs dtype {xs.dtype}: bfloat16 or float32")
    if att.dtype != torch.float32:
        raise TypeError(f"att dtype {att.dtype}: float32")
    if (xs.dim() != 3 or src.dim() != 1 or src.shape != dst.shape
            or att.shape != (src.shape[0], xs.shape[1])
            or count.numel() != 1):
        raise ValueError(f"shapes xs {tuple(xs.shape)} att "
                         f"{tuple(att.shape)} src {tuple(src.shape)} dst "
                         f"{tuple(dst.shape)} count {tuple(count.shape)}: "
                         f"expected [N, H, C], [E, H], [E], [E] and one "
                         f"value")
    if not all(t.is_contiguous() for t in (xs, att, src, dst)):
        raise ValueError("xs, att, src and dst must be contiguous")
    return count


def weighted_segment_sum(xs: torch.Tensor, att: torch.Tensor,
                         src: torch.Tensor, dst: torch.Tensor, count,
                         num_segments: int) -> torch.Tensor:
    """Segment sum of ``att[e, h] * xs[src[e], h]`` (xs [N, H, C] bf16 or
    f32, att [E, H] f32) by ``dst`` [E] int32, nondecreasing over the
    first ``count`` edges (a 0-d int32 tensor or an int); edges ``>=
    count`` and ids ``>= num_segments`` are dropped, their src and weight
    never read. Returns float32 [num_segments, H, C]."""
    if xs.device.type == "cpu" and src.device.type == "cpu":
        return _weighted_segment_sum_plain(xs, att, src, dst, count,
                                           num_segments)
    count = _checked_count(xs, att, src, dst, count)
    _, H, C = xs.shape
    out = torch.empty(num_segments, H, C, dtype=torch.float32,
                      device=xs.device)
    if num_segments == 0 or H * C == 0:
        return out
    scratch = _split_scratch(src.shape[0], H * C, xs.device)
    launch_kernel("weighted_segment_sum", _ARGTYPES, xs.device,
                  xs.data_ptr(), _DTYPE_CODE[xs.dtype], att.data_ptr(),
                  src.data_ptr(), dst.data_ptr(), count.data_ptr(),
                  src.shape[0], num_segments, H, C, out.data_ptr(),
                  scratch.data_ptr(), scratch.numel())
    weighted_segment_sum.launches += 1
    weighted_segment_sum.multihead += int(H > 1)
    return out


weighted_segment_sum.launches = 0
weighted_segment_sum.multihead = 0
weighted_segment_sum.backward = 0


def _weighted_segment_sum_backward_plain(d_out, xs, att, src, dst, count,
                                         num_segments: int,
                                         need_xs: bool = True,
                                         need_att: bool = True):
    """Plain torch version of the backward, as autograd took it through
    the gather → multiply → segment sum: the output gradient gathered by
    dst in xs's type (0 for dropped edges), ``d_att`` its dot with
    ``xs[src]`` per head in f32, ``d_xs`` the weighted rows summed by src
    with ``index_add_`` in xs's type. (d_xs or None, d_att or None)."""
    ids, rows = _real_rows(src, dst, count, num_segments)
    g = torch.cat([d_out.to(xs.dtype), d_out.new_zeros(
        (1,) + d_out.shape[1:], dtype=xs.dtype)]).index_select(0, ids)
    d_att = d_xs = None
    if need_att:
        d_att = (g * xs.index_select(0, rows)).sum(-1, dtype=torch.float32)
    if need_xs:
        d_xs = torch.zeros_like(xs).index_add_(
            0, rows, g * att.to(xs.dtype)[:, :, None])
    return d_xs, d_att


def _src_order(src: torch.Tensor, dst: torch.Tensor, count,
               num_segments: int, num_rows: int):
    """The edges in src order: (keys, perm), keys the src of each real edge
    (``e < count`` and ``dst[e] < num_segments``) and ``num_rows`` for a
    dropped one, stably sorted, so that the dropped edges come last and
    ties keep edge order; ``perm`` (int64) the edge of each sorted key.
    Reads ``count`` on the device: no host sync."""
    real = _safe_dst(dst, count, num_segments) < num_segments
    keys = torch.where(real, src, torch.full_like(src, num_rows))
    return torch.sort(keys, stable=True)


def weighted_segment_sum_backward(d_out: torch.Tensor, xs: torch.Tensor,
                                  att: torch.Tensor, src: torch.Tensor,
                                  dst: torch.Tensor, count,
                                  num_segments: int, need_xs: bool = True,
                                  need_att: bool = True):
    """The gradients of ``weighted_segment_sum`` for its output gradient
    ``d_out`` [num_segments, H, C] (any float type): (``d_xs`` [N, H, C] in
    xs's type, 0 on rows no real edge reaches, or None; ``d_att`` [E, H]
    float32, 0 on dropped edges, or None), each left out when its
    ``need_`` flag is False. Sums in f32, each d_xs row rounded to xs's
    type once; ``d_out`` is read in xs's type."""
    if xs.device.type == "cpu" and src.device.type == "cpu":
        return _weighted_segment_sum_backward_plain(
            d_out, xs, att, src, dst, count, num_segments, need_xs,
            need_att)
    count = _checked_count(xs, att, src, dst, count)
    N, H, C = xs.shape
    E, T = src.shape[0], num_segments
    if d_out.device != xs.device or d_out.shape != (T, H, C):
        raise ValueError(f"d_out {tuple(d_out.shape)} on {d_out.device}: "
                         f"expected {(T, H, C)} on {xs.device}")
    if not d_out.dtype.is_floating_point:
        raise TypeError(f"d_out dtype {d_out.dtype}: a float type")
    if E >= 2**31:
        raise ValueError(f"{E} edges: the backward takes fewer than 2^31")
    g = d_out.to(xs.dtype).contiguous()
    d_att = (torch.empty(E, H, dtype=torch.float32, device=xs.device)
             if need_att else None)
    out = keys = perm = scratch = None
    if need_xs:
        out = torch.empty_like(xs)
        keys, perm = _src_order(src, dst, count, T, N)
        scratch = _split_scratch(E, H * C, xs.device)
    if H * C == 0:
        if need_att:
            d_att.zero_()
    elif need_att or need_xs:
        def ptr(t):
            return None if t is None else t.data_ptr()

        launch_kernel("weighted_segment_grad", _GRAD_ARGTYPES, xs.device,
                      xs.data_ptr(), g.data_ptr(), _DTYPE_CODE[xs.dtype],
                      src.data_ptr(), dst.data_ptr(), count.data_ptr(),
                      att.data_ptr(), ptr(keys), ptr(perm), E, T, N, H, C,
                      ptr(d_att), ptr(out), ptr(scratch),
                      0 if scratch is None else scratch.numel())
        weighted_segment_sum.backward += 1
    return out, d_att


class _WeightedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, att, src, dst, count, num_segments: int):
        ctx.num_segments = num_segments
        ctx.save_for_backward(xs, att, src, dst, count)
        return weighted_segment_sum(xs, att, src, dst, count, num_segments)

    @staticmethod
    def backward(ctx, d_out):
        with span("gat.attention.backward"):
            xs, att, src, dst, count = ctx.saved_tensors
            d_xs, d_att = weighted_segment_sum_backward(
                d_out, xs, att, src, dst, count, ctx.num_segments,
                *ctx.needs_input_grad[:2])
        return d_xs, d_att, None, None, None, None


def weighted_segment_sum_op(xs, att, src, dst, count, num_segments: int):
    """Differentiable ``weighted_segment_sum``: kernel forward, kernel
    backward (``weighted_segment_sum_backward``)."""
    count = torch.as_tensor(count, dtype=torch.int32, device=src.device)
    return _WeightedSegmentSum.apply(xs, att, src, dst, count, num_segments)
