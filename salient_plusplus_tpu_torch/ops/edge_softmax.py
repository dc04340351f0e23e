"""GAT's edge softmax: the attention logits and the self-inclusive softmax
over each target's incoming edges, as one differentiable op.

    z_e      = leaky_relu(a_src[src_e] + a_dst[dst_e])          [E, H]
    z_self_t = leaky_relu(a_src[t] + a_dst[t])                  [T, H]
    att, self_att = softmax over {z_e : dst_e = t} ∪ {z_self_t}

Pad edges (``e >= count`` or ``dst[e] >= T``) get attention 0 and targets
with no edges ``self_att`` 1. It replaces no TPU kernel: the JAX package
takes the softmax as segmented scans (``ops/segment.py::
segment_softmax_self``). On a CUDA tensor it is the kernel pair of
``csrc/edge_softmax.cu``: the forward writes ``att`` [E, H] and
``self_att`` [T, H] in f32 from the stored logit terms summed in f32; the
backward takes their gradients to ``d_a_src`` (f32 atomics, one cast to
a_src's type) and ``d_a_dst``. Neither uses a scatter, a sort or an [E, H]
temporary, and the backward saves only the forward's outputs and inputs.
On a CPU tensor ``_edge_softmax_plain`` is the plain chain (``leaky_relu``
of the gathered terms in a_src's type, then ``segment_softmax_self`` in
f32), differentiated by autograd: it is the oracle the tests hold to the
JAX package. There is no fallback between the two.

``edge_softmax.launches`` counts the forward kernel's launches,
``edge_softmax.backward`` the backward's. Under a profiler the backward
is the span ``gat.softmax.backward`` (on autograd's thread).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..native.build import launch_kernel
from ..utils.timing import span
from .pallas_aggregate import _DTYPE_CODE
from .segment import segment_softmax_self

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             *[ctypes.c_void_p] * 3, *[ctypes.c_int64] * 4, ctypes.c_float,
             ctypes.c_void_p, ctypes.c_void_p]
_GRAD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  *[ctypes.c_void_p] * 7, *[ctypes.c_int64] * 4,
                  ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]


def _edge_softmax_plain(a_src, a_dst, src, dst, count, num_segments: int,
                        negative_slope: float):
    """Plain torch version: the logits in a_src's type (a pad's dst reads
    row T - 1, and the softmax gives the edge attention 0), the softmax in
    f32 (``segment_softmax_self``)."""
    T, ns = num_segments, negative_slope
    logits = F.leaky_relu(a_src.index_select(0, src)
                          + a_dst.index_select(0, dst.clamp(max=T - 1)), ns)
    self_logit = F.leaky_relu(a_src[:T] + a_dst, ns)
    return segment_softmax_self(logits.float(), dst, count, T,
                                self_logit.float())


def _checked(a_src, a_dst, src, dst, count, num_segments: int):
    """The kernels' inputs checked (device, dtype, shape, contiguity)."""
    dev = a_src.device
    if dev.type != "cuda":
        raise ValueError(f"edge_softmax: unsupported device {dev}")
    for name, t in (("a_dst", a_dst), ("src", src), ("dst", dst),
                    ("count", count)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, a_src on {dev}")
    for name, t in (("src", src), ("dst", dst), ("count", count)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} dtype {t.dtype}: int32")
    if a_src.dtype not in _DTYPE_CODE or a_dst.dtype != a_src.dtype:
        raise TypeError(f"a_src {a_src.dtype}, a_dst {a_dst.dtype}: both "
                        f"bfloat16 or both float32")
    E, T = src.shape[0], num_segments
    if (a_src.dim() != 2 or a_dst.shape != (T, a_src.shape[1])
            or a_src.shape[0] < T or a_src.shape[1] == 0 or src.dim() != 1
            or dst.shape != src.shape or count.numel() != 1):
        raise ValueError(f"shapes a_src {tuple(a_src.shape)} a_dst "
                         f"{tuple(a_dst.shape)} src {tuple(src.shape)} dst "
                         f"{tuple(dst.shape)} count {tuple(count.shape)}: "
                         f"expected [N >= {T}, H], [{T}, H], [E], [E] and "
                         f"one value")
    if E >= 2**31:
        raise ValueError(f"{E} edges: the kernels take fewer than 2^31")
    if not all(t.is_contiguous() for t in (a_src, a_dst, src, dst)):
        raise ValueError("a_src, a_dst, src and dst must be contiguous")


def edge_softmax_forward(a_src, a_dst, src, dst, count, num_segments: int,
                         negative_slope: float):
    """The forward kernel: (att [E, H], self_att [T, H]) float32 for a_src
    [N, H] and a_dst [T, H] (both bf16 or both f32), src and dst [E] int32
    (dst nondecreasing over the first ``count`` edges), count a one-value
    int32 tensor."""
    _checked(a_src, a_dst, src, dst, count, num_segments)
    (N, H), E, T = a_src.shape, src.shape[0], num_segments
    att = torch.empty(E, H, dtype=torch.float32, device=a_src.device)
    self_att = torch.empty(T, H, dtype=torch.float32, device=a_src.device)
    if E or T:
        launch_kernel("edge_softmax", _ARGTYPES, a_src.device,
                      a_src.data_ptr(), a_dst.data_ptr(),
                      _DTYPE_CODE[a_src.dtype], src.data_ptr(),
                      dst.data_ptr(), count.data_ptr(), E, T, N, H,
                      negative_slope, att.data_ptr(), self_att.data_ptr())
        edge_softmax.launches += 1
    return att, self_att


def edge_softmax_backward(d_att, d_self_att, a_src, a_dst, src, dst, count,
                          att, self_att, num_segments: int,
                          negative_slope: float):
    """The backward kernel: (d_a_src, d_a_dst) in a_src's and a_dst's type
    for the gradients of the forward's (att, self_att), read in f32. d_a_src
    sums in f32 by atomics (its bits vary with their order) and is cast
    once; d_a_dst is written by the kernel."""
    _checked(a_src, a_dst, src, dst, count, num_segments)
    (N, H), E, T = a_src.shape, src.shape[0], num_segments
    g = d_att.float().contiguous()
    g_self = d_self_att.float().contiguous()
    for name, t, shape in (("d_att", g, (E, H)), ("att", att, (E, H)),
                           ("d_self_att", g_self, (T, H)),
                           ("self_att", self_att, (T, H))):
        if t.device != a_src.device or t.shape != shape:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device}: "
                             f"expected {shape} on {a_src.device}")
    d_src = torch.zeros(N, H, dtype=torch.float32, device=a_src.device)
    d_dst = torch.empty_like(a_dst)
    if T:
        launch_kernel("edge_softmax", _GRAD_ARGTYPES, a_src.device,
                      a_src.data_ptr(), a_dst.data_ptr(),
                      _DTYPE_CODE[a_src.dtype], src.data_ptr(),
                      dst.data_ptr(), count.data_ptr(), att.data_ptr(),
                      self_att.data_ptr(), g.data_ptr(), g_self.data_ptr(),
                      E, T, N, H, negative_slope, d_src.data_ptr(),
                      d_dst.data_ptr(), entry="edge_softmax_backward")
        edge_softmax.backward += 1
    return d_src.to(a_src.dtype), d_dst


class _EdgeSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a_src, a_dst, src, dst, count, num_segments: int,
                negative_slope: float):
        ctx.num_segments, ctx.negative_slope = num_segments, negative_slope
        att, self_att = edge_softmax_forward(a_src, a_dst, src, dst, count,
                                             num_segments, negative_slope)
        ctx.save_for_backward(a_src, a_dst, src, dst, count, att, self_att)
        return att, self_att

    @staticmethod
    def backward(ctx, d_att, d_self_att):
        with span("gat.softmax.backward"):
            d_src, d_dst = edge_softmax_backward(
                d_att, d_self_att, *ctx.saved_tensors, ctx.num_segments,
                ctx.negative_slope)
        return d_src, d_dst, None, None, None, None, None


def edge_softmax(a_src, a_dst, src, dst, count, num_segments: int,
                 negative_slope: float):
    """(att [E, H], self_att [T, H]) float32, differentiable in a_src [N,
    H] and a_dst [T, H]: the kernel pair on a CUDA tensor, the plain chain
    (``_edge_softmax_plain``) on a CPU tensor."""
    if a_src.device.type == "cpu" and src.device.type == "cpu":
        return _edge_softmax_plain(a_src, a_dst, src, dst, count,
                                   num_segments, negative_slope)
    count = torch.as_tensor(count, dtype=torch.int32, device=src.device)
    return _EdgeSoftmax.apply(a_src.contiguous(), a_dst.contiguous(), src,
                              dst, count, num_segments, negative_slope)


edge_softmax.launches = 0
edge_softmax.backward = 0
