"""Static-shape padded mini-batch types (counterpart of the JAX package's
``sampling/batch.py``).

``BatchSpec`` is the JAX package's, unchanged: the same caps, the same
512-edge alignment and the same pad conventions make one data contract, so
one sampled batch feeds both packages. ``EdgeBlock`` and ``PaddedBatch`` are
plain dataclasses of torch tensors.

Frontier layout (prefix property):

  n_id[:level_sizes[0]]  = seed nodes
  n_id[:level_sizes[l]]  = frontier after sampling hop l
  n_id[:level_sizes[L]]  = full receptive field

Edges of hop h (sampling order) form a bipartite COO with ``dst`` indexing
the hop's target frontier (level h) and ``src`` the grown frontier (level
h+1). Models process hops outermost-first, so ``PaddedBatch.edges`` is
stored in processing order: ``edges[i]`` is hop L-1-i.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class BatchSpec:
    """Static capacities for one batch bucket (frozen, hashable)."""

    fanouts: Tuple[int, ...]          # sampling order (seeds outward)
    seed_cap: int                     # max seeds per batch
    node_caps: Tuple[int, ...]        # len L+1; cap of cumulative frontier per level
    edge_caps: Tuple[int, ...]        # len L; per-hop edge capacity (sampling order)
    # emit the src-sorted mirror for the OUTERMOST hop too (default: hops
    # 0..L-2 only); for models that differentiate a projection of the raw
    # input. Incompatible with gsrc mode.
    mirror_all: bool = False

    def __post_init__(self):
        L = len(self.fanouts)
        if len(self.node_caps) != L + 1 or len(self.edge_caps) != L:
            raise ValueError(f"caps do not match {L} hops: {self}")
        if self.node_caps[0] < self.seed_cap:
            raise ValueError(f"node_caps[0] < seed_cap: {self}")
        if any(a > b for a, b in zip(self.node_caps, self.node_caps[1:])):
            raise ValueError(f"node caps are not monotone: {self}")

    @property
    def num_hops(self) -> int:
        return len(self.fanouts)

    @property
    def total_node_cap(self) -> int:
        return self.node_caps[-1]

    @classmethod
    def worst_case(cls, batch_size: int, fanouts: Sequence[int],
                   align: int = 128) -> "BatchSpec":
        """Worst-case caps (no dedup); for tiny tests."""
        def rnd(v):
            return max(align, int(math.ceil(v / align)) * align)

        node_caps = [batch_size]
        edge_caps = []
        for f in fanouts:
            if f < 0:
                raise ValueError("worst_case cannot bound full expansion")
            e = node_caps[-1] * f
            edge_caps.append(rnd(e))
            node_caps.append(rnd(node_caps[-1] + e))
        return cls(tuple(fanouts), batch_size, tuple(node_caps), tuple(edge_caps))

    def grown(self, factor: float = 1.3, align: int = 128,
              edge_align: int = 512) -> "BatchSpec":
        """A same-shape spec with caps scaled up (after a cap-overflow
        epoch: the cap grows, data is never dropped silently)."""
        def rnd(v, a):
            return max(a, int(math.ceil(v * factor / a)) * a)

        node_caps = [self.node_caps[0]]
        node_caps += [rnd(v, align) for v in self.node_caps[1:]]
        for i in range(1, len(node_caps)):
            node_caps[i] = max(node_caps[i], node_caps[i - 1])
        return BatchSpec(self.fanouts, self.seed_cap, tuple(node_caps),
                         tuple(rnd(v, edge_align) for v in self.edge_caps))

    @classmethod
    def from_measurements(cls, batch_size: int, fanouts: Sequence[int],
                          level_sizes_max: Sequence[int],
                          edge_counts_max: Sequence[int],
                          safety: float = 1.3, align: int = 128,
                          edge_align: int = 512) -> "BatchSpec":
        def rnd(v, a):
            return max(a, int(math.ceil(v * safety / a)) * a)

        node_caps = [max(batch_size, int(level_sizes_max[0]))]
        node_caps += [rnd(v, align) for v in level_sizes_max[1:]]
        # caps must stay monotone after rounding
        for i in range(1, len(node_caps)):
            node_caps[i] = max(node_caps[i], node_caps[i - 1])
        # the JAX package's 512-edge alignment is kept: one data contract
        edge_caps = [rnd(v, edge_align) for v in edge_counts_max]
        return cls(tuple(fanouts), batch_size, tuple(node_caps), tuple(edge_caps))


# Models that differentiate a projection of the raw input (GCN, ARMA) need
# the outermost hop's mirror too; so does GAT under its opt-in custom-VJP
# attention (ops/gat_agg.py). The JAX package's rule, so specs stay
# identical.
MIRROR_ALL_MODELS = ("GCN", "ARMA")


def mirror_all_specs(model_name: str, spec: BatchSpec,
                     tight: Optional[BatchSpec] = None):
    """Apply the model-dependent ``mirror_all`` flag to a calibrated
    (spec, tight) pair. Mutually exclusive with gsrc mode, which only the
    SAGE family and GIN enable."""
    from ..ops.gat_agg import gat_custom_agg_enabled

    if model_name in MIRROR_ALL_MODELS or (
            model_name == "GAT" and gat_custom_agg_enabled()):
        spec = dataclasses.replace(spec, mirror_all=True)
        if tight is not None:
            tight = dataclasses.replace(tight, mirror_all=True)
    return spec, tight


def _unpack24(lo: torch.Tensor, hi: Optional[torch.Tensor]) -> torch.Tensor:
    """int32 ids from a wire-packed pair. ``lo`` ships as int16 (the bits
    of the sampler's uint16 halves) and ``hi`` as uint8; both widen to
    int32 before any bit operation."""
    v = lo.to(torch.int32) & 0xFFFF
    if hi is not None:
        v = v | (hi.to(torch.int32) << 16)
    return v


def _map_tensors(obj, fn):
    """Apply ``fn`` to every tensor field of a batch dataclass."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            kw[f.name] = fn(v)
        elif isinstance(v, tuple) and v and isinstance(v[0], EdgeBlock):
            kw[f.name] = tuple(_map_tensors(e, fn) for e in v)
    return dataclasses.replace(obj, **kw)


def _tensors(obj):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, tuple) and v and isinstance(v[0], EdgeBlock):
            for e in v:
                yield from _tensors(e)


class _TensorBatch:
    def to(self, device, non_blocking: bool = False):
        return _map_tensors(
            self, lambda t: t.to(device, non_blocking=non_blocking))

    def clone(self):
        return _map_tensors(self, torch.Tensor.clone)

    def tensors(self):
        """Every tensor the batch holds (what a host-to-device copy ships)."""
        return list(_tensors(self))

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in _tensors(self))

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class EdgeBlock(_TensorBatch):
    """One hop's padded bipartite COO, target-grouped (dst nondecreasing,
    pads = out-level cap). ``msrc/mdst`` is the src-sorted mirror of the
    same edges (msrc ascending, pads = in-level cap) for the scatter-free
    backward; None for the outermost hop.

    Wire-compressed forms (``decoded`` rebuilds the int32 fields):
    ``ddeg`` is uint8 per-target degrees in place of ``dst``; ``*_lo``
    (int16 bits of uint16 halves) with ``*_hi`` (uint8 third byte, or
    None when values stay below 2^16) in place of ``src``/``msrc``/``mdst``.
    """

    src: Optional[torch.Tensor]        # int32 [E_cap]
    dst: Optional[torch.Tensor]        # int32 [E_cap]
    count: torch.Tensor                # int32 [] — actual number of edges
    msrc: Optional[torch.Tensor] = None
    mdst: Optional[torch.Tensor] = None
    ddeg: Optional[torch.Tensor] = None
    src_lo: Optional[torch.Tensor] = None
    src_hi: Optional[torch.Tensor] = None
    msrc_lo: Optional[torch.Tensor] = None
    msrc_hi: Optional[torch.Tensor] = None
    mdst_lo: Optional[torch.Tensor] = None
    mdst_hi: Optional[torch.Tensor] = None

    @property
    def cap(self) -> int:
        a = self.src if self.src is not None else self.src_lo
        return a.shape[0]

    def decoded(self, E_cap: int) -> "EdgeBlock":
        """Materialize wire-compressed fields on the tensors' device."""
        out = self
        if out.src_lo is not None:
            out = out.replace(
                src=_unpack24(out.src_lo, out.src_hi),
                msrc=(_unpack24(out.msrc_lo, out.msrc_hi)
                      if out.msrc_lo is not None else out.msrc),
                mdst=(_unpack24(out.mdst_lo, out.mdst_hi)
                      if out.mdst_lo is not None else out.mdst),
                src_lo=None, src_hi=None, msrc_lo=None, msrc_hi=None,
                mdst_lo=None, mdst_hi=None)
        if out.ddeg is None:
            return out
        # dst[e] = number of targets whose cumulative degree is <= e; past
        # the real edges that is the target count, the pad convention
        bounds = torch.cumsum(out.ddeg.to(torch.int32), 0, dtype=torch.int32)
        e_iota = torch.arange(E_cap, dtype=torch.int32,
                              device=bounds.device)
        dst = torch.searchsorted(bounds, e_iota, right=True, out_int32=True)
        return out.replace(dst=dst, ddeg=None)


@dataclass
class PaddedBatch(_TensorBatch):
    """A fully-prepared, fixed-shape mini-batch (host or device tensors)."""

    n_id: Optional[torch.Tensor]      # int32 [n_cap] global ids (None when packed)
    level_sizes: torch.Tensor         # int32 [L+1]
    edges: Tuple[EdgeBlock, ...]      # PROCESSING order: edges[i] = hop L-1-i
    y: torch.Tensor                   # int32 [seed_cap]
    seed_count: torch.Tensor          # int32 []
    overflow: torch.Tensor            # int32 [2] (dropped_nodes, dropped_edges)
    # gsrc mode marker (zero-size): the outermost hop's src carries GLOBAL
    # ids, so layer 0 aggregates straight from the feature table
    gsrc: Optional[torch.Tensor] = None
    n_id_lo: Optional[torch.Tensor] = None   # int16 bits of uint16 halves
    n_id_hi: Optional[torch.Tensor] = None   # uint8 or None
    # host cold tier (hbm_fraction < 1): rows of the frontier vertices
    # whose features stay in host RAM, gathered by the sampler thread and
    # shipped with the batch; None when every row is on the device
    cold_rows: Optional[torch.Tensor] = None   # [cap, F] bf16, or uint8 fp8
    cold_pos: Optional[torch.Tensor] = None    # int32 [cap] (pads above rows)
    cold_count: Optional[torch.Tensor] = None  # int32 []
    cold_scale: Optional[torch.Tensor] = None  # f32 [cap] fp8 row scales
    spec: Optional[BatchSpec] = None

    def decoded_n_id(self) -> "PaddedBatch":
        if self.n_id_lo is None:
            return self
        return self.replace(n_id=_unpack24(self.n_id_lo, self.n_id_hi),
                            n_id_lo=None, n_id_hi=None)

    def num_real_edges(self) -> int:
        return int(sum(int(e.count) for e in self.edges))

    @property
    def num_layers(self) -> int:
        return len(self.edges)

    def layer_caps(self, i: int) -> Tuple[int, int]:
        """(input_rows_cap, output_rows_cap) for model layer i (static)."""
        L = len(self.edges)
        return self.spec.node_caps[L - i], self.spec.node_caps[L - i - 1]
