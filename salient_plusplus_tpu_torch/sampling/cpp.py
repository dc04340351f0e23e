"""ctypes bindings to the native sampler (native/sampler.cpp), the
counterpart of the JAX package's ``sampling/cpp.py``.

One ``NativeSampler`` per graph; thread-safe via per-thread workspaces
(ctypes releases the GIL during the foreign call, so Python worker threads
sample in parallel). ``BatchBuffers`` are the padded host buffers one
in-flight batch is written into. With ``pin=True`` (the CUDA path) every
buffer is a pinned torch tensor and the C++ code writes into its numpy
view, so the batch ships to the card by DMA without a staging copy.

The host cold tier's rows (``hbm_fraction < 1``) are bf16 on the card;
numpy has no bf16, so the host keeps their bits as uint16 and a batch
ships them as a bf16 view of the same bytes.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch

from ..native.build import sampler_lib_path
from .batch import BatchSpec, EdgeBlock, PaddedBatch

_c_i32p = ctypes.POINTER(ctypes.c_int32)
_c_i64p = ctypes.POINTER(ctypes.c_int64)


def _load_lib():
    lib = ctypes.CDLL(sampler_lib_path())
    lib.sptpu_ws_create.restype = ctypes.c_void_p
    lib.sptpu_ws_create.argtypes = [ctypes.c_int64]
    lib.sptpu_ws_destroy.restype = None
    lib.sptpu_ws_destroy.argtypes = [ctypes.c_void_p]
    lib.sptpu_sample_batch.restype = ctypes.c_int32
    lib.sptpu_sample_batch.argtypes = [
        ctypes.c_void_p, _c_i64p, _c_i32p, ctypes.c_int64, _c_i64p,
        ctypes.c_int32,
        _c_i32p, ctypes.c_int32, ctypes.c_uint64, _c_i32p, _c_i64p, _c_i32p,
        _c_i32p, _c_i32p, _c_i32p, _c_i32p, _c_i32p, _c_i32p,
    ]
    _c_f64p = ctypes.POINTER(ctypes.c_double)
    partition_args = [
        _c_i64p, _c_i32p, ctypes.c_int64, ctypes.c_int32, _c_f64p,
        ctypes.c_int32, _c_f64p, ctypes.c_uint64, ctypes.c_int32]
    lib.sptpu_partition.restype = None
    lib.sptpu_partition.argtypes = partition_args + [_c_i32p]
    lib.sptpu_partition_ml.restype = None
    lib.sptpu_partition_ml.argtypes = partition_args + [ctypes.c_int64,
                                                        _c_i32p]
    lib.sptpu_count_dst.restype = None
    lib.sptpu_count_dst.argtypes = [
        _c_i32p, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.sptpu_take_i32_inplace.restype = None
    lib.sptpu_take_i32_inplace.argtypes = [_c_i32p, _c_i32p, ctypes.c_int64]
    lib.sptpu_mirror_by_src.restype = None
    lib.sptpu_mirror_by_src.argtypes = [
        _c_i32p, _c_i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        _c_i32p, _c_i32p, _c_i32p,
    ]
    lib.sptpu_gather_rows.restype = None
    lib.sptpu_gather_rows.argtypes = [
        ctypes.c_void_p, _c_i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.sptpu_gather_rows_i32.restype = None
    lib.sptpu_gather_rows_i32.argtypes = [
        ctypes.c_void_p, _c_i32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    return lib


_LIB = None
_LIB_LOCK = threading.Lock()


def get_lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = _load_lib()
        return _LIB


def _ptr(a: np.ndarray, ty):
    return a.ctypes.data_as(ty)


# uint16 halves travel as int16 tensors (the same bits): int16 has full
# operator support on every device, uint16 does not
_TORCH_DTYPE = {np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.uint8): torch.uint8,
                np.dtype(np.uint16): torch.int16,
                np.dtype(np.float32): torch.float32}


def _host_zeros(n: int, dtype, pin: bool) -> np.ndarray:
    """A zeroed host array; with ``pin`` it is the numpy view of a pinned
    torch tensor (the view keeps the tensor alive)."""
    dtype = np.dtype(dtype)
    if not pin:
        return np.zeros(n, dtype)
    a = torch.zeros(int(n), dtype=_TORCH_DTYPE[dtype], pin_memory=True).numpy()
    return a.view(dtype)


def _t(a: Optional[np.ndarray]) -> Optional[torch.Tensor]:
    """Zero-copy tensor view of a host buffer (slice)."""
    if a is None:
        return None
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.from_numpy(a)


def _t_rows(a: np.ndarray) -> torch.Tensor:
    """Zero-copy tensor view of cold feature rows: uint16 bf16 bits as
    bfloat16, fp8 payload bytes as uint8."""
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _t0(a: np.ndarray, i: int) -> torch.Tensor:
    """0-d tensor view of element ``i``."""
    return torch.from_numpy(a[i:i + 1]).reshape(())


def pack_src_maxval(spec: BatchSpec, emit_gsrc: bool,
                    num_nodes: int) -> tuple:
    """Per-hop EXCLUSIVE bound of edge-src values (attach_pack): the
    grown-frontier cap, or num_nodes for the gsrc (global-id) hop."""
    L = spec.num_hops
    return tuple(
        num_nodes if (emit_gsrc and h == L - 1) else spec.node_caps[h + 1]
        for h in range(L))


class BatchBuffers:
    """Preallocated padded output buffers for one in-flight batch."""

    def __init__(self, spec: BatchSpec, pin: bool = False):
        self.spec = spec
        self.pin = pin
        z = lambda n, dt: _host_zeros(n, dt, pin)  # noqa: E731
        L = spec.num_hops
        self.mirror_hops = L if spec.mirror_all else L - 1
        self.n_id = z(spec.total_node_cap, np.int32)
        self.level_sizes = z(L + 1, np.int32)
        total_e = sum(spec.edge_caps)
        self.edge_src = z(total_e, np.int32)
        self.edge_dst = z(total_e, np.int32)
        self.edge_counts = z(L, np.int32)
        self.edge_offsets = np.zeros(L + 1, np.int64)
        np.cumsum(np.asarray(spec.edge_caps, np.int64), out=self.edge_offsets[1:])
        self.overflow = z(2, np.int32)
        # src-sorted mirrors for hops 0..L-2 (every hop with mirror_all):
        # the backward aggregation runs the same kernel over them
        mh = self.mirror_hops
        self.mirror_src = z(self.edge_offsets[mh] if mh > 0 else 0, np.int32)
        self.mirror_dst = z(self.mirror_src.shape[0], np.int32)
        self.y = z(spec.seed_cap, np.int32)
        self.seed_count = z(1, np.int32)
        # host cold tier buffers; attached only with a hot/cold split.
        # cold_len: the rows a batch ships (the cap, or a cache miss rung)
        self.cold_rows = None
        self.cold_pos = None
        self.cold_scale = None
        self.cold_count = z(1, np.int32)
        self.cold_len = 0
        # owner-served tier: [world, cold_r_cap] cold ids by owner
        self.cold_req = None
        self.gsrc = None
        self.ddeg = None
        self.ddeg_offsets = None
        self.src_lo = None
        self.src_hi = None
        self.n_id_lo = None
        self.n_id_hi = None
        self.msrc_lo = None
        self.msrc_hi = None
        self.mdst_lo = None
        self.mdst_hi = None
        # tight bucket this batch fits (set per batch by the sampler worker)
        self.bucket: Optional[BatchSpec] = None

    def attach_ddeg(self):
        """Wire-compress dst: ship per-target uint8 degrees instead of the
        int32 sorted dst arrays; the device rebuilds dst with one
        searchsorted (EdgeBlock.decoded). Requires every fanout in
        (0, 127]."""
        spec = self.spec
        if not all(0 < f <= 127 for f in spec.fanouts):
            raise ValueError(f"ddeg needs fanouts in (0, 127]: {spec.fanouts}")
        self.ddeg_offsets = np.zeros(spec.num_hops + 1, np.int64)
        np.cumsum(np.asarray(spec.node_caps[:-1], np.int64),
                  out=self.ddeg_offsets[1:])
        self.ddeg = _host_zeros(self.ddeg_offsets[-1], np.uint8, self.pin)

    def fill_ddeg(self):
        lib = get_lib()
        off_e = self.edge_offsets
        for h in range(self.spec.num_hops):
            T = int(self.spec.node_caps[h])
            o = int(self.ddeg_offsets[h])
            lib.sptpu_count_dst(
                _ptr(self.edge_dst[int(off_e[h]):], _c_i32p),
                ctypes.c_int32(int(self.edge_counts[h])),
                ctypes.c_int32(T),
                self.ddeg[o:].ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint8)))

    def attach_gsrc(self):
        # zero-size marker: with gsrc mode on, the outermost hop's src
        # slot itself carries GLOBAL ids (no duplicate array on the wire)
        self.gsrc = np.zeros(0, np.int32)

    def fill_gsrc(self, hot_cutoff: Optional[int] = None):
        """Rewrite the outermost hop's src in place to global ids
        (n_id[src]); its local ids are only ever gather indices into the
        frontier, which layer 0 skips in gsrc mode.

        With ``hot_cutoff`` (cold tier + gsrc), cold frontier ids are first
        remapped IN n_id to ``hot_cutoff + cold_slot`` (fill_cold's
        ascending slot order): the trainer writes this batch's cold rows
        into a slack region of the device table right after the hot
        prefix, so one table serves both the layer-0 message gather and
        the level-(L-1) prefix gather."""
        if hot_cutoff is not None and self.cold_pos is not None:
            n = int(self.level_sizes[-1])
            cnt = int(self.cold_count[0])
            pos_all = np.flatnonzero(self.n_id[:n] >= hot_cutoff)
            self.n_id[pos_all[:cnt]] = (
                hot_cutoff + np.arange(cnt, dtype=np.int32))
            # over-budget cold rows (no slot) alias slot 0: surfaced by
            # dropped_cold and repaired by the cap growth after the epoch
            if len(pos_all) > cnt:
                self.n_id[pos_all[cnt:]] = hot_cutoff
        off = int(self.edge_offsets[self.spec.num_hops - 1])
        cap = int(self.spec.edge_caps[-1])
        get_lib().sptpu_take_i32_inplace(
            _ptr(self.n_id, _c_i32p),
            _ptr(self.edge_src[off:], _c_i32p), ctypes.c_int64(cap))

    def attach_pack(self, src_maxval: tuple, node_caps: tuple = None,
                    num_nodes: int = None):
        """Wire-pack the int32 index arrays: low uint16 halves plus a uint8
        third byte only for hops whose value range reaches bits 16..23
        (``src_maxval[h]`` = exclusive bound of hop h's src values). All
        values must be < 2^24. ``node_caps`` bounds the mirrors' values
        (default: this spec's). With ``num_nodes`` < 2^24 the global-id
        n_id array packs the same way."""
        spec = self.spec
        L = spec.num_hops
        node_caps = tuple(node_caps or spec.node_caps)
        # src bounds are EXCLUSIVE; mirror pads are INCLUSIVE (msrc pads
        # with the cap itself), so node caps must fit 24 bits strictly
        if not all(v <= 2**24 for v in src_maxval):
            raise ValueError(f"src values exceed 24 bits: {src_maxval}")
        if not all(v < 2**24 for v in node_caps):
            raise ValueError(f"node caps exceed 24 bits: {node_caps}")
        z = lambda n, dt: _host_zeros(n, dt, self.pin)  # noqa: E731
        total_e = int(self.edge_offsets[-1])
        self.src_lo = z(total_e, np.uint16)
        self.src_hi = [
            (z(spec.edge_caps[h], np.uint8) if src_maxval[h] > 2**16 else None)
            for h in range(L)
        ]
        mir_len = int(self.mirror_src.shape[0])
        self.msrc_lo = z(mir_len, np.uint16)
        self.mdst_lo = z(mir_len, np.uint16)
        # msrc <= node_caps[h+1] (the pad IS the cap), mdst < node_caps[h]
        self.msrc_hi = [
            (z(spec.edge_caps[h], np.uint8) if node_caps[h + 1] >= 2**16
             else None)
            for h in range(self.mirror_hops)
        ]
        self.mdst_hi = [
            (z(spec.edge_caps[h], np.uint8) if node_caps[h] > 2**16
             else None)
            for h in range(self.mirror_hops)
        ]
        if num_nodes is not None and num_nodes <= 2**24:
            n = int(spec.total_node_cap)
            self.n_id_lo = z(n, np.uint16)
            self.n_id_hi = z(n, np.uint8) if num_nodes > 2**16 else None

    @staticmethod
    def _pack_one(flat_i32, lo, his, edge_offsets):
        # little-endian int32 → halves via strided views (no temporaries)
        u16 = flat_i32.view(np.uint16)
        n = lo.shape[0]
        lo[:] = u16[0 : 2 * n : 2]
        u8 = flat_i32.view(np.uint8)
        for h, hi in enumerate(his):
            if hi is not None:
                o = int(edge_offsets[h])
                hi[:] = u8[o * 4 + 2 : (o + hi.shape[0]) * 4 : 4]

    def fill_pack(self):
        self._pack_one(self.edge_src, self.src_lo, self.src_hi,
                       self.edge_offsets)
        if self.n_id_lo is not None:
            u16 = self.n_id.view(np.uint16)
            self.n_id_lo[:] = u16[0::2]
            if self.n_id_hi is not None:
                self.n_id_hi[:] = self.n_id.view(np.uint8)[2::4]
        if self.msrc_lo.shape[0]:
            self._pack_one(self.mirror_src, self.msrc_lo, self.msrc_hi,
                           self.edge_offsets)
            self._pack_one(self.mirror_dst, self.mdst_lo, self.mdst_hi,
                           self.edge_offsets)

    def attach_from_config(self, cfg, num_nodes: int,
                           pack_node_caps: tuple = None):
        """Attach every auxiliary buffer a ``FastSamplerConfig`` calls for
        (cold tier / gsrc / ddeg / wire-pack): the one place that decides
        which fields a buffer set carries."""
        if cfg.cold_owner_mode:
            self.attach_cold_requests(cfg.cold_world, cfg.cold_r_cap)
        elif cfg.hot_cutoff is not None or cfg.cold_part_size is not None:
            # cache mode ships a prefix of these at a miss rung, which is
            # at least one 128-row rung
            cap = (max(cfg.cold_cap, 128) if cfg.cold_cache is not None
                   else cfg.cold_cap)
            self.attach_cold(cap, cfg.x_cold.shape[1], cfg.x_cold.dtype,
                             with_scale=cfg.x_cold_scale is not None)
        if cfg.emit_gsrc:
            # the gsrc rewrite replaces the outer hop's src values AFTER
            # the mirror is built; an outer-hop mirror would go stale
            if cfg.spec.mirror_all:
                raise ValueError("mirror_all is incompatible with gsrc mode")
            self.attach_gsrc()
        if cfg.compress_dst:
            self.attach_ddeg()
        if cfg.pack_wire:
            # gsrc + cold encodes cold ids as hot_cutoff + slot, so the
            # shipped id space can exceed num_nodes by up to the cold cap
            # (cache mode: the slot space plus its zero row)
            idspace = num_nodes
            if cfg.emit_gsrc and cfg.hot_cutoff is not None:
                slots = (cfg.cold_cache.slots + 1
                         if cfg.cold_cache is not None else cfg.cold_cap)
                idspace = max(num_nodes, cfg.hot_cutoff + slots)
            self.attach_pack(
                pack_src_maxval(cfg.spec, cfg.emit_gsrc, idspace),
                node_caps=pack_node_caps, num_nodes=idspace)

    def finalize_from_config(self, cfg) -> int:
        """Post-:meth:`NativeSampler.sample_into` fills, in the
        load-bearing order: cold classification first (reads the raw
        ids), then ddeg (reads dst), then the gsrc in-place src rewrite,
        then packing (which must see the rewritten srcs). Returns the
        number of dropped (over-cold-budget) rows, which callers add to
        their stats."""
        if cfg.cold_cache is not None:
            # device cold-row cache: slot assignment must run serially in
            # batch CONSUMPTION order (eviction safety), so everything
            # after ddeg is deferred to the consumer (finalize_cached)
            if cfg.compress_dst:
                self.fill_ddeg()
            return 0
        dropped = 0
        if cfg.cold_owner_mode:
            dropped = self.fill_cold_requests(cfg.cold_part_size,
                                              cfg.cold_hot_size)
        elif cfg.cold_part_size is not None:
            dropped = self.fill_cold_partitioned(
                cfg.x_cold, cfg.cold_part_size, cfg.cold_hot_size,
                x_scale=cfg.x_cold_scale)
        elif cfg.hot_cutoff is not None:
            dropped = self.fill_cold(cfg.x_cold, cfg.hot_cutoff,
                                     x_scale=cfg.x_cold_scale)
        if cfg.compress_dst:
            self.fill_ddeg()
        if cfg.emit_gsrc:
            # the data-parallel tiers keep gsrc off; this is the
            # single-card tier's slack remap
            self.fill_gsrc(cfg.hot_cutoff)
        if cfg.pack_wire:
            self.fill_pack()
        return dropped

    def finalize_cached(self, cfg) -> int:
        """Consumer-side finalize for the device cold-row cache
        (``cfg.cold_cache``, sampling/cold_cache.py). Runs serially in
        batch-consumption order: assign cache slots for this batch's cold
        frontier ids, gather ONLY the miss rows into a prefix of the
        attached buffers (at a miss rung), remap cold ids in n_id to
        ``hot_cutoff + slot``, then the gsrc src rewrite and wire-packing
        (both read the remapped n_id). Returns the dropped-row count (no
        slot, or over the per-batch miss budget); dropped ids point at
        the permanent zero row ``hot_cutoff + slots``. Pad positions are
        2^30, as in the JAX package; the trainer clamps them to that zero
        row on the device."""
        from .cold_cache import miss_rung

        H = cfg.hot_cutoff
        cache = cfg.cold_cache
        n = int(self.level_sizes[-1])
        pos_all = np.flatnonzero(self.n_id[:n] >= H)
        ids = self.n_id[pos_all].astype(np.int64) - H
        slot, miss = cache.assign(ids, max_new=cfg.cold_cap)
        dropped = int((slot < 0).sum())
        self.n_id[pos_all] = (
            H + np.where(slot >= 0, slot, cache.slots)).astype(np.int32)
        m = np.flatnonzero(miss)
        cnt = len(m)
        # fold mode: always the top rung (one miss-buffer shape)
        rung = (cfg.cold_cap if cfg.cold_fold
                else miss_rung(cnt, cfg.cold_cap))
        if rung > self.cold_pos.shape[0]:
            raise ValueError(f"miss rung {rung} exceeds the attached cold "
                             f"buffers ({self.cold_pos.shape[0]} rows)")
        if cnt:
            gather_rows(cfg.x_cold, ids[m], out=self.cold_rows[:cnt])
            self.cold_pos[:cnt] = H + slot[m]
        self.cold_rows[cnt:rung] = 0
        self.cold_pos[cnt:rung] = 2**30
        if self.cold_scale is not None:
            if cnt:
                self.cold_scale[:cnt] = cfg.x_cold_scale[ids[m]]
            self.cold_scale[cnt:rung] = 0
        self.cold_count[0] = cnt
        self.cold_len = rung
        if cfg.emit_gsrc:
            self.fill_gsrc(None)  # n_id already slot-remapped: plain take
        if cfg.pack_wire:
            self.fill_pack()
        return dropped

    def attach_cold(self, cold_cap: int, num_features: int, dtype,
                    with_scale: bool = False):
        # uint16 bf16 bits or uint8 fp8 bytes
        self.cold_rows = _host_zeros(cold_cap * num_features, dtype,
                                     self.pin).reshape(cold_cap, num_features)
        self.cold_pos = _host_zeros(cold_cap, np.int32, self.pin)
        self.cold_scale = (_host_zeros(cold_cap, np.float32, self.pin)
                           if with_scale else None)
        self.cold_count[0] = 0
        self.cold_len = cold_cap

    def attach_cold_requests(self, world: int, cold_r_cap: int):
        """Owner-served tier: the workers only sort the cold frontier ids
        into per-owner request slots; the rows come from the owning
        rank's host RAM through the trainer's all_to_all before the step
        (``train/dist_loop.py``), so each host keeps O(V/k) cold rows."""
        self.cold_req = np.full((world, cold_r_cap), -1, np.int32)
        self.cold_pos = _host_zeros(world * cold_r_cap, np.int32, self.pin)
        self.cold_rows = None
        self.cold_scale = None
        self.cold_count[0] = 0
        self.cold_len = world * cold_r_cap

    def fill_cold_requests(self, part_size: int, hot_size: int) -> int:
        """Pack the cold frontier vertices into the request matrix: slot
        (o, j) of ``cold_req`` holds the j-th cold global id owned by
        partition o and ``cold_pos[o * cap + j]`` its frontier slot (pads:
        -1 and the frontier cap, which the overlay drops). The served rows
        come back in this layout. Returns the over-cap (dropped) count."""
        world, cap = self.cold_req.shape
        n = int(self.level_sizes[-1])
        ids = self.n_id[:n].astype(np.int64)
        pos = np.flatnonzero(ids % part_size >= hot_size).astype(np.int32)
        owner = (ids[pos] // part_size).astype(np.int32)
        order = np.argsort(owner, kind="stable")
        pos, owner = pos[order], owner[order]
        cnt = np.bincount(owner, minlength=world)[:world]
        starts = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int64)
        rank = np.arange(len(owner)) - starts[owner]
        keep = rank < cap
        slot = owner[keep] * cap + rank[keep]
        self.cold_req.fill(-1)
        self.cold_pos.fill(self.n_id.shape[0])
        self.cold_req.reshape(-1)[slot] = ids[pos[keep]].astype(np.int32)
        self.cold_pos[slot] = pos[keep]
        self.cold_count[0] = int(keep.sum())
        return int(len(owner) - int(keep.sum()))

    def fill_cold_partitioned(self, x_cold: np.ndarray, part_size: int,
                              hot_size: int, x_scale=None) -> int:
        """Replicated data-parallel tier: every partition keeps its first
        ``hot_size`` rows on the device and ``x_cold`` concatenates every
        partition's cold tail, so global id -> cold row is
        (id // S)·(S − H) + (id mod S) − H. Returns the dropped count."""
        n = int(self.level_sizes[-1])
        ids = self.n_id[:n].astype(np.int64)
        local = ids % part_size
        pos = np.flatnonzero(local >= hot_size).astype(np.int32)
        cold_idx = ((ids[pos] // part_size) * (part_size - hot_size)
                    + local[pos] - hot_size)
        return self._fill_cold_rows(x_cold, pos, cold_idx, x_scale)

    def _fill_cold_rows(self, x_cold, pos: np.ndarray,
                        cold_idx: np.ndarray, x_scale=None) -> int:
        cap = self.cold_pos.shape[0]
        dropped = max(0, len(pos) - cap)
        pos, cold_idx = pos[:cap], cold_idx[:cap]
        cnt = len(pos)
        self.cold_pos[:cnt] = pos
        # pad slots point past every frontier cap: the device overlay
        # drops them
        self.cold_pos[cnt:] = self.n_id.shape[0]
        idx64 = cold_idx.astype(np.int64)
        gather_rows(x_cold, idx64, out=self.cold_rows[:cnt])
        self.cold_rows[cnt:] = 0
        if self.cold_scale is not None:
            # fp8 wire: the per-row dequant scales ride along
            self.cold_scale[:cnt] = x_scale[idx64]
            self.cold_scale[cnt:] = 0
        self.cold_count[0] = cnt
        return dropped

    def fill_cold(self, x_cold: np.ndarray, hot_cutoff: int,
                  x_scale=None) -> int:
        """Gather host-resident rows for frontier vertices >= hot_cutoff
        (one global hot prefix). Returns the dropped count."""
        n = int(self.level_sizes[-1])
        ids = self.n_id[:n]
        pos = np.flatnonzero(ids >= hot_cutoff).astype(np.int32)
        return self._fill_cold_rows(x_cold, pos, ids[pos] - hot_cutoff,
                                    x_scale)

    def fits(self, spec: BatchSpec) -> bool:
        """Does the sampled batch fit a (tighter) spec's caps?"""
        L = self.spec.num_hops
        ls = self.level_sizes
        return (all(int(ls[i]) <= spec.node_caps[i] for i in range(L + 1))
                and all(int(self.edge_counts[h]) <= spec.edge_caps[h]
                        for h in range(L)))

    def to_padded_batch(self, bucket: Optional[BatchSpec] = None
                        ) -> PaddedBatch:
        """Zero-copy tensor view as a PaddedBatch (hops reversed to
        processing order).

        With ``bucket`` (a tighter spec the batch :meth:`fits`), every
        region is a contiguous PREFIX view at the bucket's caps. Real data
        sits at the front of each per-hop slice, and every pad keeps this
        spec's value (its caps), which lies strictly above the bucket's
        caps used as num_segments on the device, so pads still drop out."""
        spec = bucket or self.spec
        if not (spec is self.spec or (spec.fanouts == self.spec.fanouts
                                      and spec.seed_cap == self.spec.seed_cap)):
            raise ValueError(f"bucket {spec} does not match {self.spec}")
        L = spec.num_hops
        off = self.edge_offsets  # the BIG layout's offsets; prefix-sliced
        do = self.ddeg_offsets
        packed = self.src_lo is not None

        def sl(a, h):
            return _t(a[off[h]:off[h] + spec.edge_caps[h]])

        def hi(parts, h):
            p = parts[h] if parts is not None and h < len(parts) else None
            return _t(p[: spec.edge_caps[h]]) if p is not None else None

        mir = lambda h: h < self.mirror_hops  # noqa: E731
        edges = tuple(
            EdgeBlock(
                src=None if packed else sl(self.edge_src, h),
                dst=sl(self.edge_dst, h) if self.ddeg is None else None,
                count=_t0(self.edge_counts, h),
                msrc=sl(self.mirror_src, h) if mir(h) and not packed else None,
                mdst=sl(self.mirror_dst, h) if mir(h) and not packed else None,
                ddeg=(_t(self.ddeg[do[h]:do[h] + spec.node_caps[h]])
                      if self.ddeg is not None else None),
                src_lo=sl(self.src_lo, h) if packed else None,
                src_hi=hi(self.src_hi, h) if packed else None,
                msrc_lo=sl(self.msrc_lo, h) if packed and mir(h) else None,
                msrc_hi=hi(self.msrc_hi, h) if packed and mir(h) else None,
                mdst_lo=sl(self.mdst_lo, h) if packed and mir(h) else None,
                mdst_hi=hi(self.mdst_hi, h) if packed and mir(h) else None,
            )
            for h in reversed(range(L))
        )
        # gsrc mode: only the level-(L-1) prefix of the frontier is ever
        # gathered on the device (layer 0 reads the global table directly),
        # so the tail never ships
        n_cap = (spec.total_node_cap if self.gsrc is None
                 else spec.node_caps[L - 1])
        pack_nid = self.n_id_lo is not None
        # cold fields ship whole (no bucket cut): their pads lie above
        # every bucket's caps
        cold = self.cold_pos is not None
        cl = self.cold_len
        return PaddedBatch(
            n_id=None if pack_nid else _t(self.n_id[:n_cap]),
            n_id_lo=_t(self.n_id_lo[:n_cap]) if pack_nid else None,
            n_id_hi=(_t(self.n_id_hi[:n_cap])
                     if pack_nid and self.n_id_hi is not None else None),
            level_sizes=_t(self.level_sizes), edges=edges,
            y=_t(self.y), seed_count=_t0(self.seed_count, 0),
            overflow=_t(self.overflow), gsrc=_t(self.gsrc),
            cold_rows=(_t_rows(self.cold_rows[:cl])
                       if cold and self.cold_rows is not None else None),
            cold_pos=_t(self.cold_pos[:cl]) if cold else None,
            cold_count=_t0(self.cold_count, 0) if cold else None,
            cold_scale=(_t(self.cold_scale[:cl])
                        if cold and self.cold_scale is not None else None),
            spec=spec,
        )


class NativeSampler:
    """Stateless-per-call native sampler over one graph's CSR."""

    def __init__(self, rowptr: np.ndarray, col: np.ndarray):
        if rowptr.dtype != np.int64 or col.dtype != np.int32:
            raise ValueError(f"CSR must be int64 rowptr / int32 col, got "
                             f"{rowptr.dtype}/{col.dtype}")
        self.rowptr = np.ascontiguousarray(rowptr)
        self.col = np.ascontiguousarray(col)
        self.lib = get_lib()
        self._local = threading.local()

    def _mirror_ws(self, in_cap: int) -> np.ndarray:
        ws = getattr(self._local, "mirror_ws", None)
        if ws is None or ws.shape[0] < in_cap + 1:
            ws = np.empty(in_cap + 1, np.int32)
            self._local.mirror_ws = ws
        return ws

    def _workspace(self, max_nodes: int):
        ws = getattr(self._local, "ws", None)
        if ws is None or self._local.ws_nodes < max_nodes:
            if ws is not None:
                self.lib.sptpu_ws_destroy(ws)
            ws = self.lib.sptpu_ws_create(ctypes.c_int64(max_nodes))
            self._local.ws = ws
            self._local.ws_nodes = max_nodes
        return ws

    def sample_into(
        self,
        bufs: BatchBuffers,
        seeds: np.ndarray,
        rng_seed: int,
        y_global: Optional[np.ndarray] = None,
    ) -> None:
        spec = bufs.spec
        seeds = np.ascontiguousarray(seeds, dtype=np.int64)
        fanouts = np.asarray(spec.fanouts, np.int32)
        node_caps = np.asarray(spec.node_caps, np.int32)
        edge_caps = np.asarray(spec.edge_caps, np.int32)
        ws = self._workspace(spec.total_node_cap)
        rc = self.lib.sptpu_sample_batch(
            ws,
            _ptr(self.rowptr, _c_i64p), _ptr(self.col, _c_i32p),
            ctypes.c_int64(self.rowptr.shape[0] - 1),
            _ptr(seeds, _c_i64p), ctypes.c_int32(len(seeds)),
            _ptr(fanouts, _c_i32p), ctypes.c_int32(spec.num_hops),
            ctypes.c_uint64(rng_seed & (2**64 - 1)),
            _ptr(node_caps, _c_i32p),
            _ptr(bufs.edge_offsets, _c_i64p), _ptr(edge_caps, _c_i32p),
            _ptr(bufs.n_id, _c_i32p), _ptr(bufs.level_sizes, _c_i32p),
            _ptr(bufs.edge_src, _c_i32p), _ptr(bufs.edge_dst, _c_i32p),
            _ptr(bufs.edge_counts, _c_i32p), _ptr(bufs.overflow, _c_i32p),
        )
        if rc != 0:
            raise RuntimeError(f"sptpu_sample_batch failed rc={rc} "
                               f"(1=too many seeds, 2=duplicate seeds, "
                               f"3=seed out of range)")
        for h in range(bufs.mirror_hops):
            in_cap = int(node_caps[h + 1])
            ws = self._mirror_ws(in_cap)
            off = int(bufs.edge_offsets[h])
            self.lib.sptpu_mirror_by_src(
                _ptr(bufs.edge_src[off:], _c_i32p),
                _ptr(bufs.edge_dst[off:], _c_i32p),
                ctypes.c_int32(int(bufs.edge_counts[h])),
                ctypes.c_int32(int(spec.edge_caps[h])),
                ctypes.c_int32(in_cap),
                _ptr(ws, _c_i32p),
                _ptr(bufs.mirror_src[off:], _c_i32p),
                _ptr(bufs.mirror_dst[off:], _c_i32p))
        bufs.seed_count[0] = len(seeds)
        if y_global is not None:
            ns = len(seeds)
            bufs.y[:ns] = y_global[bufs.n_id[:ns]]
            bufs.y[ns:] = 0

    def sample(self, spec: BatchSpec, seeds: np.ndarray, rng_seed: int,
               y_global: Optional[np.ndarray] = None) -> PaddedBatch:
        bufs = BatchBuffers(spec)
        self.sample_into(bufs, seeds, rng_seed, y_global)
        return bufs.to_padded_batch()


def gather_rows(src: np.ndarray, idx: np.ndarray,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """Native host row gather ``out[i] = src[idx[i]]``."""
    lib = get_lib()
    if not src.flags["C_CONTIGUOUS"]:
        raise ValueError("gather_rows needs a C-contiguous source")
    idx = np.ascontiguousarray(idx)
    if len(idx) and (idx.min() < 0 or idx.max() >= src.shape[0]):
        raise IndexError("gather_rows index out of range")
    row_bytes = src.strides[0]
    if out is None:
        out = np.empty((len(idx), *src.shape[1:]), src.dtype)
    if idx.dtype == np.int64:
        lib.sptpu_gather_rows(
            src.ctypes.data_as(ctypes.c_void_p), _ptr(idx, _c_i64p),
            ctypes.c_int64(len(idx)), ctypes.c_int64(row_bytes),
            out.ctypes.data_as(ctypes.c_void_p))
    else:
        idx32 = np.ascontiguousarray(idx, np.int32)
        lib.sptpu_gather_rows_i32(
            src.ctypes.data_as(ctypes.c_void_p), _ptr(idx32, _c_i32p),
            ctypes.c_int64(len(idx)), ctypes.c_int64(row_bytes),
            out.ctypes.data_as(ctypes.c_void_p))
    return out
