"""Threaded sampling sessions producing padded batches (counterpart of the
JAX package's ``sampling/sampler.py``).

Python worker threads call the native sampler (GIL released during the C
call) and recycle preallocated padded buffer sets through a bounded pool.

Invariants carried over:
- *equal iteration counts*: ``split_seeds`` with ``exact_num_batches``
  splits the epoch's seed ids into exactly that many nearly-equal chunks,
  so every rank of the data-parallel trainer runs the same number of
  steps;
- *deterministic batch order*: batches are released to the consumer in
  epoch order via a reorder buffer;
- *per-batch deterministic RNG*: seed derived from (base_seed, epoch,
  batch index), the same function as the JAX package's, so both packages
  sample the same batches.

``FastPreSampler`` samples a whole epoch up front instead.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .batch import BatchSpec
from .cpp import BatchBuffers, NativeSampler


def batch_seed(base_seed: int, epoch: int, batch_no: int) -> int:
    """Deterministic, well-mixed per-batch RNG seed."""
    s = (base_seed * 0x9E3779B97F4A7C15 + epoch * 0xBF58476D1CE4E5B9
         + batch_no * 0x94D049BB133111EB) & (2**64 - 1)
    s ^= s >> 31
    return s or 1


def split_seeds(idx: np.ndarray, batch_size: int,
                exact_num_batches: Optional[int] = None) -> List[np.ndarray]:
    """Chunk epoch seeds into batches: nearly-equal with
    ``exact_num_batches``, else ``batch_size`` chunks (last partial)."""
    if exact_num_batches is not None:
        return [c for c in np.array_split(idx, exact_num_batches)]
    return [idx[i:i + batch_size] for i in range(0, len(idx), batch_size)]


@dataclass
class SamplerStats:
    """Per-epoch sampler observability."""

    total_blocked_dur: float = 0.0   # consumer wait in __next__
    total_blocked_occasions: int = 0
    sample_time: float = 0.0         # sum over workers
    batches: int = 0
    dropped_nodes: int = 0
    dropped_edges: int = 0
    dropped_cold: int = 0    # cold-tier rows over the cold budget
    cold_rows: int = 0       # host-tier rows shipped
    # static-shape padding accounting: waste = 1 − real/padded, where
    # padded sums each batch's OWN bucket caps
    real_nodes: int = 0
    real_edges: int = 0
    padded_nodes: int = 0
    padded_edges: int = 0
    tight_batches: int = 0

    def node_waste(self, node_cap: int = 0) -> float:
        denom = self.padded_nodes or self.batches * node_cap
        return 1.0 - self.real_nodes / denom if denom else 0.0

    def edge_waste(self, edge_cap_total: int = 0) -> float:
        denom = self.padded_edges or self.batches * edge_cap_total
        return 1.0 - self.real_edges / denom if denom else 0.0


@dataclass
class FastSamplerConfig:
    """What the host pipeline needs to sample one split."""

    spec: BatchSpec
    batch_size: int
    base_seed: int = 0
    num_workers: int = 3
    max_batches_in_flight: int = 8
    # exactly this many nearly-equal batches an epoch (data-parallel ranks)
    exact_num_batches: Optional[int] = None
    # host cold tier (hbm_fraction < 1): vertices with id >= hot_cutoff
    # have their rows in x_cold (host RAM, row i = global row
    # hot_cutoff + i; uint16 bf16 bits, or uint8 fp8 bytes with
    # x_cold_scale) and are gathered by the sampler threads, at most
    # cold_cap a batch
    hot_cutoff: Optional[int] = None
    x_cold: Optional[np.ndarray] = None
    cold_cap: int = 0
    x_cold_scale: Optional[np.ndarray] = None
    # the data-parallel tiers: each partition (cold_part_size ids) keeps
    # its first cold_hot_size rows on the device. Replicated: x_cold
    # concatenates every partition's cold tail and the workers gather the
    # rows. Owner-served (cold_owner_mode): the workers only sort the cold
    # ids into a [cold_world, cold_r_cap] request matrix; the owners serve
    # the rows through the trainer's all_to_all before the step
    cold_part_size: Optional[int] = None
    cold_hot_size: Optional[int] = None
    cold_owner_mode: bool = False
    cold_world: int = 0
    cold_r_cap: int = 0
    # device cold-row cache (sampling/cold_cache.py): a shared
    # HostColdCache managing the feature table's slack region; cold
    # classification then runs at CONSUMPTION time (slot-eviction safety)
    # and only miss rows ship. cold_cap is then the per-batch miss budget
    # and the top miss rung
    cold_cache: Optional[object] = None
    # cold_fold_update: miss buffers always ship at the top rung
    cold_fold: bool = False
    # emit global src ids for the outermost hop (PaddedBatch.gsrc)
    emit_gsrc: bool = False
    # ship per-target uint8 degrees instead of int32 dst arrays
    compress_dst: bool = False
    # wire-pack int32 index arrays to uint16(+uint8) halves (ids < 2^24)
    pack_wire: bool = False
    # second, tighter bucket: batches that fit it ship as prefix views
    tight_spec: Optional[BatchSpec] = None
    # allocate the buffer pool in pinned host memory (CUDA consumers)
    pin_memory: bool = False


class FastSamplerIter:
    """One epoch's iterator: spawns workers, yields in-order BatchBuffers.

    The consumer must call :meth:`recycle` once a buffer set's contents
    have been copied to the device (train/pipeline.py does this);
    recycling returns the set to the pool and unblocks a worker.
    """

    # consumer-side stall fail-fast (see __next__)
    STALL_TIMEOUT_S = 600.0

    def __init__(self, sampler: "FastSampler", epoch: int):
        self.sampler = sampler
        cfg = sampler.cfg
        idx = sampler.get_epoch_idx(epoch)
        self.batches = split_seeds(idx, cfg.batch_size, cfg.exact_num_batches)
        self.num_batches = len(self.batches)
        self.stats = SamplerStats()
        self.epoch = epoch
        self._next_expected = 0
        self._reorder: dict = {}
        self._out: queue.Queue = queue.Queue()
        self._free: queue.Queue = queue.Queue()
        self._work: queue.Queue = queue.Queue()
        self._shutdown = threading.Event()
        self._stats_lock = threading.Lock()
        pool = min(cfg.max_batches_in_flight + cfg.num_workers,
                   max(2, self.num_batches + 1))
        for _ in range(max(pool, 1)):
            bufs = BatchBuffers(cfg.spec, pin=cfg.pin_memory)
            bufs.attach_from_config(cfg, self.sampler.num_nodes)
            self._free.put(bufs)
        for bno in range(self.num_batches):
            self._work.put(bno)
        self._threads = []
        for _ in range(max(1, cfg.num_workers)):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self):
        cfg = self.sampler.cfg
        while not self._shutdown.is_set():
            # acquire the buffer BEFORE claiming a batch number: a worker
            # that owns the consumer's next batch but no buffer could be
            # starved while peers fill the pool with later batches
            bufs = self._free.get()
            if bufs is None or self._shutdown.is_set():
                return
            try:
                bno = self._work.get_nowait()
            except queue.Empty:
                self._free.put(bufs)  # keep the pool at full capacity
                return
            t0 = time.perf_counter()
            try:
                self.sampler.native.sample_into(
                    bufs, self.batches[bno],
                    rng_seed=batch_seed(cfg.base_seed, self.epoch, bno),
                    y_global=self.sampler.y,
                )
                dropped = bufs.finalize_from_config(cfg)
                # 2-bucket padding recovery: a pure function of the
                # batch's measured sizes, so bucket choice is deterministic
                bufs.bucket = (cfg.tight_spec if cfg.tight_spec is not None
                               and bufs.fits(cfg.tight_spec) else None)
            except Exception as e:  # surface in the consumer, don't hang
                self.recycle(bufs)
                self._out.put((bno, e))
                return
            with self._stats_lock:  # the workers share the stats
                self.stats.dropped_cold += dropped
                self.stats.sample_time += time.perf_counter() - t0
            self._out.put((bno, bufs))

    def __len__(self):
        return self.num_batches

    def __iter__(self):
        return self

    def __next__(self) -> BatchBuffers:
        if self._next_expected >= self.num_batches:
            self.close()
            raise StopIteration
        t0 = time.perf_counter()
        blocked = False
        while self._next_expected not in self._reorder:
            try:
                bno, bufs = self._out.get(timeout=self.STALL_TIMEOUT_S)
            except queue.Empty:
                state = (f"batch {self._next_expected}/{self.num_batches} "
                         f"never arrived after {self.STALL_TIMEOUT_S}s: "
                         f"reorder={sorted(self._reorder)[:8]} "
                         f"free={self._free.qsize()} "
                         f"work={self._work.qsize()} "
                         f"workers_alive="
                         f"{sum(t.is_alive() for t in self._threads)}")
                self.close()
                raise RuntimeError(f"sampler stalled: {state}")
            blocked = True
            self._reorder[bno] = bufs
        if blocked:
            dur = time.perf_counter() - t0
            if dur > 1e-4:
                self.stats.total_blocked_dur += dur
                self.stats.total_blocked_occasions += 1
        bufs = self._reorder.pop(self._next_expected)
        if isinstance(bufs, BaseException):
            self.close()
            raise bufs
        cfg = self.sampler.cfg
        if cfg.cold_cache is not None:
            # serial, in consumption order: the cache's eviction-safety
            # contract (sampling/cold_cache.py)
            dropped = bufs.finalize_cached(cfg)
            with self._stats_lock:
                self.stats.dropped_cold += dropped
        self._next_expected += 1
        self.stats.batches += 1
        self.stats.dropped_nodes += int(bufs.overflow[0])
        self.stats.dropped_edges += int(bufs.overflow[1])
        self.stats.real_nodes += int(bufs.level_sizes[-1])
        self.stats.real_edges += int(bufs.edge_counts.sum())
        if bufs.cold_pos is not None:
            self.stats.cold_rows += int(bufs.cold_count[0])
        eff = bufs.bucket or bufs.spec
        self.stats.padded_nodes += eff.total_node_cap
        self.stats.padded_edges += sum(eff.edge_caps)
        if bufs.bucket is not None:
            self.stats.tight_batches += 1
        return bufs

    def recycle(self, bufs: BatchBuffers) -> None:
        self._free.put(bufs)

    def close(self):
        self._shutdown.set()
        # abandon unprocessed work so exiting workers don't leave batch
        # numbers that would block a later consumer
        try:
            while True:
                self._work.get_nowait()
        except queue.Empty:
            pass
        for _ in self._threads:
            self._free.put(None)  # unblock any worker waiting on a buffer
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []


class FastPreSampler:
    """Samples a whole epoch up front into unpinned buffer sets, one a
    batch, then iterates them (the JAX package's ``FastPreSampler``):
    host memory for no sampling latency inside the epoch."""

    def __init__(self, sampler: "FastSampler"):
        self.sampler = sampler
        self.dropped_cold = 0  # over-cold-budget rows across the epoch

    def presample(self, epoch: int) -> List[BatchBuffers]:
        cfg = self.sampler.cfg
        batches = split_seeds(self.sampler.get_epoch_idx(epoch),
                              cfg.batch_size, cfg.exact_num_batches)

        def work(bno):
            bufs = BatchBuffers(cfg.spec)
            bufs.attach_from_config(cfg, self.sampler.num_nodes)
            self.sampler.native.sample_into(
                bufs, batches[bno],
                rng_seed=batch_seed(cfg.base_seed, epoch, bno),
                y_global=self.sampler.y)
            return bufs, bufs.finalize_from_config(cfg)

        out = []
        with cf.ThreadPoolExecutor(max(1, cfg.num_workers)) as ex:
            for bufs, dropped in ex.map(work, range(len(batches))):
                out.append(bufs)
                self.dropped_cold += dropped
        return out

    def __iter__(self):
        return iter(self.presample(self.sampler.epoch))


class FastSampler:
    """Epoch-iterable sampler over one graph. ``idx`` is set per epoch by
    the trainer's shuffler."""

    def __init__(self, rowptr: np.ndarray, col: np.ndarray, y: np.ndarray,
                 cfg: FastSamplerConfig,
                 idx: Optional[np.ndarray] = None):
        self.native = NativeSampler(rowptr, col)
        self.y = y
        self.cfg = cfg
        self.idx = idx if idx is not None else np.empty(0, np.int64)
        self.epoch = 0

    def get_epoch_idx(self, epoch: int) -> np.ndarray:
        return self.idx

    @property
    def num_nodes(self) -> int:
        return self.native.rowptr.shape[0] - 1

    def set_epoch(self, idx: np.ndarray, epoch: int):
        self.idx = idx
        self.epoch = epoch

    def __len__(self):
        return len(split_seeds(self.idx, self.cfg.batch_size,
                               self.cfg.exact_num_batches))

    def __iter__(self) -> FastSamplerIter:
        return FastSamplerIter(self, self.epoch)
