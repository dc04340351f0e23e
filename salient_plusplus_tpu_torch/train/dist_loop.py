"""Data-parallel training over partitioned features (counterpart of the JAX
package's ``train/dist_loop.py``).

One process a GPU, as in SALIENT++: each rank of a ``torch.distributed``
group holds one contiguous partition's feature rows on its device and
samples its own stream of batches; a step assembles the batch's frontier
through the feature exchange (``parallel/exchange.py``) and averages the
gradients, the loss and the BatchNorm statistics over the group
(``parallel/spmd.py``). On top: a VIP cache of remote rows
(``create_cache``), the federated and fully-random load-balance schemes,
the host cold tiers (replicated, or owner-served through a pre-step
all_to_all), byte accounting, and layerwise inference sharded by rank
(``train/dist_inference.py``).

Where the JAX package drives a whole mesh from one process, a rank here
sees only itself: its sampler draws the batches of the JAX package's
device ``rank`` (seed ``cfg.seed + 1000 · rank``). Every collective is
issued in the same order on every rank, or NCCL deadlocks: iteration
counts come from the global seed count (``exact_num_batches``), and every
decision that changes a later collective (cap growth, the tight bucket)
reads counts that were first summed over the group.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..caching.vip import get_lambda_vip_cache
from ..config import RunConfig
from ..data.dataset import GraphData, pad_feature_dim
from ..data.reorder import reorder_graph
from ..models import make_model, mirror_all_specs
from ..parallel.exchange import (
    DeviceCache, assemble_features, fp8_encode_rows_np, wire_row_bytes)
from ..parallel.spmd import broadcast_model, eval_step, train_step
from ..sampling.cpp import NativeSampler, gather_rows
from ..sampling.sampler import FastSampler, FastSamplerConfig
from ..sampling.shufflers import (
    DistributedShuffler, FederatedDistributedShuffler)
from ..utils.device import resolve_device, synchronize
from ..utils.logging import RunLogger
from ..utils.timing import RuntimeStats
from .loop import calibrate_spec, refuse_unlabeled_train, run_trial_impl
from .pipeline import DeviceFeeder
from .state import create_train_state


def _grow(cap: int) -> int:
    """At least 1.25× a budget that proved short, 128-aligned."""
    return int(-(-int(cap * 1.25) // 128) * 128)


def _bf16_rows(x) -> torch.Tensor:
    """A feature shard as the device holds it: the feature dimension
    zero-padded to 128 (layer 0's weight shape is the JAX package's) and
    rounded to bf16 on the host once."""
    return torch.from_numpy(np.ascontiguousarray(pad_feature_dim(
        np.asarray(x, np.float32)))).to(torch.bfloat16)


def _bits(x: torch.Tensor) -> np.ndarray:
    """bf16 rows as their uint16 bits (numpy has no bf16)."""
    return x.contiguous().view(torch.int16).numpy().view(np.uint16).copy()


class _RankFeed:
    """The rank's sampler iterator as ``DeviceFeeder`` consumes it.

    With a tight bucket, a batch ships in it only when every rank's batch
    fits: the fit bit goes into one tiny ``all_reduce`` when the batch is
    pulled, and is read one pull later, so the collective's latency hides
    behind a step (at world 1 the rank's own bit decides, with no
    collective, as in the JAX package's one-process run). Under the
    owner-served cold tier each batch's request matrix is copied out (the
    buffers go back to the sampler's pool) and queued for the trainer's
    cold exchange, in batch order.

    The host seconds of the JAX package's stages, on the thread that
    feeds: ``sample_wait`` blocked on the samplers, ``bucket_psum`` in the
    agreement's collective, ``assemble`` copying the cold requests (the
    batch build and its copy are the feeder's ``put_dur``)."""

    def __init__(self, trainer: "DistributedTrainer", it, tight):
        self.tr, self.it, self.tight = trainer, it, tight
        self.cold_reqs = collections.deque()
        self.tight_steps = 0
        self.sample_wait = self.bucket_psum = self.assemble = 0.0
        self._pending = None
        self._started = False

    def __len__(self):
        return len(self.it)

    def recycle(self, bufs) -> None:
        self.it.recycle(bufs)

    def stages(self, feeder) -> Dict[str, float]:
        """The JAX package's host stages so far, but ``cold_serve`` (the
        trainer's): host seconds since the feed began."""
        return {"sample_wait": self.sample_wait,
                "assemble_h2d": feeder.put_dur + self.assemble,
                "bucket_psum": self.bucket_psum}

    def _pull(self):
        t0 = time.perf_counter()
        try:
            bufs = next(self.it)
        except StopIteration:
            return None
        finally:
            self.sample_wait += time.perf_counter() - t0
        fut = None
        if self.tight is not None and self.tr.world > 1:
            t0 = time.perf_counter()
            fut = self.tr._allsum_start([0 if bufs.bucket is not None else 1])
            self.bucket_psum += time.perf_counter() - t0
        return bufs, fut

    def __iter__(self):
        return self

    def __next__(self):
        if not self._started:
            self._started = True
            self._pending = self._pull()
        cur = self._pending
        if cur is None:
            raise StopIteration
        self._pending = self._pull()  # the next agreement is on its way
        bufs, fut = cur
        if self.tight is not None:
            if fut is None:  # world 1: the rank's own fit bit
                fit = bufs.bucket is not None
            else:
                t0 = time.perf_counter()
                fit = self.tr._allsum_finish(fut)[0] == 0
                self.bucket_psum += time.perf_counter() - t0
            bufs.bucket = self.tight if fit else None
            self.tight_steps += int(fit)
        if self.tr._owner_cold:
            t0 = time.perf_counter()
            self.cold_reqs.append(bufs.cold_req.copy())
            self.assemble += time.perf_counter() - t0
        return bufs


class DistributedTrainer:
    """The data-parallel trainer: one feature partition and one batch
    stream a rank. Built from a full GraphData and partition labels
    (reordered in memory) or, with :meth:`from_partitioned`, from an
    on-disk reordered dataset, one shard a rank.

    ``group`` is the process group (None: the default group, which must
    exist); its rank ``r`` owns partition ``r``. ``device`` is where the
    rank's shard and steps live (None: CUDA). Under NCCL the collectives'
    tensors live on the card, under gloo on the CPU.
    """

    def __init__(self, cfg: RunConfig, graph: Optional[GraphData] = None,
                 partition_ids: Optional[np.ndarray] = None, group=None,
                 device=None, vip_weights: Optional[np.ndarray] = None,
                 logger: Optional[RunLogger] = None, _pg=None,
                 _x_local=None):
        if cfg.cold_fold_update:
            raise ValueError(
                "cold_fold_update is a single-card option: the data-parallel "
                "trainer has no gsrc slack region to fold the cold write "
                "into (the JAX package's DistributedTrainer ignores it)")
        if _pg is None:
            refuse_unlabeled_train(graph.y, graph.split_idx["train"])
        else:
            refuse_unlabeled_train(_pg.y, _pg.split_idx["train"])
        if not dist.is_initialized():
            raise RuntimeError("DistributedTrainer needs a torch.distributed "
                               "process group (parallel/mesh.py)")
        self.cfg = cfg
        self.logger = logger or RunLogger()
        self.stats = RuntimeStats()
        self.device = resolve_device(device)
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)

        if _pg is None:
            k = int(partition_ids.max()) + 1
            if k != self.world:
                raise ValueError(f"{k} partitions for {self.world} ranks")
            pg, x_shards, old2new = reorder_graph(graph, partition_ids,
                                                  vip_weights)
            x_local, x_all = x_shards[self.rank], x_shards
        else:
            if _pg.num_parts != self.world:
                raise ValueError(f"{_pg.num_parts} partitions for "
                                 f"{self.world} ranks")
            pg, x_local, old2new = _pg, _x_local, None
            x_all = [x_local] if self.world == 1 else None
        self.pg = pg
        self.old2new = old2new
        self.part_offsets = np.asarray(pg.part_offsets, np.int64)
        self.part_offsets_dev = torch.as_tensor(self.part_offsets,
                                                device=self.device)
        self.native = NativeSampler(np.asarray(pg.rowptr, np.int64),
                                    np.asarray(pg.col, np.int32))
        self.y = np.asarray(pg.y, np.int32)

        # the hot/cold split of each partition (SALIENT++'s gpu_percent):
        # the first hot_size rows of a partition stay on the device; the
        # cold tails live in host RAM, every partition's on every host
        # (replicated) or each rank's own only (owner-served)
        x = _bf16_rows(x_local)
        S = int(self.part_offsets[1] - self.part_offsets[0])
        self.part_size = S
        self.num_features = int(x.shape[1])
        self.x_cold = self.x_cold_scale = None
        self.x_cold_own = self.x_cold_own_scale = None
        if cfg.hbm_fraction < 1.0:
            H = max(128, (int(S * cfg.hbm_fraction) // 128) * 128)
            if H >= S:
                raise ValueError(f"hbm_fraction {cfg.hbm_fraction} keeps "
                                 f"{H} of a partition's {S} rows: no tail")
            self.hot_size = H
            if cfg.cold_mode == "owner":
                if cfg.cold_fp8:
                    # encoded once: the serve ships F + 4 bytes a row
                    self.x_cold_own, self.x_cold_own_scale = \
                        fp8_encode_rows_np(x[H:].float().numpy())
                else:
                    self.x_cold_own = _bits(x[H:])
            else:
                if x_all is None or len(x_all) != self.world:
                    raise ValueError(
                        "the replicated cold tier needs every partition's "
                        "shard on each host; from_partitioned loads one: "
                        "use cold_mode='owner'")
                tails = [x[H:] if p == self.rank else _bf16_rows(sh)[H:]
                         for p, sh in enumerate(x_all)]
                if cfg.cold_fp8:
                    self.x_cold, self.x_cold_scale = fp8_encode_rows_np(
                        torch.cat(tails).float().numpy())
                else:
                    self.x_cold = _bits(torch.cat(tails))
            x = x[:H]
        else:
            self.hot_size = None
        self.features = x.to(self.device)

        # equal iteration counts on every rank: the global count from
        # ceil(global train seeds / global batch)
        self.iters_per_epoch = pg.get_num_iterations(
            cfg.train_batch_size * self.world)["train"]
        if cfg.load_balance_scheme == "federated":
            self.shuffler = FederatedDistributedShuffler(
                pg.split_idx_parts[self.rank]["train"], initial_seed=cfg.seed)
        else:
            self.shuffler = DistributedShuffler(
                pg.split_idx["train"], self.world, self.rank,
                initial_seed=cfg.seed)

        pool = pg.split_idx["train"]
        # equal-iteration chunks outgrow the nominal batch when partitions
        # hold unequal train-seed counts: the seed cap covers the largest
        # rank's chunk, computed over every partition so all ranks agree
        if cfg.load_balance_scheme == "federated":
            max_stream = max(len(pg.split_idx_parts[d]["train"])
                             for d in range(self.world))
        else:
            max_stream = -(-len(pool) // self.world)
        seed_cap = max(cfg.train_batch_size,
                       -(-max_stream // self.iters_per_epoch))
        if cfg.spec_buckets > 1:
            self.train_spec, self.train_tight = calibrate_spec(
                self.native, pool, seed_cap, cfg.train_fanouts,
                cfg.calibration_batches, cfg.spec_safety, cfg.seed,
                worst_case_probe=cfg.calibrate_worst_case,
                tight_quantile=cfg.tight_quantile)
        else:
            self.train_spec = calibrate_spec(
                self.native, pool, seed_cap, cfg.train_fanouts,
                cfg.calibration_batches, cfg.spec_safety, cfg.seed,
                worst_case_probe=cfg.calibrate_worst_case)
            self.train_tight = None
        self.train_spec, self.train_tight = mirror_all_specs(
            cfg.model_name, self.train_spec, self.train_tight)
        self._cache_ids_host = None
        self.r_cap = self._calibrate_r_cap()
        self._owner_cold = (self.hot_size is not None
                            and cfg.cold_mode == "owner")
        if self._owner_cold:
            self.cold_cap = 0
            self.cold_r_cap = self._calibrate_cold_r_cap(self.train_spec)
        else:
            self.cold_cap = (self._calibrate_cold_cap(self.train_spec)
                             if self.hot_size is not None else 0)
            self.cold_r_cap = 0
        self.eval_specs: Dict = {}
        self.sampler = FastSampler(
            self.native.rowptr, self.native.col, self.y,
            self._sampler_cfg(self.train_spec, cfg.train_batch_size,
                              cfg.seed + 1000 * self.rank,
                              self.iters_per_epoch, cfg.train_fanouts,
                              cold_cap=self.cold_cap,
                              cold_r_cap=self.cold_r_cap,
                              tight=self.train_tight))
        self.cache: Optional[DeviceCache] = None
        self._init_state()

    @classmethod
    def from_partitioned(cls, cfg: RunConfig, root: str, name: str,
                         group=None, device=None,
                         logger: Optional[RunLogger] = None
                         ) -> "DistributedTrainer":
        """Build from an on-disk reordered dataset (``data/reorder.py``,
        ``partition/cli.py``): each rank loads only its own shard."""
        from ..data.dataset import PartitionedGraphData

        pg = PartitionedGraphData.load_partitioned(root, name,
                                                   dist.get_rank(group))
        return cls(cfg, group=group, device=device, logger=logger, _pg=pg,
                   _x_local=pg.x)

    def _sampler_cfg(self, spec, batch_size, base_seed, num_batches,
                     fanouts, cold_cap, cold_r_cap, tight=None):
        cfg = self.cfg
        hot = self.hot_size is not None
        return FastSamplerConfig(
            spec=spec, batch_size=batch_size, base_seed=base_seed,
            num_workers=max(1, cfg.num_workers),
            max_batches_in_flight=max(4, cfg.max_batches_in_flight),
            exact_num_batches=num_batches,
            x_cold=self.x_cold, x_cold_scale=self.x_cold_scale,
            cold_cap=cold_cap,
            cold_part_size=self.part_size if hot else None,
            cold_hot_size=self.hot_size,
            cold_owner_mode=self._owner_cold, cold_world=self.world,
            cold_r_cap=cold_r_cap,
            compress_dst=all(0 < f <= 127 for f in fanouts),
            pack_wire=cfg.pack_wire and spec.total_node_cap < 2**24,
            tight_spec=tight,
            pin_memory=self.device.type == "cuda")

    # --- calibration (host numpy from seeded generators: every rank
    # computes the same caps without a collective) ----------------------
    def _calibrate_r_cap(self, spec=None, cache_ids=None,
                         split: str = "train") -> int:
        """The request budget: the most remote rows one rank asks of one
        owner over probe batches of ``spec``, × spec_safety, 128-aligned.
        Probes every partition's seed pool under the federated scheme;
        with ``cache_ids`` (every rank's sorted cache ids) cache hits do
        not count, which is how the cache shrinks the wire."""
        spec = spec or self.train_spec
        rng = np.random.default_rng(self.cfg.seed + 5)
        probes = max(4, self.cfg.calibration_batches // 2)
        worst = 128
        federated = self.cfg.load_balance_scheme == "federated"
        pools = ([self.pg.split_idx_parts[d][split]
                  for d in range(self.world)] if federated
                 else [self.pg.split_idx[split]])
        for pi, pool in enumerate(pools):
            if len(pool) == 0:
                continue
            for i in range(probes):
                take = min(spec.seed_cap, len(pool))
                seeds = np.sort(rng.choice(pool, take, replace=False))
                b = self.native.sample(spec, seeds, rng_seed=50 + i)
                ids = b.n_id[:int(b.level_sizes[-1])].numpy()
                owner = np.searchsorted(self.part_offsets[1:], ids,
                                        side="right")
                hot = ((ids % self.part_size) < self.hot_size
                       if self.hot_size is not None else None)
                for d in ([pi] if federated else range(self.world)):
                    remote = owner != d
                    if hot is not None:
                        remote &= hot
                    if cache_ids is not None:
                        pos = np.searchsorted(cache_ids[d], ids)
                        pos = np.clip(pos, 0, len(cache_ids[d]) - 1)
                        remote &= cache_ids[d][pos] != ids
                    cnt = np.bincount(owner[remote], minlength=self.world)
                    worst = max(worst, int(cnt.max()))
        return int(-(-int(worst * self.cfg.spec_safety) // 128) * 128)

    def _cold_probe(self, spec, pool, seed, rng_base, n_probes):
        """The cold frontier ids of ``n_probes`` probe batches."""
        rng = np.random.default_rng(self.cfg.seed + seed)
        for i in range(n_probes):
            take = min(spec.seed_cap, len(pool))
            seeds = np.sort(rng.choice(pool, take, replace=False))
            b = self.native.sample(spec, seeds, rng_seed=rng_base + i)
            ids = b.n_id[:int(b.level_sizes[-1])].numpy().astype(np.int64)
            yield ids[(ids % self.part_size) >= self.hot_size]

    def _calibrate_cold_r_cap(self, spec, pool=None) -> int:
        """Owner-served tier: the most cold rows one batch asks of one
        owner over probe batches — the cold all_to_all's budget."""
        pool = pool if pool is not None else self.pg.split_idx["train"]
        worst = 128
        for cold in self._cold_probe(
                spec, pool, 29, 70, max(3, self.cfg.calibration_batches // 2)):
            cnt = np.bincount(cold // self.part_size, minlength=self.world)
            worst = max(worst, int(cnt.max()))
        return int(-(-int(worst * self.cfg.spec_safety) // 128) * 128)

    def _calibrate_cold_cap(self, spec, pool=None) -> int:
        """Replicated tier: the most cold rows of one batch over probes."""
        pool = pool if pool is not None else self.pg.split_idx["train"]
        worst = 128
        for cold in self._cold_probe(spec, pool, 21, 60, 3):
            worst = max(worst, len(cold))
        return int(-(-int(worst * self.cfg.spec_safety) // 128) * 128)

    # --- collectives of host-side counts ------------------------------
    def _allsum_start(self, vals):
        """Start summing the ints ``vals`` over the group: (tensor, work).
        On the card the sum runs off the compute stream, so reading it
        does not wait for the steps queued there."""
        t = torch.tensor(vals, dtype=torch.int64)
        if self._side is None:
            return t, dist.all_reduce(t, group=self.group, async_op=True)
        with torch.cuda.stream(self._side):
            t = t.to(self.device)
            return t, dist.all_reduce(t, group=self.group, async_op=True)

    def _allsum_finish(self, fut) -> list:
        t, work = fut
        if self._side is None:
            work.wait()
            return t.tolist()
        with torch.cuda.stream(self._side):
            work.wait()
            return t.tolist()

    def _allsum(self, t: torch.Tensor) -> list:
        """Sum an int64 tensor on the trainer's device over the group and
        read it (one host sync)."""
        dist.all_reduce(t, group=self.group)
        return t.tolist()

    def _agree_min(self, value: int) -> int:
        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
        return int(t.item())

    def _barrier(self) -> None:
        self._allsum(torch.zeros(1, dtype=torch.int64, device=self.device))

    # --- the owner-served cold tier ------------------------------------
    def _cold_ids_a2a(self, req: np.ndarray):
        """Start the exchange of a batch's cold request ids ([world, cap]
        by owner): what this rank must serve arrives in a pinned host
        buffer, with the event recorded after its copy. The trainer
        issues it one batch ahead of the step that needs the rows, and
        the host later waits on the event, not on the stream, so the
        wait does not include the step between."""
        cuda = self._side is not None
        t = torch.from_numpy(req)
        if cuda:
            t = t.pin_memory().to(self.device, non_blocking=True)
        recv = torch.empty_like(t)
        dist.all_to_all_single(recv, t, group=self.group)
        if not cuda:
            return recv, None
        host = torch.empty(recv.shape, dtype=recv.dtype, pin_memory=True)
        host.copy_(recv, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def _cold_serve(self, pending, cap: int):
        """Gather the requested rows from this rank's own cold tail
        (``sampling/cpp.py::gather_rows``), copy them to the device and
        send them back with a second all_to_all: (rows [world · cap, F],
        fp8 row scales [world · cap] or None), in the request layout.
        With cold_fp8 a row travels as F + 4 bytes (payload and its
        float32 scale) in one collective."""
        got_t, ev = pending
        if ev is not None:
            ev.synchronize()
        got = got_t.numpy()
        world, F = self.world, self.num_features
        fp8 = self.x_cold_own_scale is not None
        W = F + 4 if fp8 else 2 * F
        buf = torch.zeros((world, cap, W), dtype=torch.uint8,
                          pin_memory=self._side is not None)
        rows = buf.numpy()
        m = got >= 0
        if m.any():
            idx = (got[m].astype(np.int64) % self.part_size) - self.hot_size
            if fp8:
                rows[m, :F] = gather_rows(self.x_cold_own, idx)
                rows[m, F:] = np.ascontiguousarray(
                    self.x_cold_own_scale[idx]).view(np.uint8).reshape(-1, 4)
            else:
                rows[m] = gather_rows(self.x_cold_own.view(np.uint8), idx)
        send = buf.to(self.device, non_blocking=True)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        recv = recv.view(world * cap, W)
        if not fp8:
            return recv.view(torch.bfloat16), None
        return recv[:, :F], recv[:, F:].contiguous().view(torch.float32)[:, 0]

    def _with_cold_rows(self, batch, feed: _RankFeed, issued, cap: int):
        """Owner-served tier: attach the batch's served rows. The ids
        exchange of the next batch is started first, so its host copy is
        complete when that batch is served."""
        while len(issued) < 2 and feed.cold_reqs:
            issued.append(self._cold_ids_a2a(feed.cold_reqs.popleft()))
        rows, scale = self._cold_serve(issued.popleft(), cap)
        return batch.replace(cold_rows=rows, cold_scale=scale)

    # --- the VIP cache --------------------------------------------------
    def create_cache(self, cache_size: Optional[float] = None,
                     strategy: Optional[str] = None):
        """Choose each partition's top remote vertices by the configured
        strategy, fetch this rank's rows through the exchange, install
        the cache and recalibrate the request budget cache-aware. Every
        rank computes every partition's list, so no collective is needed
        to agree on them. Returns the DeviceCache, or None when no row is
        cached (at world 1 no vertex is remote)."""
        cfg = self.cfg
        cache_size = cache_size if cache_size is not None else cfg.cache_size
        strategy = strategy or cfg.cache_strategy
        if self.world == 1:
            self.logger.log("EFFECTIVE_CACHE_SIZE", 0)
            return None
        scheme = {"vip": "vip-analytical-device",
                  "simulation": "vip-simulation",
                  "degree": "degree"}.get(strategy, strategy)
        pids = np.searchsorted(self.part_offsets[1:],
                               np.arange(self.pg.num_nodes), side="right"
                               ).astype(np.int32)
        lam = get_lambda_vip_cache(
            self.pg.rowptr, self.pg.col, pids, self.pg.split_idx["train"],
            cfg.train_fanouts, cfg.train_batch_size * self.world,
            scheme=scheme, num_iter_simulation=cfg.cache_creation_epochs,
            device=self.device)
        cached = lam(cache_size)
        if self.hot_size is not None:
            # only rows on the device are servable by the exchange
            cached = [c[(c % self.part_size) < self.hot_size] for c in cached]
        num = min(len(c) for c in cached)
        if num == 0:
            self.logger.log("EFFECTIVE_CACHE_SIZE", 0)
            return None
        if num >= 128:
            num = (num // 128) * 128
        all_ids = [np.sort(c[:num]).astype(np.int32) for c in cached]
        ids = torch.from_numpy(all_ids[self.rank]).to(self.device)
        self.cache = DeviceCache(ids, self._fetch_rows(ids))
        old_r_cap = self.r_cap
        self.r_cap = self._calibrate_r_cap(cache_ids=all_ids)
        self.eval_specs.clear()  # eval budgets are cache-aware too
        self._cache_ids_host = all_ids
        eff = num / max(self.pg.num_nodes / self.world, 1)
        self.logger.log("EFFECTIVE_CACHE_SIZE", num)
        self.logger.log("EFFECTIVE_REPLICATION_FACTOR", round(eff, 4))
        self.logger.log("R_CAP_RECALIBRATED", old_r_cap, "->", self.r_cap)
        return self.cache

    def _fetch_rows(self, ids: torch.Tensor, chunk: int = 2048):
        """The rows of ``ids`` (this rank's cache list) from the sharded
        table, through the exchange in chunks of ``chunk`` ids with a
        request budget of ``chunk``: every rank runs the same number of
        chunks, as every list has the same length."""
        out = []
        for c in range(0, ids.shape[0], chunk):
            part = ids[c:c + chunk]
            rows, _ = assemble_features(
                self.features, part, part.shape[0], self.part_offsets_dev,
                chunk, group=self.group)
            out.append(rows)
        return torch.cat(out)

    # --- the state -----------------------------------------------------
    def _init_state(self, trial_seed: int = 0):
        """Fresh weights (rank 0's, broadcast) and optimizer."""
        cfg = self.cfg
        seed = cfg.seed + trial_seed
        model = make_model(
            cfg.model_name, self.num_features, cfg.hidden_features,
            self.pg.num_classes, cfg.num_layers, cfg.dropout,
            dtype=getattr(torch, cfg.compute_dtype),
            generator=torch.Generator().manual_seed(seed))
        self.state = create_train_state(model, cfg.lr, seed, self.device)
        broadcast_model(self.state.model, self.group)

    # --- training ------------------------------------------------------
    def epoch_feed(self, epoch: int):
        """The epoch's batches on the device: (feed, DeviceFeeder)."""
        self.sampler.set_epoch(self.shuffler.get_idx(epoch), epoch)
        it = iter(self.sampler)
        if len(it) != self.iters_per_epoch:
            raise RuntimeError(f"rank {self.rank}: {len(it)} batches, "
                               f"{self.iters_per_epoch} expected")
        feed = _RankFeed(self, it, self.train_tight)
        return feed, DeviceFeeder(feed, self.device, depth=2,
                                  pipelined=not self.cfg.pipeline_disabled)

    def run_step(self, batch):
        """One data-parallel step on a device batch: (the group's mean
        loss, this rank's ExchangeStats)."""
        return train_step(self.state, self.features, batch, "partitioned",
                          self.part_offsets_dev, self.r_cap, self.cache,
                          self.hot_size, self.cfg.wire_fp8, self.group)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        feed, feeder = self.epoch_feed(epoch)
        n_iters = self.iters_per_epoch
        # local, cached, remote, overflow, sent bytes: summed on the
        # device, reduced over the group once at the end
        acc = torch.zeros(5, dtype=torch.int64, device=self.device)
        losses, issued, cold_serve = [], collections.deque(), 0.0
        with self.stats.region("train_epoch",
                               sync=lambda: synchronize(self.device)):
            for batch in feeder:
                if self._owner_cold:
                    t0 = time.perf_counter()
                    batch = self._with_cold_rows(batch, feed, issued,
                                                 self.cold_r_cap)
                    cold_serve += time.perf_counter() - t0
                loss, ex = self.run_step(batch)
                losses.append(loss)
                acc += torch.stack([ex.num_local, ex.num_cached,
                                    ex.num_remote, ex.num_overflow,
                                    ex.sent_bytes.to(torch.int64)])
        # the JAX package's four host stages (their sum is inside the
        # region), and the single-card Trainer's feed starvation
        for k, v in feed.stages(feeder).items():
            self.stats.add(k, v)
        self.stats.add("cold_serve", cold_serve)
        self.stats.add("feed_starved", feeder.starved_dur)
        self.stats.end_epoch()
        st = feed.it.stats
        (local, cached_hits, remote, overflow, sent_bytes, drop_n, drop_e,
         cold_drops) = self._allsum(torch.cat([acc, torch.tensor(
             [st.dropped_nodes, st.dropped_edges, st.dropped_cold],
             device=self.device)]))
        if drop_n or drop_e:
            # cap overflow truncated real data: grow the spec (every rank
            # read the same sums, so every rank grows alike)
            self.logger.log("WARNING_TRAIN_DROPPED", epoch, drop_n, drop_e)
            self.train_spec = self.train_spec.grown()
            self.sampler.cfg.spec = self.train_spec
            self.logger.log("SPEC_GROWN", self.train_spec.node_caps,
                            self.train_spec.edge_caps)
        if cold_drops:
            # cold rows over the budget zero-filled: grow it (reprobe,
            # never shrink, at least 1.25×)
            if self._owner_cold:
                self.logger.log("WARNING_COLD_DROPPED", epoch, cold_drops,
                                "cold_r_cap", self.cold_r_cap)
                self.cold_r_cap = max(
                    self._calibrate_cold_r_cap(self.train_spec),
                    _grow(self.cold_r_cap))
                self.sampler.cfg.cold_r_cap = self.cold_r_cap
                self.logger.log("COLD_R_CAP_GROWN", self.cold_r_cap)
            else:
                self.logger.log("WARNING_COLD_DROPPED", epoch, cold_drops,
                                "cold_cap", self.cold_cap)
                self.cold_cap = max(
                    self._calibrate_cold_cap(self.train_spec),
                    _grow(self.cold_cap))
                self.sampler.cfg.cold_cap = self.cold_cap
                self.logger.log("COLD_CAP_GROWN", self.cold_cap)
        mean_loss = float(torch.stack(losses).mean()) if losses else \
            float("nan")
        # the wire's true payload: the all_to_all buffers are fixed, so
        # each step every rank sends [world, r_cap] ids and rows
        F = self.num_features
        row_b = wire_row_bytes(F, self.features.dtype, cfg.wire_fp8)
        wire_bytes = n_iters * self.world * self.r_cap * (row_b + 4)
        cold_wire_bytes = 0
        if self._owner_cold:
            crow_b = wire_row_bytes(F, self.features.dtype, cfg.cold_fp8)
            cold_wire_bytes = (n_iters * self.world * self.cold_r_cap
                               * (crow_b + 4))
            self.logger.log("COLD_WIRE_BYTES", epoch, cold_wire_bytes,
                            "cold_r_cap", self.cold_r_cap,
                            "cold_fp8", cfg.cold_fp8)
        self.logger.log("NUM_SENT_BYTES", epoch, sent_bytes)
        self.logger.log("WIRE_BYTES", epoch, wire_bytes, "r_cap", self.r_cap)
        self.logger.log("epoch", epoch, "loss", mean_loss,
                        "remote", remote, "cache_hits", cached_hits,
                        "local", local, "overflow", overflow)
        if overflow:
            # overflowed requests zero-filled their rows: grow the budget
            # (the counts are the group's, so every rank grows alike)
            self.logger.log("WARNING_TRAIN_OVERFLOW", epoch, overflow,
                            "r_cap", self.r_cap)
            self.r_cap = max(
                self._calibrate_r_cap(cache_ids=self._cache_ids_host),
                _grow(self.r_cap))
            self.eval_specs.clear()
            self.logger.log("R_CAP_GROWN_AFTER_OVERFLOW", self.r_cap)
        return {"loss": mean_loss, "sent_bytes": sent_bytes,
                "wire_bytes": wire_bytes, "r_cap": self.r_cap,
                "cold_wire_bytes": cold_wire_bytes,
                "remote": remote, "cache_hits": cached_hits,
                "local": local, "overflow": overflow,
                "iters": n_iters, "tight_steps": feed.tight_steps}

    # --- evaluation ----------------------------------------------------
    def evaluate(self, split: str) -> float:
        """Batchwise accuracy of a split: each rank scores its own
        partition's seeds in the global number of batches."""
        cfg = self.cfg
        fanouts = (cfg.final_test_fanouts if split == "test"
                   else cfg.batchwise_test_fanouts)
        n_iters = max(1, -(-len(self.pg.split_idx[split])
                           // (cfg.test_batch_size * self.world)))
        max_local = max(len(self.pg.split_idx_parts[d][split])
                        for d in range(self.world))
        seed_cap = max(cfg.test_batch_size, -(-max_local // n_iters))
        key = (split, tuple(fanouts), seed_cap)
        if key not in self.eval_specs:
            espec = calibrate_spec(
                self.native, self.pg.split_idx[split], seed_cap, fanouts,
                cfg.calibration_batches, cfg.spec_safety, cfg.seed + 99,
                worst_case_probe=cfg.calibrate_worst_case)
            pool = self.pg.split_idx[split]
            self.eval_specs[key] = (
                espec,
                self._calibrate_cold_r_cap(espec, pool=pool)
                if self._owner_cold else 0,
                self._calibrate_r_cap(espec, cache_ids=self._cache_ids_host,
                                      split=split),
                self._calibrate_cold_cap(espec, pool=pool)
                if self.hot_size is not None and not self._owner_cold
                else 0)
        spec, e_cold_rcap, e_rcap, e_cold_cap = self.eval_specs[key]
        sampler = FastSampler(
            self.native.rowptr, self.native.col, self.y,
            self._sampler_cfg(spec, cfg.test_batch_size, cfg.seed + 17,
                              n_iters, fanouts, cold_cap=e_cold_cap,
                              cold_r_cap=e_cold_rcap),
            idx=self.pg.split_idx_parts[self.rank][split])
        feed = _RankFeed(self, iter(sampler), None)
        acc = torch.zeros(3, dtype=torch.int64, device=self.device)
        issued = collections.deque()
        for batch in DeviceFeeder(feed, self.device, depth=2):
            if self._owner_cold:
                batch = self._with_cold_rows(batch, feed, issued,
                                             e_cold_rcap)
            acc += eval_step(self.state, self.features, batch,
                             "partitioned", self.part_offsets_dev, e_rcap,
                             self.cache, self.hot_size, cfg.wire_fp8,
                             self.group)
        st = feed.it.stats
        correct, total, ex_overflow, drop_n, drop_e, drop_c = self._allsum(
            torch.cat([acc, torch.tensor(
                [st.dropped_nodes, st.dropped_edges, st.dropped_cold],
                device=self.device)]))
        if drop_n or drop_e or drop_c or ex_overflow:
            # this accuracy ran on truncated batches or zero-filled rows:
            # rebuild the split's entry grown, as every rank does alike
            self.logger.log("EVAL_SAMPLER_OVERFLOW", split, drop_n, drop_e,
                            drop_c, "exchange", ex_overflow)
            espec2 = spec.grown() if (drop_n or drop_e) else spec
            e_rcap2 = self._calibrate_r_cap(
                espec2, cache_ids=self._cache_ids_host, split=split)
            if ex_overflow:
                e_rcap2 = max(e_rcap2, _grow(e_rcap))
            e_cold2 = (max(self._calibrate_cold_r_cap(
                espec2, pool=self.pg.split_idx[split]), _grow(e_cold_rcap))
                if self._owner_cold else 0)
            e_cold_cap2 = e_cold_cap
            if drop_c and self.hot_size is not None and not self._owner_cold:
                e_cold_cap2 = max(self._calibrate_cold_cap(
                    espec2, pool=self.pg.split_idx[split]),
                    _grow(e_cold_cap))
            self.eval_specs[key] = (espec2, e_cold2, e_rcap2, e_cold_cap2)
            self.logger.log("EVAL_SPEC_GROWN", split)
        return correct / max(total, 1)

    def evaluate_layerwise(self, splits=("valid", "test")):
        """Exact full-graph accuracy from layerwise inference sharded by
        rank (``train/dist_inference.py``). It needs every partition's
        rows on its device (hbm_fraction 1); otherwise, and for a model
        not served layerwise (ARMA), the splits are scored batchwise, as
        on one card."""
        from ..models.inference import UNSERVED
        from .dist_inference import layerwise_inference_spmd

        if self.hot_size is not None:
            self.logger.log("LAYERWISE_NEEDS_FULL_HBM_FALLBACK")
            return {s: self.evaluate(s) for s in splits}
        if self.cfg.model_name in UNSERVED:
            self.logger.log("LAYERWISE_UNSUPPORTED_FALLBACK",
                            self.cfg.model_name)
            return {s: self.evaluate(s) for s in splits}
        logp = layerwise_inference_spmd(self, chunk=self.cfg.inference_chunk)
        pred = logp.argmax(-1)
        lo = int(self.part_offsets[self.rank])
        y = torch.from_numpy(self.y[lo:lo + self.part_size].astype(
            np.int64)).to(self.device)
        counts = []
        for s in splits:
            idx = torch.from_numpy(np.asarray(
                self.pg.split_idx_parts[self.rank][s], np.int64) - lo).to(
                    self.device)
            counts += [(pred[idx] == y[idx]).sum(),
                       torch.tensor(idx.shape[0], device=self.device)]
        tot = self._allsum(torch.stack(counts).to(torch.int64))
        out = {}
        for i, s in enumerate(splits):
            out[s] = tot[2 * i] / max(tot[2 * i + 1], 1)
            self.logger.log("layerwise_acc", s, out[s])
        return out

    # --- run_trial_impl hooks (train/loop.py) -------------------------
    def _trial_reset(self, trial: int):
        # partitioning, calibration and the cache do not depend on the
        # trial; only the train state does
        self._init_state(trial_seed=trial)

    def run_trial(self, trial: int = 0, checkpoint_dir=None):
        """The shared trial loop (``loop.run_trial_impl``): every rank
        trains and scores; rank 0 writes the checkpoints."""
        return run_trial_impl(self, trial, checkpoint_dir)
