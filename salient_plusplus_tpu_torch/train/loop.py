"""Single-card training driver: epoch loop, eval, best-model tracking
(counterpart of the JAX package's ``train/loop.py``).

The feature table sits on the device in bf16, whole or, with
``hbm_fraction < 1`` (the host cold tier), as its hot prefix: the cold
tail stays in host RAM and the sampler threads gather each batch's cold
rows, which the step overlays on the gathered frontier (K1 as a sorted
placement) or, in gsrc mode, writes into a slack region of the table
(optionally a persistent cold-row cache, ``cold_cache_slots``). The final
test is batchwise or layerwise (batchwise under the cold tier). A trial
with a checkpoint directory saves on each new best validation accuracy and
resumes from its latest checkpoint under ``RESUME=1``. Besides the
streaming ``FastSampler``, an epoch can be presampled (``FastPreSampler``)
or drawn from the pure-numpy oracle (``OracleSampler``); ``collect_data``
dumps the first batches of each epoch.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import RunConfig
from ..data.dataset import GraphData, pad_feature_dim
from ..models import make_model
from ..sampling.batch import BatchSpec, mirror_all_specs
from ..parallel.exchange import fp8_encode_rows_np
from ..sampling.cold_cache import HostColdCache
from ..sampling.cpp import BatchBuffers, NativeSampler
from ..sampling.oracle import multilayer_sample_np, pad_sample
from ..sampling.sampler import FastPreSampler, FastSampler, FastSamplerConfig
from ..sampling.shufflers import Shuffler
from ..utils.data_collector import DataCollector
from ..utils.device import resolve_device, synchronize
from ..utils.logging import RunLogger
from ..utils.timing import RuntimeStats
from . import checkpoint as ckpt
from .cold_policy import measure_h2d_credit, plan_cold_cache
from .pipeline import DeviceFeeder
from .state import ReduceLROnPlateau, TrainState, create_train_state
from .step import eval_step, strip_cold, train_step, write_cold_rows


def calibrate_spec(native: NativeSampler, seeds_pool: np.ndarray,
                   batch_size: int, fanouts, num_batches: int = 8,
                   safety: float = 1.3, seed: int = 1234,
                   worst_case_probe: bool = True,
                   tight_quantile: Optional[float] = None):
    """Measure frontier/edge sizes over probe batches → padded bucket.

    Capacities are max-observed × safety, rounded to 128 (edges to 512);
    the sampler counts overflow drops so a miscalibration shows. With
    ``tight_quantile`` set, returns ``(spec, tight)`` where ``tight`` is a
    second, quantile-calibrated bucket without safety margin (None when
    it would equal ``spec``). The probes are the JAX package's, so both
    packages calibrate the same caps for the same seeds.
    """
    L = len(fanouts)
    batch_size = min(batch_size, len(seeds_pool)) or batch_size
    caps = [batch_size]
    for f in fanouts:
        caps.append(max(caps[-1],
                        min(caps[-1] * (abs(f) + 1) + 1024,
                            native.rowptr.shape[0] - 1 + 1024)))
    probe = BatchSpec(tuple(fanouts), batch_size, tuple(caps),
                      tuple(max(1024, caps[i] * max(abs(fanouts[i]), 1))
                            for i in range(L)))
    rng = np.random.default_rng(seed)
    probes = []
    for _ in range(num_batches):
        take = min(batch_size, len(seeds_pool))
        probes.append(np.sort(rng.choice(seeds_pool, size=take,
                                         replace=False)))
    # adversarial probe: the pool's highest-degree seeds form a near
    # upper-bound batch on skewed graphs
    if worst_case_probe:
        deg = np.diff(native.rowptr)
        order = np.argsort(-deg[seeds_pool], kind="stable")
        probes.append(np.sort(
            seeds_pool[order[: min(batch_size, len(seeds_pool))]]))
    bufs = BatchBuffers(probe)
    ls_all, ec_all = [], []
    for i, seeds in enumerate(probes):
        native.sample_into(bufs, seeds, rng_seed=seed + i)
        ls_all.append(bufs.level_sizes.astype(np.int64))
        ec_all.append(bufs.edge_counts.astype(np.int64))  # sampling order
    spec = BatchSpec.from_measurements(
        batch_size, fanouts, np.max(ls_all, axis=0), np.max(ec_all, axis=0),
        safety=safety)
    if tight_quantile is None:
        return spec
    # quantile over the RANDOM probes only
    n_rand = num_batches if worst_case_probe else len(ls_all)
    ls_q = np.quantile(np.stack(ls_all[:n_rand]), tight_quantile, axis=0)
    ec_q = np.quantile(np.stack(ec_all[:n_rand]), tight_quantile, axis=0)
    tight = BatchSpec.from_measurements(batch_size, fanouts, ls_q, ec_q,
                                        safety=1.0)
    tight = BatchSpec(
        tight.fanouts, tight.seed_cap,
        tuple(min(a, b) for a, b in zip(tight.node_caps, spec.node_caps)),
        tuple(min(a, b) for a, b in zip(tight.edge_caps, spec.edge_caps)))
    return spec, (tight if tight != spec else None)


@dataclass
class TrialResult:
    best_epoch: int = -1
    best_valid_acc: float = 0.0
    final_valid_acc: float = 0.0
    final_test_acc: float = 0.0
    epoch_times: List[float] = field(default_factory=list)
    losses: List[float] = field(default_factory=list)


class Trainer:
    """Single-card trainer over one GraphData. ``device=None`` means CUDA;
    the tests pass ``device="cpu"``."""

    def __init__(self, cfg: RunConfig, graph: GraphData,
                 logger: Optional[RunLogger] = None, device=None):
        self.cfg = cfg
        self.graph = graph
        self.logger = logger or RunLogger()
        self.stats = RuntimeStats()
        self.device = resolve_device(device)
        self.collector = DataCollector(cfg.output_root, rank=0,
                                       enabled=cfg.collect_data)

        self.native = NativeSampler(np.asarray(graph.rowptr, np.int64),
                                    np.asarray(graph.col, np.int32))
        train_idx = graph.split_idx["train"]
        if cfg.spec_buckets > 1:
            self.train_spec, self.train_tight = calibrate_spec(
                self.native, train_idx, cfg.train_batch_size,
                cfg.train_fanouts, cfg.calibration_batches, cfg.spec_safety,
                cfg.seed, worst_case_probe=cfg.calibrate_worst_case,
                tight_quantile=cfg.tight_quantile)
        else:
            self.train_spec = calibrate_spec(
                self.native, train_idx, cfg.train_batch_size,
                cfg.train_fanouts, cfg.calibration_batches, cfg.spec_safety,
                cfg.seed, worst_case_probe=cfg.calibrate_worst_case)
            self.train_tight = None
        self.train_spec, self.train_tight = mirror_all_specs(
            cfg.model_name, self.train_spec, self.train_tight)
        # (split, fanouts) -> (spec, tight-or-None)
        self.eval_specs: Dict[tuple, tuple] = {}
        # per-split cold cap: calibrated once per (split, spec), and a floor
        # raised after an evaluate() that dropped cold rows
        self.eval_cold_base: Dict[tuple, int] = {}
        self.eval_cold_floor: Dict[tuple, int] = {}

        # the table in bf16 once on the host; the 128-column padding keeps
        # layer 0's weight shape that of the JAX package
        V = graph.num_nodes
        x = torch.from_numpy(np.ascontiguousarray(pad_feature_dim(
            np.asarray(graph.x, np.float32)))).to(torch.bfloat16)
        # hot/cold split (SALIENT++'s gpu_percent): the hot prefix lives on
        # the device, the cold tail in host RAM as bf16 bits (numpy has no
        # bf16), or fp8 bytes with a row scale under cold_fp8
        self.hot_cutoff = (None if cfg.hbm_fraction >= 1.0
                           else max(1, int(V * cfg.hbm_fraction)))
        H = self.hot_cutoff
        self.x_cold_scale = None
        # cold rows are UNIQUE frontier members, so a batch can never hold
        # more than the whole cold tail: the cap every growth clamps to
        self._cold_cap_max = 0 if H is None else -(-(V - H) // 128) * 128
        if H is not None:
            tail = x[H:]
            if cfg.cold_fp8:
                self.x_cold, self.x_cold_scale = fp8_encode_rows_np(
                    tail.float().numpy())
            else:
                self.x_cold = tail.view(torch.int16).numpy().view(
                    np.uint16).copy()
            cold_cap = self._calibrate_cold_cap(train_idx)
        else:
            self.x_cold, cold_cap = None, 0

        # layer 0 aggregates straight from the device table when the
        # model's first hop consumes raw features (gsrc mode): the frontier
        # gather shrinks to the level-(L-1) prefix. Under the cold tier
        # the batch's cold rows are written into a slack region of the
        # table before its step and cold ids are remapped to slack slots
        # by the sampler, so the same single-gather path applies.
        self.global_msg0 = (cfg.gsrc_mode != "off" and
                            cfg.model_name in ("SAGE", "SAGEClassic", "GIN"))
        self._gsrc_cold = self.global_msg0 and H is not None
        self._slack = 0
        # ship uint8 per-target degrees instead of int32 dst
        self.compress_dst = all(0 < f <= 127 for f in cfg.train_fanouts)
        # wire-pack int32 index arrays when every shipped id fits 24 bits
        # (with gsrc the cold slot encoding adds at most the cold cap)
        self.pack_wire = (cfg.pack_wire
                          and (not self.global_msg0 or V < 2**24 - 256)
                          and self.train_spec.total_node_cap < 2**24)
        # persistent device cold-row cache in the slack region: only MISS
        # rows ship per batch; +1 slack row = the permanent zero row that
        # dropped ids point at. -1: slots from the measured link credit
        self._cold_cache = None
        self.cold_plan = None
        slots = cfg.cold_cache_slots
        if slots != 0:
            if not self._gsrc_cold:
                raise ValueError(
                    "cold_cache_slots requires a gsrc-capable model "
                    "(SAGE/SAGEClassic/GIN): the cache lives in the gsrc "
                    "slack region")
            if slots == -1:
                slots = self._plan_cold_cache(train_idx, cold_cap, V)
        if slots > 0:
            self._cold_cache = HostColdCache(V - H, max(slots, cold_cap))
        # cold_fold_update: the step itself writes the cold rows (cache
        # mode: the miss buffers always ship at the top rung)
        self._fold_cold = (cfg.cold_fold_update and
                           (self._cold_cache is not None or self._gsrc_cold))
        self._fold_slack_at = (H if self._fold_cold
                               and self._cold_cache is None else None)
        self.train_sampler = FastSampler(
            self.native.rowptr, self.native.col,
            np.asarray(graph.y, np.int32),
            FastSamplerConfig(
                spec=self.train_spec, batch_size=cfg.train_batch_size,
                base_seed=cfg.seed, num_workers=cfg.num_workers,
                max_batches_in_flight=cfg.max_batches_in_flight,
                hot_cutoff=H, x_cold=self.x_cold,
                x_cold_scale=self.x_cold_scale,
                cold_cap=cold_cap, cold_cache=self._cold_cache,
                cold_fold=self._fold_cold,
                emit_gsrc=self.global_msg0,
                compress_dst=self.compress_dst,
                pack_wire=self.pack_wire,
                tight_spec=self.train_tight,
                pin_memory=self.device.type == "cuda"))
        self.shuffler = Shuffler(train_idx, initial_seed=cfg.seed + 2**31 - 1)

        self.features = (x if H is None else x[:H]).to(self.device)
        if self._cold_cache is not None:
            self._ensure_slack(self._cold_cache.slots + 1)
        elif self._gsrc_cold:
            self._ensure_slack(self.train_sampler.cfg.cold_cap)
        self.in_features = int(self.features.shape[1])
        self.state: Optional[TrainState] = None
        self.reset()

    # --- the host cold tier -------------------------------------------
    def _plan_cold_cache(self, train_idx, cold_cap: int, V: int) -> int:
        """cold_cache_slots == -1: the slot count from the link credit
        (train/cold_policy.py). One probe batch through the production
        wire format measures the real payload split (base vs cold); the
        slots are sized so the projected residual demand fits the credit.
        Returns 0 (cache off) where the link keeps up."""
        cfg = self.cfg
        credit = cfg.h2d_credit_mbs
        if credit is None:
            credit = measure_h2d_credit(self.device)
        if credit is None:  # a CPU device: no link to be bound by
            self.logger.log("COLD_CACHE_PLAN", "cpu-backend", 0)
            return 0
        probe_cfg = FastSamplerConfig(
            spec=self.train_spec, batch_size=cfg.train_batch_size,
            base_seed=cfg.seed, num_workers=1,
            hot_cutoff=self.hot_cutoff, x_cold=self.x_cold,
            x_cold_scale=self.x_cold_scale, cold_cap=cold_cap,
            emit_gsrc=self.global_msg0, compress_dst=self.compress_dst,
            pack_wire=self.pack_wire)
        bufs = BatchBuffers(self.train_spec)
        bufs.attach_from_config(probe_cfg, V)
        self.native.sample_into(
            bufs, np.sort(np.asarray(train_idx)[: self.train_spec.seed_cap]),
            rng_seed=41, y_global=None)
        bufs.finalize_from_config(probe_cfg)
        pb = bufs.to_padded_batch()
        cold_bytes = (bufs.cold_rows.nbytes + bufs.cold_pos.nbytes
                      + (bufs.cold_scale.nbytes
                         if bufs.cold_scale is not None else 0))
        plan = plan_cold_cache(
            credit, cfg.assumed_chip_rate_eps,
            edges_per_batch=max(pb.num_real_edges(), 1),
            base_bytes_per_batch=max(pb.nbytes - cold_bytes, 0),
            cold_bytes_per_batch=cold_bytes,
            cold_tail_rows=V - self.hot_cutoff)
        self.cold_plan = plan
        self.logger.log("COLD_CACHE_PLAN", plan.slots,
                        "demand_mbs", plan.projected_demand_mbs,
                        "residual_mbs", plan.residual_demand_mbs,
                        "credit_mbs", round(plan.credit_mbs, 1),
                        plan.reason)
        return plan.slots

    def _calibrate_cold_cap(self, pool, spec=None, align: int = 128) -> int:
        """The cold rows a batch may ship: the most cold frontier rows
        over a few probe batches x spec_safety, rounded up to ``align``
        and clamped at the whole cold tail."""
        spec = spec or self.train_spec
        rng = np.random.default_rng(self.cfg.seed + 13)
        worst = align
        for i in range(max(2, self.cfg.calibration_batches // 2)):
            take = min(spec.seed_cap, len(pool))
            seeds = np.sort(rng.choice(pool, take, replace=False))
            b = self.native.sample(spec, seeds, rng_seed=77 + i)
            n = int(b.level_sizes[-1])
            worst = max(worst, int((b.n_id[:n] >= self.hot_cutoff).sum()))
        cap = int(-(-int(worst * self.cfg.spec_safety) // align) * align)
        return min(cap, self._cold_cap_max)

    def _clamped_cold_growth(self, old_cap: int, pool) -> int:
        """Post-drop cold-budget growth: max(reprobe, 1.25x), clamped at
        the whole cold tail."""
        return min(self._cold_cap_max,
                   max(self._calibrate_cold_cap(pool),
                       int(-(-int(old_cap * 1.25) // 128) * 128)))

    def _ensure_slack(self, n: int):
        """Grow the device table's slack region (rows [hot_cutoff,
        hot_cutoff + slack)) to at least ``n`` rows. This replaces
        ``self.features``: every later reader takes the new tensor."""
        if n <= self._slack:
            return
        f = self.features
        self.features = torch.cat(
            [f, f.new_zeros(n - self._slack, f.shape[1])])
        self._slack = n

    def _cold_update(self, batch):
        """Write this batch's cold rows into the slack region, in place on
        the compute stream, after the feeder's wait on the batch's copy
        and before the step (so in stream order)."""
        write_cold_rows(self.features, batch, self.hot_cutoff)

    def _cache_update(self, batch):
        """Cache mode: write this batch's MISS rows into their slots (pads
        go to the zero row), then strip the cold fields from the batch."""
        write_cold_rows(self.features, batch, None)
        return strip_cold(batch)

    def _pre_step(self, batch, fold: bool = False):
        """Per-batch cold-tier device work, issued before the step. A no-op
        for batches without cold rows; with ``fold`` the step applies the
        write itself; the overlay of the non-gsrc path runs in
        ``gather_features``."""
        if batch.cold_rows is None or fold:
            return batch
        if self._cold_cache is not None:
            return self._cache_update(batch)
        if self._gsrc_cold:
            self._cold_update(batch)
        return batch

    def run_step(self, batch) -> torch.Tensor:
        """_pre_step + one train step on a device batch; returns the loss
        (device). The single entry point for every train-batch consumer."""
        fold = self._fold_cold and batch.cold_rows is not None
        batch = self._pre_step(batch, fold=fold)
        return train_step(self.state, self.features, batch, self.global_msg0,
                          fold_cold=fold, fold_slack_at=self._fold_slack_at)

    def _grow_cold_after_drops(self, epoch: int, dropped: int):
        """Over-budget cold rows of a train epoch alias slot 0 (gsrc) or
        keep the clamped hot row: grow the per-batch cold buffer (reprobe;
        never shrink; at least 1.25x, clamped at the cold tail) and the
        slack with it. The next epoch's buffer pool picks the new cap up
        from the config."""
        scfg = self.train_sampler.cfg
        self.logger.log("WARNING_COLD_DROPPED", epoch, dropped, "cold_cap",
                        scfg.cold_cap)
        scfg.cold_cap = self._clamped_cold_growth(
            scfg.cold_cap, self.graph.split_idx["train"])
        if self._cold_cache is not None:
            # drops can come from slot exhaustion too: grow the slot space
            # alongside the per-batch miss budget
            self._cold_cache.grow(
                max(int(self._cold_cache.slots * 1.25), scfg.cold_cap))
            self._ensure_slack(self._cold_cache.slots + 1)
        elif self._gsrc_cold:
            self._ensure_slack(scfg.cold_cap)
        self.logger.log("COLD_CAP_GROWN", scfg.cold_cap)

    def reset(self, trial_seed: int = 0):
        """Fresh weights + optimizer (the per-trial reset)."""
        seed = self.cfg.seed + trial_seed
        gen = torch.Generator().manual_seed(seed)
        model = make_model(
            self.cfg.model_name, self.in_features, self.cfg.hidden_features,
            self.graph.num_classes, self.cfg.num_layers, self.cfg.dropout,
            dtype=getattr(torch, self.cfg.compute_dtype), generator=gen)
        self.state = create_train_state(model, self.cfg.lr, seed,
                                        self.device)

    def _feeder(self, it, depth: int) -> DeviceFeeder:
        return DeviceFeeder(it, self.device, depth=depth,
                            pipelined=not self.cfg.pipeline_disabled)

    def train_epoch(self, epoch: int) -> float:
        cfg = self.cfg
        if cfg.train_sampler == "OracleSampler":
            return self._train_epoch_oracle(epoch)
        self.train_sampler.set_epoch(self.shuffler.get_idx(epoch), epoch)
        if cfg.train_sampler == "FastPreSampler":
            return self._train_epoch_presampled(epoch)
        it = iter(self.train_sampler)
        feeder = self._feeder(it, max(2, cfg.max_batches_in_flight // 2))
        losses = []
        # a torch.profiler trace of the post-warm-up epoch
        prof = None
        if cfg.profile_dir is not None and epoch == 1:
            prof = torch.profiler.profile(on_trace_ready=torch.profiler
                                          .tensorboard_trace_handler(
                                              cfg.profile_dir))
            prof.__enter__()
        self.collector.set_epoch(epoch)
        try:
            with self.stats.region("train_epoch",
                                   sync=lambda: synchronize(self.device)):
                for bno, batch in enumerate(feeder):
                    if self.collector.enabled and bno < 4:
                        self.collector.collect(
                            f"batch{bno}", level_sizes=batch.level_sizes,
                            seed_count=batch.seed_count,
                            edge_counts=[e.count for e in batch.edges])
                    losses.append(self.run_step(batch))
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        self.stats.add("feed_starved", feeder.starved_dur)
        self.stats.add("sampler_blocked", it.stats.total_blocked_dur)
        self.stats.end_epoch()
        spec = self.train_spec  # this epoch's caps (for waste accounting)
        if it.stats.dropped_nodes or it.stats.dropped_edges:
            # cap overflow truncated real data: grow the spec; the next
            # epoch's buffer pool picks it up
            self.logger.log("SAMPLER_OVERFLOW", epoch,
                            it.stats.dropped_nodes, it.stats.dropped_edges)
            self.train_spec = self.train_spec.grown()
            self.train_sampler.cfg.spec = self.train_spec
            self.logger.log("SPEC_GROWN", self.train_spec.node_caps,
                            self.train_spec.edge_caps)
        if it.stats.dropped_cold:
            self._grow_cold_after_drops(epoch, it.stats.dropped_cold)
        if self._cold_cache is not None:
            h, mi, dr = self._cold_cache.reset_epoch_stats()
            self.logger.log(
                "COLD_CACHE", epoch, "hits", h, "misses", mi,
                "dropped", dr, "slots", self._cold_cache.slots,
                "hit_rate", round(h / max(h + mi, 1), 4))
        # one device→host read for the whole epoch
        mean_loss = (float(torch.stack(losses).mean().item())
                     if losses else float("nan"))
        self.logger.log(
            "epoch", epoch, "loss", mean_loss,
            "sampler_blocked", round(it.stats.total_blocked_dur, 4),
            "pad_waste_nodes",
            round(it.stats.node_waste(spec.total_node_cap), 4),
            "pad_waste_edges",
            round(it.stats.edge_waste(sum(spec.edge_caps)), 4),
            "tight_frac",
            round(it.stats.tight_batches / max(it.stats.batches, 1), 4))
        return mean_loss

    def _train_epoch_presampled(self, epoch: int) -> float:
        """FastPreSampler path: the whole epoch is sampled up front, then
        each batch is copied to the device and trained on."""
        losses = []
        pre = FastPreSampler(self.train_sampler)
        with self.stats.region("train_epoch",
                               sync=lambda: synchronize(self.device)):
            for bufs in pre.presample(epoch):
                batch = bufs.to_padded_batch().to(self.device)
                losses.append(self.run_step(batch))
        self.stats.end_epoch()
        if pre.dropped_cold:
            self._grow_cold_after_drops(epoch, pre.dropped_cold)
        mean_loss = (float(torch.stack(losses).mean().item())
                     if losses else float("nan"))
        self.logger.log("epoch", epoch, "loss", mean_loss)
        return mean_loss

    def _train_epoch_oracle(self, epoch: int) -> float:
        """OracleSampler path: train through the independent pure-numpy
        sampler (sampling/oracle.py), a cross-check of the native
        sampling, padding and step stack end to end. It has no host cold
        tier."""
        if self.hot_cutoff is not None:
            raise ValueError(
                "OracleSampler requires hbm_fraction=1 (it has no host "
                "cold tier); use it as the all-in-memory cross-check path")
        cfg = self.cfg
        idx = self.shuffler.get_idx(epoch)
        y = np.asarray(self.graph.y, np.int32)
        spec = self.train_spec
        rng = np.random.default_rng(cfg.seed * 9176 + epoch)
        losses = []
        bs = cfg.train_batch_size
        with self.stats.region("train_epoch",
                               sync=lambda: synchronize(self.device)):
            for s in range(0, len(idx) - bs + 1, bs):
                res = multilayer_sample_np(
                    self.graph.rowptr, self.graph.col,
                    np.sort(idx[s:s + bs]), spec.fanouts, rng,
                    node_caps=spec.node_caps, edge_caps=spec.edge_caps)
                batch = pad_sample(res, spec, y).to(self.device)
                losses.append(self.run_step(batch))
        self.stats.end_epoch()
        mean_loss = (float(torch.stack(losses).mean().item())
                     if losses else float("nan"))
        self.logger.log("epoch", epoch, "loss", mean_loss,
                        "sampler", "oracle")
        return mean_loss

    def _eval_sampler(self, split: str) -> FastSampler:
        cfg = self.cfg
        fanouts = (cfg.final_test_fanouts if split == "test"
                   else cfg.batchwise_test_fanouts)
        key = (split, tuple(fanouts))
        if key not in self.eval_specs:
            out = calibrate_spec(
                self.native, self.graph.split_idx[split],
                cfg.test_batch_size, fanouts,
                cfg.calibration_batches, cfg.spec_safety, cfg.seed + 99,
                worst_case_probe=cfg.calibrate_worst_case,
                tight_quantile=(cfg.tight_quantile
                                if cfg.spec_buckets > 1 else None))
            self.eval_specs[key] = out if isinstance(out, tuple) \
                else (out, None)
        spec, tight = self.eval_specs[key]
        if self.hot_cutoff is not None:
            if key not in self.eval_cold_base:
                self.eval_cold_base[key] = self._calibrate_cold_cap(
                    self.graph.split_idx[split], spec)
            cold_cap = max(self.eval_cold_base[key],
                           self.eval_cold_floor.get(key, 0))
        else:
            cold_cap = 0
        # shuffled eval seeds: sorted split slices would form
        # degree-correlated batches that need far larger caps
        eval_idx = self.graph.split_idx[split]
        eval_idx = eval_idx[np.random.default_rng(cfg.seed + 31)
                            .permutation(len(eval_idx))]
        return FastSampler(
            self.native.rowptr, self.native.col,
            np.asarray(self.graph.y, np.int32),
            FastSamplerConfig(
                spec=spec, batch_size=cfg.test_batch_size,
                base_seed=cfg.seed + 7, num_workers=cfg.num_workers,
                max_batches_in_flight=cfg.max_batches_in_flight,
                hot_cutoff=self.hot_cutoff, x_cold=self.x_cold,
                x_cold_scale=self.x_cold_scale,
                cold_cap=cold_cap, cold_cache=self._cold_cache,
                emit_gsrc=self.global_msg0,
                compress_dst=all(0 < f <= 127 for f in fanouts),
                pack_wire=(self.pack_wire
                           and spec.total_node_cap < 2**24),
                tight_spec=tight,
                pin_memory=self.device.type == "cuda"),
            idx=eval_idx)

    def evaluate(self, split: str) -> float:
        """Batchwise accuracy on a split."""
        sampler = self._eval_sampler(split)
        if self._cold_cache is not None:
            self._ensure_slack(self._cold_cache.slots + 1)
        elif self._gsrc_cold:
            # eval specs have larger frontiers, so possibly a larger cold
            # budget than the train slack
            self._ensure_slack(sampler.cfg.cold_cap)
        it = iter(sampler)
        correct, total = [], []
        for batch in DeviceFeeder(it, self.device, depth=2):
            batch = self._pre_step(batch)
            c, t = eval_step(self.state, self.features, batch,
                             self.global_msg0)
            correct.append(c)
            total.append(t)
        acc = (torch.stack(correct).sum().item()
               / max(torch.stack(total).sum().item(), 1)) if correct else 0.0
        fanouts = (self.cfg.final_test_fanouts if split == "test"
                   else self.cfg.batchwise_test_fanouts)
        key = (split, tuple(fanouts))
        if it.stats.dropped_nodes or it.stats.dropped_edges:
            self.logger.log("EVAL_SAMPLER_OVERFLOW", split,
                            it.stats.dropped_nodes, it.stats.dropped_edges)
            spec, tight = self.eval_specs[key]
            self.eval_specs[key] = (spec.grown(), tight)
            # the grown spec has larger frontiers: recalibrate its cold cap
            self.eval_cold_base.pop(key, None)
            self.logger.log("EVAL_SPEC_GROWN", split)
        if it.stats.dropped_cold:
            # over-budget cold rows: raise this split's persistent floor
            # (the per-call probe already underestimated once)
            cap = sampler.cfg.cold_cap
            self.logger.log("EVAL_COLD_DROPPED", split,
                            it.stats.dropped_cold, "cold_cap", cap)
            self.eval_cold_floor[key] = min(self._cold_cap_max, max(
                self.eval_cold_floor.get(key, 0),
                int(-(-int(cap * 1.25) // 128) * 128)))
            if self._cold_cache is not None:
                self._cold_cache.grow(
                    max(int(self._cold_cache.slots * 1.25),
                        self.eval_cold_floor[key]))
                self._ensure_slack(self._cold_cache.slots + 1)
            self.logger.log("EVAL_COLD_CAP_GROWN", split,
                            self.eval_cold_floor[key])
        return acc

    def evaluate_layerwise(self, splits=("valid", "test")):
        """Exact full-graph accuracy via layerwise inference
        (models/inference.py): one pass computes every node's
        representation, so all splits score from the same embeddings. A
        model the JAX package does not serve layerwise (ARMA) is scored
        batchwise instead, as there, and so is every model under the host
        cold tier (the table is not all on the device)."""
        from ..models.inference import UNSERVED, layerwise_inference

        if self.hot_cutoff is not None:
            self.logger.log("LAYERWISE_NEEDS_FULL_HBM_FALLBACK")
            return {s: self.evaluate(s) for s in splits}
        name = self.cfg.model_name
        if name in UNSERVED:
            self.logger.log("LAYERWISE_UNSUPPORTED_FALLBACK", name)
            return {s: self.evaluate(s) for s in splits}
        t0 = time.perf_counter()
        logp = layerwise_inference(
            name, self.state.model, self.graph.rowptr, self.graph.col,
            self.features, chunk=self.cfg.inference_chunk)
        pred = logp.argmax(-1)
        y = torch.from_numpy(np.asarray(self.graph.y, np.int64)).to(
            self.device)
        out = {}
        for s in splits:
            idx = torch.from_numpy(np.asarray(self.graph.split_idx[s],
                                              np.int64)).to(self.device)
            out[s] = float((pred[idx] == y[idx]).to(torch.float32).mean())
            self.logger.log("layerwise_acc", s, out[s])
        # the accuracies above were read back, so the device has finished
        self.logger.log("layerwise_s", round(time.perf_counter() - t0, 3))
        return out

    # --- run_trial_impl hooks -----------------------------------------
    def _trial_reset(self, trial: int):
        self.reset(trial_seed=trial)

    def run_trial(self, trial: int = 0,
                  checkpoint_dir: Optional[str] = None) -> TrialResult:
        """Epoch loop with best-validation tracking and, with
        ``checkpoint_dir``, checkpoints and ``RESUME=1``."""
        return run_trial_impl(self, trial, checkpoint_dir)


def run_trial_impl(trainer, trial: int = 0,
                   checkpoint_dir: Optional[str] = None) -> TrialResult:
    """THE trial loop of the single-card ``Trainer`` and the data-parallel
    ``DistributedTrainer``: epochs, periodic validation, best-snapshot
    tracking, checkpoints, the ``RESUME=1`` restart and the final test
    scored from the best snapshot, batchwise or layerwise
    (``final_test_mode``). ``train_epoch`` returns the epoch's mean loss
    or a dict holding it under ``"loss"``.

    With ``checkpoint_dir``: each new best validation accuracy saves the
    train state there (``use_async=cfg.async_checkpoint``), and with
    ``RESUME=1`` the trial restores its latest checkpoint and starts at the
    epoch after it. As in the JAX package, the best accuracy and the
    plateau scheduler start afresh in a resumed run.

    With a group of several ranks (a trainer with ``world`` > 1) every
    rank runs this loop: the resume epoch is the least over the ranks
    (-1 for none), so all run the same epochs; rank 0 writes each
    checkpoint and its metadata line, then every rank meets at a barrier.
    Validation accuracy and the loss are the group's, so every rank takes
    the same decisions."""
    cfg = trainer.cfg
    multi = getattr(trainer, "world", 1) > 1
    writer = getattr(trainer, "rank", 0) == 0
    trainer._trial_reset(trial)
    res = TrialResult()
    best_state = None
    scheduler = (ReduceLROnPlateau(cfg.lrs_factor, cfg.effective_patience)
                 if cfg.use_lrs else None)
    start_epoch = 0
    if checkpoint_dir and os.environ.get("RESUME", "0") == "1":
        resume = ckpt.latest_epoch(checkpoint_dir, trial)
        if multi:
            local = -1 if resume is None else resume
            agreed = trainer._agree_min(local)
            if agreed != local:
                trainer.logger.log("resume_mismatch", trial, local, agreed)
            resume = agreed if agreed >= 0 else None
        if resume is not None:
            trainer.state = ckpt.restore(checkpoint_dir, trainer.state,
                                         trial, resume)
            start_epoch = resume + 1
            trainer.logger.log("resumed", trial, resume)
    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.perf_counter()
        loss = trainer.train_epoch(epoch)
        if isinstance(loss, dict):
            loss = loss["loss"]
        dt = time.perf_counter() - t0
        trainer.state.epoch = epoch + 1
        trainer.logger.log("epoch_time", trial, epoch, round(dt, 3))
        res.epoch_times.append(dt)
        res.losses.append(loss)
        if scheduler is not None:
            trainer.state = scheduler.step(trainer.state, loss)
        if (epoch + 1) % cfg.test_epoch_frequency == 0:
            acc = trainer.evaluate("valid")
            trainer.logger.log("valid_acc", trial, epoch, acc)
            if acc > res.best_valid_acc:
                res.best_valid_acc = acc
                res.best_epoch = epoch
                best_state = {k: v.detach().clone() for k, v in
                              trainer.state.model.state_dict().items()}
                if checkpoint_dir and writer:
                    ckpt.save(checkpoint_dir, trainer.state, trial=trial,
                              epoch=epoch, acc=acc,
                              use_async=cfg.async_checkpoint)
                if checkpoint_dir and multi:
                    trainer._barrier()
    if cfg.async_checkpoint:
        ckpt.wait_for_async_saves()
    if best_state is not None:
        # score the best-validation model, not the last epoch
        trainer.state.model.load_state_dict(best_state)
    if cfg.final_test_mode == "layerwise":
        accs = trainer.evaluate_layerwise(("valid", "test"))
        res.final_valid_acc = accs["valid"]
        res.final_test_acc = accs["test"]
    else:
        res.final_valid_acc = trainer.evaluate("valid")
        res.final_test_acc = trainer.evaluate("test")
    trainer.logger.log("trial_result", trial, res.best_epoch,
                       res.final_valid_acc, res.final_test_acc)
    return res
