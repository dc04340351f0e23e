"""Single-card training driver: epoch loop, eval, best-model tracking
(counterpart of the JAX package's ``train/loop.py``).

This slice has the all-in-memory path: the whole feature table sits on
the device in bf16, and the final test is batchwise or layerwise. The host
cold tier (``hbm_fraction < 1``) and checkpoints come in later slices
(ROADMAP.md) and raise here.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import RunConfig
from ..data.dataset import GraphData, pad_feature_dim
from ..models import make_model
from ..sampling.batch import BatchSpec, mirror_all_specs
from ..sampling.cpp import BatchBuffers, NativeSampler
from ..sampling.sampler import FastSampler, FastSamplerConfig
from ..sampling.shufflers import Shuffler
from ..utils.device import resolve_device, synchronize
from ..utils.logging import RunLogger
from ..utils.timing import RuntimeStats
from .pipeline import DeviceFeeder
from .state import ReduceLROnPlateau, TrainState, create_train_state
from .step import eval_step, train_step


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


def _reject_unported(cfg: RunConfig) -> None:
    """Options whose feature is not in this slice raise, never fall back."""
    if cfg.hbm_fraction < 1.0:
        raise NotImplementedError(
            "hbm_fraction < 1 (host cold tier): ROADMAP.md Queue 1 item 14 "
            "(slice 3)")
    if cfg.train_sampler != "FastSampler":
        raise NotImplementedError(
            f"train_sampler={cfg.train_sampler}: only FastSampler is ported "
            "(FastPreSampler and OracleSampler: ROADMAP.md Queue 1 item 8)")
    if cfg.collect_data:
        raise NotImplementedError(
            "collect_data (DataCollector): ROADMAP.md Queue 1 item 8")
    if cfg.async_checkpoint:
        raise NotImplementedError(
            "async_checkpoint (checkpoints): ROADMAP.md Queue 1 item 8")


class Trainer:
    """Single-card trainer over one GraphData. ``device=None`` means CUDA;
    the tests pass ``device="cpu"``."""

    def __init__(self, cfg: RunConfig, graph: GraphData,
                 logger: Optional[RunLogger] = None, device=None):
        _reject_unported(cfg)
        self.cfg = cfg
        self.graph = graph
        self.logger = logger or RunLogger()
        self.stats = RuntimeStats()
        self.device = resolve_device(device)

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

        V = graph.num_nodes
        # layer 0 aggregates straight from the device table when the
        # model's first hop consumes raw features (gsrc mode): the
        # frontier gather shrinks to the level-(L-1) prefix
        self.global_msg0 = (cfg.gsrc_mode != "off" and
                            cfg.model_name in ("SAGE", "SAGEClassic", "GIN"))
        # ship uint8 per-target degrees instead of int32 dst
        self.compress_dst = all(0 < f <= 127 for f in cfg.train_fanouts)
        # wire-pack int32 index arrays when every shipped id fits 24 bits
        self.pack_wire = (cfg.pack_wire
                          and (not self.global_msg0 or V < 2**24 - 256)
                          and self.train_spec.total_node_cap < 2**24)
        self.train_sampler = FastSampler(
            self.native.rowptr, self.native.col,
            np.asarray(graph.y, np.int32),
            FastSamplerConfig(
                spec=self.train_spec, batch_size=cfg.train_batch_size,
                base_seed=cfg.seed, num_workers=cfg.num_workers,
                max_batches_in_flight=cfg.max_batches_in_flight,
                emit_gsrc=self.global_msg0,
                compress_dst=self.compress_dst,
                pack_wire=self.pack_wire,
                tight_spec=self.train_tight,
                pin_memory=self.device.type == "cuda"))
        self.shuffler = Shuffler(train_idx, initial_seed=cfg.seed + 2**31 - 1)

        # the whole table on the device, bf16; the 128-column padding keeps
        # layer 0's weight shape that of the JAX package
        x_np = pad_feature_dim(np.asarray(graph.x, np.float32))
        self.features = torch.from_numpy(
            np.ascontiguousarray(x_np)).to(torch.bfloat16).to(self.device)
        self.in_features = int(self.features.shape[1])
        self.state: Optional[TrainState] = None
        self.reset()

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

    def run_step(self, batch) -> torch.Tensor:
        """One train step on a device batch; returns the loss (device)."""
        return train_step(self.state, self.features, batch, self.global_msg0)

    def _feeder(self, it, depth: int) -> DeviceFeeder:
        return DeviceFeeder(it, self.device, depth=depth,
                            pipelined=not self.cfg.pipeline_disabled)

    def train_epoch(self, epoch: int) -> float:
        cfg = self.cfg
        self.train_sampler.set_epoch(self.shuffler.get_idx(epoch), epoch)
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
        try:
            with self.stats.region("train_epoch",
                                   sync=lambda: synchronize(self.device)):
                for batch in feeder:
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
        it = iter(sampler)
        correct, total = [], []
        for batch in DeviceFeeder(it, self.device, depth=2):
            c, t = eval_step(self.state, self.features, batch,
                             self.global_msg0)
            correct.append(c)
            total.append(t)
        if not correct:
            return 0.0
        acc = (torch.stack(correct).sum().item()
               / max(torch.stack(total).sum().item(), 1))
        if it.stats.dropped_nodes or it.stats.dropped_edges:
            fanouts = (self.cfg.final_test_fanouts if split == "test"
                       else self.cfg.batchwise_test_fanouts)
            key = (split, tuple(fanouts))
            self.logger.log("EVAL_SAMPLER_OVERFLOW", split,
                            it.stats.dropped_nodes, it.stats.dropped_edges)
            spec, tight = self.eval_specs[key]
            self.eval_specs[key] = (spec.grown(), tight)
            self.logger.log("EVAL_SPEC_GROWN", split)
        return acc

    def evaluate_layerwise(self, splits=("valid", "test")):
        """Exact full-graph accuracy via layerwise inference
        (models/inference.py): one pass computes every node's
        representation, so all splits score from the same embeddings. A
        model the JAX package does not serve layerwise (ARMA) is scored
        batchwise instead, as there."""
        from ..models.inference import UNSERVED, layerwise_inference

        name = self.cfg.model_name
        if name in UNSERVED:
            self.logger.log("LAYERWISE_UNSUPPORTED_FALLBACK", name)
            return {s: self.evaluate(s) for s in splits}
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
        return out

    # --- run_trial_impl hooks -----------------------------------------
    def _trial_reset(self, trial: int):
        self.reset(trial_seed=trial)

    def run_trial(self, trial: int = 0) -> TrialResult:
        """Epoch loop with best-validation tracking."""
        return run_trial_impl(self, trial)


def run_trial_impl(trainer, trial: int = 0) -> TrialResult:
    """THE trial loop: epochs, periodic validation, best-snapshot
    tracking (in memory) and the final test scored from the best
    snapshot, batchwise or layerwise (``final_test_mode``). Checkpoint IO
    waits for ROADMAP.md Queue 1 item 8."""
    cfg = trainer.cfg
    trainer._trial_reset(trial)
    res = TrialResult()
    best_state = None
    scheduler = (ReduceLROnPlateau(cfg.lrs_factor, cfg.effective_patience)
                 if cfg.use_lrs else None)
    for epoch in range(cfg.epochs):
        t0 = time.perf_counter()
        loss = trainer.train_epoch(epoch)
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
