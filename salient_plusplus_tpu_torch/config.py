"""Typed run configuration (the JAX package's ``config.py``, carried over).

Every field, default and ``__post_init__`` check is the same as in
``salient_plusplus_tpu/config.py``, so one config file drives both
packages. Fields whose feature this port does not have yet are rejected
where they are used (driver.py, train/loop.py), never ignored.

Single typed config replacing the reference's three-tier flag system
(driver/parser.py ~45 argparse flags + utils/exp_driver.py hard-coded modes +
configure_for_environment.py). Field names and defaults preserve the
semantics of the reference's knobs (file:line cites inline). Supports
file-based overrides (the reference's ``LoadFromFile`` @file support,
driver/parser.py:4-12) via ``RunConfig.from_file`` / ``from_args``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class RunConfig:
    # --- dataset / paths ---
    dataset_name: str = "synth-arxiv"
    dataset_root: str = "datasets"
    output_root: str = "job_output"
    job_name: str = "job"

    # --- batch shape (driver/parser.py:44-61) ---
    train_batch_size: int = 1024
    test_batch_size: int = 4096
    final_test_batch_size: int = 4096
    train_fanouts: List[int] = field(default_factory=lambda: [15, 10, 5])
    batchwise_test_fanouts: List[int] = field(default_factory=lambda: [20, 20, 20])
    final_test_fanouts: List[int] = field(default_factory=lambda: [20, 20, 20])

    # --- model (driver/parser.py:62-75) ---
    model_name: str = "SAGE"
    hidden_features: int = 256
    num_layers: int = 3
    lr: float = 0.003
    dropout: float = 0.5
    # ReduceLROnPlateau parity (--use_lrs, driver/drivers/base.py:300-306:
    # factor 0.8; stepped with the cross-rank-averaged epoch loss)
    use_lrs: bool = False
    lrs_factor: float = 0.8
    lrs_patience: int = 1000  # reference default (driver/parser.py:76)

    # --- run shape (driver/parser.py:76-103) ---
    epochs: int = 25
    trials: int = 1
    test_epoch_frequency: int = 1
    patience: Optional[int] = None    # LR-scheduler patience (parser.py:74)

    # --- host input pipeline (driver/parser.py:94-110) ---
    num_workers: int = 4              # sampler threads
    max_batches_in_flight: int = 8    # bounded queue depth (train_max_num_batches)
    pipeline_disabled: bool = False   # --pipeline_disabled ablation
    train_sampler: str = "FastSampler"  # FastSampler | FastPreSampler

    # --- determinism (driver/main.py:276-284) ---
    make_deterministic: bool = False
    seed: int = 0

    # --- distribution (driver/parser.py:111-208) ---
    distribute_data: bool = False
    load_balance_scheme: str = "federated"   # fully_random | federated
    execution_mode: str = "computation"      # computation | communication_simulation
    computation_mode: str = "frequency_cache"  # normal | frequency_cache
    cache_strategy: str = "vip"              # vip | simulation | degree
    cache_size: float = 0.1                  # replication budget, fraction of V/k
    cache_creation_epochs: int = 2
    hbm_fraction: float = 1.0                # gpu_percent analog (base.py:107-116)
    # distributed cold tier: "owner" = each host stores only its own
    # partitions' cold tails, rows fetched via a pre-step all_to_all
    # (O(V/k) RAM/host; reference N7 parity); "replicated" = every host
    # keeps all cold tails (zero mid-step cost, O(V·(1−f)) RAM/host)
    cold_mode: str = "owner"

    # --- static-shape bucketing (TPU-specific; no reference analog) ---
    spec_safety: float = 1.3          # capacity head-room over calibrated max
    calibration_batches: int = 20     # probes are cheap; more probes →
    #                                   tighter caps AND a better-fitting
    #                                   tight bucket (quantile of probes)
    calibrate_worst_case: bool = True  # include a top-degree probe batch
    # static-shape padding recovery: with 2 buckets, batches that fit a
    # quantile-calibrated TIGHT spec ship as zero-copy prefix views of it
    # (one extra XLA program; typical batches stop paying the worst-case
    # row padding).
    # Measured on the bench shape (_scratch/quantile_sweep.py): at the
    # production caps (safety 1.3 + worst-case probe) padding waste drops
    # 45-50% → 4.5-5.6% with 96% of batches in the tight bucket.
    spec_buckets: int = 2
    tight_quantile: float = 1.0       # probe quantile for the tight bucket
    #   (1.0 = max over the random probes, no safety margin — dominates
    #    lower quantiles: higher fit rate outweighs slightly looser caps)
    # wire-pack int32 index arrays to 2-3 bytes/element on the host→device
    # path (sampling/batch.py EdgeBlock packed fields); auto-disabled when
    # shipped ids can reach 2^24 (e.g. gsrc mode on >16M-node graphs)
    pack_wire: bool = True
    # layer-0 global-table aggregation (gsrc): "auto" enables it for
    # models whose first hop consumes raw features (SAGE/SAGEClassic/GIN)
    # on the single-host path — including hbm_fraction<1, where cold rows
    # live in a slack region of the device table (round-3 review item #2;
    # ~19-23% fewer gathered rows per step). "off" forces the fallback
    # frontier-gather path (the bit-equality cross-check target).
    gsrc_mode: str = "auto"

    # --- final inference (driver/main.py:220-245) ---
    # "batchwise" = sampled eval at final_test_fanouts (the reference's
    # only live path, base.py:430-432 asserts layerwise out);
    # "layerwise" = exact full-graph layer-at-a-time inference
    # (models/inference.py; needs hbm_fraction=1, else falls back)
    final_test_mode: str = "batchwise"
    inference_chunk: int = 4096       # seeds per layerwise chunk

    # --- precision ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # compress the feature-exchange response rows to fp8 (e4m3, per-row
    # dynamic-range scale) on the wire: halves the dominant distributed
    # payload vs bf16 (the reference ships fp16, transferers.py:507-531)
    # at ≤2^-3 relative feature error; local/cached/cold rows stay exact.
    # DEFAULT ON per the accuracy study (docs/fp8_study.json +
    # experiments/fp8_study.py): on the non-saturating tracking task with
    # NO cache and fully_random balancing — every remote row quantized —
    # the validation curves match bf16 within seed-to-seed noise
    # (max gap 0.0039 vs noise 0.0135). WIRE_BYTES logs the receipt.
    wire_fp8: bool = True
    # device cold-row cache (host cold tier, gsrc models): number of
    # feature-table slack rows kept as a persistent cache of cold rows.
    # Only MISS rows then ship host→device per batch (consecutive batches
    # re-fetch overlapping cold rows). 0 disables (per-batch slack, no
    # reuse). Requires the FastSampler train path (slot assignment runs
    # at consumption time).
    # -1 = AUTO: size from the measured host→device credit at trainer
    # build time (train/cold_policy.py: enable only when the projected
    # no-cache demand exceeds the link credit; 0 slots where the link
    # keeps up).
    cold_cache_slots: int = 0
    # AUTO policy inputs: the measured link credit (None = probe it live
    # at trainer build, train/cold_policy.measure_h2d_credit) and the
    # assumed device-bound rate used to project the demand (default: the
    # JAX package's 45M edges/s anchor; no rate of this port)
    h2d_credit_mbs: Optional[float] = None
    assumed_chip_rate_eps: float = 45e6
    # fold the cache's slack write into the train step: every batch ships
    # the full cold_cap miss buffer (no rung ladder), so more bytes ride
    # the link per batch at a hit rate above zero, for one fewer
    # per-batch update
    cold_fold_update: bool = False
    # fp8 (e4m3) host cold tier: the tail is encoded once on the host
    # (uint8 payload + per-row f32 scale) and decoded on the device:
    # about half the cold rows' host→device bytes of bf16, at the same
    # ≤2^-3 relative error as wire_fp8; also halves host RAM for the tail
    cold_fp8: bool = False

    # --- observability (§5.1 parity: NVTX/CUDA-events → jax.profiler) ---
    profile_dir: Optional[str] = None   # write a profiler trace of epoch 1
    performance_stats: bool = True      # region stats reporting
    collect_data: bool = False          # DataCollector npz dumps
    verbose: bool = False               # mirror log events to stdout
    # Orbax async checkpointing: save() returns once the state is staged
    # to host and the IO overlaps the next epoch (§5.4; the runner waits
    # for in-flight saves before exit)
    async_checkpoint: bool = False

    def __post_init__(self):
        # fail-fast enum validation: a typo'd mode string must die at
        # config construction, not after a full training run (it used to
        # be checked only at the end of run_trial)
        checks = {
            "final_test_mode": ("batchwise", "layerwise"),
            "execution_mode": ("computation", "communication_simulation"),
            "computation_mode": ("normal", "frequency_cache"),
            "load_balance_scheme": ("fully_random", "federated"),
            "cold_mode": ("owner", "replicated"),
            "train_sampler": ("FastSampler", "FastPreSampler",
                              "OracleSampler"),
            "gsrc_mode": ("auto", "off"),
        }
        for name, allowed in checks.items():
            v = getattr(self, name)
            if v not in allowed:
                raise ValueError(
                    f"{name}={v!r}: expected one of {allowed}")
        if not (0.0 < self.hbm_fraction <= 1.0):
            raise ValueError(
                f"hbm_fraction={self.hbm_fraction}: must be in (0, 1]")
        # silently-ignored combinations must die here, not run a full
        # training job with the option off (round-3 review: cold_fp8 was
        # ignored in owner mode — now implemented — and is meaningless
        # without a cold tier)
        if self.cold_fp8 and self.hbm_fraction >= 1.0:
            raise ValueError(
                "cold_fp8=True has no effect with hbm_fraction=1.0 "
                "(no host cold tier exists to encode) — set "
                "hbm_fraction<1 or drop cold_fp8")
        if self.cold_cache_slots < -1:
            raise ValueError(
                f"cold_cache_slots={self.cold_cache_slots}: expected "
                "-1 (auto), 0 (off) or a positive slot count")
        if self.cold_cache_slots > 0 or self.cold_cache_slots == -1:
            what = ("cold_cache_slots=-1 (auto)"
                    if self.cold_cache_slots == -1 else "cold_cache_slots>0")
            if self.hbm_fraction >= 1.0:
                raise ValueError(
                    f"{what} needs a cold tier (hbm_fraction<1)")
            if self.train_sampler != "FastSampler":
                raise ValueError(
                    f"{what} requires train_sampler="
                    "FastSampler (cache slot assignment runs in the "
                    "streaming consumer; the presampled/oracle paths "
                    "have no ordered consumption hook)")
            if self.gsrc_mode == "off":
                raise ValueError(
                    f"{what} requires gsrc_mode=auto (the "
                    "cache lives in the gsrc slack region)")
        if self.cold_fold_update and self.hbm_fraction >= 1.0:
            raise ValueError(
                "cold_fold_update=True has no effect without a cold "
                "tier (hbm_fraction<1)")

    @property
    def effective_patience(self) -> int:
        """LR-scheduler patience: --patience wins when given (including 0),
        else the lrs_patience default (driver/parser.py:74,76)."""
        return self.patience if self.patience is not None else self.lrs_patience

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_file(cls, path: str) -> "RunConfig":
        with open(path) as f:
            return cls(**json.load(f))

    @classmethod
    def from_args(cls, argv: Optional[List[str]] = None) -> "RunConfig":
        """CLI override of any field: --field value (lists comma-separated)."""
        import argparse

        def int_list(s: str) -> List[int]:
            return [int(v) for v in s.split(",")]

        def boolean(s: str) -> bool:
            return s.lower() in ("1", "true", "yes")

        parser = argparse.ArgumentParser(prog="salient_plusplus_tpu_torch")
        parser.add_argument("--config_file", type=str, default=None)
        for f in dataclasses.fields(cls):
            if f.type in ("List[int]", List[int]):
                parser.add_argument(f"--{f.name}", metavar="N,N,...",
                                    type=int_list)
            elif f.type in ("bool", bool):
                parser.add_argument(f"--{f.name}", type=boolean)
            elif f.type in ("Optional[int]", Optional[int]):
                parser.add_argument(f"--{f.name}", type=int)
            elif f.type in ("Optional[float]", Optional[float]):
                parser.add_argument(f"--{f.name}", type=float)
            elif f.type in ("Optional[str]", Optional[str]):
                parser.add_argument(f"--{f.name}", type=str)
            else:
                ty = {"int": int, "float": float, "str": str}.get(str(f.type), str)
                parser.add_argument(f"--{f.name}", type=ty)
        ns = parser.parse_args(argv)
        base = cls.from_file(ns.config_file) if ns.config_file else cls()
        overrides = {
            k: v for k, v in vars(ns).items()
            if k != "config_file" and v is not None
        }
        return base.replace(**overrides)
