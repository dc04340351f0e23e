"""Benchmark: steady-state training throughput (edges/s/chip) on the card
(counterpart of the JAX package's root ``bench.py``).

    python -m salient_plusplus_tpu_torch.bench

Prints ONE JSON line on stdout, with exactly the keys of the JAX bench's
line and their meaning; progress and a summary go to stderr.

Metric: graph edges sampled + aggregated per second per chip while training
the default experiment shape (3-layer SAGE, hidden 256, batch 1024, fanout
[15,10,5] — the reference's defaults, driver/parser.py:44-86) on an
ogbn-products-scale synthetic power-law graph. Edge counts are tracked on
the host by the feeder; the loop keeps a ``BENCH_SYNC``-deep queue of
losses and waits only on the oldest (``loss.item()``), so the host never
waits on the step it just queued.

vs_baseline: ratio against 45M edges/s/GPU — the throughput implied by the
SALIENT paper's ~2s ogbn-products epochs on one V100 (arXiv 2110.08450;
products ≈ 90M sampled edges/epoch at these fanouts).

The environment variables are the JAX bench's, with its defaults:
BENCH_NUM_NODES (1e6), BENCH_MODEL (SAGE), BENCH_STEPS (60), BENCH_WARMUP
(60), BENCH_WINDOWS (3), BENCH_SYNC (2), BENCH_WORKERS (max(2, cores)),
BENCH_CAL, BENCH_SAFETY, BENCH_BUCKETS (RunConfig's), BENCH_HBM_FRACTION
(1.0), BENCH_COLD_FP8, BENCH_COLD_CACHE (0, a slot count, a fraction of
the cold tail, or "auto"), BENCH_H2D_CREDIT, BENCH_COLD_FOLD, BENCH_GSRC
(auto), BENCH_PREFLIGHT, BENCH_PROBE_PRE, BENCH_GATHER_NS,
BENCH_MICROSTEP, BENCH_DEGRADED_FRAC (0.25).

Where it differs from the JAX bench on purpose: one campaign, with no
rest and retry on a degraded verdict (``campaign_attempts`` is always 1);
the link's H2D rate is measured once, with no rest below a threshold;
there is no first-contact watchdog. The gather probe times K3
(``ops/pallas_gather.py``, the kernel the step gathers with) alone, on
index sets made before the timing, by CUDA events around launches queued
behind a hold of the stream, takes the fastest of three runs at each
chain length, and raises where its slope is not physical, with no
constant to fall back to; a failed probe or microstep ends the run;
there is no re-exec onto the non-gsrc program (``gsrc_fallback_windows``
is always null). The chip state thresholds are the JAX bench's, set on a
TPU: a host-bound step on the card reads ``"degraded"``.

``main(device=None)`` runs on CUDA and raises without a card; the tests
pass ``device="cpu"``.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import time

import numpy as np
import torch

from .utils.device import resolve_device, synchronize

BASELINE_EDGES_PER_S = 45e6
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA data sheet
GATHER_NS_CEILING = 1000.0  # a per-row slope above this is not a gather
PROBE_CHAINS = (3, 11)      # the gather probe's two chain lengths
PROBE_REPEATS = 3           # timed runs of each length (the fastest counts)
PROBE_LAUNCHES = (1 + PROBE_REPEATS) * sum(PROBE_CHAINS)   # K3, a probe
# the probe holds the stream this many GPU cycles (~35 ms) while the host
# queues a run's launches, so no host gap falls between its events
PROBE_HOLD_CYCLES = 1 << 26

# "exact": the row model IS this arch's aggregation structure;
# "approx": documented estimate (gather_rows_per_step)
ROOFLINE_MODELS = {"SAGE": "exact", "SAGEClassic": "exact",
                   "GIN": "exact", "SAGEResInception": "exact",
                   "JKNet": "exact", "GAT": "approx", "GCN": "exact",
                   "GATSkip": "approx"}


def chip_state_verdict(frac, h2d_need_mbs, h2d_burst_mbs,
                       degraded_frac=0.25, link_slack=0.5):
    """Campaign-level chip-state verdict. Given the campaign's best-window
    fraction of the live roofline and its H2D demand vs the link's
    measured burst rate:

    - frac >= degraded_frac            -> "healthy"
    - low frac, demand near/above link -> "link-throttled" (the windows
      measured the link; resting the card won't change it)
    - low frac, demand << link rate    -> "degraded" (not H2D: a slow
      card, or a step bound elsewhere, e.g. by the host)

    The thresholds are the JAX bench's. Callers only reach this with a
    MEASURED gather probe and a measured link; otherwise the state stays
    "unknown"."""
    if frac >= degraded_frac:
        return "healthy"
    if h2d_need_mbs >= link_slack * h2d_burst_mbs:
        return "link-throttled"
    return "degraded"


def _h2d_preflight(device):
    """Pre-flight: the host→device rate (MB/s) with fresh pinned buffers
    (``train/cold_policy.py::measure_h2d_credit``, the best of three
    bursts), measured once. None on a CPU device (no link)."""
    from .train.cold_policy import measure_h2d_credit

    rate = measure_h2d_credit(device)
    if rate is not None:
        print(f"h2d_preflight: {rate:.0f} MB/s", file=sys.stderr)
    return rate


def gather_rows_per_step(spec, model_name, global_msg0):
    """Rows gathered per step (unsorted gathers + scatter-equivalents) at
    the CAPACITY shapes of ``spec`` — the JAX bench's row model
    (bench.py:323-343):

    - gsrc mode: prefix(node_caps[L-1]) + outer-hop msgs(edge_caps[-1])
      + 2x inner-hop msgs (fwd + bwd mirrors);
    - frontier mode: full frontier + all fwd msgs + inner bwd mirrors;
    - GAT (approx): N + 4E per the autodiff attention path (msg gather +
      two thin logit gathers fwd, ~one gather + the d_xs scatter bwd);
      GATSkip (approx) as GAT;
    - GCN: frontier gather (N) + per hop the fwd msg gather and the bwd
      mirror gather (2E).

    Gather-only: the segment kernels add on top, so the ceiling derived
    from it is an upper bound on edges/s."""
    L = spec.num_hops
    inner = sum(spec.edge_caps[: L - 1])
    total_e = sum(spec.edge_caps)
    if model_name in ("GAT", "GATSkip"):
        return spec.total_node_cap + 4 * total_e
    if model_name == "GCN":
        return spec.total_node_cap + 2 * total_e
    if global_msg0:
        return spec.node_caps[L - 1] + spec.edge_caps[L - 1] + 2 * inner
    return spec.total_node_cap + total_e + inner


def _measure_gather_ns(table, rows=262_144):
    """Per-row cost of an unsorted row gather through K3
    (``pallas_gather_rows``, a CUDA tensor launches the kernel), measured
    live against the bench's own feature table. Chains of PROBE_CHAINS
    lengths gather independent random index sets, all made before any
    timing, so a chain times K3's launches and nothing else; the slope
    between the two lengths cancels the fixed cost of a run. On the card
    a run is timed by CUDA events: the stream is held while the host
    queues the launches (PROBE_HOLD_CYCLES), and a hold that ran out
    before the last launch was queued raises, since the events would then
    take in host time. Each length runs once untimed to warm up, then
    PROBE_REPEATS times, and its fastest run is taken: PROBE_LAUNCHES
    launches in all. Returns (ns_per_row, source), source "measured" or
    "env" (BENCH_GATHER_NS overrides).

    Raises on a slope that is not physical: not positive, or on the card
    below the HBM bound of the probe's own bytes (each row read once and
    written once) or above GATHER_NS_CEILING."""
    from .ops.pallas_gather import pallas_gather_rows

    env = os.environ.get("BENCH_GATHER_NS")
    if env:
        return float(env), "env"
    V = table.shape[0]
    # probing a tiny table with many repeated indices is cache-friendly and
    # under-reports ns/row; keep the probe no larger than the table so the
    # number is comparable across BENCH_NUM_NODES settings
    rows = min(rows, V)
    n1, n2 = PROBE_CHAINS
    ix = torch.from_numpy(np.random.default_rng(11).integers(
        0, V, (n2, rows), dtype=np.int32)).to(table.device)
    cuda = table.device.type == "cuda"

    # first-use library load and allocator warm-up, untimed
    for n in (n1, n2):
        for i in range(n):
            pallas_gather_rows(table, ix[i])
    synchronize(table.device)

    def run(n):
        """Seconds for ``n`` back-to-back gathers (device time on the
        card)."""
        synchronize(table.device)
        if not cuda:
            t0 = time.perf_counter()
            for i in range(n):
                pallas_gather_rows(table, ix[i])
            return time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(PROBE_HOLD_CYCLES)
        start.record()
        for i in range(n):
            pallas_gather_rows(table, ix[i])
        end.record()
        if start.query():
            raise RuntimeError(
                f"gather probe: the host took longer than the stream's "
                f"hold of {PROBE_HOLD_CYCLES} cycles to queue {n} launches")
        end.synchronize()
        return start.elapsed_time(end) * 1e-3

    t1 = min(run(n1) for _ in range(PROBE_REPEATS))
    t2 = min(run(n2) for _ in range(PROBE_REPEATS))
    ns = (t2 - t1) / (n2 - n1) / rows * 1e9
    if cuda:
        floor = 2 * table.shape[1] * table.element_size() / HBM_BYTES_PER_S
        if not floor * 1e9 <= ns <= GATHER_NS_CEILING:
            raise RuntimeError(
                f"gather probe slope {ns:.4f} ns/row is outside "
                f"[{floor * 1e9:.4f}, {GATHER_NS_CEILING}]: below the HBM "
                f"bound of its bytes or not a gather")
    elif not ns > 0:
        raise RuntimeError(f"gather probe slope {ns:.4f} ns/row is not "
                           f"positive")
    return ns, "measured"


def _cycle_unique(idx, need, batch_size=1024):
    """Repeat the seed pool while keeping every batch window duplicate-free:
    each repetition is a fresh permutation truncated to a whole number of
    batches, so no batch spans two repetitions."""
    rng = np.random.default_rng(123)
    m = (len(idx) // batch_size) * batch_size
    outs = [idx[:m]]
    total = m
    while total < need:
        outs.append(idx[rng.permutation(len(idx))][:m])
        total += m
    return np.concatenate(outs)[:(need // batch_size) * batch_size]


def _env_config(num_nodes: int, hbm_fraction: float):
    """The bench's RunConfig from its BENCH_* variables."""
    from .config import RunConfig

    cold_fp8 = os.environ.get("BENCH_COLD_FP8", "0") == "1"
    # device cold-row cache slots (0 = off): an absolute slot count, a
    # fraction of the cold tail (e.g. "0.5"), or "auto" — the H2D-credit
    # policy (train/cold_policy.py) sizes it from the measured link
    # (BENCH_H2D_CREDIT stands in for the measurement)
    cc_raw = os.environ.get("BENCH_COLD_CACHE", "0")
    if cc_raw == "auto":
        cold_cache_slots = -1
    else:
        cc_env = float(cc_raw)
        cold_cache_slots = (int(cc_env * num_nodes * (1 - hbm_fraction))
                            if 0 < cc_env < 1 else int(cc_env))
    h2d_credit_env = os.environ.get("BENCH_H2D_CREDIT")
    return RunConfig(
        train_batch_size=1024, train_fanouts=[15, 10, 5],
        hidden_features=256, num_layers=3, lr=0.003,
        model_name=os.environ.get("BENCH_MODEL", "SAGE"),
        # the feeder thread mostly waits on dispatch, so cpu_count
        # sampler threads (the JAX bench's choice)
        num_workers=int(os.environ.get("BENCH_WORKERS",
                                       max(2, os.cpu_count() or 4))),
        max_batches_in_flight=8,
        calibration_batches=int(os.environ.get(
            "BENCH_CAL", RunConfig.calibration_batches)),
        spec_safety=float(os.environ.get("BENCH_SAFETY",
                                         RunConfig.spec_safety)),
        spec_buckets=int(os.environ.get("BENCH_BUCKETS",
                                        RunConfig.spec_buckets)),
        hbm_fraction=hbm_fraction,
        gsrc_mode=os.environ.get("BENCH_GSRC", "auto"),
        cold_fp8=cold_fp8,
        cold_cache_slots=cold_cache_slots,
        h2d_credit_mbs=float(h2d_credit_env) if h2d_credit_env else None,
        cold_fold_update=os.environ.get("BENCH_COLD_FOLD", "0") == "1",
    )


def _padded_batch(trainer, spec, seeds, rng_seed):
    """One production-shaped batch of ``spec`` sampled from ``seeds``, on
    the trainer's device."""
    from .sampling.cpp import BatchBuffers

    scfg = trainer.train_sampler.cfg
    bufs = BatchBuffers(spec)
    # tight-bucket buffers take the BIG spec's caps for the wire packing,
    # as the sampler's pool buffers (always big-spec sized) do
    bufs.attach_from_config(scfg, trainer.train_sampler.num_nodes,
                            pack_node_caps=trainer.train_spec.node_caps)
    trainer.native.sample_into(bufs, seeds, rng_seed=rng_seed,
                               y_global=np.asarray(trainer.graph.y, np.int32))
    bufs.finalize_from_config(scfg)
    if scfg.cold_cache is not None:
        # cache mode assembles the cold rows on the consumer side
        bufs.finalize_cached(scfg)
    return bufs.to_padded_batch().to(trainer.device)


def main(device=None):
    from .ops import launch_counts

    dev = resolve_device(device)

    from .data import synthetic
    from .train.loop import Trainer
    from .train.pipeline import DeviceFeeder

    h2d_burst = None
    if dev.type == "cuda" and os.environ.get("BENCH_PREFLIGHT", "1") != "0":
        h2d_burst = _h2d_preflight(dev)

    num_nodes = int(os.environ.get("BENCH_NUM_NODES", 1_000_000))
    steps = int(os.environ.get("BENCH_STEPS", 60))
    warmup = int(os.environ.get("BENCH_WARMUP", 60))
    # >HBM regime: hot prefix on the card, cold tail served from host RAM
    # by the sampler threads (gpu_percent analog, base.py:107-116)
    hbm_fraction = float(os.environ.get("BENCH_HBM_FRACTION", 1.0))
    cfg = _env_config(num_nodes, hbm_fraction)
    model_name = cfg.model_name
    cold_fp8, cold_fold = cfg.cold_fp8, cfg.cold_fold_update

    g = synthetic.powerlaw_graph(
        name="bench-products", num_nodes=num_nodes, avg_degree=15,
        num_features=100, num_classes=47, seed=0)
    if hbm_fraction < 1.0:
        # the hot/cold split's precondition: the dataset is VIP-reordered
        # so the device prefix absorbs most accesses
        from .data.reorder import hot_order_graph

        g, _ = hot_order_graph(g)

    trainer = Trainer(cfg, g, device=dev)
    print(f"bench: trainer built (features resident, calibration done) "
          f"({time.strftime('%H:%M:%S')})", file=sys.stderr, flush=True)

    idx = trainer.shuffler.get_idx(0)
    n_win = int(os.environ.get("BENCH_WINDOWS", 3))
    need = (steps * n_win + warmup + 6) * cfg.train_batch_size
    train_steps_run = 0

    # run BOTH bucket programs once (a 96%-tight stream may not show a
    # big-bucket batch until after warmup): the kernels' first-use build
    # and the allocator's growth must not land inside a window
    for spec in filter(None, [trainer.train_spec, trainer.train_tight]):
        warm = _padded_batch(trainer, spec, np.sort(idx[: spec.seed_cap]), 1)
        trainer.run_step(warm).item()
        train_steps_run += 1

    print(f"bench: warmup programs executed "
          f"({time.strftime('%H:%M:%S')})", file=sys.stderr, flush=True)
    # gather-roofline probe #1 — BEFORE the windows, on the freshest card
    # state; the ceiling is the card's BEST per-row cost, so probe both
    # sides and take the min
    if os.environ.get("BENCH_PROBE_PRE", "1") != "0":
        gather_pre, gather_pre_src = _measure_gather_ns(trainer.features)
    else:
        gather_pre, gather_pre_src = float("inf"), "skipped"
    print(f"bench: gather probe(pre) {gather_pre:.3f} ns/row; starting "
          f"{warmup} warmup + {n_win}x{steps} window steps",
          file=sys.stderr, flush=True)
    sync_win = int(os.environ.get("BENCH_SYNC", 2))

    def run_campaign(warmup_steps):
        """The measurement campaign: warmup + n_win windows of `steps`
        steps off a fresh feeder."""
        trainer.train_sampler.set_epoch(
            _cycle_unique(idx, need, cfg.train_batch_size), 0)
        it = iter(trainer.train_sampler)
        feeder = DeviceFeeder(it, trainer.device, depth=4)
        n = 0
        windows = []
        t0 = None
        e_mark = 0
        sync_q = collections.deque()
        for batch in feeder:
            if n >= warmup_steps and (n - warmup_steps) % steps == 0:
                synchronize(dev)
                now = time.perf_counter()
                if t0 is not None:
                    windows.append(
                        (feeder.edges_fed - e_mark) / (now - t0))
                    print(f"bench: window {len(windows)} "
                          f"{windows[-1] / 1e6:.1f}M e/s "
                          f"({time.strftime('%H:%M:%S')})",
                          file=sys.stderr, flush=True)
                t0 = now
                e_mark = feeder.edges_fed
            sync_q.append(trainer.run_step(batch))
            if len(sync_q) > sync_win:
                sync_q.popleft().item()
            n += 1
            if n >= warmup_steps + steps * n_win:
                break
        synchronize(dev)
        windows.append(
            (feeder.edges_fed - e_mark) / (time.perf_counter() - t0))
        it.close()
        return {
            "windows": windows,
            "steps": n,
            "stats": it.stats,
            "edges_per_batch": feeder.edges_fed / max(n, 1),
            "bytes_per_batch": feeder.bytes_fed / max(n, 1),
            "starved_dur": feeder.starved_dur,
            "starved_occasions": feeder.starved_occasions,
        }

    degraded_frac = float(os.environ.get("BENCH_DEGRADED_FRAC", 0.25))

    def step_rows(tight_frac):
        """Rows a step gathers, weighted by the campaign's tight share."""
        rows = gather_rows_per_step(trainer.train_spec, model_name,
                                    trainer.global_msg0)
        if trainer.train_tight is not None:
            rows = (tight_frac * gather_rows_per_step(
                trainer.train_tight, model_name, trainer.global_msg0)
                + (1 - tight_frac) * rows)
        return rows

    def tight_share(stats):
        return stats.tight_batches / max(stats.batches, 1)

    spec = trainer.train_spec
    # one campaign: on the card a low roofline_frac is the host-bound
    # step's, and a rest does not change it
    camp = run_campaign(warmup)
    train_steps_run += camp["steps"]
    windows = camp["windows"]
    eps = max(windows)

    # the verdict from the campaign's best window against the roofline at
    # the pre-window probe, given a measured probe and a measured link
    chip_state = "unknown"
    if ROOFLINE_MODELS.get(model_name) is not None \
            and gather_pre_src == "measured" and h2d_burst is not None:
        roof = camp["edges_per_batch"] / (
            step_rows(tight_share(camp["stats"])) * gather_pre * 1e-9)
        h2d_need = eps / max(camp["edges_per_batch"], 1) \
            * camp["bytes_per_batch"] / 1e6
        chip_state = chip_state_verdict(eps / roof, h2d_need, h2d_burst,
                                        degraded_frac)

    it_stats = camp["stats"]
    tight_frac = tight_share(it_stats)
    n_batches = max(it_stats.batches, 1)
    edges_per_batch = camp["edges_per_batch"]
    bytes_per_batch = camp["bytes_per_batch"]

    rows_step = step_rows(tight_frac)
    gather_post, gather_post_src = _measure_gather_ns(trainer.features)
    # ceiling = fastest MEASURED per-row cost (pre-load vs post-load card
    # state); an "env" override wins outright. The post probe always
    # measures or raises, so a measured side always exists.
    cands = [(gather_pre, gather_pre_src), (gather_post, gather_post_src)]
    if any(s == "env" for _, s in cands):
        gather_ns, gather_src = gather_post, "env"
    else:
        gather_ns, gather_src = min((v, s) for v, s in cands
                                    if s == "measured")
    t_floor = rows_step * gather_ns * 1e-9
    roofline_kind = ROOFLINE_MODELS.get(model_name)
    roofline_eps = (edges_per_batch / t_floor
                    if roofline_kind is not None else None)
    # the H2D rate each window needed, against the link's measured rate
    h2d_required = [w / max(edges_per_batch, 1) * bytes_per_batch / 1e6
                    for w in windows]

    # Same-process back-to-back micro-timing cross-check: M chained steps
    # on ONE device-resident batch (serialised through the in-place train
    # state), timed at two chain lengths with the slope taken. No feeder
    # or H2D in the loop: micro-vs-window disagreement isolates feed/link
    # trouble from a slow step.
    micro_ms = micro_eps = None
    if os.environ.get("BENCH_MICROSTEP", "1") != "0":
        mb = _padded_batch(trainer, trainer.train_spec,
                           np.sort(idx[: trainer.train_spec.seed_cap]), 2)
        micro_edges = mb.num_real_edges()

        def chain(m):
            t0 = time.perf_counter()
            for _ in range(m):
                trainer.run_step(mb)
            synchronize(dev)
            return time.perf_counter() - t0

        chain(2)  # re-warm the execution path
        m1, m2 = 3, 9
        micro_ms = max((chain(m2) - chain(m1)) / (m2 - m1), 1e-6) * 1e3
        micro_eps = micro_edges / (micro_ms * 1e-3)
        train_steps_run += 2 + m1 + m2
        print(f"bench: microstep {micro_ms:.2f} ms/step "
              f"({micro_eps / 1e6:.1f}M e/s equivalent)",
              file=sys.stderr, flush=True)

    probe_launches = PROBE_LAUNCHES * [
        gather_pre_src, gather_post_src].count("measured")
    print(f"bench: kernel launches {json.dumps(launch_counts())} in "
          f"{train_steps_run} train steps and {probe_launches} probe "
          f"gathers", file=sys.stderr, flush=True)
    print(f"windows(M/s)={[round(w / 1e6, 2) for w in windows]} "
          f"chip_state={chip_state} attempts=1 "
          f"feeder_starved={camp['starved_dur']:.2f}s/"
          f"{camp['starved_occasions']} "
          f"sampler_blocked={it_stats.total_blocked_dur:.2f}s "
          f"sample_time={it_stats.sample_time:.1f}s "
          f"bytes/batch={bytes_per_batch / 1e6:.2f}MB "
          f"gather={gather_ns:.3f}ns/row({gather_src}) "
          f"roofline="
          f"{roofline_eps / 1e6 if roofline_eps is not None else -1:.1f}"
          f"M e/s "
          f"pad_waste_nodes={it_stats.node_waste(spec.total_node_cap):.3f} "
          f"pad_waste_edges={it_stats.edge_waste(sum(spec.edge_caps)):.3f} "
          f"tight_frac={tight_frac:.3f}",
          file=sys.stderr)
    print(json.dumps({
        "metric": "train_edges_per_s_per_chip",
        "model": model_name,
        "value": round(eps, 1),
        "unit": "edges/s",
        "vs_baseline": round(eps / BASELINE_EDGES_PER_S, 4),
        # window-by-window evidence
        "windows_edges_per_s": [round(w, 1) for w in windows],
        "window_min": round(min(windows), 1),
        "window_median": round(float(np.median(windows)), 1),
        "vs_baseline_min": round(min(windows) / BASELINE_EDGES_PER_S, 4),
        # campaign-level verdict from the roofline + probe + h2d evidence
        # ("unknown" without a measured probe and link, e.g. on the CPU)
        "chip_state": chip_state,
        # the formulation the windows ran: the port never switches it
        "gsrc_mode": os.environ.get("BENCH_GSRC", "auto"),
        "gsrc_fallback_windows": None,
        # microstep cross-check: agreement with the windows means the step
        # itself is that slow; a far faster microstep means feed/link
        "chip_state_note": (
            ("microstep agrees with windows — the step itself is slow "
             "(program-bound or roofline-model gap), not a feed/link "
             "artifact" if micro_eps < 2 * eps else
             "microstep far faster than windows — the windows were "
             "feed/link-limited, the step is healthy")
            if micro_eps is not None and chip_state == "degraded"
            else None),
        "campaign_attempts": 1,
        "windows_all_attempts": [[round(w, 1) for w in windows]],
        # back-to-back same-process step timing (no feeder/H2D in loop)
        "microstep_ms": (round(micro_ms, 3)
                         if micro_ms is not None else None),
        "microstep_edges_per_s": (round(micro_eps, 1)
                                  if micro_eps is not None else None),
        # fraction of the gather-bound ceiling at the live-measured
        # per-row gather cost
        "roofline_edges_per_s":
            round(roofline_eps, 1) if roofline_eps is not None else None,
        "roofline_frac":
            round(eps / roofline_eps, 4)
            if roofline_eps is not None else None,
        # frac > 1 cannot happen against a correct ceiling: the probe saw
        # a different card state than the windows ran under
        "roofline_note": (
            "frac>1: probe and windows saw different chip states "
            f"(pre {gather_pre if np.isfinite(gather_pre) else None} / "
            f"post {round(gather_post, 2)} ns/row); windows effectively "
            "gathered faster than the probed ceiling"
            if roofline_eps is not None and eps / roofline_eps > 1.0
            else None),
        "gather_ns_per_row": round(gather_ns, 2),
        "gather_ns_source": gather_src,
        # both probe sides (pre = fresh card, post = after the windows)
        "gather_ns_pre": (round(gather_pre, 2)
                          if np.isfinite(gather_pre) else None),
        "gather_ns_post": round(gather_post, 2),
        "roofline_kind": roofline_kind,
        "gather_rows_per_step": int(rows_step),
        # the H2D rate each window needed
        "h2d_required_mb_per_s": [round(r, 1) for r in h2d_required],
        # the link's rate measured at bench start (pinned, best of three)
        "h2d_burst_mb_per_s":
            round(h2d_burst, 1) if h2d_burst is not None else None,
        "bytes_per_batch": int(bytes_per_batch),
        "hbm_fraction": hbm_fraction,
        # host-tier stats: rows served from host RAM per batch
        "cold_rows_per_batch": round(
            it_stats.cold_rows / n_batches, 1),
        # static cold-buffer share of the H2D wire; None with the cache on
        # (its miss buffers are bucketed: bytes_per_batch is the truth)
        "cold_bytes_share": (round(
            trainer.train_sampler.cfg.cold_cap
            * ((trainer.features.shape[1] + 4) if cold_fp8
               else 2 * trainer.features.shape[1])
            / max(bytes_per_batch, 1), 4)
            if trainer._cold_cache is None else None),
        "cold_fp8": cold_fp8,
        # device cold-row cache: with slots > 0, cold_rows_per_batch counts
        # only MISS rows; hbm_table_rows is hot prefix + cache slack
        "cold_cache_slots": (trainer._cold_cache.slots
                             if trainer._cold_cache is not None else 0),
        # H2D-credit policy decision trail (BENCH_COLD_CACHE=auto)
        "cold_cache_plan": (
            {"slots": trainer.cold_plan.slots,
             "projected_demand_mbs": trainer.cold_plan.projected_demand_mbs,
             "residual_demand_mbs": trainer.cold_plan.residual_demand_mbs,
             "credit_mbs": round(trainer.cold_plan.credit_mbs, 1),
             "reason": trainer.cold_plan.reason}
            if trainer.cold_plan is not None else None),
        "cold_fold_update": cold_fold,
        "cold_cache_hit_rate": (round(
            trainer._cold_cache.hits
            / max(trainer._cold_cache.hits + trainer._cold_cache.misses, 1),
            4) if trainer._cold_cache is not None else None),
        "hbm_table_rows": int(trainer.features.shape[0]),
        "pad_waste_nodes": round(it_stats.node_waste(spec.total_node_cap), 4),
        "pad_waste_edges": round(it_stats.edge_waste(sum(spec.edge_caps)), 4),
        "tight_frac": round(tight_frac, 4),
    }), flush=True)


if __name__ == "__main__":
    main()
