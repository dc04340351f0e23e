#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths (salient_plusplus_tpu_torch) on the card and
fails (non-zero exit, no result line) if any phase fails. The kernels are
K1 sorted segment sum, K2 fused gather + segment sum, K3 row gather and
GAT's weighted gather + segment sum (``salient_plusplus_tpu_torch/csrc``);
every model of the zoo goes through them.

1. device: name, count, power limit; TF32 off for float32 matmuls;
2. build: the host sampler (g++) and each CUDA kernel (nvcc, sm_90a), all
   started together, with nvcc's register / shared-memory / spill report;
3. kernel vs plain, each kernel against its plain torch version at the main
   paths' shapes and at edge cases, bf16 and f32 (f32 K1/K2 results
   against the float64 sum; K3 also an integer table; K1/K2 also on
   misaligned bf16 views and, for K2, count inside a slice, 0, past E and
   below 0); K1 at the step's layer-1 backward and K2 at the hub chunk
   called three times, bit-identical; times kernel, plain version, bound
   and library yardstick, with each call's share of its bound and its
   ratio to the library time:
   K1 at every K1 call of one bench-shape train step (the mirrored hops,
   forward and backward); K2 at the step's layer 0 (global src ids into
   the 1M-row table) and K3 at its frontier prefix; K2 and K3 at a hub
   chunk and a typical chunk of layerwise inference, F = 128 and 256;
   GAT's weighted gather + segment sum (``ops/weighted_segment.py``) at a
   bench-shape GAT batch's three message sums, against the float64 sum
   and timed beside the gather, multiply and K1 it replaces, and the same
   at a GATSkip batch's (4 heads of 128, of 47 in the last layer, fanouts
   10,10,10), then one GATSkip train step's launch counts; K3's gradient
   (ARMA's differentiable gather) against the float64 sum and
   ``index_select``'s;
4. the driver CLI end to end at the default model shape (batch 1024,
   fanouts 15,10,5, hidden 256, 3 layers) on a 100k-node synthetic graph,
   batchwise and then layerwise final test (slice 2's path); the kernels'
   launch counts are read around each run; then one epoch of SAGEClassic,
   GIN, JKNet and SAGEResInception (2 layers, hidden 128, layerwise); GAT
   and GCN at the default shape with a layerwise final test; ARMA
   (batchwise) at the small shape; a checkpoint drill (2 epochs,
   ``RESUME=1`` to 3, ``--do_test_run``);
5. bench-shape training: the 1M-node power-law graph of bench.py with its
   config, step time, edges/s, padding waste, H2D bytes, starvation,
   peak memory; then 10 steps under torch.profiler for the device's busy
   and idle share and its time by kernel; then layerwise inference of that
   SAGE over the whole graph: seconds per layer, nodes/s, launches, peak
   memory, and one layer under torch.profiler; then GAT's and GCN's train
   steps at the same shape, with their profiles;
6. card against CPU: one train step from the same weights and batch
   (SAGE in bf16, GAT and GCN in f32), and layerwise inference of a
   20k-node graph at the same width;
7. the host cold tier (``hbm_fraction 0.5``) on the bench graph: K1 as the
   cold overlay of a ``--gsrc_mode off`` batch, bit-identical to the plain
   version and to the all-in-memory gather, timed beside ``index_copy_``
   and two bounds; SAGE in three variants (gsrc cold, a cold-row cache,
   the fp8 tail) with phase 5's figures beside the 1.0 run's, the link
   credit probe, the plan of ``cold_cache_slots -1``, the pinned bytes of
   the buffer pool, the fp8 decode against the CPU's, and 20 steps at 0.5
   and 1.0 with bit-identical losses; then the driver at
   ``--hbm_fraction 0.5`` (SAGE under the cache policy and with a
   layerwise final test, GCN, the cache with the folded update, fp8 with
   collect_data, FastPreSampler) and with ``--train_sampler
   OracleSampler``;
8. partitioning, VIP caching, the comm-volume simulation and the feature
   exchange: ``vip_analytical_device`` over the bench graph (4 partitions)
   against the numpy recurrence, timed, with its peak memory;
   ``partition.cli`` on the 100k-node planted graph, then the driver
   trains SAGE one epoch from its ``<name>-reordered-k4`` output (K1, K2,
   K3 launched); ``--execution_mode communication_simulation`` through the
   driver (``vip`` and ``simulation``) with the accounting identity on
   every row, and ``comm_budget.measure_budget`` against phase 5's SAGE
   step; ``assemble_features`` in a world-1 NCCL group over the bench
   table (plain, a VIP cache, a hot prefix, the fp8 wire) equal to
   ``table[n_id]`` bit for bit, K3 launched 2-3 times a call, timed; a
   2-rank NCCL run of the same checks where the host has 2 cards;
9. the data-parallel trainer in a world-1 NCCL group joined through the
   port's bootstrap (``maybe_initialize_distributed`` from ``env://``),
   so the rank's heartbeat is live: its SAGE step on the bench graph at
   the bench shape (step time, edges/s, the host stages a step under the
   JAX package's names, the profile's busy and idle share, K1 4, K2 1 and
   K3 2 launches a step) beside phase 5's single-card figures; the step
   with the heartbeat on and off in turns (on, off, off, on, twice); 10 steps
   of a small shape on the card and in a gloo subgroup on the CPU, losses
   within rtol 2e-2; sharded layerwise inference over the bench graph
   against ``layerwise_inference`` with the same weights (predictions
   agree on > 0.995 of the nodes), s a layer, nodes/s, peak memory; a
   checkpoint and the group's barrier; the heartbeat never fired; where
   the host has 2 cards, ``torchrun --nproc_per_node 2`` of the driver
   with ``--distribute_data true --computation_mode frequency_cache`` on
   the 100k-node graph, and the chaos pair of phase 11 in NCCL on 2 cards
   with rank 1 stopped;
10. the readiness drill's CLI (``utils/readiness_drill.py``) in a child at
   products widths and 250k nodes: the graph written by ``GraphData.save``,
   ``partition.cli --parts 4`` in a child, then the driver in a child on
   the card for one epoch at the default model with a layerwise final
   test; each stage's seconds and peak RSS, finite losses, final_valid
   inside the band random labels allow, and the child's K1, K2 and K3
   launches (set to 0 before and written after its ``driver.main``);
11. rank-death fail-fast: the chaos pair of ``tests/_torch_chaos_worker.py``
   (two raw processes, one gloo group on the host's CPU, a 10 s
   heartbeat, one epoch of a 2-rank DistributedTrainer), four at once:
   rank 1 calls ``os._exit(42)``, raises an uncaught exception, or stops
   itself with SIGSTOP; rank 0 must end non-zero without finishing epoch
   1, by the heartbeat within its timeout of the crash and within 3× of
   the stop. In the fourth pair rank 0 sleeps 3× the timeout before the
   barrier while rank 1 waits in it: both must end with 0;
12. the launchers: (a) the README's 2-rank driver job in gloo on the
   host's CPU three ways at once, under torchrun's variables, SLURM's
   alone (``srun``) and Open MPI's alone (``mpirun``), each rank's group
   joined with a live heartbeat, every results.json equal to torchrun's
   but the epoch's wall time; (b) the plain command ``python -m
   salient_plusplus_tpu_torch.driver ... --distribute_data true`` on the
   100k-node graph with no launcher variables: one process on this
   one-card host, exit 0, final_valid above chance, and its log's kernel
   launches (K1, K2 and K3, counted from 0 in that process); (c) where
   the host has 2 cards, the same command spawning one NCCL rank a card
   and an ``srun``-emulated NCCL pair;
13. the throughput bench (``salient_plusplus_tpu_torch/bench.py``, the
   counterpart of the JAX package's ``bench.py``): its gather probe in
   this process on phase 5's feature table, read PROBE_READINGS times
   and their spread logged (K3 launched exactly the probes' chain
   lengths, each slope at or above the HBM bound of its bytes), then ``python -m salient_plusplus_tpu_torch.bench`` twice in a
   child, SAGE all-resident and at ``BENCH_HBM_FRACTION=0.5`` with
   ``BENCH_COLD_CACHE=auto`` (20 warm-up steps, 3 windows of 40): exit 0, edges/s > 0, 3 windows, a measured probe, roofline
   share in (0, 1.05], a microstep time, no gsrc fallback, and the child's
   K1, K2 and K3 launches (from 0 in that process) exactly 4, 1 and 1 a
   train step plus the probes' K3; each line is logged beside phase 5's
   (and phase 7's gsrc-cold) step time and edges/s.

The last stdout line is {"ok": true, "device": {...}}; before it, the
kernel summary JSON and the nvidia-smi name/power-limit line.
"""

from __future__ import annotations

import ast
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA data sheet
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "sorted_segment_sum": ("salient_plusplus_tpu_torch/csrc/"
                           "sorted_segment_sum.cu",
                           "salient_plusplus_tpu/ops/mxu_segment.py:68"),
    "fused_gather_segment_sum": ("salient_plusplus_tpu_torch/csrc/"
                                 "fused_gather_segment_sum.cu",
                                 "salient_plusplus_tpu/ops/"
                                 "pallas_aggregate.py:38"),
    "gather_rows": ("salient_plusplus_tpu_torch/csrc/gather_rows.cu",
                    "salient_plusplus_tpu/ops/pallas_gather.py:32"),
}
LAYERWISE_CHUNK = 4096   # RunConfig.inference_chunk's default
BENCH_CFG = dict(train_batch_size=1024, train_fanouts=[15, 10, 5],
                 hidden_features=256, num_layers=3, lr=0.003,
                 model_name="SAGE", max_batches_in_flight=8)
# the edge cases of K1 and K2: (label, E, F, T, real edges, pad id, kind);
# kind as in real_ids
EDGE_CASES = [
    ("F64", 1024, 64, 128, 900, 128, "uniform"),
    ("F100", 2048, 100, 384, 1737, 384, "uniform"),
    ("F8 no real edges", 512, 8, 128, 0, 128, "uniform"),
    ("F12 pads above T", 1024, 12, 256, 800, 640, "uniform"),
    ("hub + empty segments", 4096, 16, 256, 3000, 256, "hub"),
    ("F300 two passes", 20000, 300, 5000, 19000, 5000, "uniform"),
    ("one segment over ~4700 slices", 300_000, 256, 64, 299_000, 64, "one"),
    ("segments of one slice", 5120, 128, 80, 5120, 80, ("blocks", 64)),
    ("segments of two slices", 5120, 256, 40, 5113, 40, ("blocks", 128)),
    ("two segments a slice", 5120, 64, 160, 5120, 160, ("blocks", 32)),
    ("E below one slice", 50, 128, 32, 45, 32, "uniform"),
]


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def real_ids(rng, T, n, kind):
    """Sorted ids of n real edges: "uniform"; "hub" (80% on row 0, the
    rest spread, empty rows between); "one" (all on row 0); ("blocks", L):
    segments of exactly L edges from edge 0, so with L a multiple or a
    divisor of the kernels' 64-edge slice every boundary falls on or
    between slice boundaries."""
    if kind == "hub":
        k = int(n * 0.8)
        return np.concatenate([np.zeros(k, np.int64),
                               np.sort(rng.integers(1, T, n - k))])
    if kind == "one":
        return np.zeros(n, np.int64)
    if isinstance(kind, tuple):
        return np.arange(n) // kind[1]
    return np.sort(rng.integers(0, T, n))


def exact_sum(vals, ids, T):
    """The segment sum in float64 (ids >= T dropped) and the sum of
    |terms| a row: the reference of float32 results. A float32 kernel sum
    may differ from it by 1e-4 + 1e-6 * sum|terms| (summation order); the
    plain version's f32 atomics are no such reference, as they add a
    300k-edge segment in one chain and drift further when rows repeat."""
    keep = ids.long().clamp(max=T)
    out = torch.zeros(T + 1, 2, vals.shape[1], dtype=torch.float64,
                      device=vals.device)
    v = vals.double()
    out.index_add_(0, keep, torch.stack([v, v.abs()], 1))
    return out[:T, 0], out[:T, 1]


def check_f32(label, got, exact):
    ref, ref_abs = exact
    err = (got.double() - ref).abs()
    check(bool((err <= 1e-4 + 1e-6 * ref_abs).all()),
          f"{label} f32: max error {float(err.max())} against float64")


def check_deterministic(label, fn, times=3):
    """``fn()`` ``times`` times: the outputs must be bit-identical."""
    first = fn()
    for _ in range(times - 1):
        check(torch.equal(fn(), first), f"{label}: repeated calls differ")
    log(f"  {label}: {times} calls bit-identical")


def shares(ms, lib, bound):
    """The share of the bound a timed call reaches and its time over the
    library call's."""
    return (f"bound_share={bound / ms:.3f} "
            f"vs_library={'none' if lib is None else f'{ms / lib:.3f}x'}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3,
            budget_ms: float = 400.0, host_ms: float = 0.2) -> float:
    """Mean device time of ``fn`` over back-to-back calls: ``iters`` of
    them, fewer where one call alone would take the run past
    ``budget_ms`` (a plain hub-chunk call takes ~10 ms). ``host_ms``: the
    host time a call may take to enqueue, which the device sleeps through
    first."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    first = start.elapsed_time(end)
    iters = max(1, min(iters, int(budget_ms / max(first, 1e-3))))
    for _ in range(warmup - 1 if iters >= warmup else 0):
        fn()
    torch.cuda.synchronize()
    # the device sleeps while the host enqueues the timed calls, so that a
    # call shorter than its host overhead (checks, allocations, launches)
    # is timed on the device and not on the host: ``host_ms`` a call, at
    # the H100's ~2e6 cycles a ms
    torch.cuda._sleep(int(2e6 * (1.0 + host_ms * iters)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phase 2
def phase_build():
    from salient_plusplus_tpu_torch.native import build

    paths, errors = {}, []

    def run(name, fn):
        try:
            paths[name] = fn()
        except Exception as e:  # reported and re-raised below
            errors.append(f"{name}: {e}")

    t0 = time.perf_counter()
    jobs = [("sampler", build.sampler_lib_path)] + [
        (k, lambda k=k: build.kernel_lib_path(k)) for k in build.KERNELS]
    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("build failed: " + "; ".join(errors))
    log(f"build: {time.perf_counter() - t0:.1f} s (sampler and "
        f"{len(build.KERNELS)} kernels in parallel)")
    for k in build.KERNELS:
        for line in build.build_log(paths[k]).splitlines():
            if any(w in line for w in ("registers", "spill",
                                       "Compiling entry", "smem")):
                log("  ptxas:", line.strip())


# ---------------------------------------------------------------- phase 3
def bench_batch(trainer, dev):
    """One decoded bench-shape train batch on the card."""
    from salient_plusplus_tpu_torch.train.pipeline import DeviceFeeder
    from salient_plusplus_tpu_torch.train.step import decode_batch

    ts = trainer.train_sampler
    ts.set_epoch(trainer.shuffler.get_idx(0), 0)
    it = iter(ts)
    batch = decode_batch(next(DeviceFeeder(it, dev, depth=1)))
    it.close()
    return batch


def k1_cases(trainer, batch):
    """(label, ids, T, F, n_real) for every K1 call of one train step: each
    mirrored hop forward (by dst) and backward (by msrc). The hop without
    a mirror (layer 0) runs K2."""
    H = trainer.cfg.hidden_features
    cases = []
    for i, e in enumerate(batch.edges):
        if e.msrc is None:
            continue
        in_cap, out_cap = batch.layer_caps(i)
        n = int(e.count)
        cases.append((f"fwd layer{i}", e.dst, out_cap, H, n))
        cases.append((f"bwd layer{i}", e.msrc, in_cap, H, n))
    return cases


def phase_kernel_vs_plain(cases, dev, power):
    from salient_plusplus_tpu_torch.ops.sorted_segment import (
        _sorted_degrees, _sorted_segment_sum_plain, sorted_segment_sum_mxu)

    g = torch.Generator(device=dev).manual_seed(0)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    max_err, bound_by = 0.0, "bytes"
    for label, ids, T, F, n in cases:
        E = ids.shape[0]
        vals = torch.randn(E, F, generator=g, device=dev).to(torch.bfloat16)
        vals[n:] = 333.0  # garbage in pad rows must never be read
        got = sorted_segment_sum_mxu(vals, ids, T)
        ref = _sorted_segment_sum_plain(vals, ids, T)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=1e-2, atol=1e-2)
        err = float((got - ref).abs().max())
        max_err = max(max_err, err)
        if label == "bwd layer1":  # the mirrored backward with the hub
            check_deterministic(f"K1 {label}", lambda: sorted_segment_sum_mxu(
                vals, ids, T))
        ms = cuda_ms(lambda: sorted_segment_sum_mxu(vals, ids, T))
        plain = cuda_ms(lambda: _sorted_segment_sum_plain(vals, ids, T))
        lib = cuda_ms(lambda: torch.zeros(T, F, device=dev).index_add_(
            0, ids[:n], vals[:n].float()))
        nbytes = n * F * vals.element_size() + 4 * n + 4 * T * F
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n * F / F32_OPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        if ops_ms > bytes_ms:
            bound_by = "operations"
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                     ("bound_ms", bound)):
            tot[k] += v
        longest = int(_sorted_degrees(ids, T).max()) if T else 0
        log(f"  {label}: E={E} real={n} T={T} F={F} longest={longest} bf16  "
            f"kernel_ms={ms:.4f} "
            f"plain_ms={plain:.4f} library_ms={lib:.4f} "
            f"bound_us={bound * 1e3:.2f} ({nbytes} B at 3.35 TB/s) "
            f"{shares(ms, lib, bound)} max_abs_err={err:.3g}  [{power}]")
    return tot, max_err, bound_by


def edge_case_ids(rng, E, T, n, pad, kind):
    return np.concatenate([real_ids(rng, T, n, kind),
                           np.full(E - n, pad)]).astype(np.int32)


def phase_edge_cases(dev):
    """The edge cases of tests/test_mxu_segment.py and more, f32 and bf16:
    f32 against the float64 sum (exact_sum), bf16 against the plain
    version (both sum the same bf16 inputs in f32, rtol 1e-2); then K1 and
    K2 on bf16 views whose base is not 16-byte aligned (the one-element
    load path)."""
    from salient_plusplus_tpu_torch.ops.pallas_aggregate import (
        _fused_gather_segment_sum_plain, fused_gather_segment_sum)
    from salient_plusplus_tpu_torch.ops.sorted_segment import (
        _sorted_segment_sum_plain, sorted_segment_sum_mxu)

    rng = np.random.default_rng(1)
    for label, E, F, T, n, pad, kind in EDGE_CASES:
        ids = torch.from_numpy(edge_case_ids(rng, E, T, n, pad, kind)).to(dev)
        v32 = torch.from_numpy(rng.standard_normal((E, F)).astype(
            np.float32)).to(dev)
        v32[n:] = 333.0
        check_f32(label, sorted_segment_sum_mxu(v32, ids, T),
                  exact_sum(v32, ids, T))
        vals = v32.to(torch.bfloat16)
        got = sorted_segment_sum_mxu(vals, ids, T)
        ref = _sorted_segment_sum_plain(vals, ids, T)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, atol=1e-2, rtol=1e-2)
        log(f"  edge case {label}: E={E} F={F} T={T} real={n}: f32 matches "
            f"the float64 sum, bf16 the plain version")
    for F, offset in ((12, 12), (128, 4)):
        E, T, n = 3000, 200, 2900
        ids = torch.from_numpy(edge_case_ids(rng, E, T, n, T, "hub")).to(dev)
        buf = torch.empty(E * F + offset, dtype=torch.bfloat16, device=dev)
        view = buf[offset:].view(E, F)
        view.copy_(torch.randn(E, F, device=dev))
        check(view.data_ptr() % 16 != 0, "view is 16-byte aligned")
        torch.testing.assert_close(
            sorted_segment_sum_mxu(view, ids, T),
            _sorted_segment_sum_plain(view, ids, T), atol=1e-2, rtol=1e-2)
        src = torch.arange(E, dtype=torch.int32, device=dev)
        cnt = torch.tensor(n, dtype=torch.int32, device=dev)
        torch.testing.assert_close(
            fused_gather_segment_sum(view, src, ids, cnt, T),
            _fused_gather_segment_sum_plain(view, src, ids, cnt, T),
            atol=1e-2, rtol=1e-2)
        log(f"  misaligned bf16 view F={F} at element {offset}: K1 and K2 "
            f"match the plain version")


def _ms_of_bytes(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def _row(label, ms, plain, lib, bound, err, extra, power):
    log(f"  {label}: {extra}  kernel_ms={ms:.4f} plain_ms={plain:.4f} "
        f"library_ms={'none' if lib is None else f'{lib:.4f}'} "
        f"bound_us={bound * 1e3:.2f} {shares(ms, lib, bound)} "
        f"max_abs_err={err:.3g}  [{power}]")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                err=err)


def measure_k2(label, emb, src, dst, count, T, n, power, time_it=True):
    """K2 against its plain version on the card (and, with ``time_it``,
    the kernel, plain and library times beside the bound). f32 is held
    against the float64 sum (exact_sum); bf16 rows are summed in f32 by
    kernel and plain version, rtol 1e-2."""
    from salient_plusplus_tpu_torch.ops.pallas_aggregate import (
        _fused_gather_segment_sum_plain as plain, fused_gather_segment_sum)
    from salient_plusplus_tpu_torch.ops.segment import _safe_dst

    got = fused_gather_segment_sum(emb, src, dst, count, T)
    ref = plain(emb, src, dst, count, T)
    torch.cuda.synchronize()
    if emb.dtype == torch.float32:
        ids = _safe_dst(dst, count, T)
        check_f32(f"K2 {label}", got, exact_sum(emb.index_select(
            0, torch.where(ids < T, src.long(), 0)), ids, T))
    else:
        torch.testing.assert_close(got, ref, rtol=1e-2, atol=1e-2)
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    if not time_it:
        return err
    F = emb.shape[1]
    # the function reads each distinct table row of a real edge once (hub
    # ids repeat), each src and dst id once, and writes the f32 output once
    rows = int(torch.unique(src[:n][dst[:n] < T]).numel())
    nbytes = rows * F * emb.element_size() + 8 * n + 4 * T * F
    bound = max(_ms_of_bytes(nbytes), n * F / F32_OPS_PER_S * 1e3)
    ms = cuda_ms(lambda: fused_gather_segment_sum(emb, src, dst, count, T))
    plain_ms = cuda_ms(lambda: plain(emb, src, dst, count, T))
    # one library call for the same sum: a CSR [T, N] of ones times emb
    crow = torch.searchsorted(
        dst[:n].contiguous(), torch.arange(T + 1, dtype=torch.int32,
                                           device=dst.device),
        out_int32=True)
    csr = torch.sparse_csr_tensor(
        crow, src[:n].contiguous(), torch.ones(n, dtype=emb.dtype,
                                               device=emb.device),
        size=(T, emb.shape[0]))
    try:
        lib = cuda_ms(lambda: torch.sparse.mm(csr, emb))
    except (NotImplementedError, RuntimeError) as e:
        # the yardstick only: this torch has no single call for the sum in
        # emb's dtype, and library_ms is then null
        log(f"  K2 {label}: no library call: torch.sparse.mm in "
            f"{emb.dtype}: {str(e).splitlines()[0][:120]}")
        lib = None
    longest = int(torch.diff(crow).max()) if T else 0
    return _row(f"K2 {label}", ms, plain_ms, lib, bound, err,
                f"E={src.shape[0]} real={n} distinct_rows={rows} T={T} "
                f"N={emb.shape[0]} F={F} longest={longest} "
                f"{str(emb.dtype)[6:]} ({nbytes} B)",
                power)


def measure_k3(label, table, idx, power, time_it=True):
    """K3 against its plain version on the card: a byte copy, exact."""
    from salient_plusplus_tpu_torch.ops.pallas_gather import (
        _gather_rows_plain as plain, pallas_gather_rows)

    got = pallas_gather_rows(table, idx)
    torch.cuda.synchronize()
    check(torch.equal(got, plain(table, idx)), f"K3 {label} differs")
    if not time_it:
        return 0.0
    n, row_bytes = idx.shape[0], table.shape[1] * table.element_size()
    # each distinct row read once, each output row written once, ids once
    rows = int(torch.unique(idx).numel())
    nbytes = (rows + n) * row_bytes + 4 * n
    ms = cuda_ms(lambda: pallas_gather_rows(table, idx))
    plain_ms = cuda_ms(lambda: plain(table, idx))
    lib = cuda_ms(lambda: torch.index_select(table, 0, idx))
    return _row(f"K3 {label}", ms, plain_ms, lib, _ms_of_bytes(nbytes), 0.0,
                f"n={n} distinct_rows={rows} N={table.shape[0]} "
                f"row_bytes={row_bytes} "
                f"{str(table.dtype)[6:]} ({nbytes} B)", power)


def phase_k2_k3_main(trainer, batch, dev, power):
    """K2 and K3 at the main paths' shapes: a train step's layer 0 (global
    src ids into the 1M-row bf16 table) and frontier prefix; a hub chunk
    (the first: the power-law graph's hubs have the lowest ids) and a
    typical chunk (the middle) of layerwise inference, F = 128 and 256."""
    from salient_plusplus_tpu_torch.models.inference import LocalEngine
    from salient_plusplus_tpu_torch.ops.pallas_aggregate import (
        fused_gather_segment_sum)
    from salient_plusplus_tpu_torch.ops.segment import gather_rows

    feats = trainer.features
    V, L = feats.shape[0], batch.num_layers
    e0 = batch.edges[0]
    _, T0 = batch.layer_caps(0)
    res = {"K2 step": measure_k2("train step layer 0 (gsrc)", feats, e0.src,
                                 e0.dst, e0.count, T0, int(e0.count), power),
           "K3 step": measure_k3(
               "train step frontier prefix", feats,
               batch.n_id[:batch.spec.node_caps[L - 1]].clamp(max=V - 1),
               power)}
    g = trainer.graph
    eng = LocalEngine(g.rowptr, g.col, LAYERWISE_CHUNK, dev)
    wide = torch.randn(V, 256, generator=torch.Generator(device=dev)
                       .manual_seed(2), device=dev).to(torch.bfloat16)
    for where, s in (("hub chunk", 0),
                     ("typical chunk", V // 2 // LAYERWISE_CHUNK
                      * LAYERWISE_CHUNK)):
        n_id, edge, n = eng.chunk(s)
        for emb in (feats, wide):
            F = emb.shape[1]
            res[f"K3 {where} F{F}"] = measure_k3(
                f"layerwise {where} F={F}", emb, n_id, power)
            x = gather_rows(emb, n_id)
            if where == "hub chunk":
                check_deterministic(
                    f"K2 layerwise hub chunk F={F}",
                    lambda: fused_gather_segment_sum(x, edge.src, edge.dst,
                                                     edge.count, n))
            res[f"K2 {where} F{F}"] = measure_k2(
                f"layerwise {where} F={F}", x, edge.src, edge.dst,
                edge.count, n, int(edge.count), power)
    return res


def phase_k2_k3_edge_cases(dev):
    """K2 on K1's edge cases, with src ids into a larger table, real-looking
    dst values past count and pad src ids that are no row; K2 with count
    inside a slice, 0, past E and below 0 (clamped); K3 at odd row widths
    (the byte loop), n = 0, repeated ids and an integer table."""
    rng = np.random.default_rng(4)
    for label, E, F, T, n, pad, kind in EDGE_CASES:
        dst = edge_case_ids(rng, E, T, n, pad, kind)
        dst[n:n + (E - n) // 2] = rng.integers(0, T, (E - n) // 2)
        N = 3 * T + 5
        src = rng.integers(0, N, E).astype(np.int32)
        src[n:] = 2**31 - 1
        emb = torch.from_numpy(rng.standard_normal((N, F)).astype(
            np.float32)).to(dev)
        src_d, dst_d = torch.from_numpy(src).to(dev), torch.from_numpy(
            dst).to(dev)
        count = torch.tensor(n, dtype=torch.int32, device=dev)
        for e in (emb, emb.to(torch.bfloat16)):
            measure_k2(label, e, src_d, dst_d, count, T, n, "", False)
        log(f"  K2 edge case {label}: E={E} F={F} T={T} N={N} real={n}, "
            f"dst past count and pad src garbage: f32 and bf16 match")
    E, F, T, N = 4096, 128, 300, 1000
    for count in (333, 0, 5000, -3):
        c = max(0, min(count, E))
        dst = np.sort(rng.integers(0, T, E)).astype(np.int32)
        dst[c:] = rng.integers(0, T, E - c)   # not sorted past count
        src = rng.integers(0, N, E).astype(np.int32)
        src[c:] = 2**31 - 1
        emb = torch.from_numpy(rng.standard_normal((N, F)).astype(
            np.float32)).to(dev)
        src_d, dst_d = torch.from_numpy(src).to(dev), torch.from_numpy(
            dst).to(dev)
        cnt = torch.tensor(count, dtype=torch.int32, device=dev)
        for e in (emb, emb.to(torch.bfloat16)):
            measure_k2(f"count {count}", e, src_d, dst_d, cnt, T, c, "",
                       False)
        log(f"  K2 count={count} of E={E}: f32 and bf16 match")
    for N, F, n in ((1000, 128, 512), (300, 256, 128), (50, 12, 400),
                    (70, 100, 9), (10, 300, 0), (5, 8, 33)):
        tab = torch.from_numpy(rng.integers(-100, 100, (N, F))).to(dev)
        idx = torch.from_numpy(rng.integers(0, N, n).astype(np.int32)).to(
            dev)
        for dt in (torch.float32, torch.bfloat16, torch.int32):
            measure_k3("edge", tab.to(dt), idx, "", False)
        log(f"  K3 edge case N={N} F={F} n={n}: f32, bf16 and int32 exact")


def phase_weighted_gat(trainer, batch, dev, power, label="GAT"):
    """The weighted gather + segment sum at each hop of a bench batch of a
    GAT model (``label``): bf16 rows of each conv's heads x per-head width
    (the zoo's GAT one head; GATSkip 4, whose last layer's 47-wide heads
    straddle the 16-byte vectors), f32 weights a head; NaN weights and src
    ids that are no row past count. Against the float64 sum of the same
    products by the f32 rule, its plain version too, three calls
    bit-identical; then timed beside the three-op chain it replaces
    (gather, broadcast multiply in bf16, K1) and its plain version, with
    its bound (each real edge's row, 8 bytes of ids and 4 of weight a
    head, the f32 output). Its backward (``weighted_segment_sum_backward``,
    the kernels of ``csrc/weighted_segment_grad.cu``) the same way: against
    the plain backward in f32 on the kernels' inputs by summation order
    (and bf16 d_xs's final rounding), three calls bit-identical, timed
    beside the plain backward (gathers and a bf16 ``index_add_``), with
    its bound (each real edge's xs row and g row, each target's g row, 24
    bytes of ids and 8 a head of weight and d_att a real edge, the bf16
    d_xs). Returns the totals over the hops."""
    from salient_plusplus_tpu_torch.ops.segment import _real_rows
    from salient_plusplus_tpu_torch.ops.sorted_segment import (
        sorted_segment_sum_mxu)
    from salient_plusplus_tpu_torch.ops.weighted_segment import (
        _weighted_segment_sum_backward_plain, _weighted_segment_sum_plain,
        weighted_segment_sum, weighted_segment_sum_backward)

    model = trainer.state.model
    g = torch.Generator(device=dev).manual_seed(7)
    tot = dict(ms=0.0, chain_ms=0.0, plain_ms=0.0, bound_ms=0.0,
               bwd_ms=0.0, bwd_plain_ms=0.0, bwd_bound_ms=0.0)
    for i, e in enumerate(batch.edges):
        N, T = batch.layer_caps(i)
        conv = getattr(model, f"conv{i}")
        H, C = conv.heads, conv.features
        F = H * C
        E, n = e.src.shape[0], int(e.count)
        xs = torch.randn(N, H, C, generator=g, device=dev).bfloat16()
        att = torch.rand(E, H, generator=g, device=dev)
        att[n:] = float("nan")
        src = e.src.clone()
        src[n:] = 2**31 - 1
        args = (xs, att, src, e.dst, e.count, T)
        got = weighted_segment_sum(*args)
        ids, rows = _real_rows(src, e.dst, e.count, T)
        v = (xs.index_select(0, rows).double()
             * att.double().nan_to_num()[:, :, None]).view(E, F)
        exact = exact_sum(v, ids.int(), T)
        name = f"{label} weighted sum layer{i} ({H}x{C})"
        for side, out in (("kernel", got),
                          ("plain", _weighted_segment_sum_plain(*args))):
            check_f32(f"{name} {side}", out.view(T, F), exact)
        check_deterministic(name, lambda: weighted_segment_sum(*args))
        att0 = torch.where(att.isnan(), 0.0, att)
        ms = cuda_ms(lambda: weighted_segment_sum(*args))
        chain_ms = cuda_ms(lambda: sorted_segment_sum_mxu(
            (xs.index_select(0, e.src)
             * att0.to(torch.bfloat16)[:, :, None]).view(E, F), e.dst, T))
        plain_ms = cuda_ms(lambda: _weighted_segment_sum_plain(*args))
        bound_ms = ((n * F * 2 + (8 + 4 * H) * n + 4 * T * F)
                    / HBM_BYTES_PER_S * 1e3)
        d_out = torch.randn(T, H, C, generator=g, device=dev)
        bwd = weighted_segment_sum_backward(d_out, *args)
        g32 = d_out.bfloat16().float()
        ref = _weighted_segment_sum_backward_plain(
            g32, xs.float(), att0, src, e.dst, e.count, T)
        mag = _weighted_segment_sum_backward_plain(
            g32.abs(), xs.float().abs(), att0.abs(), src, e.dst, e.count, T)
        for part, got, want, m in (("d_xs", bwd[0], ref[0], mag[0]),
                                   ("d_att", bwd[1], ref[1], mag[1])):
            err = (got.float() - want).abs()
            tol = 1e-4 + 1e-5 * m
            if part == "d_xs":
                tol = tol + 2.0**-8 * want.abs()
            check(bool((err <= tol).all()), f"{name} backward {part}: max "
                  f"error {float(err.max())} against the plain f32 one")
        check_deterministic(f"{name} backward", lambda: torch.cat([
            t.float().flatten()
            for t in weighted_segment_sum_backward(d_out, *args)]))
        del bwd, ref, mag
        bwd_ms = cuda_ms(lambda: weighted_segment_sum_backward(d_out, *args))
        bwd_plain_ms = cuda_ms(lambda: _weighted_segment_sum_backward_plain(
            d_out, xs, att0, src, e.dst, e.count, T))
        bwd_bound_ms = ((2 * n * F * 2 + T * F * 2 + (24 + 8 * H) * n
                         + 2 * N * F) / HBM_BYTES_PER_S * 1e3)
        for k, val in (("ms", ms), ("chain_ms", chain_ms),
                       ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                       ("bwd_ms", bwd_ms), ("bwd_plain_ms", bwd_plain_ms),
                       ("bwd_bound_ms", bwd_bound_ms)):
            tot[k] += val
        log(f"  {name} (E={E} real={n} N={N} T={T} F={F} bf16): "
            f"kernel_ms={ms:.4f} chain_ms={chain_ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_us={bound_ms * 1e3:.2f} "
            f"bound_share={bound_ms / ms:.3f} "
            f"vs_chain={ms / chain_ms:.3f}x  [{power}]")
        log(f"  {name} backward: kernel_ms={bwd_ms:.4f} "
            f"plain_ms={bwd_plain_ms:.4f} "
            f"bound_us={bwd_bound_ms * 1e3:.2f} "
            f"bound_share={bwd_bound_ms / bwd_ms:.3f} "
            f"vs_plain={bwd_ms / bwd_plain_ms:.3f}x  [{power}]")
    log(f"  {label} weighted sum per step (3 calls): "
        f"kernel_ms={tot['ms']:.4f} chain_ms={tot['chain_ms']:.4f} "
        f"plain_ms={tot['plain_ms']:.4f} "
        f"bound_us={tot['bound_ms'] * 1e3:.2f} "
        f"bound_share={tot['bound_ms'] / tot['ms']:.3f}  [{power}]")
    log(f"  {label} weighted sum backward per step (3 calls): "
        f"kernel_ms={tot['bwd_ms']:.4f} "
        f"plain_ms={tot['bwd_plain_ms']:.4f} "
        f"bound_us={tot['bwd_bound_ms'] * 1e3:.2f} "
        f"bound_share={tot['bwd_bound_ms'] / tot['bwd_ms']:.3f}  [{power}]")
    return tot


def phase_gatskip_step(trainer, dev):
    """One GATSkip train step on the card after a warm one, with every
    kernel's launch counter set to 0 just before it and
    ``ops.launch_counts()`` read just after: the weighted sum once a layer,
    each launch multi-head, and its kernel backward once a layer; K3 once
    (the features); no K1 or K2."""
    from salient_plusplus_tpu_torch import ops
    from salient_plusplus_tpu_torch.train.pipeline import DeviceFeeder

    ts = trainer.train_sampler
    ts.set_epoch(trainer.shuffler.get_idx(1), 1)
    it = iter(ts)
    feeder = DeviceFeeder(it, dev, depth=2)
    trainer.run_step(next(feeder))
    batch = next(feeder)
    torch.cuda.synchronize(dev)
    for w in _wrappers().values():
        w.launches = 0
    _wrappers()["weighted_segment_sum"].multihead = 0
    _wrappers()["weighted_segment_sum"].backward = 0
    loss = trainer.run_step(batch)
    torch.cuda.synchronize(dev)
    counts = ops.launch_counts()
    it.close()
    log(f"  launches in one GATSkip train step: {counts} loss="
        f"{float(loss):.4f}")
    check(bool(torch.isfinite(loss)), "GATSkip step loss is not finite")
    want = {"sorted_segment_sum": 0, "fused_gather_segment_sum": 0,
            "gather_rows": 1, "weighted_segment_sum": 3,
            "weighted_segment_sum.multihead": 3,
            "weighted_segment_sum.backward": 3}
    check(counts == want, f"GATSkip step launches {counts}: {want} "
          f"expected")


def phase_k3_grad(batch, dev, F=256):
    """K3 differentiable on the card (ARMA's gather of the scaled
    projection) at a bench batch's layer-1 src ids into an [N_in, F] f32
    table: its gradient (``index_add_`` of the incoming rows) and that of
    ``index_select`` both within 1e-4 + 1e-6·Σ|terms| of the float64 sum;
    one K3 launch for the forward."""
    from salient_plusplus_tpu_torch.ops.pallas_gather import (
        pallas_gather_rows)
    from salient_plusplus_tpu_torch.ops.segment import gather_rows

    e = batch.edges[1]
    N, _ = batch.layer_caps(1)
    idx = e.src
    g = torch.Generator(device=dev).manual_seed(6)
    table = torch.randn(N, F, generator=g, device=dev)
    w = torch.randn(idx.shape[0], F, generator=g, device=dev)
    exact = exact_sum(w, idx, N)
    grads = {}
    for label, fn in (("K3", gather_rows),
                      ("index_select", lambda t, i: t.index_select(0, i))):
        t = table.clone().requires_grad_(True)
        k3 = pallas_gather_rows.launches
        out = fn(t, idx)
        check(out.grad_fn is not None, f"{label}: no grad_fn on the card")
        if label == "K3":
            check(pallas_gather_rows.launches == k3 + 1, "K3 not launched")
        (out * w).sum().backward()
        torch.cuda.synchronize()
        check_f32(f"{label} gradient", t.grad, exact)
        grads[label] = t.grad
    err = float((grads["K3"] - grads["index_select"]).abs().max())
    log(f"  K3 gradient (n={idx.shape[0]} N={N} F={F} f32): matches the "
        f"float64 sum and index_select's gradient (max |diff| {err:.3g})")
    return err


# ---------------------------------------------------------------- phase 4
def _wrappers():
    from salient_plusplus_tpu_torch.ops.pallas_aggregate import (
        fused_gather_segment_sum)
    from salient_plusplus_tpu_torch.ops.pallas_gather import (
        pallas_gather_rows)
    from salient_plusplus_tpu_torch.ops.sorted_segment import (
        sorted_segment_sum_mxu)
    from salient_plusplus_tpu_torch.ops.weighted_segment import (
        weighted_segment_sum)

    return {"sorted_segment_sum": sorted_segment_sum_mxu,
            "fused_gather_segment_sum": fused_gather_segment_sum,
            "gather_rows": pallas_gather_rows,
            "weighted_segment_sum": weighted_segment_sum}


def driven(label, fn):
    """``fn()`` with every kernel's launch count set to 0 just before and
    read just after: (its result, {kernel: launches})."""
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    counts = {k: w.launches for k, w in wrappers.items()}
    log(f"  launches in {label}: {counts}")
    return out, counts


def train_steps(V: int) -> int:
    """Train steps of one epoch of the planted graph at batch 1024 (its
    train split is 60% of the nodes)."""
    return -(-int(0.6 * V) // 1024)


def phase_driver(dev, V=100_000, C=32, extra=(), floor=None,
                 inspect=None):
    """One epoch through the driver CLI on the planted graph; returns the
    epoch's train steps. ``floor``: the least final_valid (chance by
    default); ``inspect(out_root)`` looks at the run's output directory
    before it is removed."""
    from salient_plusplus_tpu_torch import driver

    floor = 1.0 / C if floor is None else floor
    with tempfile.TemporaryDirectory() as out_root:
        out = driver.main([f"synth:V={V},C={C},deg=12,F=64", "smoke",
                           "--epochs", "1", "--output_root", out_root,
                           *extra], device=dev)
        if inspect is not None:
            inspect(out_root)
    r = out[0]
    log(f"  driver {' '.join(extra)}: losses={r['losses']} "
        f"final_valid={r['final_valid']:.4f} "
        f"final_test={r['final_test']:.4f} epoch_s={r['epoch_times']}")
    check(all(np.isfinite(r["losses"])), "driver losses are not finite")
    check(r["final_valid"] > floor,
          f"final_valid {r['final_valid']} is not above {floor}")
    return train_steps(V)


def phase_drivers(dev, V=100_000, C=32):
    """Slice 1's path (batchwise final test) and slice 2's (layerwise), each
    with the counts read around it, then the other four models."""
    steps, c1 = driven("driver (batchwise)", lambda: phase_driver(dev, V, C))
    log(f"  ({steps} train steps; K1 >= 4, K2 >= 1, K3 >= 1 per step "
        f"required)")
    check(c1["sorted_segment_sum"] >= 4 * steps, "K1 launched too few times")
    check(c1["fused_gather_segment_sum"] >= steps, "K2 launched too few times")
    check(c1["gather_rows"] >= steps, "K3 launched too few times")
    lw = ("--final_test_mode", "layerwise")
    _, c2 = driven("driver (layerwise)",
                   lambda: phase_driver(dev, V, C, lw, floor=0.5))
    per_layer = -(-V // LAYERWISE_CHUNK)
    log(f"  ({steps} train steps + {per_layer} chunks x 3 layers; K1 >= 4 "
        f"per step, K2 and K3 >= 1 per step and 1 per chunk and layer "
        f"required)")
    check(c2["sorted_segment_sum"] >= 4 * steps, "K1 launched too few times")
    for k in ("fused_gather_segment_sum", "gather_rows"):
        check(c2[k] >= steps + 3 * per_layer, f"{k} launched too few times")
    small = ("--num_layers", "2", "--hidden_features", "128",
             "--train_fanouts", "10,5", "--batchwise_test_fanouts", "20,20",
             "--final_test_fanouts", "20,20", *lw)
    for name in ("SAGEClassic", "GIN", "JKNet", "SAGEResInception"):
        _, c = driven(f"driver {name}", lambda: phase_driver(
            dev, V, C, ("--model_name", name, *small), floor=2.0 / C))
        check(min(c[k] for k in KERNELS) > 0,
              f"{name} bypassed a kernel: {c}")
    phase_new_models(dev, V, C, small)
    return c2


def _at_least(counts, want, label):
    log(f"  ({label}: at least {want} required)")
    for k, n in want.items():
        check(counts[k] >= n, f"{label}: {k} launched {counts[k]} times, "
              f"{n} required")


def phase_new_models(dev, V, C, small):
    """Slice 4's paths: GAT and GCN at the default shape with a layerwise
    final test, ARMA (not served layerwise) batchwise at the small shape;
    each with its launch counts and final_valid above twice chance."""
    K1, K2, K3 = "sorted_segment_sum", "fused_gather_segment_sum", "gather_rows"
    WS = "weighted_segment_sum"
    steps = train_steps(V)
    per_layer = -(-V // LAYERWISE_CHUNK)
    lw = ("--final_test_mode", "layerwise")
    # per step: GAT the weighted sum once a hop (the message sum) and K3
    # once (features); GCN K1 once a hop forward and once backward (every
    # hop mirrored); layerwise: GAT the weighted sum and K3, GCN K2 and K3,
    # once per chunk and layer
    for name, want in (("GAT", {WS: 3 * steps + 3 * per_layer,
                                K3: steps + 3 * per_layer}),
                       ("GCN", {K1: 6 * steps, K2: 3 * per_layer,
                                K3: steps + 3 * per_layer})):
        _, c = driven(f"driver {name} (layerwise)", lambda: phase_driver(
            dev, V, C, ("--model_name", name, *lw), floor=2.0 / C))
        _at_least(c, want, f"{name}, {steps} train steps + {per_layer} "
                  f"chunks x 3 layers")
    batchwise = tuple(a for a in small if a not in lw)
    _, c = driven("driver ARMA (batchwise)", lambda: phase_driver(
        dev, V, C, ("--model_name", "ARMA", *batchwise), floor=2.0 / C))
    # K3: the features and ARMA's gather of each of its 2 hops
    _at_least(c, {K3: 3 * steps}, f"ARMA, {steps} train steps")


def phase_resume(dev, V=100_000, C=32):
    """The checkpoint drill through the driver CLI at the small shape
    (GCN: parameters, Adam state and BN statistics): 2 epochs into a job
    directory; then RESUME=1 with 3 epochs, which must start at the latest
    saved epoch + 1; then --do_test_run on that epoch, which must score
    valid above twice chance. K1 runs 4 times a step (2 hops, forward and
    mirrored backward), K3 once."""
    from salient_plusplus_tpu_torch import driver
    from salient_plusplus_tpu_torch.train import checkpoint as ckpt

    K1, K3 = "sorted_segment_sum", "gather_rows"
    steps = train_steps(V)
    with tempfile.TemporaryDirectory() as root:
        args = [f"synth:V={V},C={C},deg=12,F=64", "drill", "--output_root",
                root, "--model_name", "GCN", "--num_layers", "2",
                "--hidden_features", "128", "--train_fanouts", "10,5",
                "--batchwise_test_fanouts", "20,20", "--final_test_fanouts",
                "20,20", "--async_checkpoint", "true"]
        job = os.path.join(root, "drill")
        first, c = driven("resume drill, epochs 0-1", lambda: driver.main(
            args + ["--epochs", "2"], device=dev)[0])
        _at_least(c, {K1: 8 * steps, K3: 2 * steps}, f"2 x {steps} steps")
        saved = ckpt.latest_epoch(job, 0)
        check(saved is not None, "no checkpoint saved in 2 epochs")
        log(f"  epochs 0-1: losses={first['losses']} saved epochs "
            f"{sorted(f for f in os.listdir(job) if f.startswith('model_'))}"
            f" latest={saved} best={ckpt.best_epoch(job, 0)}")
        os.environ["RESUME"] = "1"
        try:
            second, c = driven("resume drill, RESUME=1", lambda: driver.main(
                args + ["--epochs", "3"], device=dev)[0])
        finally:
            del os.environ["RESUME"]
        left = 3 - (saved + 1)
        check(len(second["losses"]) == left,
              f"RESUME=1 ran {len(second['losses'])} epochs, {left} "
              f"expected after epoch {saved}")
        _at_least(c, {K1: 4 * steps * left, K3: steps * left},
                  f"{left} x {steps} steps")
        check(second["final_valid"] > 2.0 / C, "resumed run did not learn")
        log(f"  RESUME=1: started at epoch {saved + 1}, losses="
            f"{second['losses']} final_valid={second['final_valid']:.4f}")
        scored, c = driven("resume drill, --do_test_run", lambda: driver.main(
            args + ["--do_test_run", str(saved)], device=dev))
        check([s["epoch"] for s in scored] == [saved]
              and scored[0]["valid"] > 2.0 / C,
              f"--do_test_run {saved}: {scored}")
        check(c[K1] > 0 and c[K3] > 0, f"--do_test_run bypassed a kernel: {c}")
        log(f"  --do_test_run {saved}: {scored}")


# ---------------------------------------------------------------- phase 5
def model_trainer(base, model_name, dev, **over):
    """A trainer of ``model_name`` at the bench config (``over`` changed)
    on ``base``'s graph."""
    from salient_plusplus_tpu_torch.train.loop import Trainer

    return Trainer(base.cfg.replace(model_name=model_name, **over),
                   base.graph, device=dev)


def bench_trainer(dev, num_nodes=1_000_000):
    from salient_plusplus_tpu_torch.config import RunConfig
    from salient_plusplus_tpu_torch.data import synthetic
    from salient_plusplus_tpu_torch.train.loop import Trainer

    g = synthetic.powerlaw_graph(name="bench-products", num_nodes=num_nodes,
                                 avg_degree=15, num_features=100,
                                 num_classes=47, seed=0)
    cfg = RunConfig(num_workers=max(2, os.cpu_count() or 4), **BENCH_CFG)
    return Trainer(cfg, g, device=dev)


def phase_bench(trainer, dev, power, warmup=20, steps=40):
    from salient_plusplus_tpu_torch.train.pipeline import DeviceFeeder

    ts = trainer.train_sampler
    ts.set_epoch(trainer.shuffler.get_idx(1), 1)
    it = iter(ts)
    check(len(it) >= warmup + steps + 10, "bench epoch too short")
    feeder = DeviceFeeder(it, dev, depth=4)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(warmup):
        trainer.run_step(next(feeder))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    e0, b0, s0 = feeder.edges_fed, feeder.bytes_fed, feeder.starved_dur
    n0 = {k: w.launches for k, w in _wrappers().items()}
    cache = trainer._cold_cache
    c0 = (cache.hits, cache.misses) if cache is not None else None
    t0 = time.perf_counter()
    losses = [trainer.run_step(next(feeder)) for _ in range(steps)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    per_step = {k: (w.launches - n0[k]) / steps
                for k, w in _wrappers().items()}
    check(bool(torch.isfinite(torch.stack(losses)).all()),
          "bench losses are not finite")
    # fed counters run ahead of the steps by the prefetch depth; over a
    # steady window the offset cancels
    edges = feeder.edges_fed - e0
    st = it.stats
    res = dict(step_ms=dt / steps * 1e3, edges_per_s=edges / dt,
               pad_waste_nodes=st.node_waste(), pad_waste_edges=st.edge_waste(),
               tight_frac=st.tight_batches / max(st.batches, 1),
               h2d_bytes_per_batch=(feeder.bytes_fed - b0) / steps,
               starved_s=feeder.starved_dur - s0,
               launches_per_step=per_step,
               max_memory_allocated=(torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else None))
    if trainer.hot_cutoff is not None:
        res["cold_rows_per_batch"] = st.cold_rows / max(st.batches, 1)
        if cache is not None:
            h, m = cache.hits - c0[0], cache.misses - c0[1]
            res["cache_hit_rate"] = h / max(h + m, 1)
    log("  bench: " + json.dumps(res) + f"  [{power}]")
    if dev.type == "cuda":
        res["profile"] = profile_window(
            lambda: trainer.run_step(next(feeder)), 10, "steps", power)
    it.close()
    return res


def profile_window(work, steps, unit, power):
    """Where the device time of ``steps`` calls of ``work`` (a bench-shape
    step, a layerwise layer) goes, under torch.profiler. Device intervals
    (kernels and copies, on every stream) are merged into the busy time;
    the window runs from the first one's start to the last one's end, so
    idle = 1 - busy / window. The profiler slows the host, so the idle
    share is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            work()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    ivs, by_name = [], {}
    for e in prof.events():
        # user annotations (e.g. "Optimizer.step") span other device events
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            ivs.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
    if not ivs:
        log(f"  profile: no device time recorded ({steps} {unit}, "
            f"{wall_ms:.1f} ms on the host clock)")
        return None
    ivs.sort()
    busy, (s0, e0) = 0.0, ivs[0]
    for s, e in ivs[1:]:
        if s > e0:
            busy += e0 - s0
            s0, e0 = s, e
        else:
            e0 = max(e0, e)
    busy += e0 - s0
    window = max(e for _, e in ivs) - ivs[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    u = unit[:-1]
    log(f"  profile ({steps} {unit}, host clock {wall_ms / steps:.3f} "
        f"ms/{u} under the profiler): device window "
        f"{window / steps / 1e3:.3f} ms/{u}, busy {busy / steps / 1e3:.3f} "
        f"ms/{u}, idle share {1 - busy / window:.3f}, "
        f"{len(ivs) / steps:.0f} device events/{u}  [{power}]")
    for name, us in top:
        log(f"    {us / steps / 1e3:8.4f} ms/{u}  {us / busy:6.1%}  "
            f"{name[:100]}")
    return dict(busy_ms=busy / steps / 1e3, window_ms=window / steps / 1e3,
                idle_share=1 - busy / window)


def phase_layerwise_bench(trainer, dev, power):
    """Layerwise inference of the bench trainer's SAGE (full width: 128 in,
    256 hidden, 47 out, 3 layers, bf16) over the whole 1M-node graph:
    seconds per layer, nodes/s, launches (one K2 and one K3 per chunk and
    layer), peak device memory; then one layer under torch.profiler."""
    from salient_plusplus_tpu_torch.models.inference import (
        LocalEngine, run_layerwise_zoo)

    class TimedEngine(LocalEngine):
        def propagate(self, core, emb, feat_out):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super().propagate(core, emb, feat_out)
            torch.cuda.synchronize()
            self.layer_s.append(time.perf_counter() - t0)
            self.calls.append((core, emb, feat_out))
            return out

    g, model = trainer.graph, trainer.state.model
    t0 = time.perf_counter()
    eng = TimedEngine(g.rowptr, g.col, LAYERWISE_CHUNK, dev)
    eng.layer_s, eng.calls = [], []
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    logp, counts = driven("layerwise inference (bench graph)",
                          lambda: run_layerwise_zoo("SAGE", model,
                                                    trainer.features, eng))
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    V, L = g.num_nodes, model.num_layers
    chunks = -(-V // LAYERWISE_CHUNK)
    check(logp.shape == (V, g.num_classes), f"layerwise shape {logp.shape}")
    check(bool(torch.isfinite(logp).all()), "layerwise output not finite")
    for k in ("fused_gather_segment_sum", "gather_rows"):
        check(counts[k] == chunks * L, f"{k}: {counts[k]} launches, "
              f"{chunks} chunks x {L} layers expected")
    res = dict(V=V, chunks_per_layer=chunks, edge_cap=eng.spec.edge_caps[0],
               engine_setup_s=setup_s, layer_s=eng.layer_s, total_s=total_s,
               nodes_per_s=V / total_s, launches=counts,
               max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    log("  layerwise bench: " + json.dumps(res) + f"  [{power}]")
    core, emb, feat_out = eng.calls[1]   # hidden to hidden, 256 wide
    model.eval()
    with torch.no_grad():
        profile_window(lambda: LocalEngine.propagate(eng, core, emb,
                                                     feat_out),
                       1, "layers", power)
    model.train()
    return res


# ---------------------------------------------------------------- phase 6
def phase_card_vs_cpu(dev, V=100_000, C=32, model_name="SAGE",
                      dtype=torch.bfloat16):
    """One train step of ``model_name`` at the default shape from the same
    weights and batch on ``dev`` (kernels) and on the CPU (plain
    versions), dropout 0; SAGE with layer 0 from the table (gsrc), GCN
    with every hop mirrored, as the trainer runs them. Stated tolerance:
    in bf16, which rounds differently in the two matmul backends, the loss
    must agree within 1e-2 and each gradient within 5e-2 relative
    (Frobenius) error; in float32 (TF32 off: summation order only) within
    1e-4 and 1e-3. Returns the loss difference."""
    from salient_plusplus_tpu_torch.data import synthetic
    from salient_plusplus_tpu_torch.data.dataset import pad_feature_dim
    from salient_plusplus_tpu_torch.models import (
        make_model, mirror_all_specs, model_class)
    from salient_plusplus_tpu_torch.sampling.cpp import (
        BatchBuffers, NativeSampler)
    from salient_plusplus_tpu_torch.sampling.sampler import FastSamplerConfig
    from salient_plusplus_tpu_torch.train.loop import calibrate_spec
    from salient_plusplus_tpu_torch.train.state import TrainState
    from salient_plusplus_tpu_torch.train.step import train_step

    g = synthetic.planted_partition(name="cmp", num_nodes=V, num_classes=C,
                                    avg_degree=12, num_features=64, seed=0)
    native = NativeSampler(g.rowptr, g.col)
    pool = g.split_idx["train"]
    spec = calibrate_spec(native, pool, 1024, [15, 10, 5], num_batches=4)
    spec = mirror_all_specs(model_name, spec)[0]
    gsrc = model_class(model_name).reads_table_at_layer0
    cfg = FastSamplerConfig(spec=spec, batch_size=1024, emit_gsrc=gsrc,
                            compress_dst=True, pack_wire=True)
    bufs = BatchBuffers(spec)
    bufs.attach_from_config(cfg, g.num_nodes)
    native.sample_into(bufs, np.sort(pool[:1024]), rng_seed=3,
                       y_global=np.asarray(g.y, np.int32))
    bufs.finalize_from_config(cfg)
    batch = bufs.to_padded_batch()
    feats = torch.from_numpy(pad_feature_dim(
        np.asarray(g.x, np.float32))).to(dtype)
    model = make_model(model_name, feats.shape[1], 256, C, 3, dropout=0.0,
                       dtype=dtype, generator=torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    out = {}
    for d in (torch.device("cpu"), dev):
        m = make_model(model_name, feats.shape[1], 256, C, 3, dropout=0.0,
                       dtype=dtype)
        m.load_state_dict(sd)
        st = TrainState(m.to(d), 0.003, seed=0, device=d)
        loss = train_step(st, feats.to(d), batch.to(d), global_msg0=gsrc)
        out[d.type] = (float(loss), {k: p.grad.detach().float().cpu()
                                     for k, p in m.named_parameters()})
    (lc, gc), (lg, gg) = out["cpu"], out[dev.type]
    loss_tol, grad_tol = (1e-2, 5e-2) if dtype == torch.bfloat16 else (
        1e-4, 1e-3)
    log(f"  {model_name} {str(dtype)[6:]} loss cpu={lc:.6f} card={lg:.6f} "
        f"|diff|={abs(lc - lg):.3g} (stated {loss_tol})")
    check(abs(lc - lg) < loss_tol, f"loss differs: cpu {lc} card {lg}")
    for k in gc:
        rel = float((gg[k] - gc[k]).norm() / gc[k].norm().clamp_min(1e-12))
        log(f"  {model_name} grad {k}: rel Frobenius err {rel:.3g}")
        check(rel < grad_tol, f"{model_name} gradient {k} differs: rel err "
              f"{rel}")
    return abs(lc - lg)


def phase_layerwise_card_vs_cpu(dev, V=20_000):
    """Layerwise inference of SAGE at full width (128 in, 256 hidden, 47
    out, 3 layers) on a 20k-node power-law graph, on the card (K2, K3) and
    on the CPU (plain versions), from the same weights. float32 with TF32
    off, so both compute the same products and differ only in summation
    order: each log-probability may differ by 1e-3 at most."""
    from salient_plusplus_tpu_torch.data import synthetic
    from salient_plusplus_tpu_torch.data.dataset import pad_feature_dim
    from salient_plusplus_tpu_torch.models import make_model
    from salient_plusplus_tpu_torch.models.inference import (
        layerwise_inference)

    g = synthetic.powerlaw_graph(name="lw-cmp", num_nodes=V, avg_degree=15,
                                 num_features=100, num_classes=47, seed=1)
    x = torch.from_numpy(pad_feature_dim(np.asarray(g.x, np.float32)))
    model = make_model("SAGE", x.shape[1], 256, 47, 3, dtype=torch.float32,
                       generator=torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    out = {}
    for d in (torch.device("cpu"), dev):
        m = make_model("SAGE", x.shape[1], 256, 47, 3, dtype=torch.float32)
        m.load_state_dict(sd)
        out[d.type] = layerwise_inference("SAGE", m.to(d), g.rowptr, g.col,
                                          x.to(d)).cpu()
    err = float((out["cpu"] - out[dev.type]).abs().max())
    agree = float((out["cpu"].argmax(-1) == out[dev.type].argmax(-1))
                  .float().mean())
    log(f"  layerwise card vs cpu (V={V}, f32): max |d logp| {err:.3g}, "
        f"argmax agreement {agree:.6f}")
    check(err <= 1e-3, f"layerwise card vs cpu: max error {err}")


# ---------------------------------------------------------------- phase 7
COLD_FRACTION = 0.5


def cold_trainer(base, dev, **kw):
    """A trainer of ``base``'s config and graph at hbm_fraction 0.5 (the
    host cold tier), with ``kw`` on top."""
    from salient_plusplus_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    tr = Trainer(base.cfg.replace(hbm_fraction=COLD_FRACTION, **kw),
                 base.graph, device=dev)
    cache = tr._cold_cache
    log(f"  cold trainer {kw} built in {time.perf_counter() - t0:.1f} s: "
        f"hot_cutoff={tr.hot_cutoff} cold_cap={tr.train_sampler.cfg.cold_cap}"
        f" slack={tr._slack} gsrc={tr._gsrc_cold} "
        f"cache_slots={None if cache is None else cache.slots} x_cold "
        f"{tr.x_cold.dtype} {tr.x_cold.shape}")
    return tr


def phase_cold_overlay(base, dev, power):
    """K1 as the cold overlay (its caller in ``gather_features`` under
    ``--gsrc_mode off``): one bench-shape batch at hbm_fraction 0.5; the
    frontier gather (K3 over the hot prefix, then K1 placing the cold rows)
    against the CPU's plain version and the all-in-memory gather
    ``features_full[n_id]``, bit for bit; K1 against its plain version,
    exact (one row a segment); then K1's time, the plain version's, the
    library call's for this caller (``index_copy_`` of the real cold rows
    into x) and the whole overlay's (K1, the presence mask and the
    select), beside two bounds: K1's own (the real rows and their ids
    read, the [T, F] f32 output written) and the overlay's work (the real
    rows read and written once)."""
    from salient_plusplus_tpu_torch.ops.sorted_segment import (
        _sorted_degrees, _sorted_segment_sum_plain, sorted_segment_sum_mxu)
    from salient_plusplus_tpu_torch.train.step import (_cold_rows,
                                                       gather_features)

    tr = cold_trainer(base, dev, gsrc_mode="off")
    batch = bench_batch(tr, dev)
    K1 = sorted_segment_sum_mxu
    wrappers = _wrappers()
    n0 = {k: w.launches for k, w in wrappers.items()}
    x = gather_features(tr.features, batch)
    torch.cuda.synchronize()
    got = {k: w.launches - n0[k] for k, w in wrappers.items()}
    check(got == {"sorted_segment_sum": 1, "fused_gather_segment_sum": 0,
                  "gather_rows": 1, "weighted_segment_sum": 0},
          f"overlay gather launches {got}")
    x_cpu = gather_features(tr.features.cpu(), batch.to("cpu"))
    full = base.features.index_select(0, batch.n_id.long())
    bits = lambda t: t.view(torch.int16)  # noqa: E731
    check(torch.equal(bits(x).cpu(), bits(x_cpu)),
          "overlay on the card differs from the CPU's plain version")
    check(torch.equal(bits(x), bits(full)),
          "overlay differs from the all-in-memory gather")
    rows, pos = _cold_rows(batch, x.dtype), batch.cold_pos
    T, (E, F) = x.shape[0], rows.shape
    n = int(batch.cold_count)
    placed = K1(rows, pos, T)
    check(torch.equal(placed, _sorted_segment_sum_plain(rows, pos, T)),
          "K1 placement differs from its plain version")
    hot = tr.features
    x0 = hot.index_select(0, batch.n_id.clamp(max=hot.shape[0] - 1))

    def overlay():
        mask = _sorted_degrees(pos, T) > 0
        return torch.where(mask[:, None], K1(rows, pos, T).to(x0.dtype), x0)

    check(torch.equal(bits(overlay()), bits(full)), "timed overlay differs")
    ms = cuda_ms(lambda: K1(rows, pos, T))
    plain_ms = cuda_ms(lambda: _sorted_segment_sum_plain(rows, pos, T))
    scratch, idx, real = x0.clone(), pos[:n].long(), rows[:n]
    lib = cuda_ms(lambda: scratch.index_copy_(0, idx, real))
    check(torch.equal(bits(scratch), bits(full)), "index_copy_ differs")
    overlay_ms = cuda_ms(overlay)
    k1_bytes = n * F * 2 + 4 * n + T * F * 4
    work_bytes = 2 * n * F * 2
    tight = batch.spec == tr.train_tight
    res = dict(ms=ms, plain_ms=plain_ms, library_ms=lib,
               bound_ms=_ms_of_bytes(k1_bytes), overlay_ms=overlay_ms,
               overlay_bound_ms=_ms_of_bytes(work_bytes), E=E, n=n, T=T,
               F=F, bucket="tight" if tight else "full")
    log(f"  K1 cold overlay (gsrc off, hbm_fraction {COLD_FRACTION}): E={E} "
        f"(cold_cap) real={n} T={T} ({res['bucket']} bucket) F={F} bf16: "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"index_copy_ms={lib:.4f} K1_bound_us={res['bound_ms'] * 1e3:.2f} "
        f"({k1_bytes} B) overlay_ms={overlay_ms:.4f} (K1 + mask + select "
        f"over the gathered frontier) overlay_work_bound_us="
        f"{res['overlay_bound_ms'] * 1e3:.2f} ({work_bytes} B) "
        f"{shares(ms, lib, res['bound_ms'])}; bit-identical to the plain "
        f"version and to features_full[n_id]  [{power}]")
    del tr, batch
    return res


def phase_cold_bit_equal(full, cold, dev, steps=20):
    """``steps`` train steps of epoch 0 from fresh weights (the same seed)
    at hbm_fraction 1.0 and 0.5 on the card: the losses must be equal bit
    for bit (every op of the path is deterministic: K1 and K2 by design,
    K3 a copy, the slack write a copy, the GEMMs)."""
    from salient_plusplus_tpu_torch.train.pipeline import DeviceFeeder

    out = []
    for tr in (full, cold):
        tr.reset()
        ts = tr.train_sampler
        ts.set_epoch(tr.shuffler.get_idx(0), 0)
        it = iter(ts)
        feeder = DeviceFeeder(it, dev, depth=4)
        out.append(torch.stack([tr.run_step(next(feeder))
                                for _ in range(steps)]).cpu())
        it.close()
    same = out[0] == out[1]
    first = int((~same).nonzero()[0]) if not bool(same.all()) else None
    log(f"  {steps} SAGE steps at hbm_fraction 1.0 and {COLD_FRACTION}: "
        f"losses {'bit-identical' if first is None else 'DIFFER'} "
        f"(first {out[0][0].item():.9f}, last {out[0][-1].item():.9f})")
    if first is not None:
        check(False, f"losses differ from step {first}: "
              f"{out[0][first].item()!r} vs {out[1][first].item()!r}")


def pinned_cold_bytes(tr):
    """(sets, bytes): the pinned host bytes of the cold buffers of one
    epoch's buffer pool, sets x cold_cap x (row + position [+ fp8
    scale]), at the current epoch's length."""
    cfg = tr.train_sampler.cfg
    pool = min(cfg.max_batches_in_flight + cfg.num_workers,
               max(2, len(tr.train_sampler) + 1))
    row = tr.x_cold.shape[1] * tr.x_cold.itemsize + 4
    if tr.x_cold_scale is not None:
        row += 4
    cap = cfg.cold_cap if tr._cold_cache is None else max(cfg.cold_cap, 128)
    return pool, pool * cap * row


def phase_cold_bench(base, dev, power, full_res, **bench_kw):
    """SAGE at the bench shape with the cold tail in host RAM
    (hbm_fraction 0.5), three variants: plain gsrc cold (rows written
    into the slack), a cold-row cache of about a quarter of the tail, and
    the fp8 tail; each with phase 5's figures, beside the 1.0 run's. Also
    the link credit probe, the plan cold_cache_slots -1 would choose, the
    pinned bytes of the buffer pool, the fp8 decode on the card against
    the CPU's, and the 20-step bit-equality against 1.0."""
    from salient_plusplus_tpu_torch.parallel.exchange import fp8_decode_rows
    from salient_plusplus_tpu_torch.train.cold_policy import (
        measure_h2d_credit)

    V = base.graph.num_nodes
    tail = V - int(V * COLD_FRACTION)
    quarter = -(-tail // 4 // 128) * 128
    out = {}
    for label, kw in (("gsrc cold", {}),
                      ("cache 1/4 tail", {"cold_cache_slots": quarter}),
                      ("fp8", {"cold_fp8": True})):
        log(f"  SAGE at the bench shape, hbm_fraction {COLD_FRACTION}, "
            f"{label}:")
        tr = cold_trainer(base, dev, **kw)
        if label == "gsrc cold":
            credit = measure_h2d_credit(dev)
            log(f"  measure_h2d_credit: {credit:.1f} MB/s (best of 3 "
                f"pinned 32 MB bursts)  [{power}]")
            slots = tr._plan_cold_cache(base.graph.split_idx["train"],
                                        tr.train_sampler.cfg.cold_cap, V)
            p = tr.cold_plan
            log(f"  cold_cache_slots -1 would choose {slots} slots: demand "
                f"{p.projected_demand_mbs} MB/s, residual "
                f"{p.residual_demand_mbs} MB/s, credit {p.credit_mbs:.1f} "
                f"MB/s ({p.reason})")
            phase_cold_bit_equal(base, tr, dev)
        if label == "fp8":
            pay = torch.from_numpy(tr.x_cold[:200_000])
            sc = torch.from_numpy(tr.x_cold_scale[:200_000])
            check(torch.equal(fp8_decode_rows(pay.to(dev), sc.to(dev)).cpu(),
                              fp8_decode_rows(pay, sc)),
                  "fp8 decode on the card differs from the CPU's")
            log("  fp8 decode of 200,000 cold rows on the card: "
                "bit-identical to the CPU's")
        res = phase_bench(tr, dev, power, **bench_kw)
        sets, nbytes = pinned_cold_bytes(tr)
        log(f"  pinned cold buffers of the pool: {sets} sets x cold_cap "
            f"{tr.train_sampler.cfg.cold_cap} rows = {nbytes} B")
        steps = res["launches_per_step"]
        check(steps == {"sorted_segment_sum": 4,
                        "fused_gather_segment_sum": 1, "gather_rows": 1,
                        "weighted_segment_sum": 0},
              f"cold bench step launches {steps}: K1 4, K2 1, K3 1 expected")
        prof, fprof = res.get("profile") or {}, full_res.get("profile") or {}
        log(f"  [{label} vs 1.0] step_ms {res['step_ms']:.3f} vs "
            f"{full_res['step_ms']:.3f}; edges/s {res['edges_per_s']:.4g} vs "
            f"{full_res['edges_per_s']:.4g}; H2D MB/batch "
            f"{res['h2d_bytes_per_batch'] / 1e6:.3f} vs "
            f"{full_res['h2d_bytes_per_batch'] / 1e6:.3f}; cold rows/batch "
            f"{res['cold_rows_per_batch']:.1f}; cache hit rate "
            f"{res.get('cache_hit_rate')}; device busy ms "
            f"{prof.get('busy_ms')} vs {fprof.get('busy_ms')}; idle share "
            f"{prof.get('idle_share')} vs {fprof.get('idle_share')}; "
            f"launches/step {steps}  [{power}]")
        out[label] = res
        del tr
    return out


def phase_cold_drivers(dev, V=100_000, C=32):
    """The driver CLI at --hbm_fraction 0.5 on the small planted graph,
    one epoch each, final_valid at least 0.9: SAGE under the cache policy
    (-1: it plans 0 slots where the link keeps up, so this is the plain
    batchwise run), SAGE with a layerwise final test (which falls back to
    batchwise and says so), GCN (K1 also places the cold rows: 6 + 1 a
    step), the cold-row cache with the folded update, the fp8 tail with
    collect_data, and FastPreSampler; then OracleSampler (hbm_fraction 1,
    2 layers, fanouts 5,3: the numpy oracle samples in Python)."""
    K1, K2, K3 = "sorted_segment_sum", "fused_gather_segment_sum", "gather_rows"
    steps = train_steps(V)
    cold = ("--hbm_fraction", str(COLD_FRACTION))
    sage = {K1: 4 * steps, K2: steps, K3: steps}

    def logged(*words):
        def inspect(root):
            text = "".join(open(p).read() for p in glob.glob(
                os.path.join(root, "smoke", "*_logs.txt")))
            for word in words:
                check(word in text, f"{word} not in the run's log")
                log(f"  ({word} logged)")
        return inspect

    def dumps(root):
        files = glob.glob(os.path.join(root, "collected_data_*", "epoch0",
                                       "*.npz"))
        check(len(files) == 4, f"collect_data wrote {len(files)} dumps")
        log(f"  (collect_data: {len(files)} dumps)")

    runs = [
        ("SAGE, cache policy", ("--cold_cache_slots", "-1"), sage,
         logged("COLD_CACHE_PLAN")),
        ("SAGE layerwise", ("--final_test_mode", "layerwise"), sage,
         logged("LAYERWISE_NEEDS_FULL_HBM_FALLBACK")),
        ("GCN", ("--model_name", "GCN"), {K1: 7 * steps, K3: steps}, None),
        ("cache 4096 + fold", ("--cold_cache_slots", "4096",
                               "--cold_fold_update", "true"), sage,
         logged("COLD_CACHE")),
        ("fp8 + collect_data", ("--cold_fp8", "true", "--collect_data",
                                "true"), sage, dumps),
        ("FastPreSampler", ("--train_sampler", "FastPreSampler"), sage, None),
    ]
    for label, extra, want, inspect in runs:
        _, c = driven(f"driver cold {label}", lambda: phase_driver(
            dev, V, C, cold + extra, floor=0.9, inspect=inspect))
        _at_least(c, want, f"cold {label}, {steps} train steps")
    small = ("--num_layers", "2", "--hidden_features", "128",
             "--train_fanouts", "5,3", "--batchwise_test_fanouts", "20,20",
             "--final_test_fanouts", "20,20")
    _, c = driven("driver OracleSampler", lambda: phase_driver(
        dev, V, C, ("--train_sampler", "OracleSampler") + small, floor=0.9))
    check(c[K3] >= steps, f"OracleSampler bypassed K3: {c}")


# ---------------------------------------------------------------- phase 8
SIM_SPEC = "synth:V=100000,C=32,deg=12,F=64"


def phase_vip_device(g, dev, power, parts=4):
    """``vip_analytical_device`` on ``dev`` over the bench graph, 4
    partitions of ``contiguous_partition`` (their quality does not matter
    to the timing), at the bench batch and fanouts; every partition's
    weights held to the numpy float64 recurrence within the JAX suite's
    tolerance (rtol 5e-3, atol 5e-5)."""
    from salient_plusplus_tpu_torch.caching import vip
    from salient_plusplus_tpu_torch.partition import contiguous_partition

    fanouts, mb = BENCH_CFG["train_fanouts"], BENCH_CFG["train_batch_size"]
    labels = contiguous_partition(g.num_nodes, parts)
    tipp = vip.partitionwise_train_idx(labels, g.split_idx["train"])
    vip.vip_analytical_device(g.rowptr, g.col, tipp[:1], mb, fanouts,
                              device=dev)  # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    got = vip.vip_analytical_device(g.rowptr, g.col, tipp, mb, fanouts,
                                    device=dev)  # ends in a copy to host
    dt = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    t0 = time.perf_counter()
    ref = vip.vip_analytical(g.rowptr, g.col, tipp, mb, fanouts)
    dt_np = time.perf_counter() - t0
    err = 0.0
    for p, (a, b) in enumerate(zip(got, ref)):
        bad = np.abs(a - b) > 5e-5 + 5e-3 * np.abs(b)
        check(not bad.any(), f"VIP partition {p}: {int(bad.sum())} weights "
              f"outside rtol 5e-3 / atol 5e-5 of numpy")
        err = max(err, float(np.abs(a - b).max()))
    E, L = g.num_edges, len(fanouts)
    log(f"  VIP on {dev.type}: V={g.num_nodes} E={E} {parts} partitions x "
        f"{L} hops: {dt * 1e3 / parts:.1f} ms/partition (host clock, "
        f"upload and copy-back included), {E * L * parts / dt:.4g} edges/s, "
        f"peak memory {peak}; numpy float64 {dt_np * 1e3 / parts:.1f} "
        f"ms/partition; max |card - numpy| {err:.3g}  [{power}]")


def phase_partitioned_driver(dev, C=32, spec=SIM_SPEC, extra=()):
    """The offline pipeline, then the driver on its output: partition.cli
    writes ``<name>-reordered-k4`` of the 100k-node planted graph into a
    temp root, and the driver trains SAGE one epoch from it on ``dev``,
    batchwise final test; final_valid above chance (phase 4's floor) and
    K1, K2, K3 each launched."""
    from salient_plusplus_tpu_torch import driver
    from salient_plusplus_tpu_torch.partition import cli

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        path = cli.main([spec, "--parts", "4", "--out_root", root])
        log(f"  partition.cli: {time.perf_counter() - t0:.1f} s, wrote "
            f"{sorted(os.listdir(path))}")
        out, c = driven("driver on the partitioned dataset", lambda:
                        driver.main([os.path.basename(path), "smoke",
                                     "--dataset_root", root, "--epochs", "1",
                                     "--output_root", root, *extra],
                                    device=dev))
    r = out[0]
    log(f"  driver on {os.path.basename(path)}: losses={r['losses']} "
        f"final_valid={r['final_valid']:.4f} final_test="
        f"{r['final_test']:.4f} epoch_s={r['epoch_times']}")
    check(all(np.isfinite(r["losses"])), "losses are not finite")
    check(r["final_valid"] > 1.0 / C, f"final_valid {r['final_valid']} is "
          f"not above chance")
    check(min(c[k] for k in KERNELS) > 0,
          f"the partitioned run bypassed a kernel: {c}")


def phase_simulation(step_s, spec=SIM_SPEC):
    """--execution_mode communication_simulation through the driver CLI on
    the 100k-node graph (SIM_PARTS 4, host only), with the default
    --cache_strategy vip and with simulation; the accounting identity on
    every row. Then comm_budget.measure_budget on that graph at world 4
    against the measured SAGE step ``step_s`` (phase 5)."""
    from salient_plusplus_tpu_torch import driver
    from salient_plusplus_tpu_torch.caching import comm_budget
    from salient_plusplus_tpu_torch.config import RunConfig
    from salient_plusplus_tpu_torch.partition import multiconstraint_partition

    with tempfile.TemporaryDirectory() as root:
        for strategy in ("vip", "simulation"):
            t0 = time.perf_counter()
            res = driver.main([spec, "sim", "--execution_mode",
                               "communication_simulation", "--cache_strategy",
                               strategy, "--output_root", root])
            for scheme, by_alpha in res.items():
                for alpha, d in by_alpha.items():
                    check(d["total"] == d["internal"] + d["cross"]
                          + d["cache_hits"] and d["total"] > 0,
                          f"{scheme} {alpha}: identity broken: {d}")
            log(f"  simulation --cache_strategy {strategy}: schemes "
                f"{list(res)}, identity holds on every row, "
                f"{time.perf_counter() - t0:.1f} s")
    g = driver.load_dataset(RunConfig(), spec)
    labels = multiconstraint_partition(g.rowptr, g.col, 4, seed=0)
    t0 = time.perf_counter()
    rows = comm_budget.measure_budget(g, labels, step_time_s=step_s)
    log(f"  comm budget, world 4, step {step_s * 1e3:.3f} ms (phase 5), "
        f"published link peaks {comm_budget.LINK_RATES} B/s, "
        f"{time.perf_counter() - t0:.1f} s:")
    for r in rows:
        log(f"    alpha={r.alpha:.2f} r_cap={r.r_cap} wire_bytes/step="
            f"{r.wire_bytes_per_step} comm_share_nvlink="
            f"{r.comm_share_nvlink} comm_share_nic={r.comm_share_nic} "
            f"sim_cross/batch={r.sim_cross_per_batch}")
    check(rows[-1].r_cap <= rows[0].r_cap, "caching grew r_cap")


def exchange_cases(table, n_id, count, offs, rank, dev, hot, r_cap,
                   power=None):
    """``assemble_features`` in the default group, rank ``rank`` owning
    rows [offs[rank], offs[rank+1]) of ``table`` (the full table, which
    every rank holds here only to build the expected rows): plain, with a
    DeviceCache of every 7th id of the other partitions, with the fp8
    wire, and with a hot prefix of ``hot`` rows. Each result must equal
    ``table[n_id]`` bit for bit (zero past ``count`` and past the hot
    prefix; remote rows of the fp8 wire equal to the CPU's fp8 codec round
    trip), and K3 must launch 2 times a call (3 with the cache). With
    ``power``, the calls are timed."""
    from salient_plusplus_tpu_torch.ops.pallas_gather import (
        pallas_gather_rows)
    from salient_plusplus_tpu_torch.parallel.exchange import (
        DeviceCache, assemble_features, fp8_wire_decode, fp8_wire_encode)

    world = len(offs) - 1
    lo, hi = int(offs[rank]), int(offs[rank + 1])
    offs_t = torch.tensor(offs, dtype=torch.int64, device=dev)
    ids = n_id.long()
    real = torch.arange(ids.shape[0], device=dev) < count
    want = torch.where(real[:, None], table[ids], 0)
    local = (ids >= lo) & (ids < hi)
    codec = fp8_wire_decode(fp8_wire_encode(want.cpu()), table.dtype)
    owner = torch.searchsorted(offs_t[1:], ids, right=True).clamp(
        max=world - 1)
    cached_ids = torch.cat([torch.arange(int(offs[p]), int(offs[p + 1]), 7,
                                         device=dev)
                            for p in range(world) if p != rank or world == 1])
    cache = DeviceCache(cached_ids, table[cached_ids].contiguous())
    cases = [
        ("plain", table[lo:hi], {}, want, 2),
        ("cache", table[lo:hi], {"cache": cache}, want, 3),
        ("fp8", table[lo:hi], {"wire_fp8": True},
         torch.where(local[:, None], want, codec.to(dev)), 2),
        ("hot", table[lo:lo + hot].contiguous(), {"hot_size": hot},
         torch.where(((ids - offs_t[owner]) < hot)[:, None], want, 0), 2),
    ]
    for label, shard, kw, expect, k3 in cases:
        before = pallas_gather_rows.launches
        x, st = assemble_features(shard, n_id, count, offs_t, r_cap, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        k3_calls = pallas_gather_rows.launches - before
        check(dev.type != "cuda" or k3_calls == k3,
              f"exchange {label}: K3 launched {k3_calls} times, {k3} "
              f"expected")
        check(torch.equal(x, expect),
              f"exchange {label} (rank {rank}/{world}): not equal to "
              f"table[n_id] bit for bit")
        stats = {k: float(v) for k, v in st._asdict().items()}
        check(stats["num_overflow"] == 0, f"exchange {label}: overflow")
        # ~30 small ops and 2 collectives a call: let the device sleep
        # through 3 ms of enqueueing a call
        ms = (cuda_ms(lambda: assemble_features(shard, n_id, count, offs_t,
                                                r_cap, **kw),
                      host_ms=3.0)
              if power is not None else None)
        log(f"  exchange {label} rank {rank}/{world} ({str(table.dtype)[6:]}"
            f", N_cap {ids.shape[0]}, count {int(count)}, r_cap {r_cap}): "
            f"equal to table[n_id]; K3 {k3_calls} a call; stats {stats}"
            + (f"; {ms:.4f} ms a call  [{power}]" if ms is not None else ""))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _exchange_rank(rank, port, world, V, F, n):
    """One rank of the multi-GPU leg: the same random table on every rank
    (a seeded generator on its own card), 2 partitions, its own ids."""
    import torch.distributed as dist

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        gen = torch.Generator(device=dev).manual_seed(0)
        table = torch.randn(V, F, generator=gen, device=dev).to(
            torch.bfloat16)
        rng = np.random.default_rng(rank)
        n_id = torch.from_numpy(rng.integers(0, V, n + n // 8).astype(
            np.int32)).to(dev)
        offs = [V * p // world for p in range(world + 1)]
        exchange_cases(table, n_id, torch.tensor(n, device=dev), offs, rank,
                       dev, hot=V // (2 * world), r_cap=n)
    finally:
        dist.destroy_process_group()


def phase_exchange(g, spec, dev, power):
    """The exchange in a world-1 group (NCCL on the card, gloo on the
    CPU) over the bench graph's table in bf16 and one bench-shape batch's
    frontier: every id is local, so each case must return table[n_id]
    exactly; the fp8 wire codec on the card against the CPU's; then, where
    the host has 2 cards, a 2-rank NCCL run of the same checks over 2
    partitions."""
    import torch.distributed as dist

    from salient_plusplus_tpu_torch.parallel.exchange import (
        _fp8_wire_exchange, fp8_wire_decode, fp8_wire_encode)
    from salient_plusplus_tpu_torch.sampling.cpp import NativeSampler

    native = NativeSampler(g.rowptr, g.col)
    seeds = np.sort(np.random.default_rng(8).choice(
        g.split_idx["train"], spec.seed_cap, replace=False))
    b = native.sample(spec, seeds, rng_seed=8)
    n_id = b.n_id.to(dev)
    count = b.level_sizes[-1].to(dev)
    table = torch.from_numpy(np.asarray(g.x)).to(dev).to(torch.bfloat16)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, rank=0, world_size=1,
                            init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        exchange_cases(table, n_id, count, [0, g.num_nodes], 0, dev,
                       hot=g.num_nodes // 2, r_cap=128, power=power)
        rows = table[n_id.long()[:int(count)]].view(1, -1, table.shape[1])
        via = _fp8_wire_exchange(rows)
        on_cpu = fp8_wire_decode(fp8_wire_encode(rows.cpu()), rows.dtype)
        check(torch.equal(via.cpu(), on_cpu), "fp8 wire through "
              f"{backend} differs from the CPU codec round trip")
        log(f"  fp8 wire through {backend}, {rows.shape[1]} rows: equal to "
            f"the CPU codec round trip bit for bit")
    finally:
        dist.destroy_process_group()
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n_dev < 2:
        log(f"  multi-GPU exchange leg not run: device_count={n_dev}")
        return
    import torch.multiprocessing as mp

    ctx = mp.spawn(_exchange_rank, args=(_free_port(), 2, 1_000_000, 100,
                                         200_000),
                   nprocs=2, join=False)
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=1):
        check(time.monotonic() < deadline, "2-rank exchange: no end in 300 s")
    log("  multi-GPU exchange leg: 2 ranks, NCCL, every case equal")


# ---------------------------------------------------------------- phase 9
def dist_trainer(g, dev, group=None, **over):
    """A DistributedTrainer of one partition (every label 0) of ``g`` at
    the bench config, ``over`` replacing config fields."""
    from salient_plusplus_tpu_torch.config import RunConfig
    from salient_plusplus_tpu_torch.train.dist_loop import DistributedTrainer

    cfg = RunConfig(**{**BENCH_CFG, "num_workers": max(2, os.cpu_count()
                                                        or 4), **over})
    return DistributedTrainer(cfg, g, np.zeros(g.num_nodes, np.int32),
                              group=group, device=dev)


def dist_steps(tr, steps, warmup=0):
    """``steps`` steps of epoch 1 after ``warmup`` ones: (losses, the
    sampler's edges fed to the timed ones, the feed, the feeder)."""
    feed, feeder = tr.epoch_feed(1)
    check(len(feed) >= warmup + steps, "distributed epoch too short")
    for _ in range(warmup):
        tr.run_step(next(feeder))
    e0 = feeder.edges_fed
    losses = [tr.run_step(next(feeder))[0] for _ in range(steps)]
    return losses, feeder.edges_fed - e0, feed, feeder


def _stage_marks(feed, feeder) -> dict:
    """The data-parallel trainer's host stages so far (the sums that
    ``train/dist_loop.py::train_epoch`` records), and the feed's
    starvation."""
    return dict(feed.stages(feeder), feed_starved=feeder.starved_dur)


def _steps_ms(tr, feeder, dev, steps):
    """ms a step of ``steps`` data-parallel steps on the host clock."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        tr.run_step(next(feeder))
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / steps * 1e3


HB_TURN_TIMEOUT_S = 3.0   # the heartbeat of phase 9's on turns


def phase_dist_bench(tr, dev, power, single, warmup=20, steps=40):
    """The data-parallel SAGE step at world 1 on the bench graph: step ms
    and train edges/s on the host clock, the host stages a step (the JAX
    package's sample_wait, assemble_h2d and bucket_psum; no cold tier
    here, so cold_serve is 0), the profile's busy ms and idle share, and
    the launches of each kernel a step (K1 4, K2 1, K3 2 required), beside
    phase 5's single-card figures ``single``; then the step with the
    heartbeat on and off in turns of 30 steps (on, off, off, on, twice),
    the on turns at a ``HB_TURN_TIMEOUT_S`` heartbeat so that each holds
    beats."""
    from salient_plusplus_tpu_torch.parallel import mesh

    turns_on = (True, False, False, True) * 2   # the heartbeat, in turns
    turn = 30
    feed, feeder = tr.epoch_feed(1)
    check(len(feed) >= warmup + steps + len(turns_on) * turn + 20,
          "distributed epoch too short")
    for _ in range(warmup):
        tr.run_step(next(feeder))
    torch.cuda.synchronize(dev)
    m0 = _stage_marks(feed, feeder)
    e0, t0 = feeder.edges_fed, time.perf_counter()
    losses, counts = driven("distributed SAGE step, world 1 (timed steps)",
                            lambda: [tr.run_step(next(feeder))[0]
                                     for _ in range(steps)])
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    m1 = _stage_marks(feed, feeder)
    check(bool(torch.isfinite(torch.stack(losses)).all()),
          "distributed losses are not finite")
    per_step = {k: v / steps for k, v in counts.items()}
    check(per_step == {"sorted_segment_sum": 4,
                       "fused_gather_segment_sum": 1, "gather_rows": 2,
                       "weighted_segment_sum": 0},
          f"distributed step launches {per_step}: K1 4, K2 1, K3 2 expected")
    step_ms = dt / steps * 1e3
    stages = {k: (m1[k] - m0[k]) / steps * 1e3 for k in m0}
    stages["cold_serve"] = 0.0
    res = dict(step_ms=step_ms,
               edges_per_s=(feeder.edges_fed - e0) / dt,
               launches_per_step=per_step, r_cap=tr.r_cap,
               stages_ms_per_step=stages,
               stage_share_of_step={k: v / step_ms
                                    for k, v in stages.items()},
               tight_steps=feed.tight_steps)
    check(sum(stages[k] for k in ("sample_wait", "assemble_h2d",
                                  "bucket_psum", "cold_serve")) <= step_ms,
          f"host stages {stages} exceed the step's {step_ms} ms")
    check(stages["bucket_psum"] == 0.0,
          "bucket_psum at world 1: no collective decides the bucket there")
    # the step's own host time: steps on batches already on the card, so
    # neither the sampler nor the feed is in the window
    batches = [next(feeder) for _ in range(8)]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for b in batches:
        tr.run_step(b)
    res["enqueue_ms"] = (time.perf_counter() - t0) / len(batches) * 1e3
    torch.cuda.synchronize(dev)
    res["prefetched_step_ms"] = ((time.perf_counter() - t0)
                                 / len(batches) * 1e3)
    del batches
    log("  distributed bench: " + json.dumps(res) + f"  [{power}]")
    # the heartbeat's cost: the same steps with it on and off, in turns.
    # A turn is shorter than the default 10 s beat period, so the on turns
    # run a heartbeat of a 3 s timeout (a beat every 0.3 s, 33x the
    # default rate) and each must hold at least one beat; the default
    # heartbeat is restarted after the turns.
    turns, beats = [], []
    for on in turns_on:
        if on:
            hb = mesh.start_heartbeat(HB_TURN_TIMEOUT_S)
        else:
            mesh.stop_heartbeat()
        turns.append((on, _steps_ms(tr, feeder, dev, turn)))
        if on:
            beats.append(hb.beats)
    mesh.start_heartbeat()
    check(min(beats) > 0, f"an on turn held no beat: {beats}")
    hb_on = [ms for on, ms in turns if on]
    hb_off = [ms for on, ms in turns if not on]
    gap = sum(hb_on) / len(hb_on) - sum(hb_off) / len(hb_off)
    spread = max(hb_off) - min(hb_off)
    res["heartbeat_turns_ms"] = turns
    res["heartbeat_beats_per_on_turn"] = beats
    log(f"  heartbeat on/off/off/on x2, {turn} steps a turn, the on turns "
        f"at a {HB_TURN_TIMEOUT_S:g} s timeout (beats {beats}): "
        f"{[round(ms, 3) for _, ms in turns]} ms a step; mean on - off "
        f"{gap:+.3f} ms, spread of the off turns {spread:.3f} ms: "
        f"{'within' if abs(gap) <= spread else 'outside'} it  [{power}]")
    res["profile"] = profile_window(lambda: tr.run_step(next(feeder)), 10,
                                    "steps", power)
    feed.it.close()
    sp = single.get("profile") or {}
    dp = res["profile"] or {}
    log(f"  world-1 data-parallel vs single-card (phase 5): step "
        f"{res['step_ms']:.3f} vs {single['step_ms']:.3f} ms, "
        f"{res['edges_per_s']:.4g} vs {single['edges_per_s']:.4g} edges/s, "
        f"busy {dp.get('busy_ms')} vs {sp.get('busy_ms')} ms/step, idle "
        f"share {dp.get('idle_share')} vs {sp.get('idle_share')}  [{power}]")
    return res


def phase_dist_card_vs_cpu(dev, steps=10):
    """10 steps of the data-parallel trainer at a small shape (a 10k-node
    planted graph, batch 512, fanouts [10, 5], hidden 128, 2 layers,
    dropout 0) on the card in the NCCL group and on the CPU in a gloo
    subgroup, from the same seed (the same weights and batches): every
    step's loss within rtol 2e-2, the bf16 tolerance of the CPU tests
    (tests/test_torch_dist_trainer.py)."""
    import torch.distributed as dist

    from salient_plusplus_tpu_torch.data import synthetic

    g = synthetic.planted_partition(name="dcmp", num_nodes=10_000,
                                    num_classes=32, avg_degree=12,
                                    num_features=64, seed=0)
    small = dict(train_batch_size=512, train_fanouts=[10, 5],
                 hidden_features=128, num_layers=2, dropout=0.0,
                 num_workers=2)
    gloo = dist.new_group([0], backend="gloo")
    out = []
    for d, group in ((torch.device("cpu"), gloo), (dev, None)):
        tr = dist_trainer(g, d, group=group, **small)
        (losses, _, feed, _), c = driven(
            f"distributed small shape on {d.type}",
            lambda: dist_steps(tr, steps))
        feed.it.close()
        out.append([float(v) for v in losses])
    check(min(c[k] for k in KERNELS) > 0,
          f"the card's run bypassed a kernel: {c}")
    cpu, card = out
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    log(f"  distributed card vs cpu, {steps} steps: losses card "
        f"{[round(v, 5) for v in card]} cpu {[round(v, 5) for v in cpu]}, "
        f"max rel diff {rel:.3g} (stated 2e-2)")
    check(rel < 2e-2, f"distributed card vs cpu: rel diff {rel}")
    dist.destroy_process_group(gloo)


def phase_dist_layerwise(tr, g, dev, power, single):
    """Sharded layerwise inference of the trainer's SAGE at world 1 over
    the bench graph (its one partition is the graph plus 64 ghost rows
    that pad it to 128), against ``layerwise_inference`` of the same
    model over the same table: predictions agree on > 0.995 of the nodes;
    s a layer, nodes/s, peak memory, launches (K2 1 and K3 2 a chunk and
    layer); beside phase 5's single-card run ``single``."""
    from salient_plusplus_tpu_torch.models.inference import (
        layerwise_inference)
    from salient_plusplus_tpu_torch.train import dist_inference as DI

    layer_s = []

    class TimedEngine(DI.ShardedEngine):
        def propagate(self, core, emb, feat_out):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super().propagate(core, emb, feat_out)
            torch.cuda.synchronize()
            layer_s.append(time.perf_counter() - t0)
            return out

    V, L = g.num_nodes, tr.cfg.num_layers
    t0 = time.perf_counter()
    eng = TimedEngine(tr, chunk=LAYERWISE_CHUNK)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    logp, counts = driven("sharded layerwise inference, world 1", lambda:
                          DI.run_layerwise_zoo("SAGE", tr.state.model,
                                               tr.features, eng))
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    chunks = -(-tr.part_size // LAYERWISE_CHUNK)
    check(counts["fused_gather_segment_sum"] == chunks * L
          and counts["gather_rows"] == 2 * chunks * L,
          f"sharded layerwise launches {counts}: K2 {chunks * L}, K3 "
          f"{2 * chunks * L} expected")
    ref = layerwise_inference("SAGE", tr.state.model, g.rowptr, g.col,
                              tr.features[:V], chunk=LAYERWISE_CHUNK)
    check(bool(torch.isfinite(logp).all()), "sharded layerwise not finite")
    agree = float((logp[:V].argmax(-1) == ref.argmax(-1)).float().mean())
    err = float((logp[:V] - ref).abs().max())
    res = dict(V=V, chunks_per_layer=chunks, r_cap=eng.r_cap,
               engine_setup_s=setup_s, layer_s=layer_s, total_s=total_s,
               nodes_per_s=V / total_s, max_memory_allocated=peak,
               agreement=agree, max_abs_diff=err, launches=counts)
    log("  sharded layerwise: " + json.dumps(res) + f"  [{power}]")
    log(f"  sharded vs single-card layerwise (phase 5): {total_s:.3f} vs "
        f"{single['total_s']:.3f} s, peak memory {peak} vs "
        f"{single['max_memory_allocated']} B")
    check(agree > 0.995, f"sharded layerwise agrees on {agree} of the nodes")


def phase_dist_two_cards(V=100_000, C=32):
    """``torchrun --nproc_per_node 2`` of the driver with
    ``--distribute_data true --computation_mode frequency_cache`` on the
    100k-node planted graph, one epoch; final_valid above phase 4's floor
    (chance). Only where the host has 2 cards."""
    n_dev = torch.cuda.device_count()
    if n_dev < 2:
        log(f"  2-rank data-parallel driver leg not run: device_count="
            f"{n_dev}")
        return
    with tempfile.TemporaryDirectory() as root:
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", "2", "--master_port", str(_free_port()),
               "-m", "salient_plusplus_tpu_torch.driver",
               f"synth:V={V},C={C},deg=12,F=64", "dp", "--epochs", "1",
               "--distribute_data", "true", "--computation_mode",
               "frequency_cache", "--output_root", root]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        check(p.returncode == 0, f"torchrun failed: {p.stderr[-3000:]}")
        with open(os.path.join(root, "dp", "results.json")) as f:
            r = json.load(f)[0]
    log(f"  2-rank driver: losses={r['losses']} final_valid="
        f"{r['final_valid']:.4f} epoch_s={r['epoch_times']} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(all(np.isfinite(r["losses"])) and r["final_valid"] > 1.0 / C,
          f"2-rank driver: {r}")


def phase_launchers_two_cards(power, V=100_000, C=32):
    """Phase 12(c), beside phase 9's 2-card legs: where the host has 2
    cards, the plain command spawns one NCCL rank a card (each rank's log
    shows K1, K2 and K3), and an ``srun``-emulated NCCL pair of the
    driver trains the same job."""
    from salient_plusplus_tpu_torch.parallel.launch import run_ranks

    n_dev = torch.cuda.device_count()
    if n_dev < 2:
        log(f"  local launch on every card not run: device_count={n_dev}")
        log(f"  srun-emulated NCCL pair not run: device_count={n_dev}")
        return
    with tempfile.TemporaryDirectory() as root:
        dt, res, launches, job = plain_command(root, V, C)
        files = sorted(os.listdir(job))
    log(f"  plain command, {n_dev} cards: {dt:.1f} s; {res[0]}; launches "
        f"{launches}  [{power}]")
    check(len(launches) == n_dev and all(
        min(c[k] for k in KERNELS) > 0 for c in launches.values()),
        f"local launch: {n_dev} ranks with every kernel expected: "
        f"{launches}")
    check(all(f"rank{r}_output.txt" in files for r in range(1, n_dev)),
          f"local launch: rank outputs missing: {files}")
    check(res[0]["final_valid"] > 1.0 / C, f"local launch: {res[0]}")
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        run_ranks(["-m", "salient_plusplus_tpu_torch.driver",
                   f"synth:V={V},C={C},deg=12,F=64", "srun2", "--epochs",
                   "1", "--distribute_data", "true", "--output_root", root],
                  2, 600, launcher="slurm")
        with open(os.path.join(root, "srun2", "results.json")) as f:
            r = json.load(f)[0]
        launches = _launches_in(os.path.join(root, "srun2"))
    log(f"  srun-emulated NCCL pair: {time.perf_counter() - t0:.1f} s; "
        f"{r}; launches {launches}  [{power}]")
    check(r["final_valid"] > 1.0 / C and len(launches) == 2,
          f"srun-emulated NCCL pair: {r} {launches}")


def phase_dist(g, dev, power, single, single_lw):
    """Phase 9 in a world-1 NCCL group, joined as a launcher's rank joins
    it (``maybe_initialize_distributed`` from ``env://``), so the rank's
    heartbeat is live throughout: the trainer build, the bench (with the
    heartbeat's on/off turns), the sharded layerwise pass and a
    checkpoint written before the group's barrier, as
    ``run_trial_impl`` writes one; it must never fire."""
    import torch.distributed as dist

    from salient_plusplus_tpu_torch.parallel import mesh
    from salient_plusplus_tpu_torch.train import checkpoint as ckpt

    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        check(mesh.maybe_initialize_distributed() and
              dist.get_backend() == "nccl", "the bootstrap made no group")
        hb = mesh.current_heartbeat()
        check(hb is not None, "the bootstrap started no heartbeat")
        log(f"  heartbeat live: timeout {hb.timeout_s:g} s, a beat every "
            f"{hb.period_s:g} s")
        t0 = time.perf_counter()
        tr = dist_trainer(g, dev)
        log(f"  distributed trainer built in {time.perf_counter() - t0:.1f}"
            f" s: spec {tr.train_spec} tight {tr.train_tight} r_cap "
            f"{tr.r_cap}")
        phase_dist_bench(tr, dev, power, single)
        phase_dist_layerwise(tr, g, dev, power, single_lw)
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            ckpt.save(d, tr.state, trial=0, epoch=0, acc=0.0)
            tr._barrier()
            log(f"  checkpoint and barrier: {time.perf_counter() - t0:.2f} s")
        hb = mesh.current_heartbeat()
        check(hb is not None and hb.beats > 0,
              "the heartbeat stopped in phase 9")
        log(f"  heartbeat never fired: {hb.beats} beats since its last "
            f"start (after the bench's turns), through the build, bench, "
            f"layerwise and checkpoint barrier")
        del tr
        phase_dist_card_vs_cpu(dev)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        mesh.stop_heartbeat()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    phase_dist_two_cards()
    phase_dist_two_cards_kill()


# ------------------------------------ phase 11 (and phase 9's 2-card leg)
CHAOS_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "_torch_chaos_worker.py")
CHAOS_HEARTBEAT_S = 10   # the worker's heartbeat_timeout_s


def chaos_pair(victim, how, device="cpu", timeout=120):
    """The chaos pair of ``tests/_torch_chaos_worker.py``: two raw
    processes, one 2-rank group from the environment, one epoch; then
    rank ``victim`` exits, raises, stops itself or (``wait``) sleeps
    before the barrier. Returns (return codes, outputs, seconds from the
    victim's end of epoch 0 to the end of the wait: the survivor's exit,
    or both ranks' with ``wait``). Both processes are ended before it
    returns."""
    from salient_plusplus_tpu_torch.experiments import run_ranks

    rcs, outs, t_end = run_ranks(
        [CHAOS_WORKER, str(victim), how, device], 2, timeout,
        until=None if how == "wait" else 1 - victim, check=False)
    m = re.search(r"EPOCH0_DONE (\S+)", outs[victim])
    return rcs, outs, None if m is None else t_end - float(m.group(1))


def check_chaos(label, victim, how, rcs, outs, dt, power):
    """The survivor ended non-zero after epoch 0 and before epoch 1's end;
    a crashed peer (an uncaught exception) is reported by the heartbeat
    within its timeout, a stopped one within 3x; with ``wait`` both ranks
    end with 0 and the heartbeat never fires."""
    from salient_plusplus_tpu_torch.parallel.mesh import HEARTBEAT_EXIT_CODE

    s = 1 - victim
    why = [ln for ln in outs[s].splitlines()
           if ln.startswith(("heartbeat:", "FAILFAST"))]
    log(f"  {label}: rank {victim} {how}; return codes {rcs}, "
        f"{dt if dt is None else round(dt, 2)} s from the victim's epoch 0 "
        f"to the end: {[w[:160] for w in why]}  [{power}]")
    check("EPOCH0_DONE" in outs[victim] and "EPOCH0_DONE" in outs[s],
          f"{label}: epoch 0 did not end: {outs[s][-2000:]}")
    if how == "wait":
        check(rcs == [0, 0] and not why and dt is not None and
              dt > 3 * CHAOS_HEARTBEAT_S,
              f"{label}: the long wait did not end cleanly: {rcs}, {why}")
        return
    check(rcs[s] not in (0, None) and
          "EPOCH1_DONE_UNEXPECTED" not in outs[s],
          f"{label}: the survivor did not fail fast: {outs[s][-2000:]}")
    if how in ("raise", "stop"):
        limit = CHAOS_HEARTBEAT_S * (1 if how == "raise" else 3)
        check(rcs[s] == HEARTBEAT_EXIT_CODE and dt is not None and
              dt < limit,
              f"{label}: the heartbeat did not end the survivor within "
              f"{limit} s: {rcs}, {dt}")


def phase_chaos(power):
    """Phase 11: rank-death fail-fast on the card's host. The chaos pair
    in gloo on the CPU, four at once: rank 1 exits (``os._exit(42)``),
    rank 1 raises (its heartbeat writes ``dead`` at exit, which ends rank
    0), rank 1 stops itself (``SIGSTOP``, its sockets open: only the
    heartbeat ends rank 0), and rank 0 sleeps 3x the timeout before the
    barrier while rank 1 waits in it (both end with 0)."""
    cases = [(1, "exit"), (1, "raise"), (1, "stop"), (0, "wait")]
    out = [None] * len(cases)

    def run(i):
        out[i] = chaos_pair(*cases[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for (victim, how), (rcs, outs, dt) in zip(cases, out):
        check_chaos("chaos pair, gloo", victim, how, rcs, outs, dt, power)


def phase_dist_two_cards_kill():
    """The chaos pair on 2 cards in NCCL, rank 1 stopped: the heartbeat
    must end rank 0, which waits inside an NCCL collective. Only where the
    host has 2 cards."""
    n_dev = torch.cuda.device_count()
    if n_dev < 2:
        log(f"  2-card NCCL kill leg not run: device_count={n_dev}")
        return
    rcs, outs, dt = chaos_pair(1, "stop", device="cuda")
    check_chaos("chaos pair, NCCL on 2 cards", 1, "stop", rcs, outs, dt,
                nvidia_smi())


# ---------------------------------------------------------------- phase 12
# the README's 2-rank data-parallel CPU job
LAUNCH_ARGV = ["synth:V=4096,C=4,deg=8,F=16", "dp", "--distribute_data",
               "true", "--computation_mode", "frequency_cache", "--epochs",
               "1", "--train_batch_size", "64", "--train_fanouts", "4,3",
               "--batchwise_test_fanouts", "5,5", "--final_test_fanouts",
               "5,5", "--num_layers", "2", "--hidden_features", "16",
               "--num_workers", "1"]
LAUNCH_RANK = (  # a rank: the driver on the CPU, then its group
    "import sys; import torch.distributed as dist; "
    "from salient_plusplus_tpu_torch import driver; "
    "from salient_plusplus_tpu_torch.parallel import mesh; "
    "driver.main(sys.argv[1:], device='cpu'); "
    "hb = mesh.current_heartbeat(); "
    "print('GROUP', dist.get_rank(), dist.get_world_size(), "
    "dist.get_backend(), hb is not None)")


def _but_time(results):
    return [{k: v for k, v in r.items() if k != "epoch_times"}
            for r in results]


def phase_launchers_emulated(power, timeout=180):
    """12(a): the README's 2-rank job in gloo on the host's CPU under
    torchrun's, SLURM's and Open MPI's variables, at once (each alone in
    its ranks' environment); each rank prints its group, every run ends
    with 0 and its results.json equals torchrun's but the epoch's wall
    time."""
    from salient_plusplus_tpu_torch.parallel.launch import run_ranks

    got = {}

    def run(way, root):
        t0 = time.perf_counter()
        rcs, outs, _ = run_ranks(
            ["-c", LAUNCH_RANK, *LAUNCH_ARGV, "--output_root", root], 2,
            timeout, check=False, launcher=way)
        res = None
        if rcs == [0, 0]:
            with open(os.path.join(root, "dp", "results.json")) as f:
                res = json.load(f)
        got[way] = (rcs, outs, res, time.perf_counter() - t0)

    with tempfile.TemporaryDirectory() as root:
        threads = [threading.Thread(target=run,
                                    args=(w, os.path.join(root, w)))
                   for w in ("torchrun", "slurm", "ompi")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    ref = got["torchrun"][2]
    for way, (rcs, outs, res, dt) in got.items():
        groups = [ln for o in outs for ln in o.splitlines()
                  if ln.startswith("GROUP")]
        log(f"  {way}: return codes {rcs}, {groups}, {dt:.1f} s; "
            f"{None if res is None else _but_time(res)}  [{power}]")
        check(rcs == [0, 0], f"{way} ranks failed: {outs[0][-2000:]}"
                             f"{outs[1][-2000:]}")
        check(groups == ["GROUP 0 2 gloo True", "GROUP 1 2 gloo True"],
              f"{way}: the group or the heartbeat is missing: {groups}")
        check(_but_time(res) == _but_time(ref),
              f"{way} results differ from torchrun's: {res} {ref}")


def _launches_in(job_dir):
    """Every rank's last kernel_launches line in its driver log:
    {log file name: {kernel: launches}}."""
    out = {}
    for path in sorted(glob.glob(os.path.join(job_dir, "*_logs.txt"))):
        with open(path) as f:
            for ln in f:
                if ln.startswith("('kernel_launches'"):
                    out[os.path.basename(path)] = ast.literal_eval(ln)[1]
    return out


def _plain_env():
    """This process's environment without any launcher's variable."""
    from salient_plusplus_tpu_torch.parallel.mesh import LAUNCHER_VARS

    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__)),
         os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    return env


def plain_command(root, V=100_000, C=32, timeout=600):
    """``python -m salient_plusplus_tpu_torch.driver synth:... dp1 --epochs
    1 --distribute_data true`` with no launcher variables: (seconds, rank
    0's results, {log: launches}, job dir)."""
    cmd = [sys.executable, "-m", "salient_plusplus_tpu_torch.driver",
           f"synth:V={V},C={C},deg=12,F=64", "dp1", "--epochs", "1",
           "--distribute_data", "true", "--output_root", root]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, env=_plain_env(), capture_output=True,
                       text=True, timeout=timeout)
    dt = time.perf_counter() - t0
    check(p.returncode == 0, f"the plain command failed ({p.returncode}): "
                             f"{p.stdout[-1500:]}{p.stderr[-3000:]}")
    job = os.path.join(root, "dp1")
    with open(os.path.join(job, "results.json")) as f:
        res = json.load(f)
    return dt, res, _launches_in(job), job


def phase_plain_command(power, V=100_000, C=32):
    """12(b): the plain data-parallel command on this host. With one card
    it trains on the card in one process (no rank spawned: one log, no
    -rank names, no rank outputs), exit 0, final_valid above chance, and
    K1 >= 4, K2 >= 1 and K3 >= 1 launches a train step in its log (the
    counts start at 0 in that new process)."""
    n_dev = torch.cuda.device_count()
    if n_dev > 1:
        log(f"  one-card plain command not run: device_count={n_dev} (12c "
            f"runs it as {n_dev} ranks)")
        return
    with tempfile.TemporaryDirectory() as root:
        dt, res, launches, job = plain_command(root, V, C)
        files = sorted(os.listdir(job))
    r = res[0]
    steps = train_steps(V)
    log(f"  plain command, one card: {dt:.1f} s; losses={r['losses']} "
        f"final_valid={r['final_valid']:.4f} epoch_s={r['epoch_times']}; "
        f"job files {files}; launches {launches}  [{power}]")
    check(r["final_valid"] > 1.0 / C and all(np.isfinite(r["losses"])),
          f"plain command: {r}")
    check(len(launches) == 1 and "-rank" not in next(iter(launches)) and
          not any(f.startswith("rank") for f in files),
          f"the plain command spawned ranks on one card: {files}")
    _at_least(next(iter(launches.values())),
              {"sorted_segment_sum": 4 * steps,
               "fused_gather_segment_sum": steps, "gather_rows": steps},
              f"plain command, {steps} train steps")


def phase_launchers(power):
    """Phase 12: the launchers."""
    phase_launchers_emulated(power)
    phase_plain_command(power)
    phase_launchers_two_cards(power)


# ---------------------------------------------------------------- phase 10
DRILL_NODES = 250_000   # ogbn-products' widths at a tenth of its nodes
DRILL_CLASSES = 47


def random_label_band(n: int, classes: int = DRILL_CLASSES) -> tuple:
    """The accuracies that a model can reach on ``n`` nodes whose labels
    are drawn uniformly from ``classes`` independently of the graph and
    the features (the drill's labels): chance within six standard
    deviations of a binomial share."""
    p = 1.0 / classes
    sd = (p * (1.0 - p) / n) ** 0.5
    return p - 6 * sd, p + 6 * sd


def phase_drill(power, nodes=DRILL_NODES, parts=4):
    """The readiness drill's CLI (``utils/readiness_drill.py``) in a child
    at products widths: ``powerlaw_graph`` with 100 features in fp16, 47
    classes, average degree 15, 8% train and 2% valid, written by
    ``GraphData.save``; ``partition.cli --parts 4`` in a child; then the
    driver in a child on the card at the default model (SAGE, hidden 256,
    batch 1024, fanouts 15,10,5) for one epoch with a layerwise final
    test. The driver's child sets the kernels' launch counts to 0 just
    before ``driver.main`` and writes them just after. Returns the
    drill's report."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        out = os.path.join(root, "drill.json")
        p = subprocess.run(
            [sys.executable, "-m",
             "salient_plusplus_tpu_torch.utils.readiness_drill",
             "--nodes", str(nodes), "--parts", str(parts), "--epochs", "1",
             "--final_test_mode", "layerwise", "--root", root,
             "--out", out], capture_output=True, text=True, timeout=900)
        log("\n".join("  | " + ln for ln in p.stdout.splitlines()
                      if ln.startswith(("[drill]", "trial", "partition"))))
        check(p.returncode == 0, f"the drill failed: {p.stderr[-3000:]}")
        with open(out) as f:
            rep = json.load(f)
    check_drill(rep, nodes, power)
    log(f"  drill total {time.perf_counter() - t0:.1f} s  [{power}]")
    return rep


def check_drill(rep, nodes, power):
    """Phase 10's checks of a drill report: each stage's seconds and peak
    RSS, finite losses, ``final_valid`` inside the band that random labels
    allow, and the driver child's launches: K1 >= 4 a train step, K2 and
    K3 >= 1 a train step plus 1 a layerwise chunk and layer."""
    for name, st in rep["stages"].items():
        log(f"  drill {name}: {st['seconds']} s, peak RSS "
            f"{st['peak_rss_gb']} GB  [{power}]")
        check(st["peak_rss_gb"] > 0, f"drill {name}: no peak RSS")
    r = rep["results"][0]
    n_valid = int(0.02 * nodes)
    lo, hi = random_label_band(n_valid)
    log(f"  drill: {nodes} nodes, {rep['num_edges']} edges; losses="
        f"{r['losses']} final_valid={r['final_valid']:.4f} (random labels: "
        f"chance {1 / DRILL_CLASSES:.4f}, band [{lo:.4f}, {hi:.4f}] over "
        f"{n_valid} valid nodes) final_test={r['final_test']:.4f} "
        f"epoch_s={r['epoch_times']}")
    check(all(np.isfinite(r["losses"])), "drill losses are not finite")
    check(lo <= r["final_valid"] <= hi,
          f"drill final_valid {r['final_valid']} outside [{lo}, {hi}]")
    log(f"  drill layerwise final test {rep['layerwise_s']} s; the driver "
        f"child's peak allocated {rep['max_memory_allocated']} B  [{power}]")
    steps = -(-int(0.08 * nodes) // 1024)
    chunks = -(-nodes // LAYERWISE_CHUNK)
    K1, K2, K3 = "sorted_segment_sum", "fused_gather_segment_sum", "gather_rows"
    log(f"  launches in the drill's driver child: {rep['launches']}")
    _at_least(rep["launches"], {K1: 4 * steps, K2: steps + 3 * chunks,
                                K3: steps + 3 * chunks},
              f"drill, {steps} train steps + {chunks} chunks x 3 layers")


# ---------------------------------------------------------------- phase 13
BENCH_RUN_ENV = {"BENCH_WARMUP": "20", "BENCH_STEPS": "40",
                 "BENCH_WINDOWS": "3"}
BENCH_RUNS = [("SAGE all-resident", {}),
              ("SAGE hbm_fraction 0.5, cold cache auto",
               {"BENCH_HBM_FRACTION": "0.5", "BENCH_COLD_CACHE": "auto"})]


PROBE_READINGS = 5


def phase_gather_probe(table, power):
    """The bench's gather probe in this process on ``table``, read
    PROBE_READINGS times: K3 launched exactly ``PROBE_LAUNCHES`` times a
    reading (K1, K2 never), each slope measured and at or above the HBM
    bound of the probe's bytes (each row read and written once); the
    readings' spread is logged."""
    from salient_plusplus_tpu_torch import bench

    check("BENCH_GATHER_NS" not in os.environ, "BENCH_GATHER_NS is set")
    t0 = time.perf_counter()
    readings, counts = driven(
        "the bench's gather probe",
        lambda: [bench._measure_gather_ns(table)
                 for _ in range(PROBE_READINGS)])
    ns = sorted(v for v, _ in readings)
    floor_ns = 2 * table.shape[1] * table.element_size() / HBM_BYTES_PER_S * 1e9
    log(f"  gather probe on the {tuple(table.shape)} {table.dtype} table, "
        f"{PROBE_READINGS} readings: {[round(v, 4) for v in ns]} ns/row "
        f"(min {ns[0]:.4f}, median {ns[len(ns) // 2]:.4f}, max "
        f"{ns[-1]:.4f}, max/min {ns[-1] / ns[0]:.3f}), HBM bound "
        f"{floor_ns:.4f} ns/row, share at the min {floor_ns / ns[0]:.3f}; "
        f"{time.perf_counter() - t0:.2f} s  [{power}]")
    check(all(s == "measured" for _, s in readings) and ns[0] >= floor_ns,
          f"gather probe {readings} ns/row below its bound {floor_ns}")
    want = PROBE_READINGS * bench.PROBE_LAUNCHES
    check(counts == {"sorted_segment_sum": 0, "fused_gather_segment_sum": 0,
                     "gather_rows": want, "weighted_segment_sum": 0},
          f"gather probe launches {counts}: K3 {want} expected")
    return ns[0]


def bench_run(label, over, power, timeout=420):
    """``python -m salient_plusplus_tpu_torch.bench`` in a child with
    BENCH_RUN_ENV and ``over`` (no other BENCH_* variable): (its JSON
    line, {kernel: launches}, train steps, probe launches, seconds)."""
    env = {k: v for k, v in _plain_env().items()
           if not k.startswith("BENCH_")}
    env.update(BENCH_RUN_ENV, **over)
    torch.cuda.empty_cache()  # give the cached blocks back for the child
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m",
                        "salient_plusplus_tpu_torch.bench"], env=env,
                       cwd=os.path.dirname(os.path.abspath(__file__)),
                       capture_output=True, text=True, timeout=timeout)
    dt = time.perf_counter() - t0
    log("\n".join("  | " + ln for ln in p.stderr.splitlines()
                  if ln.startswith(("bench:", "windows(", "h2d_preflight"))))
    check(p.returncode == 0, f"bench ({label}) failed ({p.returncode}): "
                             f"{p.stdout[-1500:]}{p.stderr[-3000:]}")
    line = json.loads(p.stdout.strip().splitlines()[-1])
    m = re.search(r"^bench: kernel launches (\{.*\}) in (\d+) train steps "
                  r"and (\d+) probe gathers$", p.stderr, re.M)
    check(m is not None, f"bench ({label}): no kernel launches line")
    return line, json.loads(m.group(1)), int(m.group(2)), int(m.group(3)), dt


def phase_bench_runs(power, single, cold):
    """The bench's two runs (BENCH_RUNS), each checked, each logged beside
    phase 5's figures ``single`` (and the 0.5 run beside phase 7's
    gsrc-cold ``cold``) for the same shape; the comparison is logged, not
    gated on."""
    K1, K2, K3 = "sorted_segment_sum", "fused_gather_segment_sum", "gather_rows"
    for (label, over), ref in zip(BENCH_RUNS, (single, cold)):
        line, launches, steps, probes, dt = bench_run(label, over, power)
        win = line["windows_edges_per_s"]
        # a window's step time: batches/s = H2D MB/s / MB a batch
        win_ms = [line["bytes_per_batch"] / (r * 1e6) * 1e3
                  for r in line["h2d_required_mb_per_s"]]
        log(f"  bench {label}: {dt:.1f} s; value {line['value']} e/s "
            f"(windows {win}, median {line['window_median']}; window step "
            f"ms {[round(x, 3) for x in win_ms]}), microstep "
            f"{line['microstep_ms']} ms ({line['microstep_edges_per_s']} "
            f"e/s), gather {line['gather_ns_per_row']} ns/row "
            f"({line['gather_ns_source']}; pre {line['gather_ns_pre']}, post "
            f"{line['gather_ns_post']}), rows/step "
            f"{line['gather_rows_per_step']}, roofline "
            f"{line['roofline_edges_per_s']} e/s, roofline_frac "
            f"{line['roofline_frac']}, chip_state {line['chip_state']} "
            f"({line['chip_state_note']}), h2d burst "
            f"{line['h2d_burst_mb_per_s']} MB/s, needed "
            f"{line['h2d_required_mb_per_s']}  [{power}]")
        log(f"  bench {label} line: {json.dumps(line)}")
        if ref is not None:
            log(f"  bench {label} vs chip_smoke's own bench (same shape): "
                f"window median {line['window_median']:.4g} vs "
                f"{ref['edges_per_s']:.4g} e/s; microstep "
                f"{line['microstep_ms']} vs {ref['step_ms']:.3f} ms a step "
                f"(feed included there)  [{power}]")
        log(f"  launches in the bench child: {launches} in {steps} train "
            f"steps and {probes} probe gathers")
        check(line["value"] > 0 and len(win) == 3
              and line["gather_ns_source"] == "measured"
              and 0 < line["roofline_frac"] <= 1.05
              and line["microstep_ms"] > 0
              and line["gsrc_fallback_windows"] is None,
              f"bench {label}: {line}")
        check(launches == {K1: 4 * steps, K2: steps, K3: steps + probes,
                           "weighted_segment_sum": 0,
                           "weighted_segment_sum.multihead": 0,
                           "weighted_segment_sum.backward": 0},
              f"bench {label}: launches {launches} in {steps} steps and "
              f"{probes} probe gathers; K1 4, K2 1, K3 1 a step expected")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    # phase 1
    t = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, count, power = (torch.cuda.get_device_name(0),
                          torch.cuda.device_count(), nvidia_smi())
    log(f"phase 1 device: {name} count={count} nvidia-smi: {power} "
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    # phase 2
    phase_build()
    log(f"phase 2 build: {time.perf_counter() - t:.1f} s")
    # phase 3 (main-path shapes come from one bench-shape batch)
    t = time.perf_counter()
    trainer = bench_trainer(dev)
    log(f"  bench trainer built in {time.perf_counter() - t:.1f} s: "
        f"spec {trainer.train_spec} tight {trainer.train_tight}")
    t = time.perf_counter()
    batch = bench_batch(trainer, dev)
    tot, k1_err, bound_by = phase_kernel_vs_plain(k1_cases(trainer, batch),
                                                  dev, power)
    log(f"  K1 per train step (4 calls): kernel_ms={tot['ms']:.4f} "
        f"plain_ms={tot['plain_ms']:.4f} library_ms={tot['library_ms']:.4f} "
        f"bound_us={tot['bound_ms'] * 1e3:.2f} "
        f"{shares(tot['ms'], tot['library_ms'], tot['bound_ms'])}  [{power}]")
    phase_edge_cases(dev)
    k23 = phase_k2_k3_main(trainer, batch, dev, power)
    phase_k2_k3_edge_cases(dev)
    del batch
    # slice 4's GAT calls: a GAT bench batch's weighted message sums and
    # K3's gradient
    gat = model_trainer(trainer, "GAT", dev)
    batch = bench_batch(gat, dev)
    phase_weighted_gat(gat, batch, dev, power)
    phase_k3_grad(batch, dev)
    del batch, gat
    # GATSkip's multi-head weighted sums at its published widths (4 heads
    # of 128, 4 of 47 in the last layer) and fanouts, and the launches of
    # one of its train steps
    gs = model_trainer(trainer, "GATSkip", dev, hidden_features=128,
                       train_fanouts=[10, 10, 10])
    batch = bench_batch(gs, dev)
    phase_weighted_gat(gs, batch, dev, power, label="GATSkip")
    del batch
    phase_gatskip_step(gs, dev)
    del gs
    log(f"phase 3 kernel vs plain: {time.perf_counter() - t:.1f} s")
    # phase 4: the main paths through the driver CLI
    t = time.perf_counter()
    launches = phase_drivers(dev)
    phase_resume(dev)
    log(f"phase 4 driver: {time.perf_counter() - t:.1f} s")
    # phase 5
    t = time.perf_counter()
    res = phase_bench(trainer, dev, power)
    steps = res["launches_per_step"]
    check(steps["sorted_segment_sum"] == 4
          and steps["fused_gather_segment_sum"] == 1
          and steps["gather_rows"] == 1,
          f"bench step launches {steps}: K1 4, K2 1, K3 1 expected")
    full_res = res
    full_lw = phase_layerwise_bench(trainer, dev, power)
    # per step: GAT the weighted sum 3 (message sums), GCN K1 6 (3 hops,
    # forward and mirrored backward); K3 1 (features), K2 0 (no gsrc). One
    # trainer on the card at a time, so each peak memory is its own
    for m, k1, ws in (("GAT", 0, 3), ("GCN", 6, 0)):
        log(f"  {m} at the bench shape:")
        other = model_trainer(trainer, m, dev)
        steps = phase_bench(other, dev, power)["launches_per_step"]
        del other
        check(steps == {"sorted_segment_sum": k1,
                        "fused_gather_segment_sum": 0, "gather_rows": 1,
                        "weighted_segment_sum": ws},
              f"{m} bench step launches {steps}: K1 {k1}, K2 0, K3 1, "
              f"weighted sum {ws} expected")
    log(f"phase 5 bench: {time.perf_counter() - t:.1f} s")
    # phase 6
    t = time.perf_counter()
    phase_card_vs_cpu(dev)
    for m in ("GAT", "GCN"):
        phase_card_vs_cpu(dev, model_name=m, dtype=torch.float32)
    phase_layerwise_card_vs_cpu(dev)
    log(f"phase 6 card vs cpu: {time.perf_counter() - t:.1f} s")
    # phase 7: the host cold tier (hbm_fraction 0.5)
    t = time.perf_counter()
    phase_cold_overlay(trainer, dev, power)
    cold_res = phase_cold_bench(trainer, dev, power, full_res)
    bench_graph, bench_spec = trainer.graph, trainer.train_spec
    bench_table = trainer.features  # phase 13's gather probe
    del trainer
    phase_cold_drivers(dev)
    log(f"phase 7 cold tier: {time.perf_counter() - t:.1f} s")
    # phase 8: partitioning, VIP, the comm-volume simulation, the exchange
    t = time.perf_counter()
    phase_vip_device(bench_graph, dev, power)
    phase_partitioned_driver(dev)
    phase_simulation(full_res["step_ms"] * 1e-3)
    phase_exchange(bench_graph, bench_spec, dev, power)
    log(f"phase 8 partitioning, VIP, simulation, exchange: "
        f"{time.perf_counter() - t:.1f} s")
    # phase 9: the data-parallel trainer
    t = time.perf_counter()
    phase_dist(bench_graph, dev, power, full_res, full_lw)
    del bench_graph
    log(f"phase 9 data-parallel trainer: {time.perf_counter() - t:.1f} s")
    # phase 10: the readiness drill at products widths, the driver in a
    # child on the card
    t = time.perf_counter()
    torch.cuda.empty_cache()  # give the cached blocks back for the child
    phase_drill(power)
    log(f"phase 10 readiness drill: {time.perf_counter() - t:.1f} s")
    # phase 11: rank-death fail-fast, the chaos pair on the host's CPU
    t = time.perf_counter()
    phase_chaos(power)
    log(f"phase 11 rank-death fail-fast: {time.perf_counter() - t:.1f} s")
    # phase 12: the launchers (srun / mpirun emulated, the plain command)
    t = time.perf_counter()
    phase_launchers(power)
    log(f"phase 12 launchers: {time.perf_counter() - t:.1f} s")
    # phase 13: the throughput bench, its probe here and its CLI twice
    t = time.perf_counter()
    phase_gather_probe(bench_table, power)
    del bench_table
    phase_bench_runs(power, full_res, cold_res["gsrc cold"])
    log(f"phase 13 throughput bench: {time.perf_counter() - t:.1f} s")
    log(f"total: {time.perf_counter() - t_all:.1f} s")
    # per kernel: its main-path launches (slice 2's driver run) and its
    # times at one train step's shapes (K1: its 4 calls summed)
    timed = {"sorted_segment_sum": dict(tot, err=k1_err, bound_by=bound_by),
             "fused_gather_segment_sum": dict(k23["K2 step"],
                                              bound_by="bytes"),
             "gather_rows": dict(k23["K3 step"], bound_by="bytes")}
    errs = {"fused_gather_segment_sum": max(
        v["err"] for k, v in k23.items() if k.startswith("K2")),
        "gather_rows": 0.0, "sorted_segment_sum": k1_err}
    print(json.dumps({"kernels": [{
        "name": k, "route": "cuda", "source": KERNELS[k][0],
        "replaces": KERNELS[k][1], "launches": launches[k],
        "max_abs_err": errs[k], "ms": timed[k]["ms"],
        "plain_ms": timed[k]["plain_ms"], "bound_ms": timed[k]["bound_ms"],
        "bound_by": timed[k]["bound_by"],
        "library_ms": timed[k]["library_ms"]} for k in KERNELS]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
