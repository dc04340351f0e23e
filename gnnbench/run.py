"""Run one cell of the benchmark once.

    python3 -m gnnbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Prints the result as the last line of
standard output (one JSON object) and the numbers of the correctness
check beside their limits as the last lines of standard error. Exits 2,
with no result, without a CUDA card or with fewer cards than the cell
asks for; 3 if the JAX package or JAX itself was loaded.

A run: the seeded graph (``graphgen``), made on the card; the phase's
set-up, which builds the program's trainer and fills the pool; the
window of ``--seconds``; with ``--trace 1`` a second window under
``torch.profiler`` and the per-layer metrics; the program's state freed;
the check against the plain reference.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from .cell import ROOT_DIR, resolve  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "salient_plusplus_tpu")
CACHE_DIR = os.path.join(ROOT_DIR, ".gnnbench_cache")
PROFILED_PASSES = 2     # pool passes the traced window profiles


def fixed_caches() -> None:
    """Kernel caches at fixed paths inside the checkout. The program's own
    CUDA libraries build into its package's ``_build/``."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ.setdefault(var, os.path.join(CACHE_DIR, sub))
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def parse(argv):
    p = argparse.ArgumentParser(prog="gnnbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(*a) -> None:
    print("gnnbench:", *a, file=sys.stderr, flush=True)


def main(argv=None, device=None, extra: bool = False) -> int:
    """Run the cell; ``device`` other than None (the tests' "cpu") skips
    the look for a card. ``extra`` adds the control's readings to the
    check (``gnnbench.control``)."""
    fixed_caches()
    args = parse(argv)
    cell = resolve(args.workload)
    import torch

    if device is None:
        seen = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if seen < cell.chips:
            log(f"needs {cell.chips} CUDA card(s); torch sees {seen}")
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    out = run_cell(cell, args, device, extra)
    bad = forbidden_modules()
    if bad:
        log(f"loaded {bad}: the benchmark measures the PyTorch port only")
        return 3
    checks = out.pop("checks")
    for name, c in checks.items():
        log(f"check {name} = {c['value']!r} limit {c['limit']!r}")
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    print(json.dumps(out), flush=True)
    return 0


def run_cell(cell, args, device, extra: bool = False) -> dict:
    import torch

    from . import graphgen, pool as P, trace as T
    from .judge import verdict
    from .phases import num_workers, readings, release

    phase = cell.phase
    r = SimpleNamespace(phase=cell.traffic["phase"], cfg=cell.cfg,
                        model=cell.model, device=device, trace=None,
                        power=power_limit() if device.type == "cuda"
                        else "cpu")
    run = SimpleNamespace(cfg=cell.cfg, traffic=cell.traffic,
                          model=cell.model, seed=args.seed,
                          program_seed=cell.traffic["sample_seed"],
                          device=device, workers=num_workers(), readings=r)
    run.note_pool = lambda pool: setattr(r, "pool", pool)

    t = time.perf_counter()
    run.graph = graphgen.make_graph(cell.cfg["graph"],
                                    cell.cfg["graph"]["seed"], device)
    log(f"graph {run.graph.num_nodes} nodes {run.graph.col.shape[0]} "
        f"edges in {time.perf_counter() - t:.1f} s")
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    st = phase.setup(run)
    p = st.pool
    log(f"set-up done at {time.perf_counter() - PROCESS_START:.1f} s; pool "
        f"{len(p.batches)} batches of {p.sampled} sampled, "
        f"{p.real_edges / len(p.batches):.0f} real edges a batch, "
        f"{p.outside} outside the tight bucket, edge pad waste "
        f"{p.stats.edge_waste():.4f}")
    w = phase.window(run, st, args.seconds,
                     step_events=bool(args.trace) and device.type == "cuda")
    setup_s = w.start - PROCESS_START
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    per = 1e3 / max(w.steps, 1)
    log(f"window {w.steps} steps in {w.seconds:.3f} s: host ms a step "
        f"enqueue {sum(w.enqueue_s) * per:.3f} feed {w.feed_s * per:.3f} "
        f"read {w.read_s * per:.3f}"
        + (f"; device ms a step (events) mean "
           f"{sum(w.step_ms) / len(w.step_ms):.3f}" if w.step_ms else ""))
    readings(run, st, w)

    metas = {}

    def meta(i):
        if i not in metas:
            metas[i] = P.meta(st.pool.batches[i], device)
        return metas[i]
    r.meta = meta

    if args.trace:
        families = {getattr(m, "FAMILY"): getattr(m, "KERNELS")
                    for m in cell.readers.values() if hasattr(m, "FAMILY")}
        first = st.consumed
        n = PROFILED_PASSES * len(st.pool.batches)

        def steps(k):
            phase.window(run, st, 0.0, max_steps=k, spans=True)
        r.trace = T.profile_steps(steps, n, device, families)
        r.trace_batch_index = lambda k: (first + k) % len(st.pool.batches)
        for i in range(len(st.pool.batches)):
            meta(i)

    release(st)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    prev = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        values = phase.judge(run, st, extra=extra)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
    checks = verdict(values, cell.limits)
    correct = all(c["ok"] for c in checks.values())

    e2e_values = {"setup_s": setup_s, "peak_device_gib": peak / 2**30,
                  cell.traffic["rate_metric"]: w.work / w.seconds}
    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e_values[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": card_name(device), "count": 1,
           "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": w.steps,
           "failed": int(w.failed), "metrics": metrics, "device": dev}
    if args.trace and r.trace is not None:
        dev["busy_s"] = r.trace.busy_s
        dev["window_s"] = r.trace.window_s
        out["breakdown"] = {"device_ops": r.trace.device_ops,
                            "idle_gaps": r.trace.idle_gaps}
    if extra:
        out["readings"] = {k: v for k, v in values.items()}
    out["power"] = r.power
    out["checks"] = checks
    return out


if __name__ == "__main__":
    sys.exit(main())
