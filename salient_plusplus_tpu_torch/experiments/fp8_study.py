"""The port's fp8 wire accuracy study: the evidence behind ``RunConfig``'s
``wire_fp8`` default (counterpart of the repo's ``experiments/fp8_study.py``).

The same task and settings as the JAX study: the non-saturating
accuracy-tracking task (``planted_partition``, 60,000 nodes, 64 classes,
degree 12, 64 features, ``p_intra`` 0.4, ``feature_noise`` 12, normalized,
seed 1), ``multiconstraint_partition`` into 8 parts, ``fully_random``
balancing (the most cross-partition traffic) and no VIP cache, so every
remote row crosses the quantized wire. Four runs of 6 epochs with the
port's ``DistributedTrainer``: bf16 at seeds 0 and 1 (run-to-run noise),
the fp8 wire (e4m3 with a float32 row scale) at seed 0, and the fp8 wire
with the fp8 host cold tier (``hbm_fraction`` 0.75, replicated) at seed
0. The verdict is the JAX study's: fp8 is within noise when its largest
gap to bf16 seed 0 over the valid curve is at most 1.5× the largest gap
between the two bf16 seeds, plus 0.01.

Each rank is one process of a gloo group on the CPU, as the JAX study
ran on a CPU mesh; the exchange, its fp8 codec, the trainer and the
models are the port's own. Besides the curves, each run records the
exchange's payload bytes and remote rows per epoch, summed over the
group, so the fp8 wire's bytes a row can be read beside bf16's.

    python -m salient_plusplus_tpu_torch.experiments.fp8_study \\
        [--out docs/fp8_study_torch.json]

It never writes the JAX study's ``docs/fp8_study.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

WORLD = 8
EPOCHS = 6
NODES = 60_000
CLASSES = 64
# run: (seed, wire_fp8, hbm_fraction, cold_fp8)
RUNS = {
    "bf16_seed0": (0, False, 1.0, False),
    "bf16_seed1": (1, False, 1.0, False),    # run-to-run noise
    "fp8_seed0": (0, True, 1.0, False),
    "fp8_cold_seed0": (0, True, 0.75, True),
}
DEFAULT_OUT = os.path.join("docs", "fp8_study_torch.json")


def study_graph(nodes: int = NODES):
    from ..data import synthetic

    return synthetic.planted_partition(
        name="fp8study", num_nodes=nodes, num_classes=CLASSES,
        avg_degree=12, num_features=64, p_intra=0.4, feature_noise=12.0,
        normalize=True, seed=1)


def study_config(seed: int, wire_fp8: bool, hbm_fraction: float,
                 cold_fp8: bool):
    """The JAX study's ``run`` configuration."""
    from ..config import RunConfig

    return RunConfig(
        train_batch_size=64, test_batch_size=128,
        train_fanouts=[10, 5], batchwise_test_fanouts=[12, 12],
        final_test_fanouts=[12, 12], hidden_features=64, num_layers=2,
        lr=0.01, num_workers=2, calibration_batches=4, seed=seed,
        load_balance_scheme="fully_random", wire_fp8=wire_fp8,
        hbm_fraction=hbm_fraction, cold_fp8=cold_fp8,
        cold_mode="replicated")


def run(g, labels, epochs: int, seed: int, wire_fp8: bool,
        hbm_fraction: float, cold_fp8: bool) -> dict:
    """One run on this rank: the valid curve (the group's accuracy after
    each epoch), the losses and the exchange's group sums."""
    from ..train.dist_loop import DistributedTrainer

    t0 = time.perf_counter()
    t = DistributedTrainer(
        study_config(seed, wire_fp8, hbm_fraction, cold_fp8), g, labels,
        device="cpu")
    out = {"curve": [], "loss": [], "sent_bytes": [], "remote": [],
           "wire_bytes": []}
    for e in range(epochs):
        m = t.train_epoch(e)
        if m["overflow"]:
            raise RuntimeError(f"epoch {e}: {m['overflow']} rows overflowed "
                               "the request budget")
        out["curve"].append(round(t.evaluate("valid"), 4))
        for k in ("sent_bytes", "remote", "wire_bytes"):
            out[k].append(int(m[k]))
        out["loss"].append(float(m["loss"]))
    out["seconds"] = time.perf_counter() - t0
    return out


def summarize(curves: dict) -> dict:
    """The JAX study's verdict over the four curves."""
    out = {k: curves[k] for k in RUNS}
    noise = max(abs(a - b) for a, b in
                zip(out["bf16_seed0"], out["bf16_seed1"]))
    gap = max(abs(a - b) for a, b in
              zip(out["bf16_seed0"], out["fp8_seed0"]))
    gap_cold = max(abs(a - b) for a, b in
                   zip(out["bf16_seed0"], out["fp8_cold_seed0"]))
    out["max_seed_noise"] = round(noise, 4)
    out["max_fp8_gap"] = round(gap, 4)
    out["max_fp8_cold_gap"] = round(gap_cold, 4)
    out["within_noise"] = bool(gap <= noise * 1.5 + 0.01)
    return out


def _rank_main(out_path: str, epochs: int, nodes: int) -> None:
    """One rank: every run, in order; rank 0 writes the runs' records."""
    import torch
    import torch.distributed as dist

    from ..parallel.mesh import maybe_initialize_distributed
    from ..partition import multiconstraint_partition

    torch.set_num_threads(1)
    maybe_initialize_distributed(device="cpu")
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        g = study_graph(nodes)
        labels = multiconstraint_partition(g.rowptr, g.col, world, seed=0)
        runs = {name: run(g, labels, epochs, *args)
                for name, args in RUNS.items()}
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(runs, f)
    finally:
        dist.destroy_process_group()


def run_study(out: str = DEFAULT_OUT, world: int = WORLD,
              epochs: int = EPOCHS, nodes: int = NODES,
              timeout_s: float = 3000.0) -> dict:
    """Run the study in ``world`` gloo ranks and write its result to
    ``out``: the JAX study's keys (the four curves, the gaps, the
    verdict), then each run's losses, exchange sums and seconds, the
    settings and the wall time."""
    from . import run_ranks

    t0 = time.perf_counter()
    tmp = os.path.abspath(out) + ".ranks.tmp"
    run_ranks(["-m", "salient_plusplus_tpu_torch.experiments.fp8_study",
               "--rank-of", json.dumps(dict(out_path=tmp, epochs=epochs,
                                            nodes=nodes))],
              world, timeout_s)
    with open(tmp) as f:
        runs = json.load(f)
    os.unlink(tmp)
    res = summarize({k: v["curve"] for k, v in runs.items()})
    res["runs"] = {k: {f: v[f] for f in ("loss", "sent_bytes", "remote",
                                         "wire_bytes", "seconds")}
                   for k, v in runs.items()}
    res["settings"] = {"world": world, "epochs": epochs, "nodes": nodes,
                       "classes": CLASSES, "ranks": "gloo, CPU"}
    res["wall_s"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=2)
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--rank-of", help=argparse.SUPPRESS)  # run_study's
    a = ap.parse_args(argv)
    if a.rank_of:
        _rank_main(**json.loads(a.rank_of))
        return
    if os.path.abspath(a.out) == os.path.abspath(
            os.path.join("docs", "fp8_study.json")):
        sys.exit("docs/fp8_study.json is the JAX study's result")
    print(json.dumps(run_study(a.out), indent=2))


if __name__ == "__main__":
    main()
