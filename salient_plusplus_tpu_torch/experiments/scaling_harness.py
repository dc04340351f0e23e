"""Host-overhead harness: what the data-parallel trainer's host stages cost
once a step crosses a process boundary (counterpart of the repo's
``experiments/scaling_harness.py``).

The JAX harness runs the same 8 mesh devices as one process and as two
processes of 4, so only the process boundary differs. The port has one
process a device, so its legs ask the same question in its own launch
model: one gloo rank (world 1) against two (world 2), both on the CPU, at
the same per-rank batch, graph and config as the JAX harness's
``_build_trainer`` (8,192 nodes, 8 classes, degree 10, 32 features;
batch 64, fanouts [5, 4], hidden 32, 2 layers, ``hbm_fraction`` 0.75
with the owner-served cold tier, ``federated`` balancing). World 2 runs
half the steps of an epoch that world 1 runs (the same seeds split over
two ranks), so the legs are compared a step: ``marginal_stage_s`` is
world 2's per-step stage time less world 1's, times world 2's steps an
epoch, i.e. what the process boundary adds to a world-2 epoch. Each
stage is the trainer's ``RuntimeStats`` entry of the JAX package's name
(``HOST_STAGES``); epoch 0 is warm-up and is skipped. Device compute
shares the host's cores in both legs, so the epoch walls are not the
signal: the stages and their shares of the step are.

    python -m salient_plusplus_tpu_torch.experiments.scaling_harness \\
        [--out docs/scaling_harness_torch.json]
"""

from __future__ import annotations

import argparse
import json
import os
import time

EPOCHS = 3
NODES = 8192
HOST_STAGES = ("sample_wait", "assemble_h2d", "cold_serve", "bucket_psum")
DEFAULT_OUT = os.path.join("docs", "scaling_harness_torch.json")


def _build_trainer(world: int, nodes: int):
    from ..config import RunConfig
    from ..data import synthetic
    from ..partition import contiguous_partition
    from ..train.dist_loop import DistributedTrainer

    g = synthetic.planted_partition(
        name="scalh", num_nodes=nodes, num_classes=8, avg_degree=10,
        num_features=32, seed=17)
    labels = contiguous_partition(g.num_nodes, world)
    cfg = RunConfig(
        train_batch_size=64, train_fanouts=[5, 4],
        batchwise_test_fanouts=[6, 6], final_test_fanouts=[6, 6],
        hidden_features=32, num_layers=2, lr=0.01, num_workers=1,
        calibration_batches=3, seed=5, hbm_fraction=0.75,
        cold_mode="owner", load_balance_scheme="federated")
    return DistributedTrainer(cfg, g, labels, device="cpu")


def _measure(world: int, nodes: int, epochs: int) -> dict:
    """This rank's leg: per-epoch and per-step stage seconds (mean over
    the epochs after the first) and each stage's share of the step."""
    t = _build_trainer(world, nodes)
    wall, losses = [], []
    for e in range(epochs):
        t0 = time.perf_counter()
        m = t.train_epoch(e)
        wall.append(time.perf_counter() - t0)
        losses.append(m["loss"])
    rows = t.stats.epoch_region_totals[1:] or t.stats.epoch_region_totals
    n = len(rows)
    stages = {k: sum(r.get(k, 0.0) for r in rows) / n for k in HOST_STAGES}
    timed = wall[1:] or wall
    mean_wall = sum(timed) / len(timed)
    iters = int(m["iters"])
    host = sum(stages.values())
    return {
        "epoch_wall_s": mean_wall,
        "stages_s": stages,
        "host_orchestration_s": host,
        "host_share": host / max(mean_wall, 1e-9),
        "iters": iters,
        "step_s": mean_wall / iters,
        "stages_per_step_s": {k: v / iters for k, v in stages.items()},
        "stage_share_of_step": {k: v / max(mean_wall, 1e-9)
                                for k, v in stages.items()},
        "loss_final": losses[-1],
        "process_count": world,
    }


def _rank_main(out_path: str, nodes: int, epochs: int) -> None:
    import torch
    import torch.distributed as dist

    from ..parallel.mesh import maybe_initialize_distributed

    torch.set_num_threads(1)
    maybe_initialize_distributed(device="cpu")
    try:
        res = _measure(dist.get_world_size(), nodes, epochs)
        if dist.get_rank() == 0:
            with open(out_path, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _leg(world: int, out: str, nodes: int, epochs: int,
         timeout_s: float) -> dict:
    from . import run_ranks

    tmp = os.path.abspath(out) + f".w{world}.tmp"
    run_ranks(["-m", "salient_plusplus_tpu_torch.experiments."
               "scaling_harness", "--rank-of",
               json.dumps(dict(out_path=tmp, nodes=nodes, epochs=epochs))],
              world, timeout_s)
    with open(tmp) as f:
        res = json.load(f)
    os.unlink(tmp)
    return res


def run_harness(out: str = DEFAULT_OUT, nodes: int = NODES,
                epochs: int = EPOCHS, timeout_s: float = 1200.0) -> dict:
    """Both legs, one after the other, and the JAX harness's summary keys;
    written to ``out``."""
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    one = _leg(1, out, nodes, epochs, timeout_s)
    two = _leg(2, out, nodes, epochs, timeout_s)
    per_step = {k: two["stages_per_step_s"][k] - one["stages_per_step_s"][k]
                for k in HOST_STAGES}
    delta = {k: v * two["iters"] for k, v in per_step.items()}
    result = {
        "one_process": one,
        "two_process": two,
        "marginal_stage_s": delta,
        "marginal_host_s": sum(delta.values()),
        "marginal_stage_per_step_s": per_step,
        "settings": {"nodes": nodes, "epochs": epochs,
                     "legs": "gloo ranks on the CPU, world 1 and 2"},
        "wall_s": time.perf_counter() - t0,
        "note": ("world 1 against world 2 at the same per-rank batch; "
                 "marginal_stage_s is the per-step difference times world "
                 "2's steps an epoch; bucket_psum is 0 at world 1 (no "
                 "collective decides the tight bucket there)."),
    }
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--rank-of", help=argparse.SUPPRESS)  # _leg's
    a = ap.parse_args(argv)
    if a.rank_of:
        _rank_main(**json.loads(a.rank_of))
        return
    print(json.dumps(run_harness(a.out), indent=2))


if __name__ == "__main__":
    main()
