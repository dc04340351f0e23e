"""Main CLI driver (counterpart of the JAX package's ``driver.py``).

Usage:
    python -m salient_plusplus_tpu_torch.driver <dataset> <job_name> [--flags]
        [--do_test_run epoch0,epoch1,...]

<dataset> is a GraphData directory name under --dataset_root, or a
synthetic spec "synth:V=100000,C=32,deg=12,F=64". The flags are the JAX
driver's (every RunConfig field). The port runs single-card training and
a batchwise or layerwise (``--final_test_mode layerwise``) final test on a
CUDA device, with the feature table all on the card or, with
``--hbm_fraction`` below 1, its cold tail in host RAM;
``main(argv, device="cpu")`` runs it on the CPU. Checkpoints
go to the job directory; ``RESUME=1`` restarts a trial from its latest
one, and ``--do_test_run e0,e1,...`` scores saved epochs instead of
training. What later slices bring raises NotImplementedError naming its
ROADMAP.md item.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np


def load_dataset(cfg, name: str):
    from .data import GraphData, synthetic

    if name.startswith("synth:"):
        kv = dict(p.split("=") for p in name[6:].split(",") if p)
        return synthetic.planted_partition(
            name=name.replace(":", "-").replace(",", "-").replace("=", ""),
            num_nodes=int(kv.get("V", 100_000)),
            num_classes=int(kv.get("C", 32)),
            avg_degree=int(kv.get("deg", 12)),
            num_features=int(kv.get("F", 64)),
            p_intra=float(kv.get("intra", 0.7)),
            feature_noise=float(kv.get("noise", 1.0)),
            # hardness knobs imply the normalized construction
            normalize=("noise" in kv or "intra" in kv),
            seed=int(kv.get("seed", 0)),
        )
    path = os.path.join(cfg.dataset_root, name)
    if os.path.exists(os.path.join(path, "meta.json")):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("num_parts", 1) > 1:
            raise NotImplementedError(
                f"{name} is a partitioned dataset: ROADMAP.md Queue 1 "
                "items 16-17 (slice 4)")
        return GraphData.load(cfg.dataset_root, name)
    raise NotImplementedError(
        f"dataset {name!r} is neither a synth: spec nor a GraphData "
        f"directory under {cfg.dataset_root}; OGB ingest is ROADMAP.md "
        "Queue 1 item 18 (slice 5)")


def _reject_unported(cfg) -> None:
    if cfg.distribute_data:
        raise NotImplementedError(
            "--distribute_data: ROADMAP.md Queue 1 items 16-17 (slice 4)")
    if cfg.execution_mode == "communication_simulation":
        raise NotImplementedError(
            "communication_simulation: ROADMAP.md Queue 1 item 15 (slice 4)")


def run_computation(cfg, graph, job_dir: str, logger, device=None):
    """Trial loop → epochs → periodic valid → final test (single card)."""
    from .train.loop import Trainer

    results = []
    for trial in range(cfg.trials):
        trainer = Trainer(cfg, graph, logger=logger, device=device)
        res = trainer.run_trial(trial, checkpoint_dir=job_dir)
        logger.log("performance_breakdown", trainer.stats.summary())
        results.append({"trial": trial, "best_epoch": res.best_epoch,
                        "best_valid": res.best_valid_acc,
                        "final_valid": res.final_valid_acc,
                        "final_test": res.final_test_acc,
                        "epoch_times": [round(t, 3)
                                        for t in res.epoch_times],
                        "losses": res.losses})
        logger.log("trial_complete", results[-1])
        print(f"trial {trial}: best@{res.best_epoch} "
              f"valid={res.best_valid_acc:.4f} "
              f"final_valid={res.final_valid_acc:.4f} "
              f"final_test={res.final_test_acc:.4f}")
    return results


def do_test_run(cfg, graph, job_dir: str, checkpoint_epochs, logger,
                device=None):
    """Score saved checkpoints of trial 0 on valid and test (batchwise)."""
    from .train import checkpoint as ckpt
    from .train.loop import Trainer

    trainer = Trainer(cfg, graph, logger=logger, device=device)
    out = []
    for epoch in checkpoint_epochs:
        trainer.state = ckpt.restore(job_dir, trainer.state, 0, epoch)
        acc_v = trainer.evaluate("valid")
        acc_t = trainer.evaluate("test")
        logger.log("test_run", epoch, acc_v, acc_t)
        out.append({"epoch": epoch, "valid": acc_v, "test": acc_t})
        print(f"checkpoint epoch {epoch}: valid={acc_v:.4f} test={acc_t:.4f}")
    return out


def main(argv=None, device=None):
    """Run the CLI; ``device=None`` means CUDA."""
    from .config import RunConfig
    from .utils.device import resolve_device
    from .utils.logging import RunLogger

    usage = ("usage: python -m salient_plusplus_tpu_torch.driver "
             "<dataset> <job_name> [--flags] "
             "[--do_test_run epoch0,epoch1,...]")
    argv = argv if argv is not None else sys.argv[1:]
    if argv and not argv[0].startswith("-"):
        if len(argv) < 2 or argv[1].startswith("-"):
            print(usage, file=sys.stderr)
            sys.exit(2)
        dataset_name, job_name, rest = argv[0], argv[1], argv[2:]
    else:
        dataset_name, job_name, rest = "synth:V=50000", "job", argv
    test_run_epochs = None
    if "--do_test_run" in rest:
        i = rest.index("--do_test_run")
        if i + 1 >= len(rest):
            print(usage, file=sys.stderr)
            sys.exit(2)
        test_run_epochs = [int(e) for e in rest[i + 1].split(",")]
        rest = rest[:i] + rest[i + 2:]
    cfg = RunConfig.from_args(rest)
    cfg = cfg.replace(dataset_name=dataset_name, job_name=job_name)
    _reject_unported(cfg)
    device = resolve_device(device)

    job_dir = os.path.join(cfg.output_root, job_name)
    os.makedirs(job_dir, exist_ok=True)
    with open(os.path.join(job_dir, "args.json"), "w") as f:
        f.write(cfg.to_json())
    logger = RunLogger(job_dir, host=os.environ.get("HOSTNAME", "host0"),
                       verbose=cfg.verbose)

    graph = load_dataset(cfg, dataset_name)
    if cfg.make_deterministic:
        np.random.seed(cfg.seed)
    try:
        if test_run_epochs is not None:
            out = do_test_run(cfg, graph, job_dir, test_run_epochs, logger,
                              device=device)
        else:
            out = run_computation(cfg, graph, job_dir, logger, device=device)
    finally:
        from .train.checkpoint import wait_for_async_saves

        wait_for_async_saves()  # never exit with checkpoint IO in flight
        logger.flush()
    with open(os.path.join(job_dir, "results.json"), "w") as f:
        json.dump(out, f, indent=2, default=str)
    return out


if __name__ == "__main__":
    main()
