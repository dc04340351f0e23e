"""Main CLI driver (counterpart of the JAX package's ``driver.py``).

Usage:
    python -m salient_plusplus_tpu_torch.driver <dataset> <job_name> [--flags]
        [--do_test_run epoch0,epoch1,...]

<dataset> is a GraphData directory name under --dataset_root, a
partitioned ``<name>-reordered-k{K}`` directory written by
``partition/cli.py`` or ``utils/download_datasets.py``, a synthetic spec
"synth:V=100000,C=32,deg=12,F=64", or else an OGB dataset name
(``ogbn-products``, ``MAG240``, ...): ``data/ogb.py`` ingests it into
--dataset_root (needs the ``ogb`` package, and raises an ImportError that
names the alternatives without it).
The flags are the JAX driver's (every RunConfig field). The port runs
single-card training and a batchwise or layerwise (``--final_test_mode
layerwise``) final test on a CUDA device, with the feature table all on
the card or, with ``--hbm_fraction`` below 1, its cold tail in host RAM;
``main(argv, device="cpu")`` runs it on the CPU. Checkpoints go to the
job directory; ``RESUME=1`` restarts a trial from its latest one, and
``--do_test_run e0,e1,...`` scores saved epochs instead of training.
``--execution_mode communication_simulation`` partitions the graph into
``SIM_PARTS`` (default 4) parts and sweeps the cache schemes'
communication volume on the host, with no model and no device.

Data-parallel training (``--distribute_data true``): one process a GPU,
each training its partition of the features (``DistributedTrainer``);
``--computation_mode frequency_cache`` adds the VIP cache. The plain
command on a host with N > 1 cards starts N ranks itself
(``parallel/launch.py::launch_local``, one a card, as ``torchrun
--nproc_per_node N`` would) and returns rank 0's results, as the JAX
driver builds its mesh over every local device; with one card it trains
on that card, as the JAX driver does with one device. Started by a
launcher (``torchrun``, ``srun``, Open MPI's ``mpirun``), the driver
joins the process group first (``parallel/mesh.py``: NCCL on the card,
gloo with ``device="cpu"``; the launcher's variables by JAX's rules).
``--do_test_run`` and ``communication_simulation`` run in one process,
as in JAX. A partitioned dataset must have one part a rank and is loaded
one shard a rank; any other graph is partitioned into one part a rank on
every rank alike. Rank 0 writes the job's files. A single process trains
a partitioned dataset from all its shards.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch.distributed as dist


class PartitionedDatasetRef:
    """An on-disk partition-reordered dataset (``<name>-reordered-k{K}``,
    written by ``partition/cli.py``). The single-card paths call
    :meth:`load_full`; the data-parallel trainer loads one shard a rank
    (``DistributedTrainer.from_partitioned``)."""

    def __init__(self, root: str, name: str, num_parts: int):
        self.root, self.name, self.num_parts = root, name, num_parts

    def load_full(self):
        """Every shard concatenated into one (reordered) GraphData."""
        from .data.dataset import GraphData, PartitionedGraphData

        pgs = [PartitionedGraphData.load_partitioned(self.root, self.name, r)
               for r in range(self.num_parts)]
        pg = pgs[0]
        return GraphData(
            name=pg.name, rowptr=pg.rowptr, col=pg.col,
            x=np.concatenate([p.x for p in pgs], axis=0), y=pg.y,
            split_idx=pg.split_idx, num_classes=pg.num_classes)


def _full(graph):
    """A partitioned dataset loaded whole: what every single-card path
    trains, scores or simulates on."""
    if isinstance(graph, PartitionedDatasetRef):
        return graph.load_full()
    return graph


def load_full_dataset(cfg, name: str):
    """``load_dataset``, with a partitioned dataset loaded whole."""
    return _full(load_dataset(cfg, name))


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
            return PartitionedDatasetRef(cfg.dataset_root, name,
                                         meta["num_parts"])
        return GraphData.load(cfg.dataset_root, name)
    # any other name is ingested from OGB (needs the ogb package)
    if name == "MAG240":  # the homogeneous MAG240M papers component
        from .data.ogb import load_mag240

        return load_mag240(cfg.dataset_root)
    from .data.ogb import load_ogb

    return load_ogb(name, cfg.dataset_root)


# --cache_strategy → the cache schemes the simulation sweeps. "vip" keeps
# the JAX driver's pair; "simulation" maps as the JAX package's
# DistributedTrainer.create_cache maps it (the JAX driver passes it on
# unmapped, and caching/vip.py refuses it: ROADMAP.md Queue 3)
SIM_SCHEMES = {"vip": ("vip-analytical", "degree"),
               "simulation": ("vip-simulation",)}


def run_communication_simulation(cfg, graph, logger):
    """--execution_mode communication_simulation: partition into SIM_PARTS
    (default 4, at least 2) parts, then the scheme × replication-factor
    sweep of the communication volume, with no model (host only)."""
    from .caching.simulate import run_replication_sweep, tabulate_comm_results
    from .partition import multiconstraint_partition

    k = max(2, int(os.environ.get("SIM_PARTS", "4")))
    labels = multiconstraint_partition(graph.rowptr, graph.col, k,
                                       seed=cfg.seed)
    results = run_replication_sweep(
        graph.rowptr, graph.col, labels, graph.split_idx["train"],
        cfg.train_fanouts, cfg.train_batch_size,
        schemes=SIM_SCHEMES.get(cfg.cache_strategy, (cfg.cache_strategy,)),
        replication_factors=tuple(sorted(
            {0.0, 0.01, 0.05, 0.1, 0.2, cfg.cache_size})),
        num_epochs=cfg.cache_creation_epochs, seed=cfg.seed)
    table = tabulate_comm_results(results)
    logger.log("communication_simulation", table)
    print(table)
    return results


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _distributed_trainer(cfg, graph, logger, device):
    """The data-parallel trainer of the default group: one shard a rank
    of a partitioned dataset, else the graph partitioned into one part a
    rank (deterministic, so every rank computes the same labels)."""
    from .partition import multiconstraint_partition
    from .train.dist_loop import DistributedTrainer

    world = _world()
    if isinstance(graph, PartitionedDatasetRef):
        if graph.num_parts != world:
            raise ValueError(f"{graph.name} has {graph.num_parts} parts "
                             f"for {world} ranks")
        tr = DistributedTrainer.from_partitioned(
            cfg, graph.root, graph.name, device=device, logger=logger)
    else:
        labels = multiconstraint_partition(graph.rowptr, graph.col, world,
                                           seed=cfg.seed)
        tr = DistributedTrainer(cfg, graph, labels, device=device,
                                logger=logger)
    if cfg.computation_mode == "frequency_cache":
        tr.create_cache()
    return tr


def run_computation(cfg, graph, job_dir: str, logger, device=None):
    """Trial loop → epochs → periodic valid → final test: data-parallel
    with ``--distribute_data`` and more than one rank, else on one card.
    The data-parallel trainer is built once for all trials (partitioning,
    calibration and the cache do not depend on the trial)."""
    from .ops import launch_counts
    from .train.loop import Trainer

    distributed = cfg.distribute_data and _world() > 1
    if not distributed:
        graph = _full(graph)
    results = []
    dist_trainer = None
    for trial in range(cfg.trials):
        if distributed:
            if dist_trainer is None:
                dist_trainer = _distributed_trainer(cfg, graph, logger,
                                                    device)
            trainer = dist_trainer
        else:
            trainer = Trainer(cfg, graph, logger=logger, device=device)
        res = trainer.run_trial(trial, checkpoint_dir=job_dir)
        logger.log("performance_breakdown", trainer.stats.summary(),
                   *(() if distributed else ("build_s", trainer.build_s)))
        logger.log("kernel_launches", launch_counts())   # this process's
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

    trainer = Trainer(cfg, _full(graph), logger=logger, device=device)
    out = []
    for epoch in checkpoint_epochs:
        trainer.state = ckpt.restore(job_dir, trainer.state, 0, epoch)
        acc_v = trainer.evaluate("valid")
        acc_t = trainer.evaluate("test")
        logger.log("test_run", epoch, acc_v, acc_t)
        out.append({"epoch": epoch, "valid": acc_v, "test": acc_t})
        print(f"checkpoint epoch {epoch}: valid={acc_v:.4f} test={acc_t:.4f}")
    return out


USAGE = ("usage: python -m salient_plusplus_tpu_torch.driver "
         "<dataset> <job_name> [--flags] [--do_test_run epoch0,epoch1,...]")


def parse_argv(argv):
    """(dataset name, job name, the ``--do_test_run`` epochs or None,
    RunConfig) of the CLI's arguments; malformed ones exit with 2."""
    from .config import RunConfig

    if argv and not argv[0].startswith("-"):
        if len(argv) < 2 or argv[1].startswith("-"):
            print(USAGE, file=sys.stderr)
            sys.exit(2)
        dataset_name, job_name, rest = argv[0], argv[1], argv[2:]
    else:
        dataset_name, job_name, rest = "synth:V=50000", "job", argv
    test_run_epochs = None
    if "--do_test_run" in rest:
        i = rest.index("--do_test_run")
        if i + 1 >= len(rest):
            print(USAGE, file=sys.stderr)
            sys.exit(2)
        test_run_epochs = [int(e) for e in rest[i + 1].split(",")]
        rest = rest[:i] + rest[i + 2:]
    cfg = RunConfig.from_args(rest)
    cfg = cfg.replace(dataset_name=dataset_name, job_name=job_name)
    return dataset_name, job_name, test_run_epochs, cfg


def main(argv=None, device=None):
    """Run the CLI; ``device=None`` means CUDA. The simulation mode runs
    on the host and touches no device. A data-parallel training run in a
    plain process on a host with several cards starts one rank a card and
    returns rank 0's results; under a multi-process launcher the process
    group is joined before anything else is done."""
    import torch

    from .parallel.launch import launch_local, local_launch_ranks
    from .parallel.mesh import maybe_initialize_distributed
    from .utils.device import resolve_device
    from .utils.logging import RunLogger

    argv = list(argv if argv is not None else sys.argv[1:])
    dataset_name, job_name, test_run_epochs, cfg = parse_argv(argv)
    simulate = (test_run_epochs is None
                and cfg.execution_mode == "communication_simulation")
    training = test_run_epochs is None and not simulate
    nprocs = local_launch_ranks(
        cfg.distribute_data, training,
        torch.device("cuda" if device is None else device))
    if nprocs > 1:
        return launch_local(argv, nprocs)
    maybe_initialize_distributed(device)
    if not simulate:
        device = resolve_device(device)

    # rank 0 writes the job's files; each rank logs to a file of its own
    writer = _rank() == 0
    job_dir = os.path.join(cfg.output_root, job_name)
    os.makedirs(job_dir, exist_ok=True)
    if writer:
        with open(os.path.join(job_dir, "args.json"), "w") as f:
            f.write(cfg.to_json())
    host = os.environ.get("HOSTNAME", "host0")
    if _world() > 1:
        host = f"{host}-rank{_rank()}"
    logger = RunLogger(job_dir, host=host, verbose=cfg.verbose)

    graph = load_dataset(cfg, dataset_name)
    if cfg.make_deterministic:
        np.random.seed(cfg.seed)
    try:
        if test_run_epochs is not None:
            out = do_test_run(cfg, graph, job_dir, test_run_epochs, logger,
                              device=device)
        elif simulate:
            out = run_communication_simulation(cfg, _full(graph), logger)
        else:
            out = run_computation(cfg, graph, job_dir, logger, device=device)
    finally:
        from .train.checkpoint import wait_for_async_saves

        wait_for_async_saves()  # never exit with checkpoint IO in flight
        logger.flush()
    if writer:
        with open(os.path.join(job_dir, "results.json"), "w") as f:
            json.dump(out, f, indent=2, default=str)
    return out


if __name__ == "__main__":
    from .parallel.launch import RankFailed

    try:
        main()
    except RankFailed as e:
        print(f"driver: {e}", file=sys.stderr)
        sys.exit(e.exit_code)
