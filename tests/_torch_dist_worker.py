"""The inputs of the data-parallel parity tests and the rank bodies that run
them through the port (not a test module).

``tests/test_torch_spmd.py``, ``test_torch_dist_trainer.py`` and
``test_torch_train.py`` each spawn WORLD of these ranks once, in one gloo
group with a group timeout; the ranks write their results into the test's
temp directory and the test holds them to the JAX package's
``make_spmd_train_step`` / ``DistributedTrainer`` on the same inputs. At
module level this imports numpy only: a spawned rank imports torch and the
port, never JAX, and the JAX side passes its own modules into the
functions that build inputs.
"""

import json
import os
import time

import numpy as np

WORLD = 2
GROUP_TIMEOUT_S = 120
SPAWN_TIMEOUT_S = 240

# --- parallel/spmd.py: the step on hand-made batches -------------------
SPMD_V_PER = 128        # rows a partition
SPMD_STEPS = 3
SPMD_BATCH = 16
SPMD_FANOUTS = (3, 2)
SPMD_HIDDEN = 16
SPMD_R_CAP = 256
SPMD_LR = 0.01
SPMD_MODELS = ("SAGE", "GAT", "JKNet")   # GAT with every hop mirrored
SPMD_MODES = ("replicated", "partitioned")


def spmd_graph(synthetic):
    """The step tests' graph (either package's ``data.synthetic``): its
    ids are already contiguous by partition, rank r owning
    ``[128 r, 128 r + 128)``."""
    return synthetic.planted_partition(
        name="spmd", num_nodes=WORLD * SPMD_V_PER, num_classes=4,
        avg_degree=6, num_features=8, seed=5)


def spmd_batch(cpp, sampler, spec_cls, g, step: int, rank: int,
               mirror_all: bool):
    """Rank ``rank``'s batch of step ``step``, sampled and wire-encoded
    (ddeg, packed ids) by one package's sampler modules."""
    spec = spec_cls.worst_case(SPMD_BATCH, SPMD_FANOUTS)
    spec = spec_cls(spec.fanouts, spec.seed_cap, spec.node_caps,
                    spec.edge_caps, mirror_all=mirror_all)
    seeds = np.sort(np.random.default_rng(1000 * step + rank).choice(
        np.arange(rank * SPMD_V_PER, (rank + 1) * SPMD_V_PER), SPMD_BATCH,
        replace=False))
    cfg = sampler.FastSamplerConfig(spec=spec, batch_size=SPMD_BATCH,
                                    compress_dst=True, pack_wire=True)
    bufs = cpp.BatchBuffers(spec)
    bufs.attach_from_config(cfg, g.num_nodes)
    cpp.NativeSampler(np.asarray(g.rowptr, np.int64),
                      np.asarray(g.col, np.int32)).sample_into(
        bufs, seeds, rng_seed=7 + 10 * step + rank,
        y_global=np.asarray(g.y, np.int32))
    bufs.finalize_from_config(cfg)
    return bufs.to_padded_batch()


def flatten(tree, prefix=""):
    """Nested dict of arrays -> {"a/b/c": array} (an npz can hold it)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *mods, leaf = key.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.asarray(v)
    return out


def _init(rank: int, init_file: str):
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=WORLD,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def spmd_rank(rank: int, init_file: str, out_dir: str) -> None:
    """Every (model, mode) leg: SPMD_STEPS float32 steps from the JAX
    package's initial weights (``init_{model}.npz``), then one eval
    step; and the dropout leg."""
    import torch
    import torch.distributed as dist

    from salient_plusplus_tpu_torch import weights
    from salient_plusplus_tpu_torch.data import synthetic
    from salient_plusplus_tpu_torch.data.dataset import pad_feature_dim
    from salient_plusplus_tpu_torch.models import make_model
    from salient_plusplus_tpu_torch.parallel import spmd
    from salient_plusplus_tpu_torch.sampling import cpp, sampler
    from salient_plusplus_tpu_torch.sampling.batch import BatchSpec
    from salient_plusplus_tpu_torch.train.state import TrainState

    _init(rank, init_file)
    try:
        g = spmd_graph(synthetic)
        x = torch.from_numpy(pad_feature_dim(np.asarray(g.x, np.float32)))
        offs = torch.arange(WORLD + 1) * SPMD_V_PER
        out = {}

        def fresh(name, dropout=0.0):
            m = make_model(name, x.shape[1], SPMD_HIDDEN, 4, 2, dropout,
                           dtype=torch.float32)
            init = np.load(os.path.join(out_dir, f"init_{name}.npz"))
            flat = {k: init[k] for k in init.files}
            sd = weights.params_from_jax(unflatten(
                {k[2:]: v for k, v in flat.items() if k.startswith("p/")}))
            sd.update(weights.batch_stats_from_jax(unflatten(
                {k[2:]: v for k, v in flat.items() if k.startswith("s/")})))
            m.load_state_dict(sd)
            return TrainState(m, SPMD_LR, seed=0, device=torch.device("cpu"))

        for name in SPMD_MODELS:
            batches = [spmd_batch(cpp, sampler, BatchSpec, g, t, rank,
                                  name == "GAT") for t in range(SPMD_STEPS)]
            for mode in SPMD_MODES:
                key = f"{name}_{mode}"
                feats = (x if mode == "replicated" else
                         x[rank * SPMD_V_PER:(rank + 1) * SPMD_V_PER])
                st = fresh(name)
                kw = dict(feature_mode=mode, part_offsets=offs,
                          r_cap=SPMD_R_CAP)
                for t, b in enumerate(batches):
                    loss, ex = spmd.train_step(st, feats, b, **kw)
                    out[f"{key}_loss{t}"] = loss.numpy()
                    if ex is not None:
                        for f, v in ex._asdict().items():
                            out[f"{key}_ex{t}_{f}"] = v.numpy()
                sd = st.model.state_dict()
                for k, v in flatten(weights.params_to_jax(sd)).items():
                    out[f"{key}_p/{k}"] = v
                for k, v in flatten(weights.batch_stats_to_jax(sd)).items():
                    out[f"{key}_s/{k}"] = v
                out[f"{key}_eval"] = spmd.eval_step(st, feats, batches[0],
                                                    **kw).numpy()
        # dropout 0.5: the same batch and weights on both ranks; the
        # forward's output (per rank, before any averaging) shows the mask
        b = spmd_batch(cpp, sampler, BatchSpec, g, 0, 0, False)
        for run in (0, 1):
            st = fresh("SAGE", dropout=0.5)
            seen = []
            h = st.model.register_forward_hook(
                lambda m, a, o: seen.append(o.detach().clone()))
            spmd.train_step(st, x, b, "replicated", offs, SPMD_R_CAP)
            h.remove()
            out[f"dropout_out{run}"] = seen[0].numpy()
        np.savez(os.path.join(out_dir, f"spmd{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


# --- train/dist_loop.py: the trainer on tests/_mp_worker.py's config ---
MP_GRAPH = dict(name="mp", num_nodes=4096, num_classes=4, avg_degree=8,
                num_features=16, seed=21)
DRYRUN_GRAPH = dict(name="dry", num_nodes=1500, num_classes=4,
                    avg_degree=7, num_features=16, seed=3)
MP_CFG = dict(train_batch_size=32, train_fanouts=[4, 3],
              batchwise_test_fanouts=[5, 5], final_test_fanouts=[5, 5],
              hidden_features=16, num_layers=2, lr=0.01, num_workers=1,
              calibration_batches=2, seed=3, cache_size=0.2, dropout=0.0)
DRYRUN_CFG = dict(train_batch_size=16, test_batch_size=32,
                  train_fanouts=[3, 2], batchwise_test_fanouts=[4, 4],
                  final_test_fanouts=[4, 4], hidden_features=16,
                  num_layers=2, lr=0.01, num_workers=1,
                  calibration_batches=2, seed=0,
                  load_balance_scheme="federated", cache_size=0.2,
                  hbm_fraction=0.75, cold_fp8=True, dropout=0.0)
# leg: (graph, partitioner, config)
TRAINER_LEGS = {
    "federated_cache": ("mp", "contiguous", MP_CFG),
    "owner_cold_fp8": ("mp", "contiguous", dict(
        MP_CFG, hbm_fraction=0.75, cold_mode="owner", cold_fp8=True)),
    "replicated_cold": ("mp", "contiguous", dict(
        MP_CFG, hbm_fraction=0.75, cold_mode="replicated")),
    "r_cap_growth": ("mp", "contiguous", MP_CFG),
    # __graft_entry__.py::dryrun_multichip's two legs at world 2
    "dryrun_federated": ("dry", "multiconstraint", DRYRUN_CFG),
    "dryrun_fully_random": ("dry", "multiconstraint", dict(
        DRYRUN_CFG, hbm_fraction=1.0, cold_fp8=False,
        load_balance_scheme="fully_random", wire_fp8=False,
        final_test_mode="layerwise", inference_chunk=128)),
}


def trainer_inputs(leg: str, synthetic, partition):
    """(graph, partition labels, RunConfig kwargs) of a leg, from either
    package's ``data.synthetic`` and ``partition`` modules."""
    gname, how, cfg = TRAINER_LEGS[leg]
    g = synthetic.planted_partition(
        **(MP_GRAPH if gname == "mp" else DRYRUN_GRAPH))
    if how == "contiguous":
        labels = partition.contiguous_partition(g.num_nodes, WORLD)
    else:
        labels = partition.multiconstraint_partition(g.rowptr, g.col, WORLD,
                                                     seed=0)
    return g, labels, cfg


def _epoch(m):
    return {k: (float(v) if k == "loss" else int(v)) for k, v in m.items()}


def drive_leg(leg: str, t) -> dict:
    """What a leg does with a trainer of either package (their trainers
    share these names): the integer caps and counters and the losses it
    records are what the test compares."""
    spec = t.train_spec
    tight = t.train_tight
    rec = dict(iters_per_epoch=int(t.iters_per_epoch),
               spec=[spec.seed_cap, list(spec.node_caps),
                     list(spec.edge_caps)],
               tight=(None if tight is None else
                      [list(tight.node_caps), list(tight.edge_caps)]),
               r_cap0=int(t.r_cap), cold_cap=int(t.cold_cap),
               cold_r_cap=int(t.cold_r_cap), epochs=[])
    if leg == "r_cap_growth":
        t.r_cap = 128  # a budget short enough to overflow
        if hasattr(t, "_build_steps"):
            t._build_steps(with_cache=False)
        for epoch in range(4):
            m = _epoch(t.train_epoch(epoch))
            rec["epochs"].append(m)
            if m["overflow"] == 0:
                break
        rec["r_caps"] = [m["r_cap"] for m in rec["epochs"]]
        return rec
    if leg.startswith("dryrun"):
        if leg == "dryrun_federated":
            t.create_cache()
        rec["cache_ids"] = ([np.asarray(c).tolist()
                             for c in t._cache_ids_host]
                            if t._cache_ids_host is not None else None)
        rec["r_cap1"] = int(t.r_cap)
        rec["epochs"].append(_epoch(t.train_epoch(0)))
        rec["valid"] = float(t.evaluate("valid"))
        if leg == "dryrun_federated":  # the fallback rule (hbm < 1)
            rec["layerwise_valid"] = float(
                t.evaluate_layerwise(("valid",))["valid"])
        return rec
    rec["epochs"].append(_epoch(t.train_epoch(0)))
    t.create_cache()
    rec["cache_ids"] = [np.asarray(c).tolist() for c in t._cache_ids_host]
    rec["r_cap1"] = int(t.r_cap)
    rec["epochs"].append(_epoch(t.train_epoch(1)))
    rec["valid"] = float(t.evaluate("valid"))
    return rec


def trainer_rank(rank: int, init_file: str, out_dir: str) -> None:
    """Every trainer leg from the JAX package's initial weights
    (``init_{leg}.npz``); rank 0 writes ``{leg}.json``; the fully-random
    leg also writes each rank's layerwise shard and its trained weights."""
    import torch
    import torch.distributed as dist

    from salient_plusplus_tpu_torch import partition, weights
    from salient_plusplus_tpu_torch.config import RunConfig
    from salient_plusplus_tpu_torch.data import synthetic
    from salient_plusplus_tpu_torch.train.dist_inference import (
        layerwise_inference_spmd)
    from salient_plusplus_tpu_torch.train.dist_loop import DistributedTrainer

    _init(rank, init_file)
    try:
        for leg in TRAINER_LEGS:
            t0 = time.perf_counter()
            g, labels, kw = trainer_inputs(leg, synthetic, partition)
            t = DistributedTrainer(RunConfig(**kw), g, labels, device="cpu")
            init = np.load(os.path.join(out_dir, f"init_{leg}.npz"))
            t.state.model.load_state_dict(weights.params_from_jax(
                unflatten({k: init[k] for k in init.files})), strict=False)
            rec = drive_leg(leg, t)
            rec["own_cache"] = (None if t.cache is None else
                                t.cache.vertices.numpy().tolist())
            rec["seconds"] = time.perf_counter() - t0
            rec["stages"] = t.stats.epoch_region_totals
            if leg == "dryrun_fully_random":
                emb = layerwise_inference_spmd(t, chunk=t.cfg.inference_chunk)
                out = {"emb": emb.numpy()}
                out.update({f"p/{k}": v for k, v in flatten(
                    weights.params_to_jax(t.state.model.state_dict())
                ).items()})
                np.savez(os.path.join(out_dir, f"lw{rank}.npz"), **out)
            with open(os.path.join(out_dir, f"{leg}{rank}.json"), "w") as f:
                json.dump(rec, f)
    finally:
        dist.destroy_process_group()


# --- driver.py: --distribute_data in 2 ranks ---------------------------
DRIVER_SMALL = ["--train_batch_size", "64", "--train_fanouts", "4,3",
                "--batchwise_test_fanouts", "5,5", "--final_test_fanouts",
                "5,5", "--num_layers", "2", "--hidden_features", "16",
                "--num_workers", "1", "--calibration_batches", "2",
                "--lr", "0.01", "--distribute_data", "true"]
DRIVER_SPEC = "synth:V=4096,C=4,deg=8,F=16"


def driver_rank(rank: int, port: int, root: str, partitioned: str) -> None:
    """The driver CLI as a launcher runs it (the environment names the
    group): the VIP cache with the owner-served cold tier for 2 epochs,
    then ``RESUME=1`` to 3, then training from ``partition.cli``'s output
    (``partitioned``), one shard a rank; each call's return value and the
    latest checkpoint before it go to ``{job}_rank{rank}.json``."""
    import torch
    import torch.distributed as dist

    from salient_plusplus_tpu_torch import driver
    from salient_plusplus_tpu_torch.train import checkpoint as ckpt

    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank))
    try:
        cache = ["--computation_mode", "frequency_cache",
                 "--hbm_fraction", "0.75", "--output_root", root]
        runs = [("cache", [DRIVER_SPEC, "cache", "--epochs", "2", *cache]),
                ("resume", [DRIVER_SPEC, "cache", "--epochs", "3", *cache]),
                ("partitioned", [partitioned, "part", "--dataset_root",
                                 root, "--epochs", "1", "--output_root",
                                 root])]
        for job, args in runs:
            os.environ["RESUME"] = "1" if job == "resume" else "0"
            latest = ckpt.latest_epoch(os.path.join(root, args[1]), 0)
            out = driver.main(args + DRIVER_SMALL, device="cpu")
            with open(os.path.join(root, f"{job}_rank{rank}.json"),
                      "w") as f:
                json.dump({"out": out, "latest_before": latest}, f)
        # the replicated cold tier needs every shard on each host
        from salient_plusplus_tpu_torch.config import RunConfig
        from salient_plusplus_tpu_torch.train.dist_loop import (
            DistributedTrainer)

        try:
            DistributedTrainer.from_partitioned(
                RunConfig(hbm_fraction=0.75, cold_mode="replicated"), root,
                partitioned, device="cpu")
            refused = False
        except ValueError:
            refused = True
        with open(os.path.join(root, f"refused_rank{rank}.json"), "w") as f:
            json.dump(refused, f)
    finally:
        dist.destroy_process_group()


def start(fn, args):
    """Start WORLD ranks of ``fn(rank, *args)``; :func:`wait` joins them."""
    import torch.multiprocessing as tmp

    return tmp.spawn(fn, args=args, nprocs=WORLD, join=False)


def wait(ctx, what: str) -> None:
    """Join the ranks; kill them if they take over SPAWN_TIMEOUT_S."""
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError(f"{what}: the gloo ranks did not finish in "
                               f"{SPAWN_TIMEOUT_S} s")
