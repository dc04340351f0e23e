"""The inputs of the feature-exchange cases, and the rank body that runs
them through the port's ``assemble_features`` (not a test module).

``tests/test_torch_exchange.py`` spawns WORLD of these ranks in one gloo
group; each writes its rows and ExchangeStats to ``out{rank}.npz``. The
cases are those of the JAX package's ``tests/test_spmd.py``: plain, a VIP
cache, overflow past ``r_cap``, a hot prefix, and the fp8 wire. Numpy and
torch only, so a spawned rank does not import JAX.
"""

import os

import numpy as np

WORLD = 4
V_PER = 64      # rows a partition
F = 8
CASES = ("plain", "cache", "overflow", "hot", "fp8")
DTYPES = ("float32", "bfloat16")


def make_case(name: str) -> dict:
    """One case's inputs for every rank, from a seed (the case's index)."""
    rng = np.random.default_rng(100 + CASES.index(name))
    V = WORLD * V_PER
    x = rng.normal(size=(V, F)).astype(np.float32)
    offs = np.arange(WORLD + 1, dtype=np.int32) * V_PER
    c = dict(x=x, part_offsets=offs, hot_size=-1, wire_fp8=name == "fp8")
    if name in ("plain", "fp8"):
        N_cap, c["r_cap"] = 96, 32
        sizes = [int(rng.integers(40, N_cap)) for _ in range(WORLD)]
        lists = [rng.choice(V, size=n, replace=False) for n in sizes]
    elif name == "overflow":
        N_cap, c["r_cap"] = 96, 4
        lists = [rng.choice(V, size=80, replace=False) for _ in range(WORLD)]
    elif name == "hot":
        N_cap, c["r_cap"], c["hot_size"] = 64, 32, 32
        lists = [rng.choice(V, size=48, replace=False) for _ in range(WORLD)]
    else:  # cache: local + cached + other remote ids
        N_cap, c["r_cap"] = 64, 16
        cache_v, lists = [], []
        for d in range(WORLD):
            remote = np.setdiff1d(np.arange(V),
                                  np.arange(offs[d], offs[d + 1]))
            cache_v.append(np.sort(rng.choice(remote, 32, replace=False)))
        for d in range(WORLD):
            local = rng.choice(np.arange(offs[d], offs[d + 1]), 8,
                               replace=False)
            cached = rng.choice(cache_v[d], 8, replace=False)
            rest = rng.choice(V, 16, replace=False)
            ids = np.unique(np.concatenate([local, cached, rest]))
            rng.shuffle(ids)
            lists.append(ids)
        c["cache_v"] = np.stack(cache_v).astype(np.int32)
        c["cache_f"] = x[c["cache_v"]]
    n_id = np.zeros((WORLD, N_cap), np.int32)
    for d, ids in enumerate(lists):
        n_id[d, :len(ids)] = ids
    c["n_id"] = n_id
    c["counts"] = np.array([len(ids) for ids in lists], np.int32)
    H = c["hot_size"] if c["hot_size"] > 0 else V_PER
    c["shards"] = np.stack([x[p * V_PER:p * V_PER + H]
                            for p in range(WORLD)])
    return c


def run_rank(rank: int, init_file: str, out_dir: str) -> None:
    """One gloo rank: every case in every dtype."""
    import torch
    import torch.distributed as dist

    from salient_plusplus_tpu_torch.parallel.exchange import (
        DeviceCache, assemble_features)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WORLD)
    try:
        out = {}
        for name in CASES:
            c = make_case(name)
            for dt in DTYPES:
                dtype = getattr(torch, dt)
                cache = None
                if "cache_v" in c:
                    cache = DeviceCache(
                        torch.from_numpy(c["cache_v"][rank]),
                        torch.from_numpy(c["cache_f"][rank]).to(dtype))
                x, st = assemble_features(
                    torch.from_numpy(c["shards"][rank]).to(dtype),
                    torch.from_numpy(c["n_id"][rank]),
                    torch.tensor(int(c["counts"][rank])),
                    torch.from_numpy(c["part_offsets"]), c["r_cap"],
                    cache=cache,
                    hot_size=c["hot_size"] if c["hot_size"] > 0 else None,
                    wire_fp8=c["wire_fp8"])
                key = f"{name}_{dt}"
                out[key] = x.to(torch.float32).numpy()
                for field, v in st._asdict().items():
                    out[f"{key}_{field}"] = v.numpy()
        np.savez(os.path.join(out_dir, f"out{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
