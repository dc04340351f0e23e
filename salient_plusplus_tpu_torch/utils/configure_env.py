"""Environment configuration: defaults that follow the machine
(counterpart of the JAX package's ``utils/configure_env.py``).

As the reference's utils/configure_for_environment.py: the CPU count sets
the sampler's worker count (:63-102) and the free disk the datasets that
fit, with a size factor per partition count (:123-152), written to a JSON
file a launcher can read. Run:

    python -m salient_plusplus_tpu_torch.utils.configure_env
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List


# unpartitioned base footprints in GB (configure_for_environment.py:137-144)
DATASET_BASE_GB = {
    "ogbn-arxiv": 0.5,
    "ogbn-products": 2.0,
    "ogbn-papers100M": 100.0,
    "MAG240": 300.0,
}


def _k_footprint_gb(base: float, k: int) -> float:
    """A k-way reordered copy costs about (1 + k/8) of the base (the
    features split once, the shared structure kept once a partition
    count), and the original stays beside it."""
    return base * (1.0 + k / 8.0) + base


def recommended_num_workers(cpu_count: int = 0) -> int:
    """Sampler threads: every core. The feeder thread waits on the device,
    so one thread a core leaves no core idle."""
    n = cpu_count or os.cpu_count() or 4
    return max(1, n)


def feasible_datasets(free_gb: float = 0.0,
                      ks: List[int] = (2, 4, 8)) -> Dict[str, List[int]]:
    """The datasets whose base fits in ``free_gb`` (the free disk by
    default), each with the partition counts whose copies fit too."""
    if not free_gb:
        free_gb = shutil.disk_usage(".").free / 1e9
    out: Dict[str, List[int]] = {}
    for name, base in DATASET_BASE_GB.items():
        fits = [k for k in ks if _k_footprint_gb(base, k) <= free_gb]
        if base <= free_gb:
            out[name] = fits
    return out


def write_environment_config(path: str = "configuration_files") -> str:
    os.makedirs(path, exist_ok=True)
    cfg = {
        "num_workers": recommended_num_workers(),
        "cpu_count": os.cpu_count(),
        "free_gb": round(shutil.disk_usage(".").free / 1e9, 1),
        "feasible_datasets": feasible_datasets(),
    }
    out = os.path.join(path, "environment.json")
    with open(out, "w") as f:
        json.dump(cfg, f, indent=2)
    return out


if __name__ == "__main__":
    with open(write_environment_config()) as f:
        print(f.read())
