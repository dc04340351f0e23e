"""Readings that set the limits of a cell's correctness check.

    python3 -m gnnbench.control --workload <name> --seeds 1,2,3 \
        [--seconds 2] [--out <file>.jsonl]

For each seed, in one process, a run of the cell as ``gnnbench.run``
makes it (a short window), with the check's numbers for the program and,
beside them, the control's: the plain reference put in the program's
place in the next precision below the configuration's (bfloat16 -> fp8
e4m3), and, for training, a half batch (the loss over half the seeds).
Each side is judged by the cell's own limits (``limits/<cell>.json``),
as the run judges the program: ``control_correct`` has to come out
false. One JSON line a seed on standard output (and appended to
``--out``). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from types import SimpleNamespace

from .cell import resolve
from .judge import verdict
from .run import fixed_caches, log, run_cell


SIDES = ("control", "half_batch")


def sides(readings: dict, limits: dict) -> dict:
    """``<side>_correct`` of each side beside the program (the control,
    the half batch): its numbers, and the program's where it has none of
    its own (the sampler's faults), held to the cell's limits."""
    own = {k: v for k, v in readings.items() if not isinstance(v, dict)}
    return {f"{name}_correct": all(
        c["ok"] for c in verdict({**own, **readings[name]}, limits).values())
        for name in SIDES if name in readings}


def main(argv=None, device=None) -> int:
    fixed_caches()
    p = argparse.ArgumentParser(prog="gnnbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    cell = resolve(a.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            log("needs a CUDA card")
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    for seed in (int(s) for s in a.seeds.split(",")):
        args = SimpleNamespace(workload=a.workload, seed=seed,
                               seconds=a.seconds, trace=0)
        out = run_cell(cell, args, device, extra=True)
        line = json.dumps({"workload": a.workload, "seed": seed,
                           "correct": out["correct"],
                           **sides(out["readings"], cell.limits),
                           "readings": out["readings"],
                           "metrics": out["metrics"],
                           "power": out["power"]})
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
        del out
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
