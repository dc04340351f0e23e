#!/usr/bin/env python3
"""Bench-shape training of SAGE, GAT and GCN (``chip_smoke.py`` phase 5) for
several checkouts of this repository, one after another on one NVIDIA GPU:

    python3 tools/bench_ab.py CHECKOUT [CHECKOUT ...]

Each checkout runs in a process of its own, in the order given, with its
own ``chip_smoke.py`` and its own kernels (built in that checkout): the
1M-node power-law bench graph, 20 warm-up and 40 timed steps of each model
at the bench config, then layerwise inference of the SAGE model over the
whole graph (``chip_smoke.phase_layerwise_bench``). Give two checkouts in
turns (parent, change, change, parent) to compare them on one card. Each
process prints one line ``AB {"checkout": ..., "SAGE": {...}, ...,
"layerwise": {...}}`` with each model's step time (ms, host clock) and
train edges/s, and the layerwise seconds and nodes/s; the last lines
repeat them as a table with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
dev = torch.device("cuda", 0)
power = cs.nvidia_smi()
torch.backends.cuda.matmul.allow_tf32 = False
cs.phase_build()
tr = cs.bench_trainer(dev)
out = {}
for m in ("SAGE", "GAT", "GCN"):
    t = tr if m == "SAGE" else cs.model_trainer(tr, m, dev)
    r = cs.phase_bench(t, dev, power)
    out[m] = {k: r[k] for k in ("step_ms", "edges_per_s",
                                "h2d_bytes_per_batch")}
    del t
lw = cs.phase_layerwise_bench(tr, dev, power)
out["layerwise"] = {k: lw[k] for k in ("total_s", "nodes_per_s")}
print("AB " + json.dumps(dict(out, checkout=sys.argv[1], power=power)),
      flush=True)
"""


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rows = []
    for root in argv:
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, "-c", CHILD, root], cwd=root,
                              capture_output=True, text=True, timeout=1200)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"{root}: exit {proc.returncode}", file=sys.stderr)
            return 1
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        rows.append(json.loads(line[-1][3:]))
    for r in rows:
        lw = r["layerwise"]
        print(f"{r['checkout']}: " + "  ".join(
            f"{m} {r[m]['step_ms']:.3f} ms {r[m]['edges_per_s'] / 1e6:.2f}M e/s"
            for m in ("SAGE", "GAT", "GCN")) + f"  layerwise "
            f"{lw['total_s']:.3f} s {lw['nodes_per_s'] / 1e6:.3f}M nodes/s"
            f"  [{r['power']}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
