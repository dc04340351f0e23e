"""A copy of the benchmark with tiny cells added only as new files: a
configuration and a traffic mix a phase, their limits, a per-layer metric
of its own, and ``BENCHMARK.json`` entries. Runs on the CPU with the
program's plain kernels, in a subprocess started in the copy."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
ROOT = os.path.dirname(PKG)

TRAIN, SCORE = "tiny-sage.train-tiny", "tiny-gat.score-tiny"
GRAPH = {"seed": 5, "num_nodes": 3000, "num_undirected_edges": 24000,
         "num_features": 20, "num_classes": 5,
         "split": {"train": 1000, "valid": 500, "test": 1500},
         "degree_exponent": 0.75, "max_expected_degree": 200}
# the tiny cells' limits, set from their own readings on the CPU (seeds
# 21-28): the program read at most loss 1.1e-3, grad 9.4e-3, update
# 1.2e-2, logp 5.5e-2 in training (its log-probabilities leave in bf16),
# window update 2.3e-3, window logp 2.9e-2, logp 3.5e-3 in scoring; the
# control at least loss 1.9e-3, logp 0.38 and window logp 0.18 in
# training, logp 1.5e-2 in scoring; the half batch at least window update
# 2.2e-2. The window's gradient gap is not compared, as in the real cell
LIMITS = {TRAIN: {"loss_gap": 0.0015, "grad_gap": 0.02, "update_gap": 0.02,
                  "logp_gap": 0.12, "window_update_gap": 0.01,
                  "window_logp_gap": 0.07, "sampler_faults": 0},
          SCORE: {"logp_gap": 0.008, "sampler_faults": 0}}
PROBE = '''"""tiny_probe: the pool's batches, a metric added as a file."""


def read(r):
    return float(len(r.pool.batches))
'''


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make(dst: str) -> str:
    """The copy under ``dst``; returns its root."""
    root = os.path.join(dst, "checkout")
    shutil.copytree(PKG, os.path.join(root, "gnnbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    g = os.path.join(root, "gnnbench")
    for name, model, ref in (("tiny-sage", "SAGE", "sage"),
                             ("tiny-gat", "GAT", "gat")):
        with open(os.path.join(g, "configs", f"{model.lower()}-products"
                               f".json")) as f:
            cfg = json.load(f)
        cfg.update(name=name, graph=GRAPH, hidden_features=16)
        _dump(cfg, os.path.join(g, "configs", f"{name}.json"))
        b["configs"].append({
            "name": name, "source": "https://arxiv.org/abs/2110.08450",
            "file": f"gnnbench/configs/{name}.json", "reduced": ["graph"],
            "why": "a test's tiny graph"})
    _dump({"phase": "train", "rate_metric": "train_edges_per_s",
           "split": "train", "batch_size": 128, "fanouts": [4, 3, 2],
           "sample_seed": 6, "feed_depth": 2, "result_depth": 2},
          os.path.join(g, "traffic", "train-tiny.json"))
    _dump({"phase": "score", "rate_metric": "score_nodes_per_s",
           "split": "test", "batch_size": 128, "fanouts": [4, 4, 4],
           "pool_tight": 3, "pool_outside": 0, "sample_seed": 6,
           "feed_depth": 2,
           "result_depth": 2},
          os.path.join(g, "traffic", "score-tiny.json"))
    for w, lim in LIMITS.items():
        _dump(lim, os.path.join(g, "limits", f"{w}.json"))
    with open(os.path.join(g, "metrics", "tiny_probe.py"), "w") as f:
        f.write(PROBE)
    for w, cfg, tr, rate in ((TRAIN, "tiny-sage", "train-tiny",
                              "train_edges_per_s"),
                             (SCORE, "tiny-gat", "score-tiny",
                              "score_nodes_per_s")):
        b["workloads"].append({"name": w, "config": cfg, "traffic": tr,
                               "chips": 1, "why": "a test's tiny cell"})
        for m in b["end_to_end"]:
            if m["name"] == rate:
                m["workloads"].append(w)
        twin = "sage-products.train-b8192" if w == TRAIN \
            else "gat-products.score-b4096"
        for m in b["per_layer"]:
            if twin in m["workloads"]:
                m["workloads"].append(w)
    b["per_layer"].append({
        "name": "tiny_probe", "unit": "batches", "better": "higher",
        "source": "program_counter", "layer": "host sampler",
        "moves": "setup_s", "workloads": [TRAIN, SCORE]})
    _dump(b, os.path.join(root, "BENCHMARK.json"))
    return root


def run(root: str, workload: str, seed: int = 11, seconds: float = 1.0,
        trace: int = 0, before: str = "", entry: str = "gnnbench.run",
        extra_args=(), timeout: float = 300.0):
    """Run ``entry``'s ``main`` in the copy on the CPU, after the Python
    lines ``before`` (a planted fault). Returns (returncode, stdout,
    stderr)."""
    args = ["--workload", workload, "--seed", str(seed),
            "--seconds", str(seconds)]
    if entry == "gnnbench.run":
        args += ["--trace", str(trace)]
    args += list(extra_args)
    code = (f"import sys\n{before}\nimport {entry} as m\n"
            f"rc = m.main({args!r}, device='cpu')\n"
            f"print('MODULES', sorted({{k.split('.')[0] for k in "
            f"sys.modules}}), file=sys.stderr)\n"
            f"sys.exit(rc)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=timeout)
    return p.returncode, p.stdout, p.stderr


def result(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])
