"""Real-data readiness drill: every stage after the download, at real
scale (counterpart of the JAX package's ``utils/readiness_drill.py``).

Real data comes through a download (``download_datasets.py``, or OGB
through ``data/ogb.py``). This drill proves every stage after it at
ogbn-products' shape, through the port's own CLIs:

  1. generate a products-shaped dataset in a child process (default
     2.45M nodes, 100 features in fp16, 47 classes, average degree 15, 8%
     train and 2% valid) and write it in the on-disk format
     (``GraphData.save``);
  2. load it back through the driver's dataset loader and
  3. partition and VIP-reorder it with ``partition.cli`` in a child
     process, which writes the partitioned layout;
  4. train N epochs and score through the driver (``driver.main``) in a
     child process, on the saved unpartitioned dataset, on the card
     (``device=None``) or where ``device`` says; the child writes the
     launches of the three kernels (K1 sorted segment sum, K2 fused
     gather + segment sum, K3 row gather) and the card's peak allocated
     bytes beside its ``results.json``; a layerwise final test logs its
     seconds;
  5. record the seconds and the peak RSS of each stage, its child's own
     (does ingest and reorder at products scale fit this host's RAM).

Without a network the download itself and the OGB accuracy anchors stay
unverified (the labels here are random). Usage:

    python -m salient_plusplus_tpu_torch.utils.readiness_drill \
        --nodes 2450000 --parts 8 --epochs 1 --final_test_mode layerwise \
        --out products_drill.json
"""

from __future__ import annotations

import argparse
import ast
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# the directory that holds the package, for the children's imports
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_GENERATE = ("import sys; from salient_plusplus_tpu_torch.utils."
             "readiness_drill import generate_child; "
             "generate_child(*sys.argv[1:])")
_TRAIN = ("import sys; from salient_plusplus_tpu_torch.utils.readiness_drill "
          "import train_child; train_child(sys.argv[1], sys.argv[2], "
          "sys.argv[3:])")


def _child_env() -> dict:
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ,
                PYTHONPATH=_REPO if not path else _REPO + os.pathsep + path)


def _run_child(cmd) -> float:
    """Run ``cmd`` to its end (CalledProcessError if it fails); returns
    that child's peak RSS in GB (``wait4``'s usage of it alone). A child
    starts from the drill's own high-water mark (Linux copies it at fork
    and keeps it across exec), so every stage runs in a child and the
    drill itself stays small."""
    proc = subprocess.Popen(cmd, env=_child_env())
    try:
        _, status, usage = os.wait4(proc.pid, 0)
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    proc.returncode = os.waitstatus_to_exitcode(status)
    if proc.returncode:
        raise subprocess.CalledProcessError(proc.returncode, cmd)
    return usage.ru_maxrss / 1e6  # kB


def generate_child(root: str, nodes: str, feature_dim: str) -> None:
    """Stage 1's child: the products-shaped graph, saved under ``root``
    as ``drill-products`` (fp16 rows, CSR)."""
    from ..data import synthetic

    synthetic.powerlaw_graph(
        name="drill-products", num_nodes=int(nodes), avg_degree=15,
        num_features=int(feature_dim), num_classes=47, seed=0,
        train_frac=0.08, valid_frac=0.02).save(root)


def train_child(launches_path: str, device: str, argv) -> None:
    """Stage 4's child: ``driver.main(argv)`` on ``device`` ("" for the
    card), with each kernel's launch count set to 0 just before and
    written to ``launches_path`` just after, beside the card's peak
    allocated bytes over the run (None on the CPU)."""
    import torch

    from ..driver import main
    from ..ops.pallas_aggregate import fused_gather_segment_sum
    from ..ops.pallas_gather import pallas_gather_rows
    from ..ops.sorted_segment import sorted_segment_sum_mxu

    wrappers = {"sorted_segment_sum": sorted_segment_sum_mxu,
                "fused_gather_segment_sum": fused_gather_segment_sum,
                "gather_rows": pallas_gather_rows}
    for w in wrappers.values():
        w.launches = 0
    main(list(argv), device=device or None)
    peak = (torch.cuda.max_memory_allocated()
            if torch.cuda.is_initialized() else None)
    with open(launches_path, "w") as f:
        json.dump({"launches": {k: w.launches for k, w in wrappers.items()},
                   "max_memory_allocated": peak}, f)


def _logged(job_dir: str, key: str):
    """The value of the last ``(key, value)`` event in the job's logs."""
    out = None
    for path in glob.glob(os.path.join(job_dir, "*_logs.txt")):
        with open(path) as f:
            for line in f:
                if line.startswith(f"('{key}', "):
                    out = ast.literal_eval(line)[1]
    return out


def run_drill(nodes: int = 2_450_000, parts: int = 8, epochs: int = 3,
              root: str | None = None, feature_dim: int = 100,
              fanouts: str = "15,10,5", batch: int = 1024,
              workers: int = 0, json_out: str | None = None,
              final_test_mode: str = "batchwise",
              resume: bool = False, device=None) -> dict:
    """``root`` defaults to ``products_drill`` in the temporary directory.
    ``final_test_mode="layerwise"`` is the one to use at 10M+ nodes: the
    batchwise final test samples 3-hop neighbourhoods for every node,
    where layerwise inference computes every node's representation a
    layer at a time (models/inference.py; the reference's
    layerwise_inference, driver/models.py:441-495). ``resume`` skips
    stages 1-3 when the saved dataset and its reordered layout exist.
    ``device``: where stage 4 trains (None: the card; it raises without
    one)."""
    root = root or os.path.join(tempfile.gettempdir(), "products_drill")
    os.makedirs(root, exist_ok=True)
    report = {"nodes": nodes, "parts": parts, "epochs": epochs,
              "stages": {}}
    if resume and json_out and os.path.exists(json_out):
        # keep the first run's stage receipts in the merged record
        with open(json_out) as f:
            prior = json.load(f)
        report["stages"].update(prior.get("stages", {}))
        report["num_edges"] = prior.get("num_edges")

    def stage(name, t0, rss_gb):
        report["stages"][name] = {
            "seconds": round(time.perf_counter() - t0, 1),
            "peak_rss_gb": round(rss_gb, 2)}
        print(f"[drill] {name}: {report['stages'][name]}", flush=True)
        # written after every stage: a drill that dies in stage 4 still
        # leaves the receipts of stages 1-3 on disk
        if json_out:
            with open(json_out, "w") as f:
                json.dump(report, f, indent=2)

    reordered = os.path.join(root, f"drill-products-reordered-k{parts}")
    if resume and os.path.isdir(reordered):
        report["dataset_path"] = os.path.join(root, "drill-products")
        report["resumed"] = True
        print("[drill] resume: the dataset and its layout are on disk, "
              "skipping stages 1-3", flush=True)
    else:
        # 1. generate and save in the on-disk format, in a child
        t0 = time.perf_counter()
        rss = _run_child([sys.executable, "-c", _GENERATE, root, str(nodes),
                          str(feature_dim)])
        path = os.path.join(root, "drill-products")
        report["dataset_path"] = path
        report["num_edges"] = int(np.load(os.path.join(path, "rowptr.npy"),
                                          mmap_mode="r")[-1])
        stage("generate_save", t0, rss)

        # 2+3. load → partition → VIP reorder through the CLI, in a child
        # (its peak RSS answers whether the reorder fits in RAM)
        t0 = time.perf_counter()
        rss = _run_child(
            [sys.executable, "-m", "salient_plusplus_tpu_torch.partition.cli",
             "drill-products", "--dataset_root", root, "--out_root", root,
             "--parts", str(parts), "--fanouts", fanouts,
             "--minibatch", str(batch)])
        stage("partition_reorder", t0, rss)
    if not os.path.isdir(reordered):
        raise FileNotFoundError(reordered)
    report["reordered_path"] = reordered

    # 4. train through the driver in a child (its peak RSS is stage 4's)
    t0 = time.perf_counter()
    job_dir = os.path.join(root, "jobs", "drill_run")
    os.makedirs(job_dir, exist_ok=True)
    launches_path = os.path.join(job_dir, "launches.json")
    argv = ["drill-products", "drill_run",
            "--dataset_root", root,
            "--output_root", os.path.join(root, "jobs"),
            "--epochs", str(epochs), "--train_batch_size", str(batch),
            "--train_fanouts", fanouts,
            "--batchwise_test_fanouts", fanouts,
            "--final_test_fanouts", fanouts,
            "--num_layers", str(len(fanouts.split(","))),
            "--test_epoch_frequency", str(epochs),
            "--final_test_mode", final_test_mode,
            "--num_workers", str(workers or (os.cpu_count() or 4))]
    rss = _run_child([sys.executable, "-c", _TRAIN, launches_path,
                      "" if device is None else str(device), *argv])
    stage("train_cli", t0, rss)
    with open(os.path.join(job_dir, "results.json")) as f:
        report["results"] = json.load(f)
    with open(launches_path) as f:
        report.update(json.load(f))
    report["layerwise_s"] = _logged(job_dir, "layerwise_s")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=2_450_000)
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--root", default=None,
                    help="work directory (default: products_drill in the "
                         "temporary directory)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--workers", type=int, default=0)
    ap.add_argument("--final_test_mode", default="batchwise",
                    choices=["batchwise", "layerwise"])
    ap.add_argument("--resume", action="store_true",
                    help="skip stages 1-3 when the dataset and its "
                         "reordered layout exist")
    args = ap.parse_args(argv)
    rep = run_drill(args.nodes, args.parts, args.epochs, args.root,
                    batch=args.batch, workers=args.workers,
                    json_out=args.out,
                    final_test_mode=args.final_test_mode,
                    resume=args.resume)
    s = json.dumps(rep, indent=2)
    print(s)
    if args.out:
        with open(args.out, "w") as f:
            f.write(s)
    return rep


if __name__ == "__main__":
    main()
