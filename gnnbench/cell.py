"""A cell resolved from ``BENCHMARK.json`` to its files, by name.

- the workload ``<config>.<traffic>``: its entry in ``workloads``;
- the configuration: the file its ``configs`` entry names;
- the traffic mix: ``gnnbench/traffic/<traffic>.json``;
- the limits of its correctness check: ``gnnbench/limits/<workload>.json``;
- the model's plain reference and arithmetic: ``gnnbench/models/<the
  configuration's "reference">.py``;
- the phase the traffic drives: ``gnnbench/phases/<the traffic's
  "phase">.py``;
- each per-layer metric the cell reports: ``gnnbench/metrics/<name>.py``.

Adding a cell, a configuration, a traffic mix or a metric adds files and
``BENCHMARK.json`` entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT_DIR = os.path.dirname(PKG_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: Dict[str, float]
    model: ModuleType
    phase: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, ModuleType]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(name: str) -> ModuleType:
    """``metrics/<name>.py`` by path (metric names hold dots)."""
    path = os.path.join(PKG_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "gnnbench.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(workload: str, root: str = ROOT_DIR) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"workload {workload!r} is not in BENCHMARK.json "
                       f"(it has {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = _json(os.path.join(root, conf["file"]))
    traffic = _json(os.path.join(PKG_DIR, "traffic", f"{w['traffic']}.json"))
    limits = _json(os.path.join(PKG_DIR, "limits", f"{workload}.json"))
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(
        name=workload, chips=int(w["chips"]), cfg=cfg, traffic=traffic,
        limits=limits,
        model=importlib.import_module(f"gnnbench.models.{cfg['reference']}"),
        phase=importlib.import_module(f"gnnbench.phases.{traffic['phase']}"),
        end_to_end=e2e, per_layer=per_layer,
        readers={m["name"]: load_metric(m["name"]) for m in per_layer})
