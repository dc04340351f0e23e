"""The port's throughput bench (``salient_plusplus_tpu_torch/bench.py``)
against the JAX package's root ``bench.py``: the chip-state verdict and
the seed cycling as functions, the JSON line's keys, the gather row
model, and a tiny run of ``main`` on the CPU.

The JAX bench is loaded by path (it imports no JAX at module level), as
``tests/test_bench_guard.py`` does.
"""

import ast
import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

from salient_plusplus_tpu_torch import bench
from salient_plusplus_tpu_torch.ops import launch_counts
from salient_plusplus_tpu_torch.sampling.batch import BatchSpec

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BENCH_PATH = os.path.join(REPO, "bench.py")
PORT_BENCH_PATH = os.path.join(REPO, "salient_plusplus_tpu_torch",
                               "bench.py")

_spec = importlib.util.spec_from_file_location("jax_bench", JAX_BENCH_PATH)
jax_bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_bench)


@pytest.mark.parametrize("args,kw", [
    ((0.032, 12, 1439), {}),            # BENCH_r04's degraded capture
    ((0.9, 200, 1400), {}),
    ((0.25, 200, 1400), {}),            # degraded_frac's edge: healthy
    ((0.2499, 200, 1400), {}),
    ((0.1, 700, 1400), {}),             # link_slack's edge: throttled
    ((0.1, 699.9, 1400), {}),
    ((0.1, 900, 1400), {}),
    ((0.0112, 400, 44511), {}),         # a host-bound step on a fast link
    ((0.15, 50, 1000), {"degraded_frac": 0.1}),
    ((0.05, 50, 1000), {"degraded_frac": 0.1}),
    ((0.05, 700, 1000), {"degraded_frac": 0.1, "link_slack": 0.8}),
    ((0.05, 800, 1000), {"degraded_frac": 0.1, "link_slack": 0.8}),
])
def test_chip_state_verdict_matches_jax(args, kw):
    assert bench.chip_state_verdict(*args, **kw) == \
        jax_bench.chip_state_verdict(*args, **kw)


@pytest.mark.parametrize("pool,need,batch", [
    (5000, 20_000, 1024), (2048, 2048, 1024), (3000, 1000, 256),
    (10_000, 95_000, 1024), (777, 9000, 100)])
def test_cycle_unique_matches_jax(pool, need, batch):
    idx = np.random.default_rng(pool).permutation(4 * pool)[:pool]
    got = bench._cycle_unique(idx, need, batch)
    assert np.array_equal(got, jax_bench._cycle_unique(idx, need, batch))
    # every batch window is duplicate-free
    for w in got.reshape(-1, batch):
        assert len(np.unique(w)) == batch


def _json_line_keys(path):
    """The string keys, in order, of the dict literal in the file's
    ``json.dumps({...})`` call."""
    with open(path) as f:
        tree = ast.parse(f.read())
    found = [node.args[0] for node in ast.walk(tree)
             if isinstance(node, ast.Call)
             and isinstance(node.func, ast.Attribute)
             and node.func.attr == "dumps" and node.args
             and isinstance(node.args[0], ast.Dict)]
    assert len(found) == 1, path
    return [k.value for k in found[0].keys]


def test_json_keys_are_the_jax_bench_keys():
    jax_keys = _json_line_keys(JAX_BENCH_PATH)
    assert len(jax_keys) == 41
    assert _json_line_keys(PORT_BENCH_PATH) == jax_keys


# the card's bench spec (chip_smoke phase 3's big bucket)
SPEC = BatchSpec(fanouts=(15, 10, 5), seed_cap=1024,
                 node_caps=(1024, 21120, 144000, 448128),
                 edge_caps=(19968, 194560, 718336))


# the row model of bench.py:323-343, written out for SPEC: N = 448128,
# E = 19968 + 194560 + 718336 = 932864, inner = 19968 + 194560 = 214528
@pytest.mark.parametrize("model,gsrc,rows", [
    # gsrc: node_caps[2] + edge_caps[2] + 2 inner (bench.py:341-342)
    ("SAGE", True, 144000 + 718336 + 2 * 214528),
    # frontier mode: N + E + inner (bench.py:343)
    ("SAGE", False, 448128 + 932864 + 214528),
    # GAT, autodiff attention: N + 4E (bench.py:327-332)
    ("GAT", False, 448128 + 4 * 932864),
    # GCN: N + 2E (bench.py:333-340)
    ("GCN", False, 448128 + 2 * 932864),
])
def test_gather_rows_per_step(model, gsrc, rows):
    assert bench.gather_rows_per_step(SPEC, model, gsrc) == rows
    assert rows in (1_291_392, 1_595_520, 4_179_584, 2_313_856)


def _jax_gather_rows(model_name, global_msg0):
    """bench.py's ``gather_rows`` closure, taken out of its ``main`` by AST
    and bound to ``model_name`` and a trainer stub."""
    with open(JAX_BENCH_PATH) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    fn = next(n for n in ast.walk(main)
              if isinstance(n, ast.FunctionDef) and n.name == "gather_rows")
    ns = {"model_name": model_name,
          "trainer": types.SimpleNamespace(global_msg0=global_msg0)}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), JAX_BENCH_PATH,
                 "exec"), ns)
    return ns["gather_rows"]


TIGHT = BatchSpec(fanouts=(15, 10, 5), seed_cap=1024,
                  node_caps=(1024, 15360, 96000, 301056),
                  edge_caps=(15360, 143360, 480000))


@pytest.mark.parametrize("model,gsrc", [
    ("SAGE", True), ("SAGE", False), ("GAT", False), ("GCN", False),
    ("GIN", True)])
@pytest.mark.parametrize("spec", [SPEC, TIGHT], ids=["big", "tight"])
def test_gather_rows_per_step_matches_jax(monkeypatch, spec, model, gsrc):
    # the JAX row model with its GAT switch unset: the port's one path
    monkeypatch.delenv("SPTPU_GAT_CUSTOM_VJP", raising=False)
    assert bench.gather_rows_per_step(spec, model, gsrc) == \
        _jax_gather_rows(model, gsrc)(spec)


def test_source_has_no_fallback():
    """No constant to fall back to, no re-exec, no ``try`` that could let
    a failed probe or microstep end the run with 0, and no rest loop (no
    ``time.sleep``: one campaign, one H2D measurement)."""
    with open(PORT_BENCH_PATH) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        assert not isinstance(node, ast.Try), node.lineno
        if isinstance(node, ast.Constant):
            assert node.value not in (11.6, "fallback"), node.lineno
        if isinstance(node, ast.Attribute):
            assert not node.attr.startswith("exec"), node.lineno
            assert node.attr != "sleep", node.lineno


def _bench_env(monkeypatch, **over):
    env = dict(BENCH_NUM_NODES="20000", BENCH_WARMUP="2", BENCH_STEPS="2",
               BENCH_WINDOWS="2", BENCH_WORKERS="2")
    env.update(over)
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("hbm,cache", [("1.0", "0"), ("0.5", "auto")])
def test_main_on_cpu_prints_the_line(monkeypatch, capsys, hbm, cache):
    _bench_env(monkeypatch, BENCH_HBM_FRACTION=hbm, BENCH_COLD_CACHE=cache)
    before = launch_counts()
    bench.main(device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == _json_line_keys(JAX_BENCH_PATH)
    assert line["value"] > 0 and line["model"] == "SAGE"
    assert len(line["windows_edges_per_s"]) == 2
    assert line["campaign_attempts"] == 1
    assert line["windows_all_attempts"] == [line["windows_edges_per_s"]]
    assert line["chip_state"] == "unknown"
    assert line["h2d_burst_mb_per_s"] is None
    assert line["gather_ns_source"] == "measured"
    assert line["gather_ns_pre"] > 0 and line["gather_ns_post"] > 0
    assert line["roofline_kind"] == "exact"
    assert 0 < line["roofline_frac"]
    assert line["gsrc_fallback_windows"] is None
    assert line["gsrc_mode"] == "auto"
    assert line["microstep_ms"] > 0
    assert line["hbm_fraction"] == float(hbm)
    if hbm == "0.5":
        # the cold tail in host RAM; "auto" plans no cache on the CPU
        assert line["cold_rows_per_batch"] > 0
        assert line["cold_cache_slots"] == 0
        assert line["hbm_table_rows"] > 10_000
    else:
        assert line["cold_rows_per_batch"] == 0
        assert line["hbm_table_rows"] == 20_000
    # the CPU runs the kernels' plain versions: nothing is launched
    assert launch_counts() == before


def test_gather_probe_env_override(monkeypatch):
    monkeypatch.setenv("BENCH_GATHER_NS", "0.5")
    assert bench._measure_gather_ns(torch.zeros(16, 8)) == (0.5, "env")


def test_h2d_preflight_is_none_on_the_cpu():
    assert bench._h2d_preflight(torch.device("cpu")) is None


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main()
