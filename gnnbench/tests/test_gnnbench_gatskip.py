"""The GATSkip cell's files in a copy of the benchmark: a tiny GATSkip
training cell added beside the tiny cells of ``tinycell``, run end to end
on the CPU and judged against ``models/gatskip.py``; and the trace's
families of the new cell, which give the multi-head weighted sum's kernels
to ``wsum`` alone."""

import json
import os
import subprocess
import sys

import pytest

from gnnbench.cell import load_metric, resolve
from gnnbench.tests import tinycell as tc
from gnnbench.trace import reduce_events

CELL = "gatskip-products.train-b8192-f10"
TINY = "tiny-gatskip.train-tiny"
# the tiny cell's limits, set from its own readings on the CPU (seeds
# 31-36): the program read at most loss 8.9e-4, grad 3.3e-2, update
# 4.3e-2, logp 5.6e-2, window update 8.4e-3, window logp 4.6e-2; the
# control at least loss 2.3e-3, logp 0.42, window logp 0.39; the half batch
# at least grad 0.34, update 0.14, window update 4.7e-2. The control's
# gradient and update gaps overlap the program's at 6 heads' width, so the
# half batch fails those
LIMITS = {"loss_gap": 0.0015, "grad_gap": 0.1, "update_gap": 0.09,
          "logp_gap": 0.15, "window_update_gap": 0.025,
          "window_logp_gap": 0.12, "sampler_faults": 0}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tc.make(str(tmp_path_factory.mktemp("gnnbench")))
    g = os.path.join(root, "gnnbench")
    with open(os.path.join(g, "configs", "gatskip-products.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny-gatskip", graph=tc.GRAPH, hidden_features=6)
    with open(os.path.join(g, "configs", "tiny-gatskip.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(g, "limits", f"{TINY}.json"), "w") as f:
        json.dump(LIMITS, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({
        "name": "tiny-gatskip", "source": "https://github.com/pyg-team",
        "file": "gnnbench/configs/tiny-gatskip.json", "reduced": ["graph"],
        "why": "a test's tiny graph"})
    b["workloads"].append({"name": TINY, "config": "tiny-gatskip",
                           "traffic": "train-tiny", "chips": 1,
                           "why": "a test's tiny cell"})
    for m in b["end_to_end"] + b["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    return root


def test_tiny_gatskip_cell_runs_and_is_judged_by_its_reference(root):
    rc, out, err = tc.run(root, TINY)
    assert rc == 0, err[-3000:]
    res = tc.result(out)
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == set(LIMITS)
    assert res["metrics"]["train_edges_per_s"]["value"] > 0
    # the copy resolves the cell's reference to models/gatskip.py
    code = ("from gnnbench.cell import resolve\n"
            f"c = resolve({TINY!r})\n"
            "print(c.model.__name__, c.cfg['model'])\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert p.stdout.split() == ["gnnbench.models.gatskip", "GATSkip"], \
        p.stderr[-2000:]
    # a traced run on the CPU reads no number of the card
    rc, out, err = tc.run(root, TINY, trace=1)
    assert rc == 0, err[-3000:]
    m = tc.result(out)["metrics"]
    assert "wsum_roofline.train" not in m and "mfu.train" not in m
    assert m["trainer_build_s"]["value"] > 0


def test_the_control_fails_the_tiny_gatskip_cell(root):
    rc, out, err = tc.run(root, TINY, entry="gnnbench.control",
                          extra_args=["--seeds", "31,32"])
    assert rc == 0, err[-3000:]
    for line in out.strip().splitlines():
        r = json.loads(line)
        assert r["correct"] is True, r["readings"]
        assert r["control_correct"] is False, r["readings"]
        assert r["half_batch_correct"] is False, r["readings"]


def _ev(name, ts, dur, cat="kernel"):
    return {"name": name, "ts": ts, "dur": dur, "cat": cat,
            "args": {"stream": 7}}


def test_wsum_alone_takes_the_multihead_kernels():
    """In the new cell's families (every metric of the cell that names
    one), the multi-head slice passes, vector and one-element, and the
    combine pass after each go to ``wsum``; the single-head slice pass to
    none."""
    cell = resolve(CELL)
    fams = {m.FAMILY: m.KERNELS for m in cell.readers.values()
            if hasattr(m, "FAMILY")}
    assert set(fams) == {"k3", "wsum"}
    assert load_metric("wsum_roofline.train").FAMILY == "wsum"
    multi = ["void sptpu_seg::weighted_slice_pass<__nv_bfloat16, true, 4, "
             "true>(__nv_bfloat16 const*, float const*)",
             "void sptpu_seg::weighted_slice_pass<__nv_bfloat16, false, 4, "
             "true>(__nv_bfloat16 const*, float const*)"]
    single = ("void sptpu_seg::weighted_slice_pass<__nv_bfloat16, true, 1, "
              "false>(__nv_bfloat16 const*, float const*)")
    combine = "sptpu_seg::combine_pass(int const*, int const*, long)"
    events = [_ev("gnnbench.window", 0, 100, "user_annotation"),
              _ev(multi[0], 0, 10), _ev(combine, 10, 5),
              _ev(multi[1], 20, 10), _ev(combine, 30, 5),
              _ev(single, 40, 10), _ev(combine, 50, 5)]
    t = reduce_events(events, fams, steps=1)
    assert t.family_s["wsum"] == pytest.approx(30e-6)
    assert t.family_s["k3"] == 0.0


def test_wsum_bytes_read_each_distinct_row_once():
    """The weighted sum's bytes by hand: layer 0 reads the outer hop's 7
    distinct sources, the inner layers the rows new at their input level
    (9 - 5 and 5 - 2); 8 B of ids and 4 B a head of weight an edge; the
    f32 output once. Two ops an element of a real edge's row."""
    from gnnbench.models import gatskip

    cfg = {"num_layers": 3, "hidden_features": 4, "heads": 2,
           "compute_dtype": "bfloat16",
           "graph": {"num_classes": 3, "num_features": 5}}
    meta = {"level_sizes": [2, 5, 9, 14], "edge_counts": [6, 10, 20],
            "caps": (2, 8, 12, 16), "distinct_outer_src": 7}
    calls = gatskip.kernel_calls(meta, "train", cfg)
    # 2 heads of 4 below the last layer (8 values), 2 heads of 3 in it (6)
    assert calls["wsum"] == [
        (7 * 8 * 2 + 20 * 16 + 9 * 8 * 4, 2 * 20 * 8),
        (4 * 8 * 2 + 10 * 16 + 5 * 8 * 4, 2 * 10 * 8),
        (3 * 6 * 2 + 6 * 16 + 2 * 6 * 4, 2 * 6 * 6)]


def test_heads_must_be_the_programs():
    """A configuration whose ``heads`` is not ``GATSkip.heads`` stops at
    the weights' shapes with a message that names both."""
    from gnnbench.models import gatskip

    cfg = dict(resolve(CELL).cfg)
    assert len(gatskip.param_shapes(cfg, 100)) == 18
    cfg["heads"] = 8
    with pytest.raises(ValueError, match="GATSkip.heads 4"):
        gatskip.param_shapes(cfg, 100)
