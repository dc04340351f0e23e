"""Tiny cells added only as new files, resolved and run end to end on the
CPU with the program's plain kernels; the import rules; a planted fault
in the timed path turns ``correct`` false; the control fails where the
program passes."""

import json

import pytest

from gnnbench.tests import tinycell as tc

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "salient_plusplus_tpu"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tc.make(str(tmp_path_factory.mktemp("gnnbench")))


def _modules(stderr):
    line = [ln for ln in stderr.splitlines() if ln.startswith("MODULES")][-1]
    return set(json.loads(line[len("MODULES "):].replace("'", '"')))


@pytest.mark.parametrize("workload,rate", [(tc.TRAIN, "train_edges_per_s"),
                                           (tc.SCORE, "score_nodes_per_s")])
def test_cell_runs_from_its_files(root, workload, rate):
    rc, out, err = tc.run(root, workload)
    assert rc == 0, err[-3000:]
    res = tc.result(out)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {rate, "peak_device_gib", "setup_s"}
    assert res["metrics"][rate]["value"] > 0
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "cpu"
    # the port only: no JAX and no JAX package in the process
    assert not _modules(err) & FORBIDDEN
    assert "salient_plusplus_tpu_torch" in _modules(err)


@pytest.mark.parametrize("workload", [tc.TRAIN, tc.SCORE])
def test_traced_run_reports_its_host_metrics(root, workload):
    rc, out, err = tc.run(root, workload, trace=1)
    assert rc == 0, err[-3000:]
    m = tc.result(out)["metrics"]
    # the metric added as a file reads the pool
    assert m["tiny_probe"]["value"] == (3.0 if workload == tc.SCORE
                                        else 7.0)
    assert m["trainer_build_s"]["value"] > 0
    assert m["pool_fill_edges_per_s"]["value"] > 0
    # no number of the card comes from a CPU run
    assert not any(k.startswith(("mfu", "k1_", "k2_", "k3_", "device_idle",
                                 "step_ms", "batch_ms")) for k in m)


def test_reference_imports_nothing_of_the_program(root):
    code = ("import sys\nimport gnnbench.models.sage, gnnbench.models.gat\n"
            "import gnnbench.judge, gnnbench.arith, gnnbench.graphgen\n"
            "bad = {k.split('.')[0] for k in sys.modules} & "
            "{'salient_plusplus_tpu_torch', 'salient_plusplus_tpu', 'jax'}\n"
            "sys.exit(1 if bad else 0)\n")
    import subprocess
    import sys
    assert subprocess.run([sys.executable, "-c", code], cwd=root,
                          timeout=120).returncode == 0


FAULTS = {
    "state unchanged": (tc.TRAIN, "import torch\n"
                        "torch.optim.Adam.step = lambda self, *a, **k: None"),
    "half the batch": (tc.TRAIN, (
        "import salient_plusplus_tpu_torch.train.step as s\n"
        "_nll = s.masked_nll\n"
        "s.masked_nll = lambda logp, y, c: _nll(logp, y, c // 2)")),
    # set-up runs 14 steps (two passes of the tiny pool): from then on,
    # only the window's steps leave the state unchanged
    "state unchanged in the window only": (tc.TRAIN, (
        "import torch\n"
        "_step, _calls = torch.optim.Adam.step, [0]\n"
        "def _late(self, *a, **k):\n"
        "    _calls[0] += 1\n"
        "    return None if _calls[0] > 14 else _step(self, *a, **k)\n"
        "torch.optim.Adam.step = _late")),
    "answer altered": (tc.SCORE, (
        "import salient_plusplus_tpu_torch.models.modules as mm\n"
        "_f = mm._GNNBase._final\n"
        "def _alter(self, x, batch):\n"
        "    out = _f(self, x, batch)\n"
        "    return out.index_add(0, out.new_zeros(1, dtype=int), "
        "out.new_ones(1, out.shape[1]))\n"
        "mm._GNNBase._final = _alter")),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(root, fault):
    workload, before = FAULTS[fault]
    rc, out, err = tc.run(root, workload, before=before)
    assert rc == 0, err[-3000:]
    res = tc.result(out)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("workload", [tc.TRAIN, tc.SCORE])
def test_the_control_fails_where_the_program_passes(root, workload):
    rc, out, err = tc.run(root, workload, entry="gnnbench.control",
                          extra_args=["--seeds", "21,22,23"])
    assert rc == 0, err[-3000:]
    for line in out.strip().splitlines():
        r = json.loads(line)
        # judged by the cell's own limits: the program passes, the control
        # (and the half batch, in training) does not
        assert r["correct"] is True, r["readings"]
        assert r["control_correct"] is False, r["readings"]
        if workload == tc.TRAIN:
            assert r["half_batch_correct"] is False, r["readings"]
