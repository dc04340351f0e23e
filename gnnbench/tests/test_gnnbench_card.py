"""The benchmark's real cells on the card, a short window each:
``python -m pytest gnnbench/tests -m cuda``. Skips without a card."""

import json
import os
import subprocess
import sys

import pytest

from gnnbench.tests.tinycell import ROOT

CELLS = ["sage-products.train-b8192", "gat-products.score-b4096"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the cells on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_on_the_card(card, workload):
    p = subprocess.run(
        [sys.executable, "-m", "gnnbench.run", "--workload", workload,
         "--seed", "2147483999", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ))
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
