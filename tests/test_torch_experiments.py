"""The port's experiment harnesses (``salient_plusplus_tpu_torch/
experiments/``) trimmed to 2 gloo ranks, a 2,000-node graph and 2 epochs,
run through their own functions, against the JAX harnesses' rules and
output keys. No wall-clock bound is asserted: the times are the host's
and move with its load.

- The fp8 study: the JAX study's ``main`` verdict recomputed over the
  port's curves equals the port's; its keys are the JAX study's (read
  from ``docs/fp8_study.json``); the fp8 wire ships F + 4 bytes a remote
  row where bf16 ships 2F (about half).
- The host-overhead harness: the JAX harness's summary keys and
  ``HOST_STAGES``; ``bucket_psum`` is 0 at world 1, where no collective
  decides the tight bucket.
"""

import json
import os

import pytest
import torch

from salient_plusplus_tpu_torch.experiments import fp8_study, scaling_harness
from salient_plusplus_tpu_torch.parallel.exchange import wire_row_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(nodes=2000, epochs=2)


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    out = tmp_path_factory.mktemp("fp8") / "fp8_study_torch.json"
    res = fp8_study.run_study(str(out), world=2, timeout_s=240, **SMALL)
    with open(out) as f:
        assert json.load(f) == res
    return res


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    out = tmp_path_factory.mktemp("scalh") / "scaling_harness_torch.json"
    res = scaling_harness.run_harness(str(out), timeout_s=240, **SMALL)
    with open(out) as f:
        assert json.load(f) == res
    return res


def _jax_verdict(curves):
    """``experiments/fp8_study.py::main``'s verdict, as written there."""
    out = dict(curves)
    noise = max(abs(a - b) for a, b in
                zip(out["bf16_seed0"], out["bf16_seed1"]))
    gap = max(abs(a - b) for a, b in
              zip(out["bf16_seed0"], out["fp8_seed0"]))
    gap_cold = max(abs(a - b) for a, b in
                   zip(out["bf16_seed0"], out["fp8_cold_seed0"]))
    out["max_seed_noise"] = round(noise, 4)
    out["max_fp8_gap"] = round(gap, 4)
    out["max_fp8_cold_gap"] = round(gap_cold, 4)
    out["within_noise"] = bool(gap <= noise * 1.5 + 0.01)
    return out


def test_fp8_study_keys_and_verdict_match_jax(study):
    with open(os.path.join(REPO, "docs", "fp8_study.json")) as f:
        jax_keys = set(json.load(f))
    mine = {k: v for k, v in study.items() if k in jax_keys}
    assert set(mine) == jax_keys
    curves = {k: study[k] for k in fp8_study.RUNS}
    assert mine == _jax_verdict(curves)
    for c in curves.values():
        assert len(c) == SMALL["epochs"]
        assert all(0.0 <= a <= 1.0 for a in c)
    assert study["settings"]["world"] == 2


@pytest.mark.parametrize("run", ["fp8_seed0", "fp8_cold_seed0"])
def test_fp8_wire_sends_about_half_the_bytes_a_row(study, run):
    runs = study["runs"]
    F = 128  # the 64 study features, padded to 128 as the device holds them
    for name, fp8 in (("bf16_seed0", False), (run, True)):
        r = runs[name]
        assert all(rem > 0 for rem in r["remote"])
        for sent, rem in zip(r["sent_bytes"], r["remote"]):
            assert sent == rem * wire_row_bytes(F, torch.bfloat16, fp8)
    per_row = [runs[n]["sent_bytes"][0] / runs[n]["remote"][0]
               for n in ("bf16_seed0", run)]
    assert 0.5 <= per_row[1] / per_row[0] <= 0.55, per_row
    # the cold tier keeps remote tails off the wire: fewer remote rows
    if run == "fp8_cold_seed0":
        assert runs[run]["remote"][0] < runs["bf16_seed0"]["remote"][0]
    else:
        assert runs[run]["remote"] == runs["bf16_seed0"]["remote"]


def test_scaling_harness_keys_and_stages(harness):
    assert scaling_harness.HOST_STAGES == (
        "sample_wait", "assemble_h2d", "cold_serve", "bucket_psum")
    for k in ("one_process", "two_process", "marginal_stage_s",
              "marginal_host_s"):
        assert k in harness
    one, two = harness["one_process"], harness["two_process"]
    for leg, world in ((one, 1), (two, 2)):
        for k in ("epoch_wall_s", "stages_s", "host_orchestration_s",
                  "host_share", "iters", "loss_final", "process_count"):
            assert k in leg, k
        assert leg["process_count"] == world
        assert set(leg["stages_s"]) == set(scaling_harness.HOST_STAGES)
        assert all(v >= 0 for v in leg["stages_s"].values())
        # the stages lie inside the epoch's region
        assert sum(leg["stages_s"].values()) <= leg["epoch_wall_s"]
        assert leg["stages_s"]["cold_serve"] > 0  # the owner-served tier
    assert set(harness["marginal_stage_s"]) == set(
        scaling_harness.HOST_STAGES)
    # the same seeds over two ranks: half the steps an epoch
    assert two["iters"] == -(-one["iters"] // 2)


def test_bucket_psum_is_zero_at_world_one(harness):
    assert harness["one_process"]["stages_s"]["bucket_psum"] == 0.0
    assert harness["two_process"]["stages_s"]["bucket_psum"] > 0.0
