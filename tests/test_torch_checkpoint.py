"""Checkpoints of the port (``train/checkpoint.py``) and their use by the
trial loop and the driver, on the CPU: a save/restore round trip (sync and
async), ``RESUME=1`` after epoch k reproducing the uninterrupted run,
``--do_test_run`` scoring saved epochs, and both metadata line forms.

The resumed run must give the uninterrupted run's losses and validation
accuracies bit for bit: on the CPU the sampler, the shuffler and the
dropout masks (reseeded from seed and step) are deterministic, and the
checkpoint carries the parameters, Adam's moments, the learning rate and
the step.
"""

import json
import os

import pytest
import torch

from salient_plusplus_tpu_torch import driver
from salient_plusplus_tpu_torch.models import make_model
from salient_plusplus_tpu_torch.train import checkpoint as ckpt
from salient_plusplus_tpu_torch.train.state import (TrainState,
                                                    get_learning_rate,
                                                    set_learning_rate)

torch.set_num_threads(1)


def _state(seed):
    """A GCN train state (parameters, BN buffers) after one Adam update,
    so that the optimizer has moments to carry."""
    model = make_model("GCN", 6, 8, 3, 2,
                       generator=torch.Generator().manual_seed(seed))
    st = TrainState(model, 0.01, seed=seed, device=torch.device("cpu"))
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=torch.Generator()
                             .manual_seed(seed + 1))
    st.optimizer.step()
    model.bn0.mean.add_(0.5)
    st.step, st.epoch = 17, 3
    return set_learning_rate(st, 0.004)


@pytest.mark.parametrize("use_async", [False, True])
def test_save_restore_round_trip(tmp_path, use_async):
    a = _state(0)
    path = ckpt.save(str(tmp_path), a, trial=2, epoch=5, acc=0.75,
                     use_async=use_async)
    # the snapshot is taken before save returns: later updates do not leak
    with torch.no_grad():
        for p in a.model.parameters():
            p.add_(1.0)
    ckpt.wait_for_async_saves()
    assert os.path.basename(path) == "model_2_5" and os.path.exists(path)
    b = ckpt.restore(str(tmp_path), _state(9), trial=2, epoch=5)
    want = _state(0)
    for k, v in want.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    sa, sb = want.optimizer.state_dict(), b.optimizer.state_dict()
    for i, s in sa["state"].items():
        for k, v in s.items():
            assert torch.equal(sb["state"][i][k], v), (i, k)
    assert get_learning_rate(b) == 0.004
    assert (b.step, b.epoch) == (17, 3)
    assert (tmp_path / "metadata.txt").read_text() == "2,5,0.75\n"


def test_latest_and_best_epoch_read_both_metadata_forms(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_epoch(d) is None and ckpt.best_epoch(d) is None
    st = _state(1)
    for e in (0, 3, 1):
        ckpt.save(d, st, trial=0, epoch=e)
    ckpt.save(d, st, trial=1, epoch=7)
    (tmp_path / "model_0_9.tmp123").write_text("half a file")
    assert ckpt.latest_epoch(d, 0) == 3 and ckpt.latest_epoch(d, 1) == 7
    assert ckpt.latest_epoch(d, 4) is None
    # the reference's two-field lines count as trial 0
    (tmp_path / "metadata.txt").write_text(
        "0,0.5\n2,0.9\n1,4,0.95\n0,3,0.7\n1,6,0.2\n")
    assert ckpt.best_epoch(d, 0) == 2
    assert ckpt.best_epoch(d, 1) == 4
    assert ckpt.best_epoch(d, 5) is None


def test_async_save_error_surfaces_at_wait(tmp_path):
    st = _state(2)
    ckpt.save(str(tmp_path), st, 0, 0, use_async=True)
    # a directory where the checkpoint file should go: the write fails
    (tmp_path / "model_0_1").mkdir()
    ckpt.save(str(tmp_path), st, 0, 1, use_async=True)
    with pytest.raises(RuntimeError, match="asynchronous checkpoint"):
        ckpt.wait_for_async_saves()
    ckpt.wait_for_async_saves()   # nothing left to report


_ARGS = ["--train_batch_size", "128", "--train_fanouts", "5,3",
         "--batchwise_test_fanouts", "6,6", "--final_test_fanouts", "6,6",
         "--num_layers", "2", "--hidden_features", "16", "--num_workers",
         "1", "--calibration_batches", "2", "--lr", "0.01",
         "--make_deterministic", "true", "--test_batch_size", "128"]
_DATA = "synth:V=1500,C=4,deg=8,F=16"


def _run(tmp_path, job, *flags):
    out = driver.main([_DATA, job, *_ARGS, "--output_root", str(tmp_path),
                       *flags], device="cpu")
    log = (tmp_path / job / "host0_logs.txt").read_text()
    return out, log


def _valid_accs(log):
    return [line for line in log.splitlines() if "'valid_acc'" in line]


@pytest.mark.parametrize("model", ["SAGE", "GCN"])
def test_resume_reproduces_the_uninterrupted_run(tmp_path, monkeypatch,
                                                 model):
    """Epochs 0-2 in one run, against epoch 0 (async checkpoint), then
    RESUME=1 for epochs 1-2 from the saved epoch 0."""
    monkeypatch.delenv("RESUME", raising=False)
    flags = ("--model_name", model, "--dropout", "0.3")
    full, full_log = _run(tmp_path, "full", "--epochs", "3", *flags)
    first, _ = _run(tmp_path, "part", "--epochs", "1",
                    "--async_checkpoint", "true", *flags)
    assert ckpt.latest_epoch(str(tmp_path / "part")) == 0
    monkeypatch.setenv("RESUME", "1")
    rest, rest_log = _run(tmp_path, "part", "--epochs", "3", *flags)
    assert "('resumed', 0, 0)" in rest_log
    losses = full[0]["losses"]
    assert first[0]["losses"] == losses[:1]
    assert rest[0]["losses"] == losses[1:]
    # the valid accuracies of epochs 1 and 2, logged line for line (the
    # job's log also holds the first run's lines, before them)
    full_acc = [a.split("'valid_acc', ")[1] for a in _valid_accs(full_log)]
    rest_acc = [a.split("'valid_acc', ")[1] for a in _valid_accs(rest_log)]
    assert rest_acc[-2:] == full_acc[1:]
    if full[0]["best_epoch"] >= 1:
        assert rest[0]["final_test"] == full[0]["final_test"]
    assert full[0]["final_valid"] > 0.5   # chance is 0.25


def test_do_test_run_scores_saved_epochs(tmp_path, monkeypatch):
    monkeypatch.delenv("RESUME", raising=False)
    out, _ = _run(tmp_path, "j", "--epochs", "2")
    saved = sorted(int(n.split("_")[-1]) for n in
                   os.listdir(tmp_path / "j") if n.startswith("model_0_"))
    assert saved and saved[0] == 0
    scored, log = _run(tmp_path, "j", "--do_test_run",
                       ",".join(map(str, saved)))
    assert [s["epoch"] for s in scored] == saved
    assert all(0.25 < s["valid"] <= 1 and 0.25 < s["test"] <= 1
               for s in scored)
    # the best epoch's checkpoint scores what the trial's batchwise final
    # test scored from its best snapshot
    best = ckpt.best_epoch(str(tmp_path / "j"))
    assert best == out[0]["best_epoch"]
    assert {s["epoch"]: s for s in scored}[best]["test"] == \
        out[0]["final_test"]
    with open(tmp_path / "j" / "results.json") as f:
        assert json.load(f) == scored
    assert "'test_run'" in log


def test_do_test_run_without_epochs_is_a_usage_error(tmp_path):
    with pytest.raises(SystemExit):
        driver.main([_DATA, "j", "--output_root", str(tmp_path),
                     "--do_test_run"], device="cpu")


def test_unseeded_dropout_needs_no_generator_state():
    """The dropout generator is reseeded from (seed, step): the same step
    draws the same mask in a fresh state, which is why a checkpoint needs
    no generator state."""
    a, b = _state(3), _state(3)
    b.dropout_generator.manual_seed(12345)   # whatever it held before
    ga, gb = a.dropout_generator_for_step(), b.dropout_generator_for_step()
    assert torch.equal(torch.rand(8, generator=ga),
                       torch.rand(8, generator=gb))
