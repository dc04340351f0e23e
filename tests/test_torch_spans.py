"""The port's spans (``utils/timing.py::span``): the names and nesting a
train step, an eval step and the feeder emit under ``torch.profiler``,
nothing but the profiler's flag checked when no profiler records, and the
trainer's set-up seconds (``Trainer.build_s``)."""

import contextlib
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from salient_plusplus_tpu_torch.config import RunConfig
from salient_plusplus_tpu_torch.data import synthetic
from salient_plusplus_tpu_torch.train.loop import Trainer
from salient_plusplus_tpu_torch.train.step import eval_step
from salient_plusplus_tpu_torch.utils import timing

PREFIXES = ("feed.", "step.", "gat.")
LAYERS = 2


def _cfg(model="SAGE", **kw):
    base = dict(model_name=model, train_batch_size=64, train_fanouts=[4, 3],
                batchwise_test_fanouts=[5, 5], final_test_fanouts=[5, 5],
                test_batch_size=64, num_layers=LAYERS, hidden_features=16,
                num_workers=1, calibration_batches=2, lr=0.01,
                max_batches_in_flight=2)
    base.update(kw)
    return RunConfig(**base)


@pytest.fixture(scope="module")
def graph():
    return synthetic.planted_partition(name="spans", num_nodes=600,
                                       num_classes=4, avg_degree=6,
                                       num_features=8, seed=4)


def _feeder(tr, depth=1):
    tr.train_sampler.set_epoch(tr.shuffler.get_idx(0), 0)
    return tr._feeder(iter(tr.train_sampler), depth)


def _spans(prof):
    """The program's spans in the order they began, each with the name of
    the program span it sits in (None at the top)."""
    evs = [e for e in prof.events() if e.name.startswith(PREFIXES)]
    out = []
    for e in sorted(evs, key=lambda e: e.time_range.start):
        p = e.cpu_parent
        while p is not None and not p.name.startswith(PREFIXES):
            p = p.cpu_parent
        out.append((e.name, None if p is None else p.name))
    return out


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _refuse(*a, **k):
    raise AssertionError("record_function called with no profiler")


@pytest.fixture
def no_record_function(monkeypatch):
    """``torch.profiler.record_function``, which ``span`` makes, raises
    (torch's own optimizer makes its spans through
    ``torch.autograd.profiler`` whatever the flag)."""
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)


def test_train_step_spans(graph):
    tr = Trainer(_cfg(), graph, device="cpu")
    batch = next(_feeder(tr))
    _, got = _profiled(lambda: tr.run_step(batch))
    T = "step.train"
    assert got == [("step.pre", None), (T, None), ("step.decode", T),
                   ("step.gather", T), ("step.forward", T), ("step.loss", T),
                   ("step.backward", T), ("step.optimizer", T)]


def test_eval_step_spans_and_gat_attention_once_a_layer(graph):
    tr = Trainer(_cfg("GAT"), graph, device="cpu")
    batch = next(_feeder(tr))

    def step():
        b = tr._pre_step(batch)
        return eval_step(tr.state, tr.features, b, tr.global_msg0)
    _, got = _profiled(step)
    E, F = "step.eval", "step.forward"
    assert got == ([("step.pre", None), (E, None), ("step.decode", E),
                    ("step.gather", E), (F, E)]
                   + [("gat.attention", F)] * LAYERS + [("step.score", E)])


def test_feeder_spans(graph):
    tr = Trainer(_cfg(), graph, device="cpu")
    feed = _feeder(tr, depth=1)
    next(feed)      # the first batch
    _, got = _profiled(lambda: next(feed))
    N = "feed.next"
    assert got == [(N, None), ("feed.sample", N), ("feed.put", N)]
    for _ in range(len(feed) - 2):
        next(feed)
    # the last call finds the sampler spent and waits on the copies left
    _, got = _profiled(lambda: next(feed, None))
    assert got == [(N, None), ("feed.sample", N), ("feed.recycle", N)]


def test_span_off_is_the_flag_alone(graph, no_record_function):
    assert not torch._C._autograd._profiler_enabled()
    a, b = timing.span("step.train"), timing.span("feed.put")
    assert a is b and isinstance(a, contextlib.nullcontext)
    # a whole step, the feeder and an eval step run with no span made
    tr = Trainer(_cfg(), graph, device="cpu")
    feed = _feeder(tr)
    tr.run_step(next(feed))
    eval_step(tr.state, tr.features, tr._pre_step(next(feed)),
              tr.global_msg0)


def test_spans_leave_the_loss_bit_identical(graph, monkeypatch):
    """The same first step of two fresh trainers: one under the profiler
    (spans on), one with ``record_function`` refused (spans off)."""
    on = Trainer(_cfg(), graph, device="cpu")
    batch = next(_feeder(on))
    loss_on, _ = _profiled(lambda: on.run_step(batch))
    off = Trainer(_cfg(), graph, device="cpu")
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    loss_off = off.run_step(batch)
    assert torch.equal(loss_on, loss_off)
    for (k, p), (_, q) in zip(on.state.model.named_parameters(),
                              off.state.model.named_parameters()):
        assert torch.equal(p, q), k


def test_build_s_parts(graph):
    t0 = time.perf_counter()
    tr = Trainer(_cfg(), graph, device="cpu")
    total = time.perf_counter() - t0
    assert set(tr.build_s) == {"calibrate", "table", "sampler", "model"}
    assert all(v >= 0 for v in tr.build_s.values())
    assert sum(tr.build_s.values()) <= total
    assert tr.build_s["calibrate"] > 0 and tr.build_s["model"] > 0
    # an eval bucket's calibration adds to ``calibrate``
    before = tr.build_s["calibrate"]
    tr._eval_sampler("valid")
    assert tr.build_s["calibrate"] > before
