"""Phases of the program a traffic mix drives, one module each, named by
the traffic file's ``phase``: ``train`` and ``score``.

A phase module has ``setup(run)``, ``window(run, state, seconds,
**window_options)`` and ``judge(run, state, extra)``; what they share is
here.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..models.common import make_weights


def program_config(run, **overrides):
    """The program's run configuration for a cell: the configuration
    file's model and defaults, the run's seed, with the phase's batch
    size and fanouts put in by the caller."""
    from salient_plusplus_tpu_torch.config import RunConfig

    c = run.cfg
    kw = dict(
        model_name=c["model"], hidden_features=c["hidden_features"],
        num_layers=c["num_layers"], lr=c["lr"], dropout=c["dropout"],
        param_dtype=c["param_dtype"], compute_dtype=c["compute_dtype"],
        gsrc_mode=c["gsrc_mode"], hbm_fraction=c["hbm_fraction"],
        train_batch_size=c["train_batch_size"],
        train_fanouts=list(c["train_fanouts"]),
        test_batch_size=c["final_test_batch_size"],
        final_test_batch_size=c["final_test_batch_size"],
        final_test_fanouts=list(c["final_test_fanouts"]),
        seed=run.program_seed, num_workers=run.workers)
    kw.update(overrides)
    return RunConfig(**kw)


def build_trainer(run, rc):
    """The program's trainer over the run's graph, on the run's device;
    the host seconds its constructor took (``trainer_build_s``)."""
    from salient_plusplus_tpu_torch.data.dataset import GraphData
    from salient_plusplus_tpu_torch.train.loop import Trainer

    g = run.graph
    data = GraphData(name=run.cfg["name"], rowptr=g.rowptr, col=g.col,
                     x=g.x, y=g.y, split_idx=g.split_idx,
                     num_classes=g.num_classes)
    t0 = time.perf_counter()
    trainer = Trainer(rc, data, device=run.device)
    return trainer, time.perf_counter() - t0


def bench_weights(run, trainer):
    """The benchmark's weights for the run's seed, made on the device at
    the program's parameter shapes and loaded into the program's model
    (its optimizer holds the same tensors)."""
    shapes = run.model.param_shapes(run.cfg, trainer.in_features)
    W0 = make_weights(shapes, run.model.init_bounds(shapes), run.seed,
                      run.device)
    trainer.state.model.load_state_dict(W0, strict=True)
    return W0


def taker(st):
    """The window's ``take``: the next batch of the phase's feeder."""
    def take():
        st.consumed += 1
        return next(st.feeder)
    return take


def release(st) -> None:
    """Free the program's device state before the reference runs."""
    st.feeder = None
    st.trainer = None


def readings(run, st, w) -> None:
    """What the per-layer metrics read from a phase's window."""
    r = run.readings
    r.steps = w.steps
    r.window_s = w.seconds
    r.enqueue_s = w.enqueue_s
    r.step_ms = w.step_ms
    r.h2d_bytes = st.bytes_fed_after_window - st.bytes_fed_at_window
    r.batch_index = lambda k: (w.first + k) % len(st.pool.batches)


def num_workers() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def reference_features(run) -> torch.Tensor:
    """The features as the reference reads them: float32 on the device."""
    return torch.from_numpy(np.asarray(run.graph.x)).to(run.device).float()
