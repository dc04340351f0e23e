"""Final scoring: the program's ``Trainer._pre_step`` and
``train.step.eval_step`` (what ``Trainer.evaluate`` runs a batch
through) on batches from its ``DeviceFeeder``, which replays a pool that
the program's own eval sampler (``Trainer._eval_sampler``: the split
shuffled as the program shuffles it, the eval bucket it calibrates)
filled during set-up.

The pool holds the first ``pool_tight`` batches of the shuffle that fit
the program's tight bucket and the first ``pool_outside`` that do not,
so the window meets the larger bucket as often as a full pass does.

The check reads the log-probabilities the timed steps themselves
produce: a forward hook on the program's model copies the output of one
window step of each of CAPTURE_BATCHES pool batches: every batch outside
the tight bucket and others drawn from the seed, each step drawn from
the seed among the batch's first passes. After the window the plain
reference scores the same batches (checked against the graph first) from
the same weights.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from .. import judge as J
from .. import pool as P
from ..window import run_window
from . import bench_weights, build_trainer, program_config, \
    reference_features, taker

# pool batches the check compares, each captured in one of its first
# CAPTURE_CYCLES passes
CAPTURE_BATCHES = 8
CAPTURE_CYCLES = 4


@dataclass
class State:
    trainer: object
    feeder: object
    pool: P.Pool
    W0: Dict[str, torch.Tensor]
    consumed: int = 0
    captured: Dict[int, torch.Tensor] = field(default_factory=dict)
    planned: int = 0            # pool batches the window is to capture
    bytes_fed_at_window: int = 0
    bytes_fed_after_window: int = 0


def setup(run) -> State:
    from salient_plusplus_tpu_torch.train.pipeline import DeviceFeeder

    tr = run.traffic
    rc = program_config(run, test_batch_size=tr["batch_size"],
                        final_test_batch_size=tr["batch_size"],
                        final_test_fanouts=list(tr["fanouts"]))
    trainer, run.readings.trainer_build_s = build_trainer(run, rc)
    W0 = bench_weights(run, trainer)
    sampler = trainer._eval_sampler(tr["split"])
    pool = P.fill(sampler, sampler.idx, tr["batch_size"], run.seed,
                  keep=(tr["pool_tight"], tr["pool_outside"]))
    run.note_pool(pool)
    feeder = DeviceFeeder(P.Replay(pool), run.device, depth=tr["feed_depth"])
    st = State(trainer, feeder, pool, W0)
    step = _step(st)
    # two passes: every batch in its bucket
    for _ in range(2 * len(pool.batches)):
        step(next(feeder))
        st.consumed += 1
    return st


def _step(st: State):
    from salient_plusplus_tpu_torch.train.step import eval_step

    tr = st.trainer

    def step(batch):
        batch = tr._pre_step(batch)
        correct, _ = eval_step(tr.state, tr.features, batch, tr.global_msg0)
        return correct
    return step


def capture_plan(seed: int, first: int, pool: P.Pool) -> Dict[int, int]:
    """Window step -> pool batch: one step of each of CAPTURE_BATCHES pool
    batches (every batch outside the tight bucket, the others drawn from
    the seed), drawn from the seed among its first CAPTURE_CYCLES passes
    in the window."""
    n = len(pool.batches)
    rng = np.random.default_rng(int(seed) + 17)
    outside = [j for j, b in enumerate(pool.batches) if b.bucket is None]
    tight = [j for j in range(n) if j not in outside]
    k = max(0, min(CAPTURE_BATCHES, n) - len(outside))
    chosen = outside + [int(j) for j in rng.choice(tight, k, replace=False)]
    cyc = rng.integers(0, CAPTURE_CYCLES, size=len(chosen))
    base = first % n
    return {int((j - base) % n + n * c): j for j, c in zip(chosen, cyc)}


def window(run, st: State, seconds: float, **kw):
    first = st.consumed
    plan = {} if kw.get("spans") else capture_plan(run.seed, first, st.pool)
    st.planned = st.planned or len(plan)
    want = {}

    def hook(_module, _inputs, out):
        if want.get("j") is not None:
            st.captured[want["j"]] = out.detach().clone()
            want["j"] = None

    step = _step(st)

    def timed_step(batch):
        want["j"] = plan.get(want.get("k", 0))
        want["k"] = want.get("k", 0) + 1
        return step(batch)

    handle = st.trainer.state.model.register_forward_hook(hook) \
        if plan else None
    st.bytes_fed_at_window = st.feeder.bytes_fed
    try:
        w = run_window(run.device, seconds, taker(st),
                       timed_step if plan else step, int,
                       run.traffic["result_depth"],
                       min_steps=max(plan, default=-1) + 1, **kw)
    finally:
        if handle is not None:
            handle.remove()
    st.bytes_fed_after_window = st.feeder.bytes_fed
    w.work = sum(st.pool.seeds_of(first + k) for k in range(w.steps))
    w.failed = 0
    w.first = first
    return w


def judge(run, st: State, extra: bool = False) -> dict:
    """``logp_gap``: the largest |log-probability - reference's| over every
    class of every seed of the captured steps. ``sampler_faults``: faults
    of their batches against the graph. With ``extra`` also the control's
    reading (the reference in fp8)."""
    model = run.model
    g = run.graph
    gi = J.GraphIndex(g.rowptr, g.col, run.device)
    labels = torch.from_numpy(g.y).to(run.device).long()
    batches = {j: P.sampled(st.pool.batches[j], g.num_nodes).to(run.device)
               for j in sorted(st.captured)}
    faults = sum(J.sampler_faults(gi, s, torch.from_numpy(np.asarray(
        st.pool.seeds[j], np.int64)).to(run.device), labels)
        for j, s in batches.items())
    del gi
    # a planned step that was never captured is a missing answer
    faults += st.planned - len(batches)
    feats = reference_features(run)
    gap, ctl = 0.0, 0.0
    with torch.no_grad():
        for j, s in batches.items():
            ref = model.forward(st.W0, feats, s, run.cfg)
            gap = max(gap, J.widest_gap(st.captured[j], ref))
            if extra:
                low = model.forward(st.W0, feats, s, run.cfg,
                                    precision="fp8")
                ctl = max(ctl, J.widest_gap(low, ref))
    out = {"logp_gap": gap, "sampler_faults": float(faults)}
    if extra:
        out["control"] = {"logp_gap": ctl}
    return out

