"""Training: the program's ``Trainer.run_step`` on batches from its
``DeviceFeeder``, which replays a pool of one epoch's batches that the
program's ``FastSampler`` filled during set-up.

Set-up builds one trainer (weights from the seed), fills the pool, and
drives the trainer through its first three steps on pool batches 0-2
through the same feeder and call the window uses: their losses, the
first step's log-probabilities, the first gradient as Adam holds it after
step 1, and the weights after step 3 are the program's side of the
check. Then the rest of that pass and one more warm every shape and the
allocator, and the window replays the pool on from there. The window
also keeps the program's state and output around one of its steps: the
first step of the pool's batch outside the tight bucket (where the pool
has none, of a batch drawn from the seed). The
judge trains the plain reference from the same weights on the same three
sampled batches, and from the state kept before the window's step on its
batch (each batch checked against the graph first).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import judge as J
from .. import pool as P
from ..models.common import Sampled
from ..window import run_window
from . import bench_weights, build_trainer, program_config, \
    reference_features, taker

CHECK_STEPS = 3


@dataclass
class State:
    trainer: object
    feeder: object
    pool: P.Pool
    W0: Dict[str, torch.Tensor]
    losses: List[float]
    first_grads: Dict[str, torch.Tensor]
    after: Dict[str, torch.Tensor]
    first_logp: Optional[torch.Tensor] = None
    consumed: int = 0           # batches taken from the feeder so far
    bytes_fed_at_window: int = 0
    bytes_fed_after_window: int = 0
    kept: Optional["Kept"] = None   # the program's state around a window step
    beta1: float = 0.9          # the program's Adam's first-moment decay


@dataclass
class Kept:
    """The program's state before and after one window step: its weights,
    Adam's moments and step count, and its step counter; all on the
    device, read once the window has closed."""
    batch: int                  # the pool batch the step ran
    before: Dict[str, torch.Tensor]
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    adam_steps: torch.Tensor
    step: int
    after: Dict[str, torch.Tensor] = field(default_factory=dict)
    m_after: Dict[str, torch.Tensor] = field(default_factory=dict)
    logp: Optional[torch.Tensor] = None


@contextlib.contextmanager
def output_of(model, into: list):
    """Copies of what ``model``'s forward passes return while open: the
    log-probabilities of the step it runs."""
    handle = model.register_forward_hook(
        lambda _m, _i, out: into.append(out.detach().clone()))
    try:
        yield
    finally:
        handle.remove()


def _moment(opt, p, name):
    """A copy of one of Adam's moments of ``p``; zeros where ``p`` has
    none (it took no step)."""
    st = opt.state.get(p, {})
    return st[name].detach().clone() if name in st \
        else torch.zeros_like(p.detach())


def keep_state(trainer, batch: int) -> Kept:
    model, opt = trainer.state.model, trainer.state.optimizer
    named = list(model.named_parameters())
    steps = [opt.state[p]["step"] for _, p in named
             if "step" in opt.state.get(p, {})]
    return Kept(batch=batch,
                before={k: p.detach().clone() for k, p in named},
                m={k: _moment(opt, p, "exp_avg") for k, p in named},
                v={k: _moment(opt, p, "exp_avg_sq") for k, p in named},
                adam_steps=(steps[0].detach().clone() if steps
                            else torch.zeros(())),
                step=int(trainer.state.step))


def kept_step(seed: int, first: int, pool: P.Pool) -> int:
    """The window step whose state is kept: the first of the pool's batch
    outside the tight bucket, or of a batch drawn from the seed."""
    n = len(pool.batches)
    outside = [j for j, b in enumerate(pool.batches) if b.bucket is None]
    j = outside[0] if outside else int(
        np.random.default_rng(int(seed) + 17).integers(n))
    return (j - first) % n


def setup(run) -> State:
    from salient_plusplus_tpu_torch.train.pipeline import DeviceFeeder

    tr = run.traffic
    rc = program_config(run, train_batch_size=tr["batch_size"],
                        train_fanouts=list(tr["fanouts"]))
    trainer, run.readings.trainer_build_s = build_trainer(run, rc)
    W0 = bench_weights(run, trainer)
    pool = P.fill(trainer.train_sampler, trainer.shuffler.get_idx(0),
                  tr["batch_size"], run.seed)
    run.note_pool(pool)
    feeder = DeviceFeeder(P.Replay(pool), run.device, depth=tr["feed_depth"])
    st = State(trainer, feeder, pool, W0, [], {}, {})

    model, opt = trainer.state.model, trainer.state.optimizer
    beta1 = st.beta1 = opt.param_groups[0]["betas"][0]
    losses, logp = [], []
    for t in range(CHECK_STEPS):
        with output_of(model, logp if t == 0 else []):
            losses.append(trainer.run_step(next(feeder)))
        st.consumed += 1
        if t == 0:
            st.first_logp = logp[0]
            # Adam's first moment after one step is (1 - beta1) * grad; a
            # leaf without one took no step, and reads a zero gradient
            st.first_grads = {k: _moment(opt, p, "exp_avg") / (1.0 - beta1)
                              for k, p in model.named_parameters()}
    st.after = {k: p.detach().clone() for k, p in model.named_parameters()}
    st.losses = [float(v) for v in losses]
    # the rest of this pass and one more: every batch in its bucket
    n = len(pool.batches)
    for _ in range(2 * n - CHECK_STEPS):
        trainer.run_step(next(feeder))
        st.consumed += 1
    return st


def window(run, st: State, seconds: float, **kw):
    """The measured window; returns it with its real edges."""
    first = st.consumed
    n = len(st.pool.batches)
    trainer = st.trainer
    k_kept = None if kw.get("spans") else kept_step(run.seed, first,
                                                     st.pool)
    taken = [0]

    def step(batch):
        k = taken[0]
        taken[0] += 1
        if k != k_kept:
            return trainer.run_step(batch)
        kept = keep_state(trainer, (first + k) % n)
        logp = []
        with output_of(trainer.state.model, logp):
            loss = trainer.run_step(batch)
        kept.logp = logp[0]
        opt = trainer.state.optimizer
        for name, p in trainer.state.model.named_parameters():
            kept.after[name] = p.detach().clone()
            kept.m_after[name] = _moment(opt, p, "exp_avg")
        st.kept = kept
        return loss

    st.bytes_fed_at_window = st.feeder.bytes_fed
    w = run_window(run.device, seconds, taker(st), step, float,
                   run.traffic["result_depth"],
                   min_steps=0 if k_kept is None else k_kept + 1, **kw)
    st.bytes_fed_after_window = st.feeder.bytes_fed
    edges = sum(st.pool.edges_of(first + k) for k in range(w.steps))
    w.failed = sum(1 for v in w.results if not np.isfinite(v))
    w.work = edges
    w.first = first
    return w


def sampled_batches(run, st: State) -> Tuple[List[Sampled], List[int]]:
    """The batches of the three checked steps, then the window step's."""
    idx = list(range(CHECK_STEPS)) + ([st.kept.batch] if st.kept else [])
    return [P.sampled(st.pool.batches[i], run.graph.num_nodes).to(run.device)
            for i in idx], idx


def judge(run, st: State, extra: bool = False) -> dict:
    """The program's first three steps, and the window step whose state
    it kept, against the plain reference's.

    ``loss_gap``: the worst step's |loss - reference loss| over the
    reference loss. ``grad_gap``: the worst leaf's gap of first-gradient
    norms. ``update_gap``: the worst leaf's gap of the norms of the
    weights' change over the three steps, over the leaves the reference's
    first gradient moves (at least 1e-3 of the median leaf's).
    ``logp_gap``: the largest |log-probability - reference's| of the first
    step's seeds (dropout on, as the step draws it).
    ``window_grad_gap``, ``window_update_gap`` and ``window_logp_gap``:
    the same of the window step, from the state the program held before
    it (its gradient is worked out from Adam's first moment before and
    after).
    ``sampler_faults``: faults of the four batches against the graph; a
    window step that never ran counts as one. The cell's limits file says
    which of these are compared.

    With ``extra`` also the control's readings (the reference in fp8),
    those of a half batch (the loss taken over half the seeds), and each
    leaf's gaps of the window step (``window_leaves``)."""
    model = run.model
    g = run.graph
    batches, idx = sampled_batches(run, st)
    gi = J.GraphIndex(g.rowptr, g.col, run.device)
    labels = torch.from_numpy(g.y).to(run.device).long()
    faults = sum(J.sampler_faults(gi, s, torch.from_numpy(
        np.asarray(st.pool.seeds[i], np.int64)).to(run.device), labels)
        for i, s in zip(idx, batches))
    faults += int(st.kept is None)
    del gi
    feats = reference_features(run)
    k = st.kept
    start = (k.m, k.v, int(k.adam_steps.item()), k.step) if k else None

    def references(**kw):
        """The reference's three set-up steps, and its window step."""
        ref = model.train_reference(st.W0, feats, batches[:CHECK_STEPS],
                                    run.cfg, run.program_seed, **kw)
        w_ref = model.train_reference(
            k.before, feats, batches[CHECK_STEPS:], run.cfg,
            run.program_seed, start=start, **kw) if k else None
        return ref, w_ref

    def gaps(side, ref, W0):
        """Each leaf's gradient and update gaps of ``side`` against
        ``ref``, both (losses, first gradients, weights after, first
        log-probabilities) from the weights W0."""
        moving = J.moving_leaves(ref[1])
        return (J.leaf_gaps(side[1], ref[1]),
                J.leaf_gaps({n: side[2][n] - W0[n] for n in moving},
                            {n: ref[2][n] - W0[n] for n in moving}, moving))

    def compare(side, w_side):
        """``side`` and ``w_side`` (the three set-up steps and the window
        step) against the float32 reference's."""
        grad, update = gaps(side, ref, st.W0)
        out = {"loss_gap": max(J.rel_gap(a, b)
                               for a, b in zip(side[0], ref[0])),
               "grad_gap": max(grad.values()),
               "update_gap": max(update.values()),
               "logp_gap": J.widest_gap(side[3], ref[3])}
        if k:
            grad, update = gaps(w_side, w_ref, k.before)
            out["window_grad_gap"] = max(grad.values())
            out["window_update_gap"] = max(update.values())
            out["window_logp_gap"] = J.widest_gap(w_side[3], w_ref[3])
        return out

    ref, w_ref = references()
    # Adam's first moment after the step: beta1 m + (1 - beta1) grad
    beta1 = st.beta1
    w_program = (None, {n: (k.m_after[n] - beta1 * k.m[n]) / (1.0 - beta1)
                        for n in k.m}, k.after, k.logp) if k else None
    out = compare((st.losses, st.first_grads, st.after, st.first_logp),
                  w_program)
    out["sampler_faults"] = float(faults)
    if extra:
        if k:
            # each leaf of the window step: its gradient and update gaps
            grad, update = gaps(w_program, w_ref, k.before)
            out["window_leaves"] = {n: [grad[n], update.get(n)]
                                    for n in grad}
        for name, kw in (("control", {"precision": "fp8"}),
                         ("half_batch", {"half_batch": True})):
            out[name] = compare(*references(**kw))
    return out
