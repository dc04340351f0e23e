"""Rank-death fail-fast in the port: a crashed or silent rank must not hang
the group (the counterpart of ``tests/test_failfast.py``).

Two raw processes (``tests/_torch_chaos_worker.py``, started by the
port's launcher ``experiments.run_ranks``; ``chip_smoke.py``'s phase 11
runs the same pairs on the card's host) join a gloo group through
``parallel/mesh.py::maybe_initialize_distributed`` with a 10 s heartbeat
and train one epoch of a 2-rank ``DistributedTrainer``; then one of them
leaves abruptly and the other must end non-zero without finishing epoch
1:

- rank 1 calls ``os._exit(42)``;
- rank 0, the host of the group's store, calls ``os._exit(42)``;
- rank 1 raises an uncaught exception: its exit handlers run, and its
  heartbeat must tell rank 0 of the crash (``dead``) rather than of a
  clean leave, so that the heartbeat ends rank 0 (exit 70) within one
  timeout;
- rank 1 stops itself with ``SIGSTOP``: its sockets stay open, so gloo
  sees no reset and, without the heartbeat, rank 0 would wait in its next
  collective for gloo's 30-minute timeout. The heartbeat must end rank 0
  within 3× its timeout of the stop.

And the heartbeat must stay quiet through a legitimate long wait: rank 0
sleeps for 3× the timeout (a long checkpoint write) before the group's
barrier while rank 1 waits in it; both end with 0.

Each pair is killed after 120 s: a hang is the failure tested for.
"""

import os
import re
import signal

import pytest

from salient_plusplus_tpu_torch.experiments import run_ranks
from salient_plusplus_tpu_torch.parallel.mesh import HEARTBEAT_EXIT_CODE

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_chaos_worker.py")
HEARTBEAT_S = 10   # the worker's heartbeat_timeout_s


def chaos_pair(victim, how, timeout=120):
    """(return codes, outputs, seconds from the victim's end of epoch 0
    to the end of the wait: the survivor's exit, or both ranks' with
    ``wait``)."""
    rcs, outs, t_end = run_ranks(
        [WORKER, str(victim), how, "cpu"], 2, timeout,
        until=None if how == "wait" else 1 - victim, check=False)
    m = re.search(r"EPOCH0_DONE (\S+)", outs[victim])
    return rcs, outs, None if m is None else t_end - float(m.group(1))


@pytest.mark.parametrize("victim,how", [(1, "exit"), (0, "exit"),
                                        (1, "raise"), (1, "stop")],
                         ids=["rank1_exits", "rank0_exits", "rank1_raises",
                              "rank1_stops"])
def test_rank_death_fails_fast_not_hangs(victim, how):
    rcs, outs, dt = chaos_pair(victim, how)
    survivor = 1 - victim
    assert dt is not None, ("no epoch 0", outs[victim][-2000:])
    if how == "raise":
        # the crashed rank may still be leaving when the survivor has
        # ended: it is killed then
        assert "RuntimeError: simulated crash" in outs[victim]
        assert rcs[victim] in (1, -signal.SIGKILL), outs[victim][-2000:]
    else:
        assert rcs[victim] == (42 if how == "exit" else -signal.SIGKILL)
    # the survivor ended abnormally (a collective's error or the
    # heartbeat), after epoch 0 and without completing epoch 1, before
    # the pair's time ran out (a survivor killed at 120 s reads -9)
    assert rcs[survivor] not in (0, -signal.SIGKILL), outs[survivor][-2000:]
    assert "EPOCH0_DONE" in outs[survivor], outs[survivor][-2000:]
    assert "EPOCH1_DONE_UNEXPECTED" not in outs[survivor]
    if how == "raise":
        # the crashed rank wrote dead at exit while its sockets were still
        # open: the heartbeat, not gloo, ends the survivor
        assert rcs[survivor] == HEARTBEAT_EXIT_CODE, outs[survivor][-2000:]
        assert f"heartbeat: rank {victim} crashed" in outs[survivor]
        assert dt < HEARTBEAT_S, dt
    if how == "stop":
        # gloo sees no reset from a stopped peer: only the heartbeat ends
        # the survivor, naming the silent rank, within 3x its timeout
        assert rcs[survivor] == HEARTBEAT_EXIT_CODE, outs[survivor][-2000:]
        assert f"heartbeat: rank {victim} silent" in outs[survivor]
        assert dt < 3 * HEARTBEAT_S, dt


def test_heartbeat_quiet_through_a_long_wait():
    rcs, outs, dt = chaos_pair(0, "wait")
    assert rcs == [0, 0], outs
    assert all("WAIT_DONE" in o for o in outs), outs
    assert not any("heartbeat:" in o for o in outs), outs
    assert dt is not None and dt > 3 * HEARTBEAT_S, dt
