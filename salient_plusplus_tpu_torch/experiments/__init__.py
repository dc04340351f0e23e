"""The port's experiment harnesses (counterparts of the repo's
``experiments/fp8_study.py`` and ``experiments/scaling_harness.py``): each
runs its ranks as processes of one gloo group on the CPU, started by
:func:`run_ranks` as a launcher would start them."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv: Sequence[str], world: int, timeout_s: float,
              until: Optional[int] = None, check: bool = True
              ) -> Tuple[List[int], List[str], float]:
    """Run ``python <argv>`` as ``world`` ranks of one group: the
    environment names it (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``), as ``torchrun`` does. It waits for every rank and
    ends them all when one fails; with ``until``, it waits for that rank
    alone. Ranks still running when the wait ends, or when ``timeout_s``
    runs out, are killed. Returns each rank's return code and output and
    the ``time.monotonic()`` at which the wait ended; with ``check``, a
    rank that failed raises instead."""
    port = _free_port()
    procs, logs = [], []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [REPO, os.environ.get("PYTHONPATH", "")]).rstrip(
                           os.pathsep))
        logs.append(tempfile.TemporaryFile("w+"))  # a pipe could fill
        procs.append(subprocess.Popen(
            [sys.executable, *argv], env=env, stdout=logs[-1],
            stderr=subprocess.STDOUT, text=True))
    watched = procs if until is None else [procs[until]]
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in watched):
            failed = until is None and any(
                p.poll() not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        t_end = time.monotonic()
    finally:
        outs = []
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()  # SIGKILL also ends a stopped process
            p.wait()
            log.seek(0)
            outs.append(log.read())
            log.close()
    rcs = [p.returncode for p in procs]
    bad = [r for r, rc in enumerate(rcs) if rc != 0]
    if check and bad:
        r = bad[0]
        raise RuntimeError(f"rank {r} of {world} ended with "
                           f"{rcs[r]}:\n{outs[r][-3000:]}")
    return rcs, outs, t_end
