"""Starting ranks on one host (the counterpart of the JAX driver's
``len(jax.devices()) > 1``).

The JAX driver, run as one plain process with ``--distribute_data
true``, builds its mesh over every local device. The port runs one
process a GPU, so the plain command starts one rank a card itself
(:func:`launch_local`), as ``torchrun --nproc_per_node`` would: each rank
is ``python -m salient_plusplus_tpu_torch.driver <argv>`` with torchrun's
variables set, and joins the group through
``parallel/mesh.py::maybe_initialize_distributed``. :func:`run_ranks`
starts any script that way (the experiment harnesses, the tests), under
torchrun's variables or, to emulate them, ``srun``'s or ``mpirun``'s.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .mesh import LAUNCHER_PORT_BASE, LAUNCHER_VARS, multiprocess_intended

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class RankFailed(RuntimeError):
    """A rank of :func:`launch_local` ended with a non-zero code; the
    others were ended. ``exit_code`` is the code the parent exits with
    (128 + the signal for a rank a signal ended)."""

    def __init__(self, rank: int, returncode: int, world: int, tail: str):
        self.rank, self.returncode = rank, returncode
        self.exit_code = returncode if returncode > 0 else 128 - returncode
        super().__init__(f"rank {rank} of {world} ended with {returncode}; "
                         f"the other ranks were ended\n{tail}")


def _free_port(lo: Optional[int] = None, hi: Optional[int] = None) -> int:
    """A free TCP port on 127.0.0.1: any (the kernel's choice), or the
    first free one from a random start in ``[lo, hi]``."""
    if lo is None:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]
    start = int.from_bytes(os.urandom(2), "little") % (hi - lo + 1)
    for i in range(hi - lo + 1):
        port = lo + (start + i) % (hi - lo + 1)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError(f"no free port in [{lo}, {hi}]")


def _torchrun_env(rank: int, world: int, port: int) -> Dict[str, str]:
    return dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))


def _slurm_env(rank: int, world: int, port: int) -> Dict[str, str]:
    """``srun -n world`` on this host: JAX's port is ``SLURM_JOB_ID % 4096
    + 61440``, so the job id is chosen to give ``port``."""
    return dict(SLURM_JOB_ID=str(port - LAUNCHER_PORT_BASE),
                SLURM_STEP_NODELIST="localhost", SLURM_NTASKS=str(world),
                SLURM_STEP_NUM_TASKS=str(world), SLURM_PROCID=str(rank),
                SLURM_LOCALID=str(rank))


def _ompi_env(rank: int, world: int, port: int) -> Dict[str, str]:
    """``mpirun -np world`` (Open MPI 4) on this host: JAX's port is
    ``(jobid // 4096) % 4096 + 61440`` of the URI's job id."""
    jobid = 4096 * (port - LAUNCHER_PORT_BASE)
    return dict(OMPI_MCA_orte_hnp_uri=f"{jobid}.0;tcp://127.0.0.1:{port}",
                OMPI_COMM_WORLD_RANK=str(rank),
                OMPI_COMM_WORLD_SIZE=str(world),
                OMPI_COMM_WORLD_LOCAL_RANK=str(rank))


_LAUNCHER_ENVS: Dict[str, Callable[[int, int, int], Dict[str, str]]] = {
    "torchrun": _torchrun_env, "slurm": _slurm_env, "ompi": _ompi_env}


def _rank_env(launcher: str, rank: int, world: int,
              port: int) -> Dict[str, str]:
    """The environment of rank ``rank`` of ``world`` on this host as
    ``launcher`` (``torchrun``, ``slurm`` or ``ompi``) sets it: this
    process's without any launcher's variables, then this launcher's, with
    the repo on ``PYTHONPATH``. ``OMP_NUM_THREADS`` is 1 unless set, as
    torchrun does."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    env.update(_LAUNCHER_ENVS[launcher](rank, world, port))
    env.setdefault("OMP_NUM_THREADS", "1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    return env


def run_ranks(argv: Sequence[str], world: int, timeout_s: float,
              until: Optional[int] = None, check: bool = True,
              launcher: str = "torchrun"
              ) -> Tuple[List[int], List[str], float]:
    """Run ``python <argv>`` as ``world`` ranks of one group on this host
    with ``OMP_NUM_THREADS=1``, named by ``launcher``'s variables
    (torchrun's by default; ``slurm`` or ``ompi`` emulate ``srun`` or
    ``mpirun``, on a free port in JAX's range [61440, 65535], which
    follows from the job id). It waits for every rank and ends them
    all when one fails; with ``until``, it waits for that rank alone.
    Ranks still running when the wait ends, or when ``timeout_s`` runs
    out, are killed. Returns each rank's return code and output and the
    ``time.monotonic()`` at which the wait ended; with ``check``, a rank
    that failed raises instead."""
    port = _free_port() if launcher == "torchrun" else _free_port(
        LAUNCHER_PORT_BASE, 65535)
    procs, logs = [], []
    for rank in range(world):
        env = _rank_env(launcher, rank, world, port)
        env["OMP_NUM_THREADS"] = "1"
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


def local_launch_ranks(distribute_data: bool, training: bool, device,
                       env=None) -> int:
    """How many ranks a plain driver command starts on this host: one a
    card (``torch.cuda.device_count()``) for a data-parallel training run
    on CUDA in a process that is not already one of several (no
    torchrun variables, no launcher with more than one task); else 1, and
    the process trains by itself. The counterpart of the JAX driver's
    ``cfg.distribute_data and len(jax.devices()) > 1``: JAX never
    distributes ``--do_test_run`` or ``communication_simulation``."""
    env = os.environ if env is None else env
    if not (distribute_data and training) or device.type != "cuda" or \
            multiprocess_intended(env):
        return 1
    return max(1, torch.cuda.device_count())


def _end(procs, grace_s: float = 5.0) -> None:
    """SIGTERM every rank still running, then SIGKILL after ``grace_s``."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + grace_s
    for p in procs:
        try:
            p.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _tail(path: str, n: int = 3000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def launch_local(argv: Sequence[str], nprocs: int, device=None,
                 timeout_s: Optional[float] = None):
    """Run the driver on ``argv`` as ``nprocs`` ranks of one group on this
    host, as ``torchrun --nproc_per_node nprocs`` would (127.0.0.1, a free
    port, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``; ``OMP_NUM_THREADS`` 1
    unless set), and return rank 0's results, read back from the job's
    ``results.json``. Each rank is ``python -m
    salient_plusplus_tpu_torch.driver <argv>`` (card ``LOCAL_RANK``);
    with ``device`` (``"cpu"``) it calls ``driver.main(argv,
    device=device)`` instead, in gloo.

    Rank 0's output passes through; rank r's goes to
    ``<job dir>/rank<r>_output.txt``. The parent opens no CUDA context:
    the ranks are new processes. It waits for every rank; when one ends
    non-zero it ends the others and raises :class:`RankFailed` with that
    rank's code (the driver's CLI exits with it). Ctrl-C, SIGTERM or
    ``timeout_s`` end every rank too."""
    from ..driver import parse_argv

    _, job_name, _, cfg = parse_argv(argv)
    job_dir = os.path.join(cfg.output_root, job_name)
    os.makedirs(job_dir, exist_ok=True)
    results = os.path.join(job_dir, "results.json")
    before = os.stat(results).st_mtime_ns if os.path.exists(results) else None
    if device is None:
        cmd = [sys.executable, "-m", "salient_plusplus_tpu_torch.driver",
               *argv]
    else:
        cmd = [sys.executable, "-c",
               "import sys; from salient_plusplus_tpu_torch import driver; "
               "driver.main(sys.argv[2:], device=sys.argv[1])",
               str(device), *argv]
    port = _free_port()
    procs, logs, failed = [], {}, None
    old_term = None
    if threading.current_thread() is threading.main_thread():
        def on_term(signum, frame):
            raise KeyboardInterrupt(f"signal {signum}")
        old_term = signal.signal(signal.SIGTERM, on_term)
    try:
        for rank in range(nprocs):
            out = None
            if rank > 0:
                logs[rank] = os.path.join(job_dir, f"rank{rank}_output.txt")
                out = open(logs[rank], "w")
            try:
                procs.append(subprocess.Popen(
                    cmd, env=_rank_env("torchrun", rank, nprocs, port),
                    stdout=out,
                    stderr=None if out is None else subprocess.STDOUT))
            finally:
                if out is not None:
                    out.close()   # the child holds its own descriptor
        deadline = None if timeout_s is None else \
            time.monotonic() + timeout_s
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks still running after "
                                   f"{timeout_s} s")
            time.sleep(0.1)
    finally:
        _end(procs)
        if old_term is not None:
            signal.signal(signal.SIGTERM, old_term)
    if failed is None:
        failed = next((r for r, p in enumerate(procs) if p.returncode),
                      None)
    if failed is not None:
        tail = _tail(logs[failed]) if failed in logs else \
            "(its output is above)"
        raise RankFailed(failed, procs[failed].returncode, nprocs, tail)
    if not os.path.exists(results) or \
            os.stat(results).st_mtime_ns == before:
        raise RuntimeError(f"every rank ended with 0 but rank 0 wrote no "
                           f"{results}")
    with open(results) as f:
        return json.load(f)
