"""Process-group bootstrap (counterpart of the JAX package's
``parallel/mesh.py``).

One process per GPU, as in the reference. The JAX package builds a device
``Mesh`` after ``jax.distributed.initialize``; here the
``torch.distributed`` process group is the mesh, and its collectives
(NCCL on the card, gloo on the CPU) carry the exchange.

Rank-death fail-fast. ``jax.distributed.initialize`` runs a coordination
service whose heartbeat ends every process when a peer falls silent
(``heartbeat_timeout_seconds``, 100 s by default in JAX 0.9.0). A
``torch.distributed`` group has nothing of the kind: a survivor waits in
its next collective until NCCL's watchdog or gloo's timeout fires (10 and
30 minutes by default), or forever when a peer host vanishes without
closing its sockets. :class:`Heartbeat` is the port's counterpart: every
rank writes a counter to the group's store and reads its peers'; a peer
whose counter has not moved for the timeout, a peer that left with an
exception (it writes ``dead``), or a store that is gone, ends the
process. It checks liveness, not progress: a rank that waits at
a barrier while rank 0 writes a checkpoint keeps beating, which a short
collective timeout would not allow.

Launchers. ``jax.distributed.initialize()`` with no arguments takes its
rendezvous from the launcher: Open MPI's ``mpirun`` first, then SLURM's
``srun`` (JAX 0.9.0, ``jax/_src/clusters``). :func:`launcher_env` is the
port's copy of those rules: it turns either launcher's variables into
torchrun's (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``), which ``init_process_group("env://")`` reads. Rank 0
hosts the group's store on ``MASTER_ADDR``, the first host of the step's
node list or the ``mpirun`` host: SLURM's block distribution puts
``SLURM_PROCID`` 0 on the first node, and the ``mpirun`` host is rank 0's
in the common case. JAX relies on the same. Open MPI 5 (no
``orte_hnp_uri``) and MPICH's hydra are joined by neither package.
"""

from __future__ import annotations

import atexit
import datetime
import os
import re
import sys
import threading
import time
from typing import Optional

import torch
import torch.distributed as dist

HEARTBEAT_TIMEOUT_S = 100.0   # jax.distributed's heartbeat_timeout_seconds
HEARTBEAT_EXIT_CODE = 70      # os._exit code of a rank the heartbeat ends
_DONE = b"done"
_DEAD = b"dead"


def multiprocess_intended(env) -> bool:
    """True when the environment says this process is one of several:
    torchrun's ``WORLD_SIZE`` / ``RANK``, or a SLURM or MPI launcher with
    more than one task."""
    if any(v in env for v in ("WORLD_SIZE", "RANK")):
        return True
    for v in ("SLURM_NTASKS", "SLURM_STEP_NUM_TASKS",
              "OMPI_COMM_WORLD_SIZE", "PMI_SIZE"):
        try:
            if int(env.get(v, "1")) > 1:
                return True
        except ValueError:
            pass
    return False


TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
_SLURM_VARS = ("SLURM_JOB_ID", "SLURM_STEP_NODELIST", "SLURM_NTASKS",
               "SLURM_PROCID", "SLURM_LOCALID")
_OMPI_URI = "OMPI_MCA_orte_hnp_uri"   # set by mpirun / mpiexec before 5.0
_OMPI_VARS = ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
              "OMPI_COMM_WORLD_LOCAL_RANK")
LAUNCHER_PORT_BASE = 65536 - 4096   # JAX's ephemeral range [61440, 65535]
# every variable of a launcher that launcher_env or multiprocess_intended
# reads
LAUNCHER_VARS = (TORCHRUN_VARS + ("LOCAL_RANK",) + _SLURM_VARS +
                 ("SLURM_STEP_NUM_TASKS", _OMPI_URI) + _OMPI_VARS +
                 ("PMI_SIZE",))
LAUNCHERS = ("torchrun (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE), "
             "srun (" + ", ".join(_SLURM_VARS) + ") or Open MPI's mpirun "
             "before 5.0 (" + ", ".join((_OMPI_URI,) + _OMPI_VARS) + ")")


def slurm_first_host(node_list: str) -> str:
    """The first host of a SLURM node list: ``n001`` of ``n001``,
    ``n001,h2``, ``n[001-015],h2`` or ``n[001,007-015],h2`` (JAX's
    ``SlurmCluster`` parse)."""
    cut = next((i for i, ch in enumerate(node_list) if ch in ",["),
               len(node_list))
    if cut == len(node_list) or node_list[cut] == ",":
        return node_list[:cut]
    suffix = node_list[cut + 1:]
    end = next((i for i, ch in enumerate(suffix) if ch in ",-]"), None)
    return node_list[:cut] + suffix[:end]


def ompi_launcher_host(uri: str) -> str:
    """The ``mpirun`` host's first address in ``OMPI_MCA_orte_hnp_uri``:
    ``10.96.0.1`` of ``1531576320.0;tcp://10.96.0.1,10.148.0.1:34911``,
    ``fe80::b9b`` (no brackets) of ``...;tcp6://[fe80::b9b,...]:43370``
    (JAX's ``OmpiCluster`` parse)."""
    m = re.search(r"tcp://(.+?)[,:]|tcp6://\[(.+?)[,\]]", uri)
    if m is None:
        raise RuntimeError(f"no launcher address in {_OMPI_URI}={uri!r}")
    return next(g for g in m.groups() if g is not None)


def _required(env, names, launcher: str) -> list:
    """The values of ``names`` in ``env``; one unset raises."""
    missing = [v for v in names if v not in env]
    if missing:
        raise ValueError(f"{launcher} is incomplete: {', '.join(missing)} "
                         f"not set; the launchers joined are {LAUNCHERS}")
    return [env[v] for v in names]


def launcher_env(env) -> Optional[dict]:
    """The torchrun variables (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``) of the launcher ``env`` names, or None
    when it names none.

    torchrun's own set wins when ``RANK`` or ``WORLD_SIZE`` is set, and is
    then taken whole (``LOCAL_RANK`` 0 when unset); an incomplete one
    raises. Otherwise Open MPI (``OMPI_MCA_orte_hnp_uri`` set), then SLURM
    (every one of ``SLURM_JOB_ID``, ``SLURM_STEP_NODELIST``,
    ``SLURM_NTASKS``, ``SLURM_PROCID``, ``SLURM_LOCALID`` set), by JAX
    0.9.0's rules: the host is the first of the step's node list, or the
    ``mpirun`` host's first address; the port is ``SLURM_JOB_ID % 4096 +
    61440``, or ``(jobid // 4096) % 4096 + 61440`` of the URI's job id. A
    ``MASTER_ADDR`` or ``MASTER_PORT`` the user set wins over the
    launcher's host or port (``MASTER_PORT`` as JAX's
    ``JAX_COORDINATOR_PORT``)."""
    if "RANK" in env or "WORLD_SIZE" in env:
        out = dict(zip(TORCHRUN_VARS,
                       _required(env, TORCHRUN_VARS, "torchrun's set")))
        out["LOCAL_RANK"] = env.get("LOCAL_RANK", "0")
        return out
    if _OMPI_URI in env:
        uri = env[_OMPI_URI]
        rank, world, local = _required(env, _OMPI_VARS, "Open MPI's set")
        host = env.get("MASTER_ADDR") or ompi_launcher_host(uri)
        port = env.get("MASTER_PORT") or str(
            (int(uri.split(".", 1)[0]) // 4096) % 4096 + LAUNCHER_PORT_BASE)
    elif all(v in env for v in _SLURM_VARS):
        rank, world, local = (env[v] for v in (
            "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID"))
        host = env.get("MASTER_ADDR") or slurm_first_host(
            env["SLURM_STEP_NODELIST"])
        port = env.get("MASTER_PORT") or str(
            int(env["SLURM_JOB_ID"]) % 4096 + LAUNCHER_PORT_BASE)
    else:
        return None
    return {"MASTER_ADDR": host, "MASTER_PORT": port, "RANK": str(int(rank)),
            "WORLD_SIZE": str(int(world)), "LOCAL_RANK": str(int(local))}


def card_index(env) -> int:
    """The card of this rank: its ``LOCAL_RANK``, as JAX's
    ``local_device_ids=[local id]``. A local rank without a card raises
    (never wrapped round onto a card another rank holds)."""
    local = int(env.get("LOCAL_RANK", "0"))
    count = torch.cuda.device_count()
    if not 0 <= local < count:
        raise RuntimeError(
            f"LOCAL_RANK={local} has no card: torch.cuda.device_count() is "
            f"{count} (CUDA_VISIBLE_DEVICES="
            f"{env.get('CUDA_VISIBLE_DEVICES', '<unset>')}); start one "
            f"process a card, each seeing every card of its host")
    return local


def _base_store(store):
    """The store under the default group's ``PrefixStore`` wrappers."""
    while hasattr(store, "underlying_store"):
        store = store.underlying_store
    return store


def crash_pending() -> bool:
    """True while an exception is on its way out of the main thread: one
    being handled there now (in an ``except``, ``finally`` or
    ``__exit__``), or an uncaught one the interpreter has printed
    (``sys.last_exc``, set before the exit handlers run)."""
    if getattr(sys, "last_exc", getattr(sys, "last_value", None)) is not None:
        return True
    current = getattr(sys, "_current_exceptions", dict)()
    return current.get(threading.main_thread().ident) is not None


class Heartbeat:
    """A liveness monitor over a group's store.

    Two daemon threads a rank. The beat thread writes ``hb/<restart>/<rank>``
    (a counter) every ``timeout_s / 10`` s through a client connection of
    its own and reads its peers' keys; a peer whose value has not changed
    for ``timeout_s`` on this rank's monotonic clock is dead (each writer
    keeps its own clock, so values are compared, not times), and so is a
    peer whose key reads ``dead``. The watch thread never touches the
    store: a store call to a host that is stopped can block past its own
    timeout, so the watch thread ends the process when the beat thread has
    not finished a round for ``timeout_s``. A closed connection to the
    store (its host, rank 0, is gone) ends it at once. Either way one line
    naming the rank goes to stderr and the process ends with
    ``os._exit(HEARTBEAT_EXIT_CODE)``, as JAX's coordination service ends
    the process rather than raising in a thread; a rank ended for a peer's
    sake writes ``dead`` first, so the rest of the group follows.

    Leaving. A rank that leaves cleanly (the group destroyed, or
    interpreter exit) writes ``done``, and its peers stop watching it. A
    rank that leaves while an exception is on its way out of it
    (:func:`crash_pending`: an uncaught exception at exit, or the group
    destroyed in a ``finally`` as one passes) writes ``dead`` and stays up
    for at most two beat periods, until every peer has left, so that each
    reads it; a group destroyed during an exception only stops the
    judging, and the exit handler writes the verdict. Rank 0 hosts the
    store under ``env://``: on a clean leave it keeps the store up until
    every peer has left or missed two beats (at most ``timeout_s``), and a
    peer that saw rank 0's ``done`` stops quietly once the store is gone.
    The key prefix carries torchrun's ``TORCHELASTIC_RESTART_COUNT``, so a
    restarted rank never reads the keys of the incarnation before it.
    """

    def __init__(self, store, rank: int, world: int,
                 timeout_s: float = HEARTBEAT_TIMEOUT_S):
        self.timeout_s = float(timeout_s)
        self.period_s = self.timeout_s / 10
        self.rank, self.world = rank, world
        restart = os.environ.get("TORCHELASTIC_RESTART_COUNT", "0")
        self._prefix = f"hb/{restart}/"
        self._base = _base_store(store)   # keeps rank 0's server up
        if not hasattr(self._base, "clone"):
            raise RuntimeError(
                f"the heartbeat needs a connection of its own to the "
                f"group's store, and this torch's {type(self._base).__name__}"
                f" has no clone()")
        self._store = self._base.clone()
        self._store.set_timeout(datetime.timedelta(
            seconds=max(1.0, self.period_s)))
        self._group = dist.GroupMember.WORLD
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._leaving = False
        self._judging = True     # while this rank's group lives
        self._crashed = False    # the leave writes dead, not done
        self._count = 0
        now = time.monotonic()
        self._last_ok = now
        # peer -> (last value read, monotonic time it changed)
        self._seen = {p: (None, now) for p in range(world) if p != rank}
        self._key(rank, str(self._count))
        self._beat_thread = threading.Thread(
            target=self._beat, name=f"heartbeat-beat-{rank}", daemon=True)
        self._watch_thread = threading.Thread(
            target=self._watch, name=f"heartbeat-watch-{rank}", daemon=True)

    @property
    def beats(self) -> int:
        """Rounds this rank has written its key (0 at start)."""
        return self._count

    def start(self) -> "Heartbeat":
        self._beat_thread.start()
        self._watch_thread.start()
        return self

    def _key(self, rank: int, value: Optional[str] = None):
        key = f"{self._prefix}{rank}"
        if value is not None:
            self._store.set(key, value)
        return key

    # --- the beat thread ------------------------------------------------
    def _read_peers(self) -> None:
        """One round: every peer's value, each compared with the last."""
        keys = [self._key(p) for p in self._seen]
        present = [k for k in keys if self._store.check([k])]
        vals = dict(zip(present, self._store.multi_get(present))
                    ) if present else {}
        now = time.monotonic()
        for p, key in zip(list(self._seen), keys):
            val, t = self._seen[p]
            got = vals.get(key)
            if got is not None and got != val:
                self._seen[p] = (got, now)

    def _verdict(self) -> Optional[str]:
        now = time.monotonic()
        for p, (val, t) in self._seen.items():
            if val == _DEAD:
                return f"rank {p} crashed"
            if val != _DONE and now - t > self.timeout_s:
                return f"rank {p} silent for {now - t:.1f} s"
        return None

    def _group_gone(self) -> bool:
        return not dist.is_initialized() or \
            dist.GroupMember.WORLD is not self._group

    def _beat(self) -> None:
        next_beat = 0.0
        while not self._stop.is_set():
            if self._judging and self._group_gone():
                if not crash_pending() and \
                        threading.main_thread().is_alive():
                    break   # a clean leave
                # an exception may be ending the process: beat on, judge
                # no more, and let the exit handler write done or dead
                self._judging = False
            if time.monotonic() >= next_beat:
                try:
                    self._count += 1
                    self._key(self.rank, str(self._count))
                    if self._judging:
                        self._read_peers()
                except Exception as e:  # noqa: BLE001 — any store fault
                    self._store_fault(e)
                else:
                    with self._lock:
                        self._last_ok = time.monotonic()
                    why = self._verdict() if self._judging else None
                    if why is not None:
                        self._fire(why, mark_dead=True)
                next_beat = time.monotonic() + self.period_s
            # the group is checked often, so a clean leave is seen at once
            self._stop.wait(min(0.2, self.period_s))
        self._leave()

    def _store_fault(self, e: Exception) -> None:
        """A store call failed. Rank 0 gone after its ``done``, or this
        rank no longer judging: the store went with rank 0, stop quietly.
        A closed connection: rank 0 is gone, end now. A timeout: the watch
        thread decides."""
        if not self._judging or self._seen.get(0, (None, 0))[0] == _DONE:
            self._stop.set()
            return
        network = getattr(dist, "DistNetworkError", ())
        if isinstance(e, network):
            self._fire(f"rank 0 (the store's host) unreachable: "
                       f"{type(e).__name__}: {str(e).splitlines()[0]}")

    # --- the watch thread -----------------------------------------------
    def _watch(self) -> None:
        while not self._stop.wait(self.period_s / 2):
            with self._lock:
                stalled = time.monotonic() - self._last_ok
            if stalled > self.timeout_s:
                self._fire(f"the store (rank 0) has not answered for "
                           f"{stalled:.1f} s")

    def _fire(self, why: str, mark_dead: bool = False) -> None:
        """End the process; with ``mark_dead`` (the store answers, on the
        beat thread) write ``dead`` first, so the peers follow."""
        with self._lock:
            if self._leaving or self._stop.is_set() or not self._judging:
                return
        print(f"heartbeat: {why} (timeout {self.timeout_s:g} s); ending "
              f"rank {self.rank}", file=sys.stderr, flush=True)
        if mark_dead:
            try:
                self._key(self.rank, _DEAD.decode())
            except Exception:  # noqa: BLE001 — ending regardless
                pass
        os._exit(HEARTBEAT_EXIT_CODE)

    # --- leaving --------------------------------------------------------
    def _leave(self) -> None:
        with self._lock:
            self._leaving = True
        self._stop.set()
        try:
            self._key(self.rank, (_DEAD if self._crashed else _DONE).decode())
            if self._crashed or self.rank == 0:
                # stay up while a peer still beats and has not left: it
                # must read this key (and, from rank 0, reach the store)
                # first. A peer that missed two beats is not reading.
                linger = 2 * self.period_s if self._crashed else \
                    self.timeout_s
                deadline = time.monotonic() + linger
                while time.monotonic() < deadline:
                    self._read_peers()
                    now = time.monotonic()
                    if all(v in (_DONE, _DEAD) or now - t > 2 * self.period_s
                           for v, t in self._seen.values()):
                        break
                    time.sleep(min(0.05, self.period_s))
        except Exception:  # noqa: BLE001 — the store may be gone already
            pass
        self._store = self._base = None

    def stop(self, crashed: bool = False) -> None:
        """Leave (``dead`` if ``crashed``, else ``done``), with rank 0's
        or the crashed rank's linger; both threads ended (the caller
        waits for them)."""
        with self._lock:
            self._leaving = True
            self._crashed = crashed
        self._stop.set()
        self._beat_thread.join(self.timeout_s + 5)
        self._watch_thread.join(self.timeout_s)


_heartbeat: Optional[Heartbeat] = None


def start_heartbeat(timeout_s: float = HEARTBEAT_TIMEOUT_S) -> Heartbeat:
    """Start this rank's :class:`Heartbeat` over the default group's store
    (a previous one is stopped first). It stops by itself when the group
    is destroyed, and at interpreter exit."""
    global _heartbeat
    stop_heartbeat()
    _heartbeat = Heartbeat(dist.distributed_c10d._get_default_store(),
                           dist.get_rank(), dist.get_world_size(),
                           timeout_s).start()
    return _heartbeat


def current_heartbeat() -> Optional[Heartbeat]:
    """This rank's running heartbeat, or None."""
    return _heartbeat


def stop_heartbeat() -> None:
    """Stop this rank's heartbeat, if one runs: as a crash (``dead``) when
    an exception is on its way out of the main thread
    (:func:`crash_pending`), else as a clean leave (``done``). It runs at
    interpreter exit too, after an uncaught exception has been printed."""
    global _heartbeat
    hb, _heartbeat = _heartbeat, None
    if hb is not None:
        hb.stop(crashed=crash_pending())


atexit.register(stop_heartbeat)


def maybe_initialize_distributed(
        device=None, heartbeat_timeout_s: float = HEARTBEAT_TIMEOUT_S) -> bool:
    """Join the default process group from the launcher's variables
    (:func:`launcher_env`: torchrun's, ``srun``'s or ``mpirun``'s, written
    into ``os.environ`` as torchrun's, so ``env://``, the heartbeat's store
    and every later reader of ``LOCAL_RANK`` see the same), with NCCL for
    CUDA (``device=None``; the rank's card is its local rank,
    :func:`card_index`) and gloo for ``device="cpu"``, and start the
    rank's heartbeat (:class:`Heartbeat`; ``heartbeat_timeout_s`` as
    ``jax.distributed.initialize``'s ``heartbeat_timeout_seconds``).
    Idempotent; a plain single-process run is left alone. Returns whether
    a group exists.

    Fail-fast: when several processes are intended
    (:func:`multiprocess_intended`) and no launcher names the rendezvous
    (``srun`` in a batch step with no step node list, MPICH's hydra, Open
    MPI 5), or the bootstrap fails, it raises instead of carrying on as
    one process, as ``jax.distributed.initialize()`` does. A rank whose
    local rank has no card raises once its heartbeat runs, so its peers
    read ``dead`` and end too. Once the group runs, a rank whose peer
    falls silent for ``heartbeat_timeout_s`` ends. The group has no short
    collective timeout: long legitimate waits (a checkpoint written by
    rank 0, the cache build, the layerwise test) stay allowed.

    The heartbeat's keys carry torchrun's ``TORCHELASTIC_RESTART_COUNT``
    (0 under ``srun`` and ``mpirun``); a requeued ``srun`` step or a new
    ``mpirun`` job cannot read the keys of the run before it, because each
    run's rank 0 hosts a new store.
    """
    from ..utils.device import resolve_device

    if dist.is_initialized():
        return True
    if not multiprocess_intended(os.environ):
        return False
    filled = launcher_env(os.environ)
    if filled is None:
        said = {v: os.environ[v] for v in (
            "SLURM_NTASKS", "SLURM_STEP_NUM_TASKS", "OMPI_COMM_WORLD_SIZE",
            "PMI_SIZE") if v in os.environ}
        raise RuntimeError(
            f"the environment says this process is one of several ({said}) "
            f"but names no rendezvous; the launchers joined are "
            f"{LAUNCHERS} (neither this port nor JAX 0.9.0 joins Open MPI 5 "
            f"or MPICH)")
    os.environ.update(filled)
    dev = resolve_device(device)   # CUDA without a card raises here
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://")
    start_heartbeat(heartbeat_timeout_s)
    if dev.type == "cuda":
        torch.cuda.set_device(card_index(os.environ))
    return True
