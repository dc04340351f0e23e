"""Worker for the port's rank-death tests (not a test module).

Launched twice by ``tests/test_torch_failfast.py``, as a launcher starts
ranks: the environment names the group (``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``). Both processes join it through the port's
bootstrap with a 10 s heartbeat, train one epoch of a 2-rank
``DistributedTrainer`` at the config of ``tests/_mp_chaos_worker.py``,
and then the victim rank leaves abruptly: ``os._exit(42)`` (``exit``),
an uncaught exception (``raise``: the interpreter's exit handlers run,
so the heartbeat sees the crash), or ``SIGSTOP`` (``stop``: the process
stays, with its sockets open, and answers nothing). The other rank goes
on into epoch 1 and must end non-zero instead of finishing it or waiting
in a collective. With ``wait`` nothing dies: the victim sleeps for 3×
the heartbeat's timeout (a long checkpoint write) before the group's
barrier, in which the other rank waits, and both must end with 0.

    python tests/_torch_chaos_worker.py <victim rank> <exit|raise|stop|wait> \
        [cpu|cuda]

With ``cuda`` the group is NCCL and each rank trains on its card
(``LOCAL_RANK``); ``chip_smoke.py`` runs that leg where a host has 2
cards. Numpy, torch and the port only: no JAX.
"""

import os
import signal
import sys
import time

HEARTBEAT_S = 10


def main():
    victim, how = int(sys.argv[1]), sys.argv[2]
    on_card = sys.argv[3:] == ["cuda"]
    import torch

    from salient_plusplus_tpu_torch.config import RunConfig
    from salient_plusplus_tpu_torch.data import synthetic
    from salient_plusplus_tpu_torch.parallel.mesh import (
        maybe_initialize_distributed)
    from salient_plusplus_tpu_torch.partition import contiguous_partition
    from salient_plusplus_tpu_torch.train.dist_loop import DistributedTrainer

    torch.set_num_threads(1)
    maybe_initialize_distributed(device=None if on_card else "cpu",
                                 heartbeat_timeout_s=HEARTBEAT_S)
    rank = int(os.environ["RANK"])
    device = torch.device("cuda", rank) if on_card else "cpu"
    g = synthetic.planted_partition(
        name="chaos", num_nodes=1024, num_classes=4, avg_degree=6,
        num_features=8, seed=11)
    labels = contiguous_partition(g.num_nodes, int(os.environ["WORLD_SIZE"]))
    cfg = RunConfig(
        train_batch_size=16, train_fanouts=[3, 2],
        batchwise_test_fanouts=[3, 3], final_test_fanouts=[3, 3],
        hidden_features=8, num_layers=2, lr=0.01, num_workers=1,
        calibration_batches=1, seed=5)
    t = DistributedTrainer(cfg, g, labels, device=device)
    t.train_epoch(0)
    print("EPOCH0_DONE", time.monotonic(), flush=True)

    if how == "wait":
        if rank == victim:
            time.sleep(3 * HEARTBEAT_S)  # a long write; the peer waits
        t._barrier()
        print("WAIT_DONE", flush=True)
        sys.exit(0)
    if rank == victim:
        if how == "exit":
            os._exit(42)  # simulated rank death mid-job
        if how == "raise":
            raise RuntimeError("simulated crash")  # e.g. an out-of-memory
        os.kill(os.getpid(), signal.SIGSTOP)  # a host that goes silent

    # Survivor: the next epoch's collectives must fail fast, not hang.
    try:
        t.train_epoch(1)
    except BaseException as e:  # noqa: BLE001 — any error is fail-fast
        print("FAILFAST", type(e).__name__, str(e)[:300], flush=True)
        sys.exit(7)
    print("EPOCH1_DONE_UNEXPECTED", flush=True)
    sys.exit(0)


if __name__ == "__main__":
    main()
