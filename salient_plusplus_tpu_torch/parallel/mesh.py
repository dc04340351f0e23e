"""Process-group bootstrap (counterpart of the JAX package's
``parallel/mesh.py``).

One process per GPU, as in the reference. The JAX package builds a device
``Mesh`` after ``jax.distributed.initialize``; here the
``torch.distributed`` process group is the mesh, and its collectives
(NCCL on the card, gloo on the CPU) carry the exchange.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


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


def maybe_initialize_distributed(device=None) -> bool:
    """Join the default process group from the environment (``env://``:
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``), with NCCL
    for CUDA (``device=None``; the rank's card is ``LOCAL_RANK``) and gloo
    for ``device="cpu"``. Idempotent; a plain single-process run is left
    alone. Returns whether a group exists.

    Fail-fast: when several processes are intended
    (:func:`multiprocess_intended`) and the bootstrap fails, it raises
    instead of carrying on as one process.
    """
    from ..utils.device import resolve_device

    if dist.is_initialized():
        return True
    if not multiprocess_intended(os.environ):
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://")
    return True
