"""Checkpoint and resume (counterpart of the JAX package's
``train/checkpoint.py``, with its public names).

A checkpoint is one ``torch.save`` file ``model_{trial}_{epoch}`` in the
job directory holding the train state: ``step``, ``epoch``, the model's
state_dict (parameters and BatchNorm running statistics) and the
optimizer's state_dict (Adam's moments and the current learning rate).
No generator state is stored: the port reseeds its dropout generator from
(seed, step) every step (``train/state.py::step_seed``), so the restored
``step`` is all a resumed run needs to draw the same masks. The file
format is the port's own; nothing here reads the JAX package's Orbax
checkpoints.

``metadata.txt`` gets one ``trial,epoch,acc`` line per saved improvement;
``best_epoch`` also reads the reference's two-field ``epoch,acc`` lines as
trial 0.

``use_async=True`` copies every tensor to the CPU on the caller's thread,
so training may go on updating the live ones, and writes the file on a
worker thread; ``wait_for_async_saves`` joins the workers and re-raises
what failed.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

import torch

from .state import TrainState

_PENDING_SAVES: List[threading.Thread] = []
_ERRORS: List[Exception] = []


def _ckpt_path(directory: str, trial: int, epoch: int) -> str:
    return os.path.join(os.path.abspath(directory), f"model_{trial}_{epoch}")


def _to_cpu(obj):
    """A copy of a (nested) state with every tensor on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _snapshot(state: TrainState) -> dict:
    return {"step": state.step, "epoch": state.epoch,
            "model": _to_cpu(state.model.state_dict()),
            "optimizer": _to_cpu(state.optimizer.state_dict())}


def _write(payload: dict, path: str) -> None:
    # write beside it and rename, so a reader never sees half a file
    tmp = f"{path}.tmp{threading.get_ident()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _write_async(payload: dict, path: str) -> None:
    try:
        _write(payload, path)
    except Exception as e:  # re-raised by wait_for_async_saves
        _ERRORS.append(e)


def save(directory: str, state: TrainState, trial: int, epoch: int,
         acc: Optional[float] = None, use_async: bool = False) -> str:
    """Checkpoint the train state; with ``acc``, append its metadata line.
    ``use_async=True`` returns once the state is copied to the CPU."""
    os.makedirs(directory, exist_ok=True)
    path = _ckpt_path(directory, trial, epoch)
    payload = _snapshot(state)
    if use_async:
        t = threading.Thread(target=_write_async, args=(payload, path),
                             name=f"checkpoint-{trial}-{epoch}")
        t.start()
        _PENDING_SAVES.append(t)
    else:
        _write(payload, path)
    if acc is not None:
        with open(os.path.join(directory, "metadata.txt"), "a") as f:
            f.write(f"{trial},{epoch},{acc}\n")
    return path


def wait_for_async_saves() -> None:
    """Join every asynchronous save; raise the first error one met."""
    while _PENDING_SAVES:
        _PENDING_SAVES.pop(0).join()
    if _ERRORS:
        err = _ERRORS[0]
        _ERRORS.clear()
        raise RuntimeError("an asynchronous checkpoint save failed") from err


def restore(directory: str, state: TrainState, trial: int,
            epoch: int) -> TrainState:
    """Load a checkpoint into ``state`` (same model and optimizer shapes),
    onto the state's device."""
    payload = torch.load(_ckpt_path(directory, trial, epoch),
                         map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    state.epoch = int(payload["epoch"])
    return state


def latest_epoch(directory: str, trial: int = 0) -> Optional[int]:
    """Highest checkpointed epoch of a trial (resume from the latest)."""
    if not os.path.isdir(directory):
        return None
    best = None
    prefix = f"model_{trial}_"
    for name in os.listdir(directory):
        if name.startswith(prefix):
            try:
                e = int(name[len(prefix):])
            except ValueError:
                continue
            best = e if best is None else max(best, e)
    return best


def best_epoch(directory: str, trial: int = 0) -> Optional[int]:
    """This trial's best-accuracy epoch from metadata.txt (``trial,epoch,
    acc`` lines; a two-field ``epoch,acc`` line counts as trial 0)."""
    meta = os.path.join(directory, "metadata.txt")
    if not os.path.exists(meta):
        return None
    best, best_acc = None, -1.0
    with open(meta) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 2:
                continue
            t, e, a = (0, *parts) if len(parts) == 2 else parts
            if int(t) != trial:
                continue
            if float(a) > best_acc:
                best, best_acc = int(e), float(a)
    return best
