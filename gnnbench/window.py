"""The measured window, the same for every phase.

Steps run back to back for ``seconds``: take the next batch from the
program's feeder, enqueue the program's step on it, and keep at most
``depth`` step results unread, reading back the oldest when there are
more, so the host runs at most ``depth`` steps ahead of the card. The
window starts on an idle, synchronised card and ends when the last step
enqueued before the deadline has finished (``torch.cuda.synchronize``):
its rate is all the work of all its steps over all its time.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from .trace import span


@dataclass
class Window:
    steps: int = 0
    seconds: float = 0.0
    start: float = 0.0              # perf_counter at the window's start
    results: list = field(default_factory=list)     # host values, in order
    enqueue_s: List[float] = field(default_factory=list)
    feed_s: float = 0.0             # host s taking batches from the feeder
    read_s: float = 0.0             # host s reading results back
    step_ms: List[float] = field(default_factory=list)  # CUDA events


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(device, seconds: float, take: Callable, step: Callable,
               read: Callable, depth: int, min_steps: int = 0,
               max_steps: Optional[int] = None, spans: bool = False,
               step_events: bool = False) -> Window:
    """Run steps for ``seconds`` (and at least ``min_steps``; exactly
    ``max_steps`` when given, whatever the time). ``take()`` gives the next
    batch, ``step(batch)`` enqueues the program's step and returns its
    device result, ``read(result)`` brings it to the host.
    ``step_events`` records a CUDA event at each step's start (and one at
    the end) on the compute stream."""
    w = Window()
    pending = collections.deque()
    events = []
    sync(device)
    w.start = t0 = time.perf_counter()
    while True:
        if max_steps is not None:
            if w.steps >= max_steps:
                break
        elif w.steps >= min_steps and time.perf_counter() - t0 >= seconds:
            break
        a = time.perf_counter()
        with span("feed_wait", spans):
            batch = take()
        w.feed_s += time.perf_counter() - a
        if step_events:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        a = time.perf_counter()
        with span("enqueue", spans):
            out = step(batch)
        w.enqueue_s.append(time.perf_counter() - a)
        pending.append(out)
        w.steps += 1
        if len(pending) > depth:
            a = time.perf_counter()
            with span("queue_wait", spans):
                w.results.append(read(pending.popleft()))
            w.read_s += time.perf_counter() - a
    if step_events:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
    while pending:
        w.results.append(read(pending.popleft()))
    sync(device)
    w.seconds = time.perf_counter() - t0
    w.step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return w
