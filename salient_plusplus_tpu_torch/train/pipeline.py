"""Host→device batch feeder with transfer/compute overlap (counterpart of
the JAX package's ``train/pipeline.py``).

``DeviceFeeder`` keeps ``depth`` batches in flight. On a CUDA device each
batch is copied from its pinned sampler buffers on a side stream; an event
recorded after the copy is what the compute stream waits on before the
batch is used, and the host buffers go back to the sampler pool only once
that event has completed (earlier, the sampler could overwrite bytes the
DMA has not read yet). Device tensors are marked as used by the compute
stream, so the caching allocator does not hand their memory to the next
copy while a step still reads it. Feed starvation and the host time of
building and queuing the copies (``put_dur``) are counted. Under a
profiler each ``next`` is the span ``feed.next``, holding ``feed.sample``
(the wait on the sampler), ``feed.put`` (the batch built and its copies
enqueued) and ``feed.recycle`` (a blocking wait on a copy's event).
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import torch

from ..sampling.cpp import BatchBuffers
from ..sampling.sampler import FastSamplerIter
from ..utils.timing import span


class DeviceFeeder:
    """Iterate device-resident PaddedBatches with prefetch depth.

    pipelined=False degrades to one synchronous copy per batch (the
    --pipeline_disabled ablation).
    """

    def __init__(self, it: FastSamplerIter, device: torch.device,
                 depth: int = 2, pipelined: bool = True):
        self.it = it
        self.device = torch.device(device)
        self.depth = max(1, depth)
        self.pipelined = pipelined
        self._cuda = self.device.type == "cuda"
        self._copy_stream = (torch.cuda.Stream(device=self.device)
                             if self._cuda else None)
        self._inflight = collections.deque()   # (dev_batch, bufs, event)
        self._pending = collections.deque()    # (event, bufs) to recycle
        self._primed = False  # first batch returned (initial fill done)
        self.starved_dur = 0.0
        self.starved_occasions = 0
        self.put_dur = 0.0  # host s building batches and queuing copies
        # host-side accounting: no device scalar is read in the hot loop
        self.edges_fed = 0
        self.bytes_fed = 0  # H2D bytes (sum of shipped tensor sizes)

    def _put(self, bufs: BatchBuffers):
        self.edges_fed += int(bufs.edge_counts.sum())
        host_batch = bufs.to_padded_batch(bufs.bucket)
        self.bytes_fed += host_batch.nbytes
        if not self._cuda:
            # a CPU "copy" would alias the pooled buffer: clone instead
            self._inflight.append((host_batch.clone(), bufs, None))
            return
        with torch.cuda.stream(self._copy_stream):
            dev = host_batch.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        self._inflight.append((dev, bufs, event))

    def _recycle_done(self, wait: bool = False):
        while self._pending and (wait or self._pending[0][0].query()):
            event, bufs = self._pending.popleft()
            event.synchronize()
            self.it.recycle(bufs)

    def __iter__(self):
        return self

    def __len__(self):
        return len(self.it)

    def __next__(self):
        with span("feed.next"):
            return self._next()

    def _next(self):
        while len(self._inflight) < (self.depth if self.pipelined else 1):
            # a worker may need one of these buffers for the next batch
            self._recycle_done()
            try:
                t0 = time.perf_counter()
                with span("feed.sample"):
                    bufs = next(self.it)
                dt = time.perf_counter() - t0
                # any sampler wait after the initial fill delays the step
                # this __next__ serves: that is feed starvation
                if self._primed and dt > 1e-4:
                    self.starved_dur += dt
                    self.starved_occasions += 1
                t0 = time.perf_counter()
                with span("feed.put"):
                    self._put(bufs)
                self.put_dur += time.perf_counter() - t0
            except StopIteration:
                break
        if not self._inflight:
            with span("feed.recycle"):
                self._recycle_done(wait=True)
            raise StopIteration
        dev, bufs, event = self._inflight.popleft()
        self._primed = True
        if event is None:
            self.it.recycle(bufs)
            return dev
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(event)
        for t in dev.tensors():
            t.record_stream(compute)
        if not self.pipelined:
            event.synchronize()
        self._pending.append((event, bufs))
        self._recycle_done()
        return dev
