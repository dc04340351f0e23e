"""The traced window: ``torch.profiler`` over a fixed number of steps, and
its reduction to what the per-layer metrics read.

The harness marks its own host spans with ``record_function`` (the
program has no spans of its own): ``enqueue`` around each call into the
program's step, ``feed_wait`` around taking the next batch from the
program's feeder, ``queue_wait`` around reading back an old step's
result. From the trace:

- busy seconds: the union of device operations (kernels, copies, sets)
  inside the window;
- each device operation's total seconds by name;
- each idle gap of the device, named by the host span that covers its
  middle (``other`` when none does);
- each kernel family's seconds (``families``: name patterns). A K1/K2
  ``combine_pass`` launch belongs to the ``slice_pass`` launch before it
  on its stream: the two kernels share that second pass.
"""

from __future__ import annotations

import bisect
from contextlib import nullcontext
import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "gnnbench.window"
HOST_SPANS = ("enqueue", "feed_wait", "queue_wait")
SHARED_SECOND_PASS = "combine_pass"
TOP = 10
NAME_CHARS = 160    # a device op's name as the breakdown keeps it


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    steps: int
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)
    family_s: Dict[str, float] = field(default_factory=dict)

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def span(name: str, on: bool):
    """A host span in the traced window; nothing outside it."""
    return torch.profiler.record_function(name) if on else nullcontext()


def _union(intervals):
    """Merged, sorted [start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events: List[dict], families: Dict[str, str],
                  steps: int) -> Optional[TraceSummary]:
    """Summarise chrome-trace events (``ts``/``dur`` in µs). None when the
    window span or any device operation is missing."""
    win = [e for e in events if e.get("name") == WINDOW_SPAN
           and e.get("cat") == "user_annotation"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and "dur" in e]
    if not win or not dev:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    clipped = []
    for e in dev:
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b > a:
            clipped.append((a, b, e))
    busy = _union([(a, b) for a, b, _ in clipped])
    by_name: Dict[str, float] = {}
    for a, b, e in clipped:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a)

    # each kernel to its family, stream by stream in time order
    pats = {f: re.compile(p) for f, p in families.items()}
    family_us: Dict[str, float] = {f: 0.0 for f in families}
    last: Dict[object, Optional[str]] = {}
    for a, b, e in sorted(clipped, key=lambda t: t[0]):
        if e.get("cat") != "kernel":
            continue
        stream = (e.get("args") or {}).get("stream")
        name = e["name"]
        fam = None
        if SHARED_SECOND_PASS in name:
            fam = last.get(stream)
        else:
            fam = next((f for f, p in pats.items() if p.search(name)), None)
            last[stream] = fam
        if fam is not None:
            family_us[fam] += b - a

    # idle gaps named by the host span over their middle
    hosts = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in events if e.get("name") in HOST_SPANS
             and e.get("cat") == "user_annotation"]
    hosts.sort()
    starts = [h[0] for h in hosts]
    gaps: Dict[str, float] = {}
    edges = [w0] + [v for iv in busy for v in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        # the spans do not nest: only the last one begun can cover mid
        i = bisect.bisect_right(starts, mid) - 1
        label = hosts[i][2] if i >= 0 and hosts[i][1] >= mid else "other"
        gaps[label] = gaps.get(label, 0.0) + (b - a)

    def top(d):
        return [[k[:NAME_CHARS], v * 1e-6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return TraceSummary(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        steps=steps, device_ops=top(by_name), idle_gaps=top(gaps),
        family_s={f: v * 1e-6 for f, v in family_us.items()})


def profile_steps(run_steps, steps: int, device,
                  families: Dict[str, str]) -> Optional[TraceSummary]:
    """Profile ``run_steps(steps)`` (which marks its host spans) between
    two synchronisations, and reduce the trace. On a device without a
    profiler trace of its own (the CPU) the summary is None."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        _sync(device)
        with torch.profiler.record_function(WINDOW_SPAN):
            run_steps(steps)
            _sync(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_events(events, families, steps)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
