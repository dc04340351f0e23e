"""The program's own spans in a ``torch.profiler`` chrome trace, reduced to
a table a step.

    python3 -m gnnbench.spans <trace.json or a directory of them> ...

The program marks each layer boundary of its hot path with a span
(``salient_plusplus_tpu_torch/utils/timing.py::span``: ``feed.*``,
``step.*``, ``gat.attention``): a ``record_function`` while a profiler
records, so on the trace's clock beside the kernels. A trace that holds
them: the program's ``profile_dir`` epoch (``tensorboard_trace_handler``
writes ``*.pt.trace.json``), or any ``export_chrome_trace``. The window
is the benchmark's ``gnnbench.window`` span where the trace has one,
else the whole trace; a step is a ``step.train`` or ``step.eval`` span
that starts in it. From the trace:

- each device operation goes to the innermost program span whose host
  interval holds its launch: the ``cuda_runtime`` (or ``cuda_driver``)
  event with the same ``args.correlation``, on any host thread (autograd
  launches the backward's kernels from its own thread while the step's
  thread sits in ``step.backward``);
- each idle gap of the card goes to the innermost program span over its
  middle, else to ``outside``;
- exposed H2D: the time of the host-to-device copies enqueued under
  ``feed.put`` in which no kernel runs.

A span is keyed by its path: the names of the program spans it sits in
and its own, joined by ``/`` (``step.eval/step.forward/gat.attention``).
Its device time, launches and idle time are its own, outside its child
spans.

The benchmark's traced window does not run this reduction: its result
has no metric that reads the spans yet.
"""

from __future__ import annotations

import bisect
import glob
import json
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import trace as T

PREFIXES = ("feed.", "step.", "gat.")
STEP_SPANS = ("step.train", "step.eval")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SEP = "/"
H2D = "HtoD"
FEED_PUT = "feed.put"


@dataclass
class SpanStats:
    count: int = 0              # times the span ran in the window
    host_us: float = 0.0        # its whole host time
    device_us: float = 0.0      # device operations launched in it
    launches: int = 0           # kernels launched in it
    idle_us: float = 0.0        # idle gaps with their middle in it


@dataclass
class ProgramTrace:
    steps: int
    window_us: float
    busy_us: float
    spans: Dict[str, SpanStats]         # path -> its own numbers
    outside: SpanStats = field(default_factory=SpanStats)
    h2d_exposed_us: float = 0.0


def _segments(spans):
    """The timeline cut into disjoint (start, end, path) pieces, each
    labelled with the innermost span over it; ``spans`` are nested
    (start, end, name). Also each span's (start, end, path)."""
    pieces, paths = [], []
    stack = []      # (end, path)
    t = -math.inf

    def close(until):
        nonlocal t
        while stack and stack[-1][0] <= until:
            end, path = stack.pop()
            if end > t:
                pieces.append((t, end, path))
                t = end

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        close(a)
        if stack and a > t:
            pieces.append((t, a, stack[-1][1]))
        t = a
        path = stack[-1][1] + SEP + name if stack else name
        end = min(b, stack[-1][0]) if stack else b
        stack.append((end, path))
        paths.append((a, end, path))
    close(math.inf)
    return pieces, paths


def _at(pieces, starts, x) -> Optional[str]:
    i = bisect.bisect_right(starts, x) - 1
    return pieces[i][2] if i >= 0 and x <= pieces[i][1] else None


def _overlap(a, b, union, starts) -> float:
    """The part of [a, b) covered by the sorted, merged ``union``."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    got = 0.0
    while i < len(union) and union[i][0] < b:
        got += max(0.0, min(b, union[i][1]) - max(a, union[i][0]))
        i += 1
    return got


def _interval(e):
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


def reduce_program(events: List[dict]) -> Optional[ProgramTrace]:
    """The program's spans in chrome-trace events (``ts``/``dur`` in µs).
    None without a device operation or a program span in the window."""
    notes = [e for e in events if e.get("cat") == "user_annotation"
             and "dur" in e and e.get("name", "").startswith(PREFIXES)]
    dev = [e for e in events if e.get("cat") in T.DEVICE_CATS
           and "dur" in e]
    if not dev or not notes:
        return None
    win = [e for e in events if e.get("name") == T.WINDOW_SPAN
           and e.get("cat") == "user_annotation"]
    if win:
        w0, w1 = _interval(win[0])
    else:
        ends = [_interval(e) for e in notes + dev]
        w0, w1 = min(a for a, _ in ends), max(b for _, b in ends)
    ops = []
    for e in dev:
        a, b = _interval(e)
        a, b = max(a, w0), min(b, w1)
        if b > a:
            ops.append((a, b, e))
    notes = [e for e in notes if w0 <= float(e["ts"]) < w1]
    if not ops or not notes:
        return None

    pieces, paths = _segments([(*_interval(e), e["name"]) for e in notes])
    starts = [p[0] for p in pieces]
    spans: Dict[str, SpanStats] = {}
    for a, b, path in paths:
        s = spans.setdefault(path, SpanStats())
        s.count += 1
        s.host_us += max(0.0, min(b, w1) - a)
    steps = sum(1 for e in notes if e["name"] in STEP_SPANS)

    launched = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launched[corr] = float(e["ts"])
    outside = SpanStats()
    kernels = []
    h2d = []        # (a, b) of the copies enqueued under feed.put
    for a, b, e in ops:
        t = launched.get((e.get("args") or {}).get("correlation"))
        path = None if t is None else _at(pieces, starts, t)
        s = outside if path is None else spans[path]
        s.device_us += b - a
        if e.get("cat") == "kernel":
            s.launches += 1
            kernels.append((a, b))
        if (e.get("cat") == "gpu_memcpy" and H2D in e["name"]
                and path is not None and FEED_PUT in path.split(SEP)):
            h2d.append((a, b))
    kunion = T._union(kernels)
    kstarts = [u[0] for u in kunion]
    exposed = sum(b - a - _overlap(a, b, kunion, kstarts) for a, b in h2d)

    # idle gaps: the innermost program span over the middle
    busy = T._union([(a, b) for a, b, _ in ops])
    edges = [w0] + [v for iv in busy for v in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            path = _at(pieces, starts, 0.5 * (a + b))
            (outside if path is None else spans[path]).idle_us += b - a
    return ProgramTrace(steps=steps, window_us=w1 - w0,
                        busy_us=sum(b - a for a, b in busy), spans=spans,
                        outside=outside, h2d_exposed_us=exposed)


def table(p: ProgramTrace) -> List[str]:
    """The per-span lines, a step each."""
    per = 1e-3 / max(p.steps, 1)
    lines = [f"program spans, ms a step over {p.steps} steps (window "
             f"{p.window_us * per:.4f}, busy {p.busy_us * per:.4f}; host_ms "
             f"the span's whole time; device_ms, idle_ms, launches its own, "
             f"outside its child spans)"]

    def line(name, s):
        return (f"span {name} host_ms {s.host_us * per:.4f} device_ms "
                f"{s.device_us * per:.4f} idle_ms {s.idle_us * per:.4f} "
                f"launches {s.launches / max(p.steps, 1):.2f}")
    for path in sorted(p.spans):
        lines.append(line(path, p.spans[path]))
    lines.append(line("(outside)", p.outside))
    lines.append(f"h2d exposed ms a step {p.h2d_exposed_us * per:.4f}")
    return lines


def trace_files(paths: List[str]) -> List[str]:
    """Each path, or the ``*.json`` traces of each directory."""
    out = []
    for path in paths:
        out += (sorted(glob.glob(os.path.join(path, "*.json")))
                if os.path.isdir(path) else [path])
    return out


def main(argv=None) -> int:
    files = trace_files(sys.argv[1:] if argv is None else argv)
    if not files:
        print("usage: python3 -m gnnbench.spans <trace.json or dir> ...",
              file=sys.stderr)
        return 2
    bad = 0
    for path in files:
        with open(path) as f:
            p = reduce_program(json.load(f)["traceEvents"])
        print(path)
        if p is None:
            print("no program span or device operation")
            bad += 1
            continue
        for line in table(p):
            print(line)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
