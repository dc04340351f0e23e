"""What the per-layer metric files share. A reader takes the run's
readings (``r``) and returns a number, or None where it finds nothing to
read: a number of the card (a time on it, a share of its peak or of a
roofline) is never read from a run on the CPU.
"""

from __future__ import annotations

import math

from . import arith


def on_card(r) -> bool:
    return r.device.type == "cuda"


def mean_ms(seconds) -> float | None:
    return 1e3 * sum(seconds) / len(seconds) if seconds else None


def mfu(r, phase: str):
    """The FLOPs every window step needed (the model's ``step_flops`` at
    its batch's real sizes) over the window's seconds, as a share of the
    card's bf16 peak, in %."""
    if r.phase != phase or not on_card(r) or not r.steps:
        return None
    flops = sum(r.model.step_flops(r.meta(r.batch_index(k)), phase, r.cfg)
                for k in range(r.steps))
    return 100.0 * flops / (r.window_s * arith.BF16_FLOPS_PER_S)


def roofline(r, phase: str, family: str):
    """A kernel family's share of its roofline over the traced window, in
    %: the least time its calls in the traced steps could take (the
    model's ``kernel_calls``, ``arith.bound_s``) over the time the trace
    gives its kernels."""
    t = r.trace
    if r.phase != phase or t is None or not t.family_s.get(family):
        return None
    calls = []
    for k in range(t.steps):
        calls += r.model.kernel_calls(r.meta(r.trace_batch_index(k)), phase,
                                      r.cfg).get(family, [])
    if not calls:
        return None
    return 100.0 * arith.bound_s(calls) / t.family_s[family]


def idle_share(r, phase: str):
    if r.phase != phase or r.trace is None:
        return None
    return 100.0 * r.trace.idle_share


def p95_ms(r, phase: str):
    if r.phase != phase or not on_card(r) or not r.step_ms:
        return None
    s = sorted(r.step_ms)
    return s[math.ceil(0.95 * len(s)) - 1]
