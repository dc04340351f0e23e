"""The window's arithmetic: all the work over all the time, so a stall
inside the window lowers the rate."""

import time

import torch

from gnnbench.window import run_window

CPU = torch.device("cpu")


def _rate(stall_at=None, stall_s=0.0, seconds=0.3):
    n = {"k": 0}

    def take():
        return 1000

    def step(work):
        if n["k"] == stall_at:
            time.sleep(stall_s)
        n["k"] += 1
        time.sleep(0.002)
        return work

    w = run_window(CPU, seconds, take, step, int, depth=2)
    assert len(w.results) == w.steps
    return sum(w.results) / w.seconds


def test_a_stall_lowers_the_rate():
    steady = _rate()
    stalled = _rate(stall_at=5, stall_s=0.2)
    assert stalled < 0.8 * steady


def test_max_steps_is_exact_and_min_steps_holds():
    w = run_window(CPU, 10.0, lambda: 1, lambda b: b, int, depth=2,
                   max_steps=7)
    assert w.steps == 7 and len(w.results) == 7
    w = run_window(CPU, 0.0, lambda: 1, lambda b: b, int, depth=2,
                   min_steps=5)
    assert w.steps == 5
