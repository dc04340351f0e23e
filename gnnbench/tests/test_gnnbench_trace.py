"""The trace's reduction on a hand-made chrome trace."""

import pytest

from gnnbench.trace import reduce_events

FAM = {"k1": r"slice_pass<[^>]*,\s*false>", "k2": r"slice_pass<[^>]*,\s*true>",
       "k3": r"gather_rows_kernel"}


def ev(name, ts, dur, cat="kernel", stream=7):
    return {"name": name, "ts": ts, "dur": dur, "cat": cat,
            "args": {"stream": stream}}


def test_busy_gaps_and_families():
    events = [
        ev("gnnbench.window", 0, 100, "user_annotation"),
        ev("enqueue", 0, 10, "user_annotation"),
        ev("feed_wait", 60, 20, "user_annotation"),
        ev("void sptpu_seg::slice_pass<bf16, true, 1, false>(...)", 10, 10),
        ev("sptpu_seg::combine_pass(int const*)", 20, 5),
        ev("void sptpu_seg::slice_pass<bf16, true, 1, true>(...)", 25, 10),
        ev("sptpu_seg::combine_pass(int const*)", 35, 5),
        ev("(anonymous namespace)::gather_rows_kernel(char const*)", 40, 20),
        ev("Memcpy HtoD (Pinned -> Device)", 50, 5, "gpu_memcpy", 9),
        ev("outside", 150, 10),
    ]
    t = reduce_events(events, FAM, steps=2)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(50e-6)
    assert t.idle_share == pytest.approx(0.5)
    assert t.family_s["k1"] == pytest.approx(15e-6)
    assert t.family_s["k2"] == pytest.approx(15e-6)
    assert t.family_s["k3"] == pytest.approx(20e-6)
    gaps = dict(t.idle_gaps)
    assert gaps["enqueue"] == pytest.approx(10e-6)
    # the gap [60, 100) has its middle in feed_wait's span
    assert gaps["feed_wait"] == pytest.approx(40e-6)
    assert "other" not in gaps
    assert t.device_ops[0][0].endswith("gather_rows_kernel(char const*)")


def test_no_device_ops_reads_nothing():
    events = [ev("gnnbench.window", 0, 100, "user_annotation")]
    assert reduce_events(events, FAM, steps=1) is None
