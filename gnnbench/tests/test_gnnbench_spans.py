"""The program spans' reduction (``gnnbench/spans.py``) on hand-made
chrome traces."""

import json
from dataclasses import asdict

import pytest

from gnnbench import spans
from gnnbench import trace as T

FAM = {"k1": r"slice_pass<[^>]*,\s*false>", "k3": r"gather_rows_kernel"}
MAIN, AUTOGRAD = 1, 2


def note(name, ts, dur, tid=MAIN):
    return {"name": name, "ts": ts, "dur": dur, "cat": "user_annotation",
            "tid": tid}


def launch(corr, ts, tid=MAIN):
    return {"name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "cat": "cuda_runtime", "tid": tid, "args": {"correlation": corr}}


def op(name, ts, dur, corr, cat="kernel", stream=7):
    return {"name": name, "ts": ts, "dur": dur, "cat": cat,
            "args": {"stream": stream, "correlation": corr}}


def harness():
    return [note(T.WINDOW_SPAN, 0, 100), note("enqueue", 0, 60)]


def train_events():
    """One step: step.train [0, 60) ⊃ step.backward [10, 30),
    step.optimizer [30, 58); feed.next [60, 80) ⊃ feed.put [62, 70).
    Kernel 1 is launched by autograd's thread during step.backward, kernel
    2 under step.optimizer, kernel 3 under step.train itself; the copy
    under feed.put runs [70, 80), half under kernel 5 (launched in no
    program span)."""
    return harness() + [
        note("step.train", 0, 60), note("step.backward", 10, 20),
        note("step.optimizer", 30, 28), note("feed.next", 60, 20),
        note("feed.put", 62, 8),
        launch(1, 12, tid=AUTOGRAD), op("bwd_kernel", 20, 10, 1),
        launch(2, 31), op("adam_kernel", 31, 4, 2),
        launch(3, 5), op("fold_kernel", 5, 5, 3),
        launch(4, 64), op("Memcpy HtoD (Pinned -> Device)", 70, 10, 4,
                          cat="gpu_memcpy", stream=9),
        launch(5, 90), op("late_kernel", 75, 5, 5),
    ]


def test_backward_kernel_from_autograd_thread_goes_to_backward():
    p = spans.reduce_program(train_events())
    s = p.spans["step.train/step.backward"]
    assert s.launches == 1 and s.device_us == pytest.approx(10)
    assert p.spans["step.train/step.optimizer"].launches == 1
    assert p.spans["step.train"].launches == 1      # its own: fold_kernel
    assert sum(v.launches for k, v in p.spans.items()
               if k.startswith("step.train")) == 3
    assert p.outside.launches == 1                  # late_kernel
    assert p.spans["step.train"].host_us == pytest.approx(60)
    assert p.spans["feed.next/feed.put"].count == 1
    assert p.steps == 1 and p.window_us == pytest.approx(100)


def test_idle_gap_goes_to_the_innermost_program_span():
    p = spans.reduce_program(train_events())
    # [35, 70): its middle 52.5 lies in enqueue ⊃ step.train ⊃
    # step.optimizer; [30, 31) in step.optimizer too
    assert p.spans["step.train/step.optimizer"].idle_us == pytest.approx(36)
    assert p.spans["step.train/step.backward"].idle_us == pytest.approx(10)
    assert p.spans["step.train"].idle_us == pytest.approx(5)    # [0, 5)
    # [80, 100) lies in no program span
    assert p.outside.idle_us == pytest.approx(20)
    assert p.busy_us == pytest.approx(100 - 36 - 10 - 5 - 20)


def test_h2d_copy_half_covered_is_half_exposed():
    p = spans.reduce_program(train_events())
    assert p.h2d_exposed_us == pytest.approx(5)


def score_events():
    """step.eval ⊃ step.forward ⊃ gat.attention × 2, each launching a
    torch kernel, K1's slice_pass and its combine_pass, and K3."""
    ev = [note(T.WINDOW_SPAN, 0, 200), note("step.eval", 0, 200),
          note("step.forward", 0, 190)]
    corr = 0
    for base in (0, 90):
        ev.append(note("gat.attention", base, 80))
        for name, dur in (("elementwise_kernel", 10),
                          ("void sptpu_seg::slice_pass<bf16, true, 1, "
                           "false>(...)", 6),
                          ("sptpu_seg::combine_pass(int const*)", 2),
                          ("(anonymous namespace)::gather_rows_kernel(c)", 4)):
            corr += 1
            ev += [launch(corr, base + corr), op(name, base + 2 * corr + 20,
                                                 dur, corr)]
    return ev


def test_nested_attention_spans_count_once_a_layer():
    p = spans.reduce_program(score_events())
    s = p.spans["step.eval/step.forward/gat.attention"]
    assert s.count == 2 and s.launches == 8
    assert s.device_us == pytest.approx(2 * (10 + 6 + 2 + 4))
    assert list(p.spans) == ["step.eval", "step.eval/step.forward",
                             "step.eval/step.forward/gat.attention"]
    assert p.steps == 1


def test_without_window_span_the_whole_trace_is_the_window():
    """A ``profile_dir`` trace: no harness span; two steps."""
    ev = [note("step.train", 100, 50), note("step.optimizer", 140, 10),
          launch(1, 141), op("adam_kernel", 150, 10, 1),
          note("step.train", 200, 40),
          launch(2, 205), op("fwd_kernel", 210, 20, 2)]
    p = spans.reduce_program(ev)
    assert p.steps == 2 and p.window_us == pytest.approx(140)
    assert p.spans["step.train/step.optimizer"].launches == 1
    assert p.spans["step.train"].count == 2
    assert p.busy_us == pytest.approx(30)


def test_existing_fields_unchanged_by_program_spans():
    events = train_events()
    bare = [e for e in events if not (e.get("cat") == "user_annotation"
                                      and e["name"].startswith(
                                          spans.PREFIXES))]
    a, b = T.reduce_events(events, FAM, 1), T.reduce_events(bare, FAM, 1)
    assert asdict(a) == asdict(b)
    assert spans.reduce_program(bare) is None


def test_main_prints_the_table_of_each_trace(tmp_path, capsys):
    (tmp_path / "a.pt.trace.json").write_text(
        json.dumps({"traceEvents": train_events()}))
    (tmp_path / "notes.txt").write_text("not a trace")
    assert spans.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "over 1 steps" in out
    assert "span step.train/step.backward host_ms 0.0200 device_ms " \
        "0.0100 idle_ms 0.0100 launches 1.00" in out
    assert "h2d exposed ms a step 0.0050" in out
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps({"traceEvents": harness()}))
    assert spans.main([str(bare)]) == 1
    assert spans.main([]) == 2
