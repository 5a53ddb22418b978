"""The program's spans in a traced stretch (``portbench/spans.py``) and the
five readers of them: the innermost-span rule on hand-built stretches, gaps
under ``trace.SHORT_GAP_US`` left out, time outside every pass given to no
metric, None where the spans or the device events a reader needs are
absent; and one traced run of the file cell's tiny stub on the CPU."""

import dataclasses
import time

import pytest
import torch

from portbench import harness, spans, trace
from portbench_cases import tiny

P = "gan_tpu_torch."


def stretch(device, host, end=1000.0):
    """A stretch from 0 to ``end`` µs: ``device`` (start, end) of kernels,
    ``host`` (start, end, short span name) of program spans."""
    return trace.Stretch(device=[("k", a, b - a) for a, b in device], start=0.0, end=end,
                         config={}, steps=[], window={},
                         host=sorted((a, b, P + n) for a, b, n in host))


def read(name, s):
    return trace.load_reader(name)(s)


def test_the_innermost_span_takes_each_part_of_a_gap():
    s = stretch(device=[(0, 100), (200, 500), (900, 950)],
                host=[(0, 1000, "epoch"), (100, 200, "runner.prepare"), (120, 180, "data.wait"),
                      (500, 900, "step.eager")])
    assert spans.idle_by_span(s) == {P + "runner.prepare": 40.0, P + "data.wait": 60.0,
                                     P + "step.eager": 400.0, P + "epoch": 50.0,
                                     spans.BETWEEN: 0.0}
    assert read("eager_idle_pct", s) == pytest.approx(40.0)
    assert read("runner_idle_pct", s) == pytest.approx(9.0)   # prepare 40 + epoch 50
    assert read("data_wait_pct", s) == pytest.approx(6.0)


def test_the_latest_starting_span_decides_where_spans_overlap():
    pieces = spans.innermost([(0, 100, "a"), (50, 150, "b"), (50, 60, "c"), (200, 300, "d")])
    assert pieces == [(0, 50, "a"), (50, 60, "c"), (60, 150, "b"), (200, 300, "d")]


def test_gaps_under_the_short_gap_are_left_out():
    s = stretch(device=[(0, 100), (100 + trace.SHORT_GAP_US - 1, 1000)],
                host=[(0, 1000, "step.eager")])
    assert spans.idle_by_span(s) == {}
    assert read("eager_idle_pct", s) == 0.0


def test_time_outside_every_pass_goes_to_no_metric():
    s = stretch(device=[(0, 50), (500, 1000)], host=[(100, 400, "epoch")])
    assert spans.idle_by_span(s) == {P + "epoch": 300.0, spans.BETWEEN: 150.0}
    assert read("runner_idle_pct", s) == pytest.approx(30.0)
    assert read("eager_idle_pct", s) == 0.0


def test_graph_step_pct_counts_replays_among_all_steps():
    s = stretch(device=[(0, 10)], host=[(0, 1000, "epoch")]
                + [(100 * i, 100 * i + 50, "runner.replay") for i in range(1, 4)]
                + [(900, 950, "step.eager")])
    assert read("graph_step_pct", s) == pytest.approx(75.0)


@pytest.mark.parametrize("name", ["eager_idle_pct", "runner_idle_pct", "graph_step_pct",
                                  "data_wait_pct"])
def test_a_reader_reads_nothing_without_its_spans_or_its_device(monkeypatch, name):
    no_spans = stretch(device=[(0, 100), (500, 1000)], host=[])
    assert read(name, no_spans) is None
    if name != "data_wait_pct":   # host time alone: it needs no device event
        no_device = stretch(device=[], host=[(0, 1000, "epoch"), (0, 100, "step.eager"),
                                             (200, 300, "runner.replay")])
        assert read(name, no_device) is None
    whole = stretch(device=[(0, 100), (500, 1000)],
                    host=[(0, 1000, "epoch"), (100, 500, "data.wait"), (100, 200, "step.eager")])
    assert read(name, whole) is not None
    monkeypatch.setattr(spans, "SPANS", ())   # a program that names no spans
    assert read(name, whole) is None


def test_decode_files_per_s_reads_the_program_counters(monkeypatch):
    from gan_tpu_torch.utils import profiling
    counters = profiling.Counters()
    monkeypatch.setattr(profiling, "COUNTERS", counters)
    assert read("decode_files_per_s", stretch([], [])) is None
    counters.add("decode.files", 12)
    counters.add("decode.seconds", 0.5)
    assert read("decode_files_per_s", stretch([], [])) == pytest.approx(24.0)


def test_a_traced_cpu_run_of_the_file_cell(pool, monkeypatch):
    """The program's host spans and counters read on the CPU; the readers of
    the card's idle and its graphs read nothing there. With one device event
    laid over the same stretch, every step of the traced epoch counts as an
    eager step: the CPU runs no graph."""
    seen = []
    real_breakdown = trace.breakdown
    monkeypatch.setattr(trace, "breakdown", lambda s: seen.append(s) or real_breakdown(s))
    out = harness.run(tiny("pix2pix-512.b4.files", dtype="fp32"), 2**31 + 7, 0.1, True,
                      torch.device("cpu"), time.perf_counter())
    assert out["correct"] is True
    assert set(out["metrics"]) == {"data_wait_pct", "decode_files_per_s"}
    assert 0 < out["metrics"]["data_wait_pct"]["value"] < 100
    assert out["metrics"]["decode_files_per_s"]["value"] > 0
    (s,) = seen
    steps = sum(n for _training, n, _bx, _by in s.steps)   # every step of the traced epoch
    assert spans.count(s, P + "step.eager") == steps
    assert spans.count(s, P + "data.wait") == steps
    assert read("graph_step_pct", dataclasses.replace(s, device=[("k", s.start, 1.0)])) == 0.0
