"""The trace arithmetic on hand-made intervals, and the readers built on
it."""

from types import SimpleNamespace

import pytest

import devtrace
import manifest

SPANS = sorted([(10, 20, "a"), (15, 30, "b"), (40, 50, "c"), (60, 65, "d")])


def test_busy_is_the_union_clipped_to_the_window():
    assert devtrace.busy_in(SPANS, 0, 100) == 20 + 10 + 5
    assert devtrace.busy_in(SPANS, 25, 45) == 5 + 5


def test_idle_gaps_cover_the_rest():
    gaps = devtrace.idle_gaps(SPANS, 0, 100)
    assert gaps == [(0, 10), (30, 40), (50, 60), (65, 100)]
    assert sum(b - a for a, b in gaps) + devtrace.busy_in(SPANS, 0, 100) \
        == 100


def test_idle_time_goes_to_the_innermost_stage():
    stages = [(0, 100, "outer"), (10, 20, "inner"), (12, 14, "innermost"),
              (50, 60, "other")]
    segs = devtrace.innermost(stages, 0, 120)
    assert segs == [(0, 10, "outer"), (10, 12, "inner"),
                    (12, 14, "innermost"), (14, 20, "inner"),
                    (20, 50, "outer"), (50, 60, "other"),
                    (60, 100, "outer"), (100, 120, devtrace.OUTSIDE)]
    gaps = [(5, 13), (55, 70), (110, 115)]
    assert devtrace.idle_by_stage(gaps, segs) == {
        "outer": 5 + 10, "inner": 2, "innermost": 1, "other": 5,
        devtrace.OUTSIDE: 5}


def _run(**trace):
    tr = devtrace.DeviceTrace(**trace)
    return SimpleNamespace(trace=tr, traced_work=lambda: [
        {"itx": [3.35e6, 0], "intra": [0, 0], "deblock": [6.7e6, 0]}])


def test_roofline_and_idle_readers():
    run = _run(window_s=2.0, busy_s=0.5,
               kernel_s={"itx": 1e-5, "intra": 0.0, "deblock": 1e-5},
               kernel_events={"itx": 1, "intra": 0, "deblock": 2},
               launches={"itx": 1, "intra": 0, "deblock": 2})
    # least: 1 us + 2 us of bytes; device: 20 us
    assert manifest.load_reader("kernel_roofline_pct")(run) == \
        pytest.approx(15.0)
    assert manifest.load_reader("device_idle_pct")(run) == \
        pytest.approx(75.0)


def test_a_trace_that_lost_a_launch_reads_nothing():
    run = _run(window_s=2.0, busy_s=0.5, kernel_s={"itx": 1e-5},
               kernel_events={"itx": 0}, launches={"itx": 1})
    assert not run.trace.whole
    assert manifest.load_reader("kernel_roofline_pct")(run) is None
    assert manifest.load_reader("device_idle_pct")(run) is None
