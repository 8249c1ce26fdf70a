"""The arithmetic of the rate, the p90 and the idle share, on a hand-built
window with a stall in it, where a median of chunks would not move."""

import statistics

import pytest

from benchlib import stats
from benchlib.trace import TraceView


def window_with_stall():
    """Ten calls of 0.1 s each, the sixth stalled to 1.0 s; the device busy
    for the first 60 ms of every call."""
    calls, t = [], 0.0
    for i in range(10):
        d = 1.0 if i == 5 else 0.1
        calls.append((t, t + d))
        t += d
    return calls, t


def test_rate_takes_the_whole_window():
    calls, end = window_with_stall()
    ops = 64 * len(calls)
    assert stats.rate(ops, end) == pytest.approx(640 / 1.9)
    # a median of the calls' own rates ignores the stall; the window's does not
    per_call = [64 / (b - a) for a, b in calls]
    assert statistics.median(per_call) == pytest.approx(640.0)
    assert stats.rate(ops, end) < 0.6 * statistics.median(per_call)


def test_p90_is_the_tail_of_every_call():
    walls = [0.1] * 95 + [1.0] * 5
    assert stats.percentile(walls, 50) == pytest.approx(0.1)
    assert stats.percentile(walls, 90) == pytest.approx(0.1)
    walls = [0.1] * 85 + [1.0] * 15
    assert stats.percentile(walls, 90) == pytest.approx(1.0)
    import numpy as np

    rng = np.random.default_rng(3)
    v = list(rng.random(137))
    assert stats.percentile(v, 90) == pytest.approx(float(np.percentile(v, 90)))


def test_idle_share_counts_the_stall():
    calls, end = window_with_stall()
    device = [("k", a, a + 0.06) for a, _b in calls]
    view = TraceView((0.0, end), device, [("benchmark_window", 0.0, end)] +
                     [("benchmark_call", a, b) for a, b in calls], ["benchmark_window", "benchmark_call"])
    assert view.busy_s() == pytest.approx(0.6)
    assert stats.idle_share(view.device_intervals(), *view.window) == pytest.approx(100 * (1 - 0.6 / 1.9))
    gaps = view.breakdown()["idle_gaps"]
    assert gaps[0][1] == pytest.approx(0.94)
    assert gaps[0][0] == "benchmark_window > benchmark_call"


def test_union_merges_overlaps_and_clips():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.union(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert stats.busy(iv, 1.0, 3.5) == pytest.approx(1.5)
    assert stats.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]


def test_spread_is_the_quartile_distance_over_the_median():
    v = [1.0, 1.1, 0.9, 1.05, 0.95, 1.0]
    q1, _m, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / statistics.median(v))


def test_recording_plot_worker_keeps_every_job_and_runs_none():
    from benchlib.plotworker import RecordingPlotWorker

    ran = []
    w = RecordingPlotWorker()
    jobs = [lambda: ran.append(1), lambda: ran.append(2)]
    for j in jobs:
        w.submit(j, label="x")
    w.drain()
    assert w.jobs == jobs and ran == [] and w.drain_collect() == [] and w.timings_by_kind() == {}
    w.close()
