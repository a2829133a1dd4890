"""Statistics over every sample of a window."""

import math
import statistics

import pytest

from benchmark.harness import stats


def test_percentile_is_nearest_rank_over_all_samples():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 50) == 50
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 4, 2, 3], 50) == 3


def test_a_failed_sample_lies_above_every_percentile_it_reaches():
    xs = [1.0] * 94 + [math.inf] * 6
    assert stats.percentile(xs, 50) == 1.0
    assert stats.percentile(xs, 95) == math.inf


def test_rate_and_spread():
    assert stats.rate(300, 2.0) == 150.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    vals = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / med)


def test_idle_share_is_read_against_the_untraced_steps():
    import types

    from benchmark.harness import spec

    read = spec.reader("device.idle_share.offline")
    window = types.SimpleNamespace(steps=1000, step_s=1.0e-3)
    traced = {"steps": 10, "busy_s": 6.0e-3, "window_s": 11.0e-3}
    rec = types.SimpleNamespace(trace=traced, window=window)
    assert read(rec) == pytest.approx(0.4)  # not 1 - 6 / 11 over the traced stretch
    # a profiler that slows the device reads below 0, as measured
    rec.trace = dict(traced, busy_s=10.2e-3)
    assert read(rec) == pytest.approx(-0.02)
    rec.trace = None
    assert read(rec) is None
