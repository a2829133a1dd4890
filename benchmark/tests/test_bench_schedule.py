"""The traffic generator: the open loop's schedule and the seeded frames."""

import numpy as np
import torch

from benchmark.harness import traffic


def test_open_loop_rate_phases_and_order():
    s = traffic.schedule(12345678901, streams=70, fps=30.0, horizon_s=10.0, phase="random")
    due = s["due"]
    assert np.all(np.diff(due) >= 0)
    assert due.min() >= 0 and due.max() < 10.0
    assert abs(len(due) - 70 * 30 * 10) <= 70  # one frame per stream at most at the edge
    for k in range(70):
        mine = due[s["stream"] == k]
        assert 0 <= mine[0] < 1 / 30
        assert np.allclose(np.diff(mine), 1 / 30)
        assert np.array_equal(s["frame"][s["stream"] == k], np.arange(len(mine)))


def test_schedule_is_the_seeds():
    a = traffic.schedule(2**31 + 5, 8, 30.0, 2.0, "random")
    b = traffic.schedule(2**31 + 5, 8, 30.0, 2.0, "random")
    c = traffic.schedule(2**31 + 6, 8, 30.0, 2.0, "random")
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["due"], c["due"])
    aligned = traffic.schedule(1, 8, 30.0, 1.0, "aligned")
    assert np.allclose(aligned["due"][:8], 0.0)


def test_frames_are_the_seeds():
    a = traffic.device_frames(4000000001, 3, 4, 5, 1, "cpu")
    b = traffic.device_frames(4000000001, 3, 4, 5, 1, "cpu")
    assert a.dtype == torch.uint8 and torch.equal(a, b)
    assert not torch.equal(a, traffic.device_frames(4000000002, 3, 4, 5, 1, "cpu"))
    assert np.array_equal(traffic.host_frames(9, 2, 3, 3, 1), traffic.host_frames(9, 2, 3, 3, 1))
