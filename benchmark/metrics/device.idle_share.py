"""The device's idle share of the window's untraced steps: 1 - (device busy
per step in the profiled stretch / host seconds per step outside it), as
measured. Under the profiler (CUPTI) the device's work runs a little
longer than in the untraced steps, so a device-bound cell can read below
0: that is the profiler's cost, not idle time."""


def read(rec):
    t, w = rec.trace, rec.window
    if not t or not t["steps"] or t["busy_s"] <= 0 or not w.steps:
        return None
    return 1.0 - (t["busy_s"] / t["steps"]) / w.step_s
