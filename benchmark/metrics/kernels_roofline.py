"""The least time of the step's work (benchmark/harness/cost.py) over the
device busy time per step in the profiled stretch, in percent: all of the
step's kernels taken together."""


def read(rec):
    t = rec.trace
    if not t or not t["steps"] or t["busy_s"] <= 0:
        return None
    return 100.0 * rec.least_time_s / (t["busy_s"] / t["steps"])
