"""Median latency of every frame of the window; a failed frame lies above
it. The traffic's generator times each frame: an open loop from its due
time to its result on the host (host clock), one frame in flight by CUDA
events (the device's own timestamps) from the call to the output on the
device."""

from benchmark.harness.stats import percentile


def read(rec):
    lat = rec.window.latencies_ms
    return percentile(lat, 50) if lat else None
