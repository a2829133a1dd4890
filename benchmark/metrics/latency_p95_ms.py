"""95th percentile of the latencies of every frame of the window, timed as
for `latency_p50_ms`; a failed frame lies above it."""

from benchmark.harness.stats import percentile


def read(rec):
    lat = rec.window.latencies_ms
    return percentile(lat, 95) if lat else None
