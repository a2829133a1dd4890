"""Median of the service's frame latencies, from each frame's due time to
its result on the host; a failed frame lies above it. Over every frame due
in the window; in a traced run over those due before the profiled stretch
(`trace_at` of the window), since the profiler's start and stop hold up
the generator for some hundreds of ms."""

from benchmark.harness.stats import percentile


def read(rec):
    lat = rec.window.latencies_ms
    if lat and rec.trace is not None:
        lat = lat[:int(len(lat) * float(rec.traffic["trace_at"]))]
    return percentile(lat, 50) if lat else None
