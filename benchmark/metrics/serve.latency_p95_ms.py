"""95th percentile of the service's frame latencies, over the frames that
`serve.latency_p50_ms` takes; a failed frame lies above it."""

from benchmark.harness.stats import percentile


def read(rec):
    lat = rec.window.latencies_ms
    if lat and rec.trace is not None:
        lat = lat[:int(len(lat) * float(rec.traffic["trace_at"]))]
    return percentile(lat, 95) if lat else None
