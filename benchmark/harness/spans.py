"""What the per-layer metrics of the service's own records read:
`StreamingEngine.stats()["trace"]`, one record per batch, kept whether or
not tracing is on. A service that keeps no records gives nothing to read
(None)."""

from __future__ import annotations

from typing import List, Optional


def service_batches(rec) -> Optional[List[dict]]:
    """The service's batch records whose staging began in the window, in a
    traced run before the profiled stretch (`trace_at` of the window, as
    `serve.latency_*` take their frames); None where the service keeps no
    records."""
    st, bounds = rec.window.service_stats, rec.window.window_bounds
    if not st or "trace" not in st or bounds is None:
        return None
    w0, w1 = bounds
    if rec.trace is not None:
        w1 = w0 + (w1 - w0) * float(rec.traffic["trace_at"])
    return sorted((b for b in st["trace"] if w0 <= b["staging_began"] < w1),
                  key=lambda b: b["staging_began"])
