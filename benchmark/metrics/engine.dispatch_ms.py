"""Host ms from one call into the step to its return, on an idle device
(synchronised just before): the benchmark's own span, mean over the traced
stretch's probe steps."""


def read(rec):
    t = rec.trace
    spans = t.get("dispatch_ms") if t else None
    return sum(spans) / len(spans) if spans else None
