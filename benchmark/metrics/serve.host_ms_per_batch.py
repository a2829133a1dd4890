"""Host ms per batch in the service: the dispatched time minus the time
staging began (`StreamingEngine.timeline`), mean over every batch whose
staging began in the window."""


def read(rec):
    tl, bounds = rec.window.timeline, rec.window.window_bounds
    if not tl or bounds is None:
        return None
    w0, w1 = bounds
    spans = [d - s for s, _h, d, _r in tl if w0 <= s < w1]
    return 1e3 * sum(spans) / len(spans) if spans else None
