"""The step's model operations over (host seconds per step outside the
traced stretch x the peak at the configuration's precision), in percent."""


def read(rec):
    if rec.trace is None or not rec.window.steps:
        return None
    return 100.0 * rec.cost["ops"] / (rec.window.step_s * rec.peak_ops)
