"""The service's mean blocking wait for a batch's outputs
(`StreamingEngine.stats()["mean_fetch_ms"]`)."""


def read(rec):
    st = rec.window.service_stats
    return st["mean_fetch_ms"] if st and st.get("batches_run") else None
