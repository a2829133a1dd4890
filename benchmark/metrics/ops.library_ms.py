"""Device ms per step of every event that is not a hand-written kernel:
cuDNN, cuBLAS, ATen (the ingest among them), copies and fills."""


def read(rec):
    t = rec.trace
    if not t or not t["steps"]:
        return None
    us = sum(r["us"] for r in t["rows"].values() if r["category"] != "hand-written")
    return us / t["steps"] / 1e3
