"""The share of the time the service's one dispatcher thread works: 1 -
(time blocked waiting for frames + time blocked on done events) / the
stretch, from the first to the last staging of the batches
`service_batches` takes. Each record holds what the dispatcher spent
blocked since the batch before, so the records after the first cover the
stretch exactly. Near 1 the dispatcher is the service's limit."""

from benchmark.harness.spans import service_batches


def read(rec):
    b = service_batches(rec)
    if not b or len(b) < 2:
        return None
    stretch = b[-1]["staging_began"] - b[0]["staging_began"]
    blocked = sum(x["blocked_frames_s"] + x["blocked_done_s"] for x in b[1:])
    return 1.0 - blocked / stretch if stretch > 0 else None
