"""The service's mean queue wait per frame: from `submit()` to the
dispatcher taking the frame off the queue (blocking on a full queue
included), over the frames of the batches `service_batches` takes."""

from benchmark.harness.spans import service_batches


def read(rec):
    b = service_batches(rec)
    frames = sum(x["frames"] for x in b) if b else 0
    return 1e3 * sum(x["queue_wait_sum_s"] for x in b) / frames if frames else None
