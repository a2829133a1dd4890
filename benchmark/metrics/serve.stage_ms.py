"""The service's mean host ms per batch stacking its frames into pinned
host memory (staging began to staged), over the batches `service_batches`
takes."""

from benchmark.harness.spans import service_batches


def read(rec):
    b = service_batches(rec)
    return 1e3 * sum(x["staged"] - x["staging_began"] for x in b) / len(b) if b else None
