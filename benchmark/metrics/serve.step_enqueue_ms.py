"""The service's mean host ms per batch queuing the step (the ingest and
the model's launches on the compute stream: upload queued to step
queued), over the batches `service_batches` takes."""

from benchmark.harness.spans import service_batches


def read(rec):
    b = service_batches(rec)
    return 1e3 * sum(x["step_queued"] - x["upload_queued"] for x in b) / len(b) if b else None
