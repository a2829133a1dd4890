"""The per-layer metrics that read the service's own batch records
(`harness/spans.py`, `metrics/serve.queue_wait_ms.py`, `serve.stage_ms.py`,
`serve.step_enqueue_ms.py`, `serve.dispatcher_busy_share.py`): listed in
their cell, a number in a traced CPU run of it, and nothing (not an error)
where the service keeps no records."""

import json
import math
import os
import types

import pytest

from conftest import ROOT, run_tiny, tiny_cell

NEW = ["serve.queue_wait_ms", "serve.stage_ms", "serve.step_enqueue_ms",
       "serve.dispatcher_busy_share"]
SERVE = "espcn-540p-serve"
CELLS = ["espcn-540p-b8", "styletransfer-candy-512-b4", "espcn-540p-b1", SERVE]


def test_the_new_metrics_are_appended_entries_with_readers():
    from benchmark.harness import spec

    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    tail = bench["per_layer"][-len(NEW):]
    assert [m["name"] for m in tail] == NEW
    for m in tail:
        assert m["workloads"] == [SERVE] and m["layer"] == "serve"
        assert m["source"] == "program_span" and m["better"] == "lower"
        assert callable(spec.reader(m["name"]))
    for cell in CELLS:
        names = {m["name"] for m in spec.load_cell(cell).per_layer}
        assert (set(NEW) <= names) == (cell == SERVE)


def test_a_traced_served_run_reads_every_new_metric():
    traced = run_tiny(tiny_cell(SERVE), trace=True)
    assert traced["correct"]
    got = {n: traced["metrics"][n]["value"] for n in NEW if n in traced["metrics"]}
    assert list(got) == NEW
    assert all(math.isfinite(v) and v >= 0 for v in got.values()), got
    assert 0 < got["serve.dispatcher_busy_share"] <= 1
    plain = run_tiny(tiny_cell(SERVE))
    assert not set(NEW) & set(plain["metrics"])  # per-layer metrics: traced runs only


@pytest.mark.parametrize("name", NEW)
def test_a_service_without_records_gives_nothing(name):
    from benchmark.harness import spec

    window = types.SimpleNamespace(t_start=0.0, window_s=1.0, window_bounds=(0.0, 1.0),
                                   service_stats={"frames_done": 1, "batches_run": 1})
    rec = types.SimpleNamespace(window=window, trace={}, traffic={"trace_at": 0.5})
    assert spec.reader(name)(rec) is None
