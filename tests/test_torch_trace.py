"""The port's span and counter recorder (utils/timer.py) on the CPU: off by
default (no span recorded, no span object made), spans kept from several
threads with their nesting, a torch.profiler session turning tracing on
and seeing the program's ranges, the offset that puts spans on the
profiler's clock, the service's one record per batch, the counters of the
ingest, the prepared operands and the launches, the exported Chrome trace
with the dispatcher's row, and the per-layer table of
`Engine.time_report()`. Every test leaves tracing off and the recorder
empty."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import shadernn_tpu_torch as P
from shadernn_tpu_torch.engine.streaming import BatchTrace, Frame, StreamingEngine
from shadernn_tpu_torch.image.ingest import ingest_frames
from shadernn_tpu_torch.kernels import KERNELS, count_launch, launch_counts
from shadernn_tpu_torch.utils import timer
from shadernn_tpu_torch.utils.profiler import export_chrome_trace
from shadernn_tpu_torch.utils.trace_profile import (
    HAND_WRITTEN, TraceOp, TraceReport, complete, launches_per_step,
)

STOP_S = 60.0


@pytest.fixture(autouse=True)
def clean_recorder():
    timer.disable()
    timer.reset()
    try:
        yield
    finally:
        timer.disable()
        timer.reset()


def cpu_engine(name, batch=1, **kw):
    return P.Engine.from_graph(P.build_model(name, **kw),
                               P.EngineOptions(batch_size=batch, device="cpu"))


def serve(svc, frames):
    got = {}
    svc.on_result = lambda r: got.__setitem__(r.frame_id, r)
    for sid, fid, data in frames:
        svc.queue.put(Frame(sid, fid, data))
    try:
        svc.start()
    finally:
        svc.stop(drain=True, timeout=STOP_S)
    return got


def uint8_frames(n, h=16, w=24, seed=0):
    rng = np.random.default_rng(seed)
    return [(0, i, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)) for i in range(n)]


def test_tracing_is_off_by_default_and_makes_no_span(monkeypatch):
    made = []
    orig = timer._Span.__init__

    def counting(self, *a, **k):
        made.append(a)
        orig(self, *a, **k)

    monkeypatch.setattr(timer._Span, "__init__", counting)
    assert not timer.tracing()
    eng = cpu_engine("espcn", batch=2, h=16, w=24)
    eng.run({"input": np.random.rand(2, 16, 24, 1).astype("float32")})
    svc = StreamingEngine(eng, ingest={"means": (0.0,), "norms": (1 / 255.0,)})
    got = serve(svc, uint8_frames(3))
    assert sorted(got) == [0, 1, 2]
    assert made == [] and timer.snapshot()["spans"] == []
    assert len(svc.stats()["trace"]) == 2  # the service's records are always kept


def test_spans_from_two_threads_nest_and_are_kept():
    timer.enable()
    go = threading.Barrier(2)

    def work(tag):
        go.wait(timeout=10)
        with timer.span("outer", tag=tag):
            with timer.span("inner", tag=tag):
                time.sleep(0.002)
            with timer.span("inner", tag=tag):
                pass

    threads = [threading.Thread(target=work, args=(t,), name=f"worker-{t}") for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    snap = timer.snapshot()
    assert len(snap["spans"]) == 6
    by_tag = {}
    for s in snap["spans"]:
        by_tag.setdefault(s["attrs"]["tag"], []).append(s)
    assert by_tag.keys() == {"a", "b"}
    tids = set()
    for tag, spans in by_tag.items():
        (outer,) = [s for s in spans if s["name"] == "outer"]
        inner = [s for s in spans if s["name"] == "inner"]
        assert outer["depth"] == 0 and [s["depth"] for s in inner] == [1, 1]
        assert len({s["thread"] for s in spans}) == 1
        for s in inner:
            assert outer["start_ns"] <= s["start_ns"] <= s["end_ns"] <= outer["end_ns"]
        tids.add(outer["thread"])
        assert snap["threads"][outer["thread"]] == f"worker-{tag}"
    assert len(tids) == 2


def test_a_thread_after_a_finished_one_keeps_its_own_name():
    """Thread idents are reused once a thread ends; a span's row still
    names the thread that recorded it."""
    timer.enable()
    for name in ("first", "second", "third"):
        t = threading.Thread(target=lambda: timer.record("s", 1, 2), name=name)
        t.start()
        t.join(10)
        assert not t.is_alive()
    snap = timer.snapshot()
    assert [snap["threads"][s["thread"]] for s in snap["spans"]] == ["first", "second", "third"]


def test_a_profiler_session_turns_tracing_on_and_sees_the_layers():
    eng = cpu_engine("styletransfer", batch=1, h=32, w=32)
    x = {"input": np.random.rand(1, 32, 32, 3).astype("float32")}
    eng.run(x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert timer.tracing()
        eng.run(x)
    assert not timer.tracing()
    host = [e.name for e in prof.events()]
    assert "snn.layer" in host and "snn.step" in host
    spans = timer.snapshot()["spans"]
    layers = [s for s in spans if s["name"] == "snn.layer"]
    assert {s["attrs"]["path"] for s in layers} == {"single", "torch"}
    assert {s["attrs"]["node"] for s in layers} <= set(eng.graph.nodes)
    (step,) = [s for s in spans if s["name"] == "snn.step"]
    assert all(step["start_ns"] <= s["start_ns"] and s["end_ns"] <= step["end_ns"]
               and s["depth"] == 1 for s in layers)


def test_the_offset_puts_a_span_around_the_profilers_range(tmp_path):
    """After the offset, a span around a record_function range contains the
    profiler's stamps of that range in the exported trace."""
    timer.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with timer.span("snn.check"):
                time.sleep(0.002)
                with record_function("snn.probe"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
                time.sleep(0.002)
    snap = timer.snapshot()
    assert abs(snap["offset_ns"] - snap["offset_at_enable_ns"]) < 1_000_000
    path = export_chrome_trace(prof, str(tmp_path / "t.json"), snap)
    events = json.loads(open(path).read())["traceEvents"]
    probes = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("name") == "snn.probe" and e.get("cat") == "user_annotation")
    checks = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("name") == "snn.check" and e.get("pid") == "snn spans")
    assert len(probes) == len(checks) == 3
    for (p0, p1), (c0, c1) in zip(probes, checks):
        assert c0 <= p0 and p1 <= c1


def test_the_service_keeps_one_ordered_record_per_batch():
    eng = cpu_engine("espcn", batch=4, h=16, w=24)
    svc = StreamingEngine(eng, ingest={"means": (0.0,), "norms": (1 / 255.0,)})
    got = serve(svc, uint8_frames(6))
    assert sorted(got) == list(range(6))
    st = svc.stats()
    recs = st["trace"]
    assert len(recs) == st["batches_run"] == 2
    assert [r["frames"] for r in recs] == [4, 2]
    stamps = BatchTrace._fields[:11]
    for r in recs:
        assert all(r[a] <= r[b] for a, b in zip(stamps, stamps[1:])), r
        assert 0 <= r["queue_wait_max_s"] <= r["queue_wait_sum_s"]
        assert r["blocked_frames_s"] >= 0 and r["blocked_done_s"] >= 0
        stage = r["staged"] - r["staging_began"]
        enqueue = r["step_queued"] - r["upload_queued"]
        assert stage + enqueue <= r["dispatched"] - r["staging_began"]
    assert svc.timeline == [(r["staging_began"], r["staged"], r["dispatched"], r["drained"])
                            for r in recs]
    assert st["mean_fetch_ms"] == pytest.approx(
        1e3 * np.mean([r["drained"] - r["done_wait_began"] for r in recs]))


def test_a_frames_queue_wait_runs_from_submit():
    eng = cpu_engine("espcn", batch=2, h=16, w=24)
    svc = StreamingEngine(eng, batch_window_s=0.0)
    svc.on_result = lambda r: None
    svc.submit(0, 0, uint8_frames(1)[0][2].astype("float32"))
    time.sleep(0.05)  # the first frame waits in the queue before the service starts
    try:
        svc.start()
    finally:
        svc.stop(drain=True, timeout=STOP_S)
    (rec,) = svc.stats()["trace"]
    assert rec["frames"] == 1 and rec["queue_wait_max_s"] >= 0.05


def test_the_ingest_counts_two_constants_a_call():
    raw = torch.randint(0, 256, (2, 8, 8, 3), dtype=torch.uint8)
    for _ in range(3):
        ingest_frames(raw, means=(0.5,), norms=(1 / 255.0,))
    assert timer.snapshot()["counters"]["ingest.consts"] == 6


def test_operands_are_prepared_once():
    eng = cpu_engine("styletransfer", batch=1, h=32, w=32)
    x = {"input": np.random.rand(1, 32, 32, 3).astype("float32")}
    eng.run(x)
    first = timer.snapshot()["counters"].get("engine.operand_prepares", 0)
    assert first > 0
    timer.reset()
    eng.run(x)
    eng.run(x)
    assert timer.snapshot()["counters"].get("engine.operand_prepares", 0) == 0


def test_the_exported_trace_has_a_row_for_the_dispatcher(tmp_path):
    """The dispatcher thread starts before the profiler, which records none
    of its host ops; the exported trace holds its spans as a row."""
    eng = cpu_engine("espcn", batch=2, h=16, w=24)
    svc = StreamingEngine(eng, on_result=lambda r: None,
                          ingest={"means": (0.0,), "norms": (1 / 255.0,)})
    svc.start()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _, i, data in uint8_frames(8):
                svc.submit(0, i, data)
                time.sleep(0.004)
            time.sleep(0.05)
    finally:
        svc.stop(drain=True, timeout=STOP_S)
    path = export_chrome_trace(prof, str(tmp_path / "serve.json"))
    events = json.loads(open(path).read())["traceEvents"]
    rows = {e["tid"]: e["args"]["name"] for e in events
            if e.get("pid") == "snn spans" and e.get("name") == "thread_name"}
    (tid,) = [t for t, name in rows.items() if name == "snn-dispatch"]
    names = {e["name"] for e in events if e.get("pid") == "snn spans" and e.get("tid") == tid
             and e.get("ph") == "X"}
    assert {"snn.serve.wait_frames", "snn.serve.stage", "snn.serve.step_enqueue",
            "snn.serve.fetch_enqueue", "snn.serve.wait_done", "snn.serve.route",
            "snn.step", "snn.ingest", "snn.layer"} <= names
    # the profiler's own host rows hold none of the dispatcher's ops
    assert not any(e.get("tid") == tid and e.get("cat") == "cpu_op" for e in events)


def test_time_report_has_a_row_per_layer_and_the_counters():
    eng = cpu_engine("espcn", batch=1, h=16, w=24)
    x = {"input": np.random.rand(1, 16, 24, 1).astype("float32")}
    timer.enable()
    for _ in range(eng.options.warmup_loops + 2):
        eng.run(x)
    report = eng.time_report()
    heads = list(eng.model.forward.chain_plan)
    assert heads and all(f"[{h}" in report for h in heads)
    assert "n 2" in report and "counters: engine.operand_prepares" in report


def test_storage_is_bounded():
    rec = timer.Recorder(capacity=3)
    for i in range(5):
        rec.record("s", i, i + 1)
    snap = rec.snapshot()
    assert [s["start_ns"] for s in snap["spans"]] == [2, 3, 4] and snap["dropped"] == 2


def test_counters_lose_no_update_across_threads():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        rec = timer.Recorder()
        threads = [threading.Thread(target=lambda: [rec.count("c") for _ in range(5000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert rec.counters()["c"] == 16 * 5000


def test_a_profile_missing_a_counted_launch_is_incomplete():
    packed = "kernels.launches.conv_chain_tc_kernel.fused_conv_chain_packed"
    plain = "kernels.launches.conv_chain_tc_kernel.fused_conv_chain"
    before = {packed: 3, "ingest.consts": 1}
    after = {packed: 5, plain: 2, "ingest.consts": 9}
    launches = launches_per_step(before, after, 4)
    assert launches == {"conv_chain_tc_kernel": 1.0}
    ops = [TraceOp("conv_chain_tc_kernel", "hand-written", 880.0, 1.0)]
    assert complete(TraceReport(880.0, ops, 4, launches=launches))
    # a whole number of events a step, but fewer than the program launched
    assert not complete(TraceReport(880.0, ops, 4, launches={"conv_chain_tc_kernel": 2.0}))
    assert not complete(TraceReport(0.0, [], 4, launches=launches))


def test_the_kernel_table_names_every_kernel_of_the_sources():
    """`KERNELS`, from which the launch counters and `HAND_WRITTEN` are
    named, holds exactly the `__global__` kernels of csrc/*.cu."""
    import pathlib
    import re

    csrc = pathlib.Path(P.__file__).parent / "csrc"
    declared = {m for f in csrc.glob("*.cu")
                for m in re.findall(r"__global__[^;{]*?\b(\w+_kernel)\s*\(", f.read_text())}
    named = {k for ks in KERNELS.values() for k in ks}
    assert declared == named and len(named) == 10
    for k in named:
        assert HAND_WRITTEN.search(f"void {k}<8, 2>(float const*)").group(0) == k
    assert not HAND_WRITTEN.search("void conv_chain_kernel(float const*)")


@pytest.mark.parametrize("entry", sorted(KERNELS))
def test_a_counted_launch_reads_by_entry_and_by_kernel(entry):
    forms = KERNELS[entry]
    before = timer.counters()
    for form in range(len(forms)):
        for _ in range(form + 1):
            count_launch(entry, form)
    after = timer.counters()
    by_entry = launch_counts("entry", after)
    assert set(by_entry) == set(KERNELS)
    assert by_entry[entry] == len(forms) * (len(forms) + 1) // 2
    assert all(n == 0 for e, n in by_entry.items() if e != entry)
    assert launches_per_step(before, after, 1) == {k: float(i + 1) for i, k in enumerate(forms)}
    with pytest.raises(KeyError):
        count_launch(entry, len(forms))


def test_trace_check_rehearses_every_phase_on_the_cpu(tmp_path, capsys):
    from shadernn_tpu_torch.tools import trace_check

    assert trace_check.main(["--device", "cpu", "--out", str(tmp_path), "--calls", "2"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    kinds = [x["kind"] for x in lines]
    # no device events on the CPU: that phase emits nothing there
    assert kinds == ["margins"] + ["cost"] * 4 + ["launches"] * 6 + ["serve_capture", "counters"]
    by = {x["kind"]: x for x in lines}
    assert by["margins"]["pairs"] == 20 and by["margins"]["contained"]
    for x in lines[5:11]:  # no kernel runs on the CPU, so none is counted or traced
        assert x["counted_per_step"] == {} and x["complete"]
        assert x["counters_per_step"] == {"ingest.consts": 2.0}
    serve = by["serve_capture"]
    assert serve["batches"] > 0 and serve["stage_plus_enqueue_within_dispatch"] == serve["batches"]
    assert by["counters"]["batches"] > 0 and by["counters"]["per_batch"]["ingest.consts"] == 2.0
    assert (tmp_path / "serve_trace.json").is_file()
