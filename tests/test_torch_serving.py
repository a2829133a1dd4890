"""The port's serving layer on the CPU, against the JAX package: the
continuous-batching StreamingEngine (engine/streaming.py), the exported
engine (engine/deploy.py), the InferenceProcessor, Engine.classify /
device_benchmark / trace_benchmark, run_model(image_path=), the per-layer
profiler and the profile parser. Engines take EngineOptions(device="cpu");
each test that starts a service stops it in `finally`, and stop() has a
time limit. Tolerances: the port's own engine exactly (same program on the
same inputs) or to 1e-4 where a batch differs; the JAX engine at the suite's
thresholds (0.01 fp32, 0.1 bf16, times max(1, max|ref|)); YOLO detections
box to box (utils/metrics.py detections_agree)."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import shadernn_tpu as J
from shadernn_tpu.engine.deploy import export_engine as j_export
from shadernn_tpu.engine.processor import InferenceProcessor as JProcessor
from shadernn_tpu.engine.processor import InitializationParameters as JParams
from shadernn_tpu.engine.streaming import StreamingEngine as JStreaming
from shadernn_tpu.models import build_model as jbuild
from shadernn_tpu.models.runners import run_model as j_run_model

import shadernn_tpu_torch as P
from shadernn_tpu_torch.engine.deploy import ExportedEngine, export_engine
from shadernn_tpu_torch.engine.processor import InferenceProcessor, InitializationParameters
from shadernn_tpu_torch.engine.streaming import StreamingEngine
from shadernn_tpu_torch.image.color import ColorFormat
from shadernn_tpu_torch.image.image import Image
from shadernn_tpu_torch.models import zoo
from shadernn_tpu_torch.models.runners import run_model
from shadernn_tpu_torch.ops.yolo import YOLOV3_TINY_MASKS
from shadernn_tpu_torch.utils.metrics import (
    detections_agree, mean_average_precision, top1_accuracy, topk_accuracy,
)

TOL = {"fp32": 0.01, "bf16": 0.1}  # tests/conftest.py thresholds
STOP_S = 60.0  # every stop() in this file: a hung dispatcher fails, it does not hang


def close(got, want, prec):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL[prec] * max(1.0, float(np.abs(want).max())), err


def cpu_engine(name, prec="fp32", batch=1, **kw):
    return P.Engine.from_graph(P.build_model(name, **kw), P.EngineOptions(
        precision=getattr(P.Precision, prec.upper()), batch_size=batch, device="cpu"))


def serve(svc, frames, prefill=False):
    """Submit (stream, frame id, data) triples and stop with a drain; the
    results by frame id."""
    got = {}
    if svc.on_result is None:
        svc.on_result = lambda r: got.__setitem__(r.frame_id, r)
    try:
        if not prefill:
            svc.start()
        for sid, fid, data in frames:
            svc.submit(sid, fid, data)
        if prefill:
            svc.start()
    finally:
        svc.stop(drain=True, timeout=STOP_S)
    return got


# --- StreamingEngine: the JAX package's three streaming tests -------------------


def test_streaming_continuous_batching(rng):
    """Multi-stream frames through the batcher match single-shot results,
    the port's and the JAX engine's."""
    eng = cpu_engine("espcn", batch=4, h=16, w=24)
    je = J.Engine.from_graph(jbuild("espcn", h=16, w=24), J.EngineOptions(batch_size=4))
    frames = [rng.random((16, 24, 1), dtype=np.float32) for _ in range(10)]
    want = [eng.run_single(f[None])[0].numpy() for f in frames]
    svc = StreamingEngine(eng)
    got = serve(svc, [(i % 3, i, f) for i, f in enumerate(frames)])
    assert sorted(got) == list(range(10))
    out = eng.graph.output_names[0]
    for i, f in enumerate(frames):
        np.testing.assert_allclose(got[i].outputs[out], want[i], atol=1e-4)
        close(got[i].outputs[out], np.asarray(je.run_single(f[None]))[0], "fp32")
        assert isinstance(got[i].outputs[out], np.ndarray)
    stats = svc.stats()
    assert stats["frames_done"] == 10
    assert stats["batches_run"] <= 10  # batching actually happened


def test_streaming_stats_keys_match_jax(rng):
    """stats() has the JAX service's keys; a partial batch is padded and
    counted."""
    eng = cpu_engine("espcn", batch=4, h=16, w=24)
    frames = [(0, i, rng.random((16, 24, 1), dtype=np.float32)) for i in range(6)]
    svc = StreamingEngine(eng)
    got = serve(svc, frames, prefill=True)
    assert sorted(got) == list(range(6))
    st = svc.stats()
    jsvc = JStreaming(J.Engine.from_graph(jbuild("espcn", h=16, w=24),
                                          J.EngineOptions(batch_size=4)))
    jsvc.queue.close()
    jsvc.start()
    jsvc.stop(drain=True)
    # the JAX service's keys, and the port's per-batch records ("trace")
    want_keys = set(jsvc.stats()) | {"p50_latency_ms", "p99_latency_ms", "trace"}
    assert set(st) == want_keys
    assert st["frames_done"] == 6 and st["batches_run"] == 2 and st["padded_frames"] == 2
    assert st["avg_fill"] == 3.0 and st["throughput_fps"] > 0
    assert st["p99_latency_ms"] >= st["p50_latency_ms"] > 0
    assert len(svc.timeline) == 2 and all(s <= h <= d <= r for s, h, d, r in svc.timeline)


def test_streaming_dispatch_overlaps_fetch():
    """The dispatcher runs ahead of the drain: batch N+1 is dispatched while
    batch N is still executing. A stub engine whose batches are done 30 ms
    after the emulated device reaches them (a serial device, in dispatch
    order): with max_inflight=4 batch 5 must be dispatched before batch 2
    drained. The in-flight record's done marker comes from _mark_ready,
    which the stub overrides."""
    dispatch_times, drain_times = [], []

    class SlowReady:
        device_free = 0.0  # when the emulated device finishes queued work

        def __init__(self):
            start = max(time.monotonic(), SlowReady.device_free)
            self.ready_at = start + 0.03
            SlowReady.device_free = self.ready_at

        def query(self):
            return time.monotonic() >= self.ready_at

        def synchronize(self):
            rem = self.ready_at - time.monotonic()
            if rem > 0:
                time.sleep(rem)

    class SlowStreaming(StreamingEngine):
        def _mark_ready(self):
            return SlowReady()

    class StubModel:
        def __call__(self, inputs):
            dispatch_times.append(time.monotonic())
            return {"out": inputs["input"]}

    class StubEngine:
        class options:
            batch_size = 1

        class graph:
            input_names = ["input"]

        model = StubModel()

    svc = SlowStreaming(StubEngine(), max_inflight=4,
                        on_result=lambda r: drain_times.append(time.monotonic()))
    serve(svc, [(0, i, np.zeros((4, 4, 1), np.float32)) for i in range(6)])
    assert len(dispatch_times) == 6 and len(drain_times) == 6
    assert dispatch_times[5] < drain_times[2], (
        f"dispatch {[round(t - dispatch_times[0], 3) for t in dispatch_times]}, "
        f"drain {[round(t - dispatch_times[0], 3) for t in drain_times]}")
    assert svc.stats()["frames_done"] == 6


class _Echo:
    """A stub engine on the CPU: its step returns the input."""

    def __init__(self, batch=4, step=None):
        self.options = type("O", (), {"batch_size": batch})()
        self.graph = type("G", (), {"input_names": ["input"]})()
        self.model = step or (lambda inputs: {"out": inputs["input"]})


def test_streaming_prefilled_and_double_closed_queue():
    """A queue pre-filled and closed, then closed again by stop(drain=True),
    yields every frame exactly once, for several in-flight settings."""
    for inflight in (1, 2, 4):
        got = []
        svc = StreamingEngine(_Echo(), max_inflight=inflight,
                              on_result=lambda r: got.append(r.frame_id))
        for i in range(10):  # 2 full batches + one partial
            svc.submit(0, i, np.full((2, 2, 1), i, np.float32))
        svc.queue.close()
        try:
            svc.start()
        finally:
            svc.stop(drain=True, timeout=STOP_S)
        assert sorted(got) == list(range(10)), (inflight, got)
        assert svc.stats()["frames_done"] == 10


def test_streaming_outputs_route_to_their_frames():
    """Every frame's result is its own row of the batch, partial batches
    padded with the last frame, through two multi-input batches."""
    got = serve(StreamingEngine(_Echo(batch=3)),
                [(i % 2, i, np.full((2, 2, 1), i, np.float32)) for i in range(7)], prefill=True)
    for i in range(7):
        assert got[i].stream_id == i % 2 and np.all(got[i].outputs["out"] == i)
        assert got[i].batch_fill == (1 if i == 6 else 3)


def test_streaming_dispatcher_failure_raises():
    """An error in the dispatcher is re-raised by stop() (and by submit once
    it has happened); a dispatcher that does not end makes stop() raise
    after its time limit."""
    def broken(inputs):
        raise ValueError("launch failed")

    svc = StreamingEngine(_Echo(batch=1, step=broken))
    svc.start()
    svc.submit(0, 0, np.zeros((2, 2, 1), np.float32))
    t0 = time.monotonic()
    while svc._thread.is_alive() and time.monotonic() - t0 < STOP_S:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="launch failed|dispatcher failed") as e:
        svc.submit(0, 1, np.zeros((2, 2, 1), np.float32))
    assert isinstance(e.value.__cause__, ValueError)
    with pytest.raises(RuntimeError, match="dispatcher failed") as e:
        svc.stop(timeout=STOP_S)
    assert isinstance(e.value.__cause__, ValueError)

    release = threading.Event()

    def stuck(inputs):
        release.wait(STOP_S)
        return {"out": inputs["input"]}

    svc = StreamingEngine(_Echo(batch=1, step=stuck))
    svc.start()
    svc.submit(0, 0, np.zeros((2, 2, 1), np.float32))
    try:
        with pytest.raises(RuntimeError, match="did not stop within"):
            svc.stop(timeout=0.3)
    finally:
        release.set()
        svc._thread.join(STOP_S)
        assert not svc._thread.is_alive()


def test_serving_entry_points_need_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")

    class OnCard(_Echo):
        def __init__(self):
            super().__init__()
            self.model = type("M", (), {"device": torch.device("cuda")})()

    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingEngine(OnCard())
    eng = cpu_engine("espcn", h=16, w=24)
    path = export_engine(eng, str(tmp_path / "e"))
    with pytest.raises(RuntimeError, match="cuda"):
        ExportedEngine(path)
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceProcessor().initialize(InitializationParameters(),
                                        graph=P.build_model("espcn", h=16, w=24))


# --- ingest and multi-input streaming against the JAX service -------------------


def _jax_serve(eng, frames, **kw):
    got = {}
    svc = JStreaming(eng, on_result=lambda r: got.__setitem__(r.frame_id, r), **kw)
    for sid, fid, data in frames:
        svc.submit(sid, fid, data)
    svc.queue.close()
    svc.start()
    svc.stop(drain=True)
    return got


def test_streaming_raw_uint8_ingest_matches_jax(rng):
    """Producers submit raw uint8 frames; they are normalized on the
    engine's device before the model. Each frame against the JAX service's
    and against the port engine run on the host-normalized frame."""
    eng = cpu_engine("espcn", batch=2, h=16, w=24)
    je = J.Engine.from_graph(jbuild("espcn", h=16, w=24), J.EngineOptions(batch_size=2))
    ingest = {"means": (0.0,), "norms": (1 / 255.0,)}
    frames = [(0, i, (rng.random((16, 24, 1)) * 255).astype(np.uint8)) for i in range(6)]
    got = serve(StreamingEngine(eng, ingest=ingest), frames, prefill=True)
    want = _jax_serve(je, frames, ingest=ingest)
    out = eng.graph.output_names[0]
    assert sorted(got) == sorted(want) == list(range(6))
    for i, (_, _, raw) in enumerate(frames):
        host = (raw.astype(np.float32) - 0.0) * np.float32(1 / 255.0)
        np.testing.assert_allclose(got[i].outputs[out], eng.run_single(host[None])[0].numpy(),
                                   atol=1e-4)
        np.testing.assert_allclose(got[i].outputs[out], want[i].outputs[out], atol=1e-4)


def test_streaming_two_input_yolo_head():
    """Frames whose data is {input name: array} stream through the
    two-input YOLOv3-tiny head (tests/test_yolo_stream.py's graph and
    frames: boxes encoded into the per-scale features): detections per
    frame equal to the JAX service's, mAP >= 0.95, and the partial batch of
    the first 10 frames padded."""
    from test_yolo_stream import NUM_CLASSES, _frames, _head_graph

    from shadernn_tpu_torch.graph.builder import GraphBuilder

    gts, heads = _frames()
    n = 10
    frames = [(0, i, {k: np.asarray(v) for k, v in heads[i].items()}) for i in range(n)]
    je = J.Engine.from_graph(_head_graph(), J.EngineOptions(batch_size=4))
    b = GraphBuilder("yolo_head")
    no = len(YOLOV3_TINY_MASKS[0]) * (5 + NUM_CLASSES)
    h1 = b.input(13, 13, no, name="head_32")
    h2 = b.input(26, 26, no, name="head_16", index=1)
    b.yolo([h1, h2], num_classes=NUM_CLASSES, net_hw=(416, 416), max_detections=20, name="yolo")
    eng = P.Engine.from_graph(b.build(), P.EngineOptions(batch_size=4, device="cpu"))
    svc = StreamingEngine(eng)
    got = serve(svc, frames, prefill=True)
    want = _jax_serve(je, frames)
    assert sorted(got) == list(range(n))
    dets = np.stack([got[i].outputs["yolo"] for i in range(n)])
    detections_agree(dets, np.stack([want[i].outputs["yolo"] for i in range(n)]), TOL["fp32"])
    assert mean_average_precision([d[d[:, 1] > 0] for d in dets], gts[:n], NUM_CLASSES) >= 0.95
    st = svc.stats()
    assert st["frames_done"] == n and st["padded_frames"] == 2


def test_detections_agree_nms_ties():
    """A box that one output keeps and the other suppresses is allowed only
    where its overlap with a higher-scored box of its class is within the
    tolerance of the NMS threshold."""
    ref = np.zeros((1, 6, 6), np.float32)
    ref[0, :2] = [[0, 0.9, 0.30, 0.30, 0.2, 0.2], [1, 0.8, 0.7, 0.7, 0.1, 0.1]]
    kept = ref.copy()
    kept[0, 2] = [0, 0.6, 0.37, 0.30, 0.2, 0.2]  # IoU 0.48 with the 0.9 box
    with pytest.raises(AssertionError):
        detections_agree(kept, ref, 0.1)
    assert detections_agree(kept, ref, 0.1, nms_iou=0.45)["nms_ties"] == 1
    with pytest.raises(AssertionError):
        detections_agree(kept, ref, 0.01, nms_iou=0.45)
    far = ref.copy()
    far[0, 2] = [0, 0.6, 0.60, 0.30, 0.2, 0.2]  # no overlap: a box lost, not a tie
    with pytest.raises(AssertionError):
        detections_agree(far, ref, 0.1, nms_iou=0.45)


# --- the exported engine ----------------------------------------------------------


def test_export_and_reload(tmp_path, rng):
    """The exported ESPCN reloads with the same plans and the same outputs,
    bit for bit; a recorded plan that no longer matches is refused."""
    eng = cpu_engine("espcn", batch=2, h=16, w=24)
    x = rng.random((2, 16, 24, 1), dtype=np.float32)
    want = eng.run_single(x)
    path = export_engine(eng, str(tmp_path / "exported"))
    assert sorted(os.listdir(path)) == ["graph.json", "meta.json", "params.npz"]
    loaded = ExportedEngine(path, device="cpu")
    assert torch.equal(loaded.run_single(x), want)
    assert torch.equal(loaded({"input": x})[eng.graph.output_names[0]], want)
    assert loaded.meta["outputs"] == eng.graph.output_names
    assert loaded.meta["inputs"] == {"input": [2, 16, 24, 1]}
    assert loaded.model.forward.chain_plan == eng.model.forward.chain_plan != {}
    meta = json.load(open(os.path.join(path, "meta.json")))
    meta["plans"]["chain_plan"] = {}
    json.dump(meta, open(os.path.join(path, "meta.json"), "w"))
    with pytest.raises(ValueError, match="plans"):
        ExportedEngine(path, device="cpu")


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_export_classifier_and_params_match_jax(tmp_path, rng, prec):
    """A classifier round trip; the port's params.npz holds the JAX export's
    keys and values for the same graph."""
    eng = cpu_engine("resnet18", prec, batch=2)
    path = export_engine(eng, str(tmp_path / "rn"))
    loaded = ExportedEngine(path, device="cpu")
    x = rng.random((2, 32, 32, 3), dtype=np.float32)
    assert torch.equal(loaded.run_single(x), eng.run_single(x))
    np.testing.assert_array_equal(loaded.classify(x), eng.classify(x))
    je = J.Engine.from_graph(jbuild("resnet18"), J.EngineOptions(
        precision=getattr(J.Precision, prec.upper()), batch_size=2))
    jpath = j_export(je, str(tmp_path / "jrn"))
    ours, theirs = np.load(os.path.join(path, "params.npz")), np.load(
        os.path.join(jpath, "params.npz"))
    assert sorted(ours.files) == sorted(theirs.files) and len(ours.files) > 20
    for k in ours.files:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k
    close(loaded.run_single(x), je.run_single(x), prec)


def test_exported_engine_streams(tmp_path, rng):
    """An ExportedEngine is served as the JAX demo serves its export."""
    eng = cpu_engine("espcn", batch=2, h=16, w=24)
    loaded = ExportedEngine(export_engine(eng, str(tmp_path / "e")), device="cpu")
    frames = [(0, i, rng.random((16, 24, 1), dtype=np.float32)) for i in range(4)]
    got = serve(StreamingEngine(loaded), frames, prefill=True)
    out = eng.graph.output_names[0]
    for i, (_, _, f) in enumerate(frames):
        np.testing.assert_allclose(got[i].outputs[out], eng.run_single(f[None])[0].numpy(),
                                   atol=1e-4)


# --- processor, classify, benchmarks, runners ------------------------------------


@pytest.mark.parametrize("use_pallas", [False, True])
def test_processor_matches_jax(rng, use_pallas):
    """use_pallas=True plans the hand-written kernels (KERNEL), False plain
    ops (TORCH); both against the JAX processor on its XLA backend (the JAX
    fused-matmul softmax counts padded columns, ROADMAP C3)."""
    x = rng.random((2, 32, 32, 3), dtype=np.float32)
    proc = InferenceProcessor()
    proc.initialize(InitializationParameters(batch_size=2, model_type="classification",
                                             use_pallas=use_pallas, max_loops=7,
                                             device="cpu"),
                    graph=P.build_model("resnet18"))
    assert proc.engine.options.backend == (P.BackendKind.KERNEL if use_pallas
                                           else P.BackendKind.TORCH)
    proc.preProcess({"input": x})
    res = proc.process()
    jproc = JProcessor()
    jproc.initialize(JParams(batch_size=2, model_type="classification", max_loops=7),
                     graph=jbuild("resnet18"))
    jproc.pre_process({"input": x})
    jres = jproc.process()
    out = proc.engine.graph.output_names[0]
    close(res["outputs"][out], jres["outputs"][out], "fp32")
    np.testing.assert_array_equal(res["class_index"], jres["class_index"])
    assert res["loops"] == jres["loops"] == 2 and res["mean_ms"] > 0
    assert set(res) == set(jres)
    assert use_pallas == bool(proc.engine.model.forward.kernel_dense_plan)


def test_engine_classify_and_benchmarks(rng):
    eng = cpu_engine("resnet18", batch=4)
    x = rng.random((4, 32, 32, 3), dtype=np.float32)
    logits = eng.run_single(x).numpy()
    np.testing.assert_array_equal(eng.classify(x), np.argmax(logits, -1))
    labels = np.argmax(logits, -1)
    assert top1_accuracy(logits, labels) == 1.0 and topk_accuracy(logits, labels, 3) == 1.0
    from shadernn_tpu.utils.metrics import top1_accuracy as jt1, topk_accuracy as jtk

    wrong = (labels + 1) % 10
    assert top1_accuracy(logits, wrong) == jt1(logits, wrong)
    assert topk_accuracy(logits, wrong, 3) == jtk(logits, wrong, 3)
    db = eng.device_benchmark({"input": x}, iters=2, repeats=2)
    assert set(db) == {"mean_ms", "p50_ms", "p50_ms_per_frame", "frames_per_sec", "iters",
                       "batch"}
    assert db["batch"] == 4 and db["iters"] == 2 and db["p50_ms"] >= db["mean_ms"] > 0
    tb = eng.trace_benchmark({"input": x}, steps=2)
    assert set(tb) == {"device_ms_per_step", "device_ms_per_frame", "frames_per_sec", "steps",
                       "batch", "report"}
    assert tb["steps"] == 2 and tb["device_ms_per_step"] > 0
    assert abs(tb["report"].e2e_us - 1e3 * tb["device_ms_per_step"]) < 1e-6


def test_run_model_image_path_matches_jax(tmp_path, rng):
    img = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
    p = str(tmp_path / "in.png")
    Image(img, ColorFormat.RGB8).save(p)
    got = run_model("resnet18", image_path=p, precision=P.Precision.FP32, inner_loops=1,
                    device="cpu")
    want = j_run_model("resnet18", image_path=p, precision=J.Precision.FP32,
                       backend=J.BackendKind.XLA, inner_loops=1)
    assert got["output_shape"] == want["output_shape"] == (1, 10)
    np.testing.assert_array_equal(got["class_index"], want["class_index"])
    got = run_model("yolov3-tiny", image_path=p, precision=P.Precision.FP32, inner_loops=1,
                    device="cpu")
    want = j_run_model("yolov3-tiny", image_path=p, precision=J.Precision.FP32,
                       backend=J.BackendKind.XLA, inner_loops=1)
    assert got["output_shape"] == want["output_shape"] == (1, 100, 6)
    # The runner's preprocessing (to [0, 1], then its 1/255 norm, as the JAX
    # runner does) leaves the seeded detector no box over the cutoff here:
    # both sides must agree on that.
    worst = detections_agree(got["detections"][None], want["detections"][None], TOL["fp32"])
    assert worst["unmatched"] == 0 and worst["kept"] == len(want["detections"]), worst
    got = run_model("espcn", image_path=p, precision=P.Precision.FP32, inner_loops=1,
                    device="cpu")
    assert got["output_shape"] == (1, 1080, 1920, 1)


# --- profiler and profile parser ---------------------------------------------------


def test_profile_layers_and_report_match_jax_counts(rng):
    from shadernn_tpu.utils.profiler import profile_layers as j_profile
    from shadernn_tpu_torch.utils.profiler import (
        PEAKS, peaks_for, print_report, profile_layers, step_cost,
    )

    eng = cpu_engine("espcn", h=16, w=24)
    x = {"input": rng.random((1, 16, 24, 1), dtype=np.float32)}
    profiles = profile_layers(eng, x, iters=2)
    assert [p.name for p in profiles] == [n for n in eng.graph.nodes
                                          if eng.graph.nodes[n].op != "InputLayer"]
    je = J.Engine.from_graph(jbuild("espcn", h=16, w=24), J.EngineOptions())
    want = {p.name: p for p in j_profile(je, x, iters=1)}
    for p in profiles:
        assert (p.flops, p.bytes_moved) == (want[p.name].flops, want[p.name].bytes_moved), p.name
        assert p.ms > 0 and p.device == "cpu"
    report = print_report(profiles)
    assert "Total GPU runtime" in report and "conv_1" in report and "no device roofline" in report
    assert step_cost(eng)["flops"] == sum(p.flops for p in profiles) > 0
    assert peaks_for("NVIDIA H100 80GB HBM3") == ("H100 SXM", PEAKS["H100 SXM"])
    assert PEAKS["H100 SXM"] == (3.35e12, 989e12, 67e12, 495e12, 1979e12)
    assert peaks_for("NVIDIA H100 PCIe")[0] == "H100 PCIe"
    card = [type(p)(**{**p.__dict__, "device": "NVIDIA H100 80GB HBM3"}) for p in profiles]
    assert "roofline vs H100 SXM peaks" in print_report(card)


def test_trace_report_parses_cpu_profile(tmp_path, rng):
    from shadernn_tpu_torch.utils.profiler import capture_trace
    from shadernn_tpu_torch.utils.trace_profile import HAND_WRITTEN, _category, trace_report

    eng = cpu_engine("espcn", h=16, w=24)
    x = {"input": rng.random((1, 16, 24, 1), dtype=np.float32)}
    rep = trace_report(eng, x, steps=3)
    assert rep.steps == 3 and rep.ops and rep.e2e_us == pytest.approx(rep.covered_us)
    assert {o.category for o in rep.ops} == {"cpu"}
    assert any("conv" in o.name for o in rep.ops)
    assert "device busy" in rep.table()
    assert _category("void (anonymous namespace)::conv_chain_tc_kernel<float, false>(x)") == (
        "conv_chain_tc_kernel", "hand-written")
    assert _category("Memcpy HtoD (Pinned -> Device)")[1] == "memcpy"
    assert _category("sm90_xmma_fprop_implicit_gemm")[1] == "library"
    assert HAND_WRITTEN.search("matmul_fused_kernel") and not HAND_WRITTEN.search("conv_chain")
    for body in ("conv_single_wide_kernel<1, false>", "conv_single_fma_kernel<9, 3>"):
        assert _category(f"void (anonymous namespace)::{body}(x)")[1] == "hand-written"
    path = capture_trace(eng, x, str(tmp_path / "trace.json"), steps=2)
    assert json.load(open(path))["traceEvents"]


# --- the trained detector through the service -------------------------------------


def test_trained_yolo_stream_bf16_matches_jax():
    """The trained YOLOv3-tiny at BF16 (256x256, b8), 16 frames of the JAX
    streaming gate's scenes through both services: detections box to box
    against the JAX service's, mAP >= 0.45 (tests/test_accuracy_yolo.py)."""
    from shadernn_tpu_torch.tools.train_yolo import NUM_CLASSES as NC, synth_scenes

    x, gts = synth_scenes(np.random.default_rng(7), 16)
    eng = P.Engine.from_json(zoo.YOLOV3_TINY_TRAINED, P.EngineOptions(
        precision=P.Precision.BF16, batch_size=8, device="cpu"))
    je = J.Engine.from_json(zoo.YOLOV3_TINY_TRAINED, J.EngineOptions(
        precision=J.Precision.BF16, batch_size=8))
    frames = [(0, i, x[i]) for i in range(len(x))]
    got = serve(StreamingEngine(eng), frames, prefill=True)
    want = _jax_serve(je, frames)
    out = eng.graph.output_names[0]
    dets = np.stack([got[i].outputs[out] for i in range(len(x))])
    # NMS ties: a box whose overlap with a higher-scored one is within the
    # tolerance of the 0.45 threshold may be kept by one rounding only
    detections_agree(dets, np.stack([np.asarray(want[i].outputs[out], np.float32)
                                     for i in range(len(x))]), TOL["bf16"], nms_iou=0.45)
    m = mean_average_precision([d[d[:, 1] > 0] for d in dets], gts, NC)
    assert m >= 0.45, m
