"""The fused ingest step as CUDA graphs (engine/graphs.py).

On the CPU: the rule that decides where the graphs engage (the CPU,
`dump_outputs`, a sharded model and an op that waits on the host stay
eager; `Engine.dispatch` besides needs a plan of more than one entry), the
graphs dropped when parameters are installed or changed in
place, the capture's tally of launches and the operands it holds, and the
forward's outputs left uncast for the copy-out. On the card (tests marked
`card`, which skip without a CUDA device), ESPCN 540p at b1 and as a b8
served batch: a replay equal to the eager step bit for bit at BF16, FP32 and
INT8; 64 calls over 64 inputs with 64 outputs of their own; new weights
after `load_params`; the launch counters; a profile of replays; a fault
planted on `CompiledModel.__call__` showing through the graph. Through
`Engine.dispatch`: YOLOv3-tiny 416 b8 (BF16, FP32) and StyleTransfer-candy
512 b4 replayed bit-equal to the eager step, ESPCN b8 (one chain) eager,
new weights, one NMS launch a step by counter and by profile; the TORCH
convs' bf16 cuDNN route (ops/conv.py `cudnn_bf16`) counted once per
captured dispatch, and under FP32 the convs in float32 with TF32 off (on
the CPU: a plan's TORCH convs counted on the route where it is forced). This file
imports no JAX, so that on the card it runs without the test configuration:

    python -m pytest tests/test_torch_graphs.py -q --noconftest -p no:cacheprovider
"""

import dataclasses

import numpy as np
import pytest
import torch

import shadernn_tpu_torch as P
from shadernn_tpu_torch.engine import graphs
from shadernn_tpu_torch.engine.compile import CompiledModel, ShardedModel, uncast_outputs
from shadernn_tpu_torch.graph.ir import Graph, Node, TensorSpec
from shadernn_tpu_torch.image.ingest import ingest_frames, make_ingest_fn
from shadernn_tpu_torch.kernels import capturing, count_launch, launch_counts
from shadernn_tpu_torch.utils import timer

GRAPH_COUNTERS = ("engine.graph_captures", "engine.graph_replays", "engine.graph_eager")
NORM = (1 / 255.0,)


@pytest.fixture(autouse=True)
def clean_recorder():
    timer.disable()
    timer.reset()
    try:
        yield
    finally:
        timer.disable()
        timer.reset()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def cpu_model(precision=P.Precision.FP32, **kw) -> CompiledModel:
    opts = P.EngineOptions(precision=precision, device="cpu", **kw)
    return P.Engine.from_graph(P.build_model("espcn", h=16, w=24), opts).model


def pool_graph(h: int, w: int) -> Graph:
    g = Graph("pool")
    g.add(Node("input", "InputLayer", out_spec=TensorSpec((1, h, w, 4))))
    g.add(Node("pool", "AdaptiveAvgPool2d", ["input"], {"output_height": 3, "output_width": 2}))
    return g


def _cuda(m):
    return dataclasses.replace(m, device=torch.device("cuda"))


RULE_CASES = {
    "cpu": (lambda m: m, False),
    "cuda": (_cuda, True),
    "dump_outputs": (lambda m: _cuda(dataclasses.replace(
        m, options=dataclasses.replace(m.options, dump_outputs=True))), False),
    "sharded": (lambda m: ShardedModel(m.graph, m.options, m.params, m.forward,
                                       m.input_specs, torch.device("cuda")), False),
    # 7x5 to 3x2: the gathers' indices come from the host in every call
    "pool_waits_on_host": (lambda m: _cuda(dataclasses.replace(m, graph=pool_graph(7, 5))),
                           False),
    "pool_divides": (lambda m: _cuda(dataclasses.replace(m, graph=pool_graph(9, 4))), True),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_the_rule_engages_on_an_unsharded_cuda_model_only(case):
    make, want = RULE_CASES[case]
    assert graphs.engages(make(cpu_model())) is want


def yolo80_model(precision=P.Precision.BF16, hw=(64, 64), device="cpu") -> CompiledModel:
    return yolo80(precision, 2, hw, device).model


def yolo80(precision, batch, hw, device=None) -> P.Engine:
    """The seeded YOLOv3-tiny at darknet's widths with its heads and its
    detections as outputs."""
    from shadernn_tpu_torch.graph.parser import parse_model_file
    from shadernn_tpu_torch.tools.seeded_artifact import LAYERS_JSON

    g = parse_model_file(LAYERS_JSON, input_hw=hw)
    g.output_names = ["head1", "head2", "yolo"]
    kw = {"device": device} if device else {}
    return P.Engine.from_graph(g, P.EngineOptions(precision=precision, batch_size=batch, **kw))


DISPATCH_CASES = {
    # one B1 chain: a graph would save one launch and add a pass over the input
    "espcn_bf16_one_chain": (lambda: cpu_model(P.Precision.BF16), False),
    "espcn_fp32_chain_and_subpixel": (lambda: cpu_model(P.Precision.FP32), True),
    "yolov3_tiny_80": (yolo80_model, True),
    "mobilenetv2": (lambda: P.Engine.from_graph(P.build_model("mobilenetv2"), P.EngineOptions(
        precision=P.Precision.BF16, batch_size=2, device="cpu")).model, True),
    "resnet18_kernel": (lambda: P.Engine.from_graph(P.build_model("resnet18"), P.EngineOptions(
        precision=P.Precision.BF16, batch_size=2, device="cpu",
        backend=P.BackendKind.KERNEL)).model, True),
    "unet": (lambda: trained_cpu("UNET_TRAINED"), True),
    "spatialdenoise_chain_and_residual": (lambda: trained_cpu("SPATIALDENOISE_TRAINED"), True),
    "aidenoise": (lambda: trained_cpu("AIDENOISE_TRAINED"), True),
}


def trained_cpu(name) -> CompiledModel:
    from shadernn_tpu_torch.models import zoo

    return P.Engine.from_json(getattr(zoo, name), P.EngineOptions(
        precision=P.Precision.BF16, batch_size=2, device="cpu"), input_hw=(64, 64)).model


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_dispatch_engages_where_the_plan_runs_more_than_one_entry(case):
    make, want = DISPATCH_CASES[case]
    model = make()
    assert graphs.one_launch(model) is not want
    assert graphs.engages(_cuda(model))


def test_a_cpu_dispatch_runs_eager_and_counts_no_graph():
    eng = P.Engine(yolo80_model())
    x = {"input": torch.rand(2, 64, 64, 3)}
    want = eng.model(x)
    for _ in range(3):
        got, events = eng.dispatch(x)
        assert events == [] and sorted(got) == ["head1", "head2", "yolo"]
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert eng.model.graphs is False
    assert not any(k in timer.counters() for k in GRAPH_COUNTERS)


def test_a_cpu_step_runs_eager_and_counts_no_graph():
    model = cpu_model()
    eng = P.Engine(model)
    step = make_ingest_fn(eng, norms=NORM)
    raw = torch.randint(0, 256, (1, 16, 24, 1), dtype=torch.uint8)
    want = model({"input": ingest_frames(raw, norms=NORM, dtype_name="float32")})
    for _ in range(3):
        got = step(raw)
        assert torch.equal(got["subpixel"], want["subpixel"])
    assert model.graphs is False
    assert not any(k in timer.counters() for k in GRAPH_COUNTERS)


def test_graphs_drop_on_load_params_and_on_a_parameters_version():
    model = cpu_model()
    g = model.graphs = graphs.StepGraphs(model.device, model.forward.out_dtype,
                                         model.forward.store)
    sentinel = object()
    g.check(model.params)
    g.graphs["k"] = sentinel
    g.check(model.params)  # nothing changed: kept
    assert g.graphs == {"k": sentinel}
    next(iter(model.params["conv_2"].values())).add_(0.0)  # in place: its _version moves
    g.check(model.params)
    assert g.graphs == {}
    g.graphs["k"] = sentinel
    g.check(model.params)
    model.load_params({n: {k: v.clone() for k, v in d.items()} for n, d in model.params.items()})
    assert g.graphs == {}  # load_params drops them at once
    g.check(model.params)  # the next call takes the new tensors as its stamp
    g.graphs["k"] = sentinel
    g.check(model.params)
    assert g.graphs == {"k": sentinel}
    with torch.no_grad():  # a call outside the graphs sees a change first: they still drop
        next(iter(model.params["conv_1"].values())).mul_(1.0)
    model({"input": torch.rand(1, 16, 24, 1)})
    g.check(model.params)
    assert g.graphs == {}


def test_a_capture_tallies_its_launches_and_holds_what_they_read():
    before = timer.counters()
    with capturing() as tally:
        count_launch("fused_conv_chain_packed")
        count_launch("fused_conv_chain_packed")
        count_launch("fused_invres_block", 1)
    assert timer.counters() == before  # a capture launches nothing
    assert tally == {"kernels.launches.conv_chain_tc_kernel.fused_conv_chain_packed": 2,
                     "kernels.launches.invres_tf32_kernel.fused_invres_block": 1}
    count_launch("fused_conv_chain_packed")
    assert launch_counts("entry")["fused_conv_chain_packed"] == 1
    # What a graph holds from its capture on (engine/graphs.py `_capture`):
    # the store's parameters and every prepared operand its launches read.
    model = cpu_model(P.Precision.BF16)
    model({"input": torch.rand(1, 16, 24, 1)})
    store = model.forward.store
    assert {id(t) for d in model.params.values() for t in d.values()} == set(map(id, store.tensors))
    (chain_ops,) = store.entries.values()
    assert chain_ops is store.get("conv_1", None)
    model.load_params({n: {k: v.clone() for k, v in d.items()} for n, d in model.params.items()})
    model({"input": torch.rand(1, 16, 24, 1)})
    assert store.entries["conv_1"] is not chain_ops and chain_ops.params.numel() > 0


CONV_ROUTE = "ops.conv_bf16_cudnn"


def style_cpu() -> CompiledModel:
    from shadernn_tpu_torch.models import zoo

    return P.Engine.from_json(zoo.STYLE512_TRAINED["candy"], P.EngineOptions(
        precision=P.Precision.BF16, batch_size=2, device="cpu"), input_hw=(64, 64)).model


# The plan's TORCH Conv2D and Conv2DTranspose entries: each a call of the
# bfloat16 cuDNN route on a CUDA device (ops/conv.py `cudnn_bf16`).
ROUTED_CPU = {
    "yolov3_tiny_80": (yolo80_model, (2, 64, 64, 3), 12),  # 13 convs less B3's stem
    "styletransfer_candy": (style_cpu, (2, 64, 64, 3), 14),  # the k9 stem and head on B3
    "espcn_one_chain": (lambda: cpu_model(P.Precision.BF16), (1, 16, 24, 1), 0),
}


@pytest.mark.parametrize("case", sorted(ROUTED_CPU))
def test_a_plans_torch_convs_count_on_the_bf16_route(case, monkeypatch):
    from shadernn_tpu_torch.ops import conv

    make, shape, want = ROUTED_CPU[case]
    x = {"input": torch.rand(*shape)}
    make()(x)
    assert timer.counters().get(CONV_ROUTE, 0) == 0  # the CPU keeps the float32 route
    # A model's route is fixed by its device and dtype, so it caches one
    # layout of each weight: a model of its own takes the forced route.
    monkeypatch.setattr(conv, "cudnn_bf16", lambda t: t.dtype == torch.bfloat16)
    make()(x)
    assert timer.counters().get(CONV_ROUTE, 0) == want


@pytest.mark.parametrize("precision", [P.Precision.BF16, P.Precision.FP32])
def test_the_copy_out_cast_of_uncast_outputs_is_the_forwards_cast(precision):
    model = cpu_model(precision)
    x = {"input": torch.rand(1, 16, 24, 1)}
    want = model(x)
    with uncast_outputs():
        raw = model(x)
    assert raw["subpixel"].dtype == precision.activation_dtype
    assert model.forward.out_dtype == torch.float32
    assert torch.equal(raw["subpixel"].to(model.forward.out_dtype, copy=True), want["subpixel"])


# --- on the card -----------------------------------------------------------

def espcn(precision, batch=1) -> P.Engine:
    from shadernn_tpu_torch.models import zoo

    return P.Engine.from_json(zoo.ESPCN_TRAINED,
                              P.EngineOptions(precision=precision, batch_size=batch),
                              input_hw=(540, 960))


def frames(n, batch, seed=0):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return [torch.randint(0, 256, (batch, 540, 960, 1), generator=g, dtype=torch.uint8,
                          device="cuda") for _ in range(n)]


def eager(eng, raw):
    return eng.model({"input": ingest_frames(raw, norms=NORM, dtype_name="float32")})["subpixel"]


def graph_counts():
    c = timer.counters()
    return tuple(c.get(k, 0) for k in GRAPH_COUNTERS)


@pytest.mark.card
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("precision", [P.Precision.BF16, P.Precision.FP32, P.Precision.INT8])
def test_a_replay_equals_the_eager_step_bit_for_bit(card, precision, batch):
    eng = espcn(precision, batch)
    step = make_ingest_fn(eng, norms=NORM)
    raws = frames(4, batch)
    # a b8 batch as the service runs it: on a stream of its own
    stream = torch.cuda.Stream() if batch > 1 else torch.cuda.current_stream()
    with torch.cuda.stream(stream):
        got = [step(r)["subpixel"] for r in raws]  # eager, capture, replay, replay
    stream.synchronize()
    assert graph_counts() == (1, 3, 1)
    for r, g in zip(raws, got):
        want = eager(eng, r)
        assert g.dtype == want.dtype == torch.float32 and g.shape == want.shape
        assert torch.equal(g, want)


@pytest.mark.card
def test_64_calls_over_64_inputs_return_64_outputs_of_their_own(card):
    eng = espcn(P.Precision.BF16)
    step = make_ingest_fn(eng, norms=NORM)
    raws = frames(64, 1, seed=1)
    got = [step(r)["subpixel"] for r in raws]
    torch.cuda.synchronize()
    assert len({t.data_ptr() for t in got}) == 64
    for r, g in zip(raws, got):
        assert torch.equal(g, eager(eng, r))
    assert graph_counts() == (1, 63, 1)


@pytest.mark.card
def test_new_weights_after_load_params_and_an_in_place_change(card):
    eng = espcn(P.Precision.BF16)
    step = make_ingest_fn(eng, norms=NORM)
    (raw,) = frames(1, 1, seed=2)
    for _ in range(3):
        old = step(raw)["subpixel"]
    eng.model.load_params({n: {k: v * 0.5 if k == "weight" else v for k, v in d.items()}
                           for n, d in eng.model.params.items()})
    new = [step(raw)["subpixel"] for _ in range(3)]  # eager, capture, replay
    want = eager(eng, raw)
    assert not torch.equal(want, old)
    assert all(torch.equal(t, want) for t in new)
    assert graph_counts() == (2, 4, 2)
    with torch.no_grad():
        next(iter(eng.model.params["conv_3"].values())).mul_(2.0)
    changed = [step(raw)["subpixel"] for _ in range(3)]
    before, want = want, eager(eng, raw)
    assert not torch.equal(want, before)  # the change reaches the chain's bf16 operands
    assert all(torch.equal(t, want) for t in changed)
    assert graph_counts() == (3, 6, 3)


@pytest.mark.card
def test_a_replay_counts_the_launches_of_an_eager_step(card):
    eng = espcn(P.Precision.BF16)
    step = make_ingest_fn(eng, norms=NORM)
    (raw,) = frames(1, 1, seed=3)
    per_call = []
    for _ in range(4):
        before = launch_counts("kernel")
        step(raw)
        after = launch_counts("kernel")
        per_call.append({k: n - before.get(k, 0) for k, n in after.items()})
    torch.cuda.synchronize()
    assert per_call == [{"conv_chain_tc_kernel": 1}] * 4


@pytest.mark.card
def test_a_profile_of_replays_holds_one_chain_event_a_step(card):
    from shadernn_tpu_torch.utils.trace_profile import profile_steps

    eng = espcn(P.Precision.BF16)
    step = make_ingest_fn(eng, norms=NORM)
    (raw,) = frames(1, 1, seed=4)
    step(raw)
    step(raw)  # warmed and captured: the profile holds replays only
    timer.reset()
    report = profile_steps(lambda: step(raw), 10, torch.device("cuda"))
    events = {o.name: o.count for o in report.ops if o.category == "hand-written"}
    assert report.launches == {"conv_chain_tc_kernel": 1.0}
    assert events == {"conv_chain_tc_kernel": 1.0}
    c = timer.counters()
    assert c.get("engine.graph_eager", 0) == 0 and c["engine.graph_replays"] >= 11


@pytest.mark.card
def test_a_fault_planted_on_the_models_call_shows_through_the_graph(card, monkeypatch):
    eng = espcn(P.Precision.BF16)
    (raw,) = frames(1, 1, seed=5)
    want = eager(eng, raw)
    real = CompiledModel.__call__

    def altered(self, inputs):
        out = {k: v.clone() for k, v in real(self, inputs).items()}
        out["subpixel"][0, :100] += 0.25
        return out

    monkeypatch.setattr(CompiledModel, "__call__", altered)
    step = make_ingest_fn(eng, norms=NORM)
    got = [step(raw)["subpixel"] for _ in range(3)]
    assert graph_counts() == (1, 2, 1)
    for g in got:
        assert not torch.equal(g, want)
        assert torch.equal(g[0, 100:], want[0, 100:])


@pytest.mark.card
def test_the_service_serves_its_batches_through_the_graph(card):
    from shadernn_tpu_torch.engine.streaming import StreamingEngine

    eng = espcn(P.Precision.BF16, batch=8)
    host = np.random.default_rng(6).integers(0, 256, (40, 540, 960, 1), dtype=np.uint8)
    got = {}
    svc = StreamingEngine(eng, on_result=lambda r: got.__setitem__(r.frame_id, r),
                          ingest={"means": (0.0,), "norms": NORM})
    svc.start()
    try:
        for i, f in enumerate(host):
            svc.submit(0, i, f)
    finally:
        svc.stop(drain=True, timeout=120)
    assert sorted(got) == list(range(40))
    captures, replays, eager_calls = graph_counts()
    assert captures == 1 and eager_calls == 1 and replays == svc.batches_run - 1
    for i in range(0, 40, 8):
        want = eager(eng, torch.from_numpy(host[i:i + 8]).cuda()).cpu().numpy()
        for j in range(8):
            np.testing.assert_array_equal(got[i + j].outputs["subpixel"], want[j])


# --- Engine.dispatch on the card ---------------------------------------------

def style(precision=P.Precision.BF16, batch=4) -> P.Engine:
    from shadernn_tpu_torch.models import zoo

    return P.Engine.from_json(zoo.STYLE512_TRAINED["candy"],
                              P.EngineOptions(precision=precision, batch_size=batch),
                              input_hw=(512, 512))


def device_inputs(n, batch, hw, c, seed=0):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return [ingest_frames(torch.randint(0, 256, (batch, *hw, c), generator=g, dtype=torch.uint8,
                                        device="cuda"), norms=NORM, dtype_name="float32")
            for _ in range(n)]


def zoo_engine(name, precision, batch, **kw) -> P.Engine:
    return P.Engine.from_graph(P.build_model(name),
                               P.EngineOptions(precision=precision, batch_size=batch, **kw))


def trained(name, precision, batch, hw) -> P.Engine:
    from shadernn_tpu_torch.models import zoo

    return P.Engine.from_json(getattr(zoo, name),
                              P.EngineOptions(precision=precision, batch_size=batch), input_hw=hw)


DISPATCHED = {
    "yolov3_tiny_416_b8_bf16": (lambda: yolo80(P.Precision.BF16, 8, (416, 416)), (416, 416), 3),
    "yolov3_tiny_416_b8_fp32": (lambda: yolo80(P.Precision.FP32, 8, (416, 416)), (416, 416), 3),
    "styletransfer_candy_512_b4_bf16": (style, (512, 512), 3),
    # B4's blocks
    "mobilenetv2_224_b8_bf16": (lambda: zoo_engine("mobilenetv2", P.Precision.BF16, 8),
                                (224, 224), 3),
    # B3 and B6 with its softmax, whose arrival counters are kept per stream
    "resnet18_b8_kernel_bf16": (lambda: zoo_engine("resnet18", P.Precision.BF16, 8,
                                                   backend=P.BackendKind.KERNEL), (32, 32), 3),
    "resnet18_b8_kernel_fp32": (lambda: zoo_engine("resnet18", P.Precision.FP32, 8,
                                                   backend=P.BackendKind.KERNEL), (32, 32), 3),
    "unet_256_b8_bf16": (lambda: trained("UNET_TRAINED", P.Precision.BF16, 8, (256, 256)),
                         (256, 256), 1),
    "unet_256_b8_fp32": (lambda: trained("UNET_TRAINED", P.Precision.FP32, 8, (256, 256)),
                         (256, 256), 1),
    # a B1 chain and TORCH ops around it
    "spatialdenoise_1080p_b2_bf16": (lambda: trained("SPATIALDENOISE_TRAINED", P.Precision.BF16,
                                                     2, (1080, 1920)), (1080, 1920), 1),
    "aidenoise_1080p_b2_bf16": (lambda: trained("AIDENOISE_TRAINED", P.Precision.BF16, 2,
                                                (1080, 1920)), (1080, 1920), 1),
    "aidenoise_1080p_b2_fp32": (lambda: trained("AIDENOISE_TRAINED", P.Precision.FP32, 2,
                                                (1080, 1920)), (1080, 1920), 1),
    "espcn_540p_b8_fp32": (lambda: espcn(P.Precision.FP32, batch=8), (540, 960), 1),
}


@pytest.fixture
def deterministic_cudnn():
    """cuDNN's deterministic algorithms: StyleTransfer's transposed convs
    (cuDNN's dgrad) otherwise differ from one eager step to the next, by
    0.002 at the head (on an H100), so that no two steps, eager or
    replayed, are bit-equal."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(DISPATCHED))
def test_a_dispatch_replay_equals_the_eager_step_bit_for_bit(card, deterministic_cudnn, case):
    make, hw, c = DISPATCHED[case]
    eng = make()
    batch = eng.options.batch_size
    xs = device_inputs(4, batch, hw, c, seed=7)
    got = [eng.dispatch({"input": x})[0] for x in xs]  # eager, capture, replay, replay
    torch.cuda.synchronize()
    assert graph_counts() == (1, 3, 1)
    for x, g in zip(xs, got):
        want = eng.model({"input": x})
        assert sorted(g) == sorted(want)
        for k in want:
            assert g[k].dtype == want[k].dtype and torch.equal(g[k], want[k]), k
    assert len({t.data_ptr() for g in got for t in g.values()}) == 4 * len(got[0])


ROUTED = {
    "styletransfer_candy_512_b4_bf16": (style, (512, 512), 14),
    "styletransfer_candy_512_b4_fp32": (lambda: style(P.Precision.FP32), (512, 512), 0),
    "yolov3_tiny_416_b8_bf16": (lambda: yolo80(P.Precision.BF16, 8, (416, 416)), (416, 416), 12),
    "yolov3_tiny_416_b8_fp32": (lambda: yolo80(P.Precision.FP32, 8, (416, 416)), (416, 416), 0),
}


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(ROUTED))
def test_the_bf16_route_counts_once_per_captured_dispatch(card, case):
    make, hw, want = ROUTED[case]
    eng = make()
    per_call = []
    for x in device_inputs(4, eng.options.batch_size, hw, 3, seed=13):
        before = timer.counters().get(CONV_ROUTE, 0)
        eng.dispatch({"input": x})  # eager, capture, replay, replay
        per_call.append(timer.counters().get(CONV_ROUTE, 0) - before)
    torch.cuda.synchronize()
    assert graph_counts() == (1, 3, 1)
    assert per_call == [want, want, 0, 0]


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(ROUTED))
def test_the_torch_convs_run_in_the_engines_dtype_with_tf32_off(card, case, monkeypatch):
    import torch.nn.functional as F

    make, hw, routed = ROUTED[case]
    eng = make()
    seen = []
    for name in ("conv2d", "conv_transpose2d"):
        def spy(x, *args, _call=getattr(F, name), _name=name, **kw):
            seen.append((_name, x.dtype, torch.backends.cudnn.allow_tf32))
            return _call(x, *args, **kw)

        monkeypatch.setattr(F, name, spy)
    (x,) = device_inputs(1, eng.options.batch_size, hw, 3, seed=14)
    eng.model({"input": x})
    transposed = 2 if case.startswith("style") else 0
    assert sorted(n for n, _, _ in seen) == ["conv2d"] * 12 + ["conv_transpose2d"] * transposed
    fp32 = routed == 0
    assert all(dt == (torch.float32 if fp32 else torch.bfloat16) for _, dt, _ in seen)
    if fp32:
        assert not any(tf32 for _, _, tf32 in seen)


@pytest.mark.card
def test_espcn_b8_dispatch_stays_eager(card):
    eng = espcn(P.Precision.BF16, batch=8)
    x = ingest_frames(frames(1, 8, seed=8)[0], norms=NORM, dtype_name="float32")
    for _ in range(3):
        eng.dispatch({"input": x})
    torch.cuda.synchronize()
    assert graph_counts() == (0, 0, 3)
    assert eng.model.graphs and not eng.model.graphs.dispatch


@pytest.mark.card
def test_new_weights_drop_the_dispatch_graphs(card):
    eng = yolo80(P.Precision.BF16, 8, (416, 416))
    (x,) = device_inputs(1, 8, (416, 416), 3, seed=9)
    for _ in range(3):
        old = eng.dispatch({"input": x})[0]
    eng.model.load_params({n: {k: v * 0.5 if k == "weight" else v for k, v in d.items()}
                           for n, d in eng.model.params.items()})
    new = [eng.dispatch({"input": x})[0] for _ in range(3)]  # eager, capture, replay
    want = eng.model({"input": x})
    assert not torch.equal(want["head1"], old["head1"])
    assert all(torch.equal(t[k], want[k]) for t in new for k in want)
    assert graph_counts() == (2, 4, 2)
    with torch.no_grad():
        eng.model.params["head2"]["bias"].add_(1.0)
    changed = [eng.dispatch({"input": x})[0] for _ in range(3)]
    want = eng.model({"input": x})
    assert all(torch.equal(t[k], want[k]) for t in changed for k in want)
    assert graph_counts() == (3, 6, 3)


@pytest.mark.card
def test_a_dispatch_replay_launches_the_nms_once_a_step(card):
    from shadernn_tpu_torch.utils.trace_profile import profile_steps

    eng = yolo80(P.Precision.BF16, 8, (416, 416))
    (x,) = device_inputs(1, 8, (416, 416), 3, seed=10)
    per_call = []
    for _ in range(4):
        before = launch_counts("kernel")
        eng.dispatch({"input": x})
        after = launch_counts("kernel")
        per_call.append({k: n - before.get(k, 0) for k, n in after.items()})
    want = {"conv_single_tc_kernel": 1, "yolo_nms_kernel": 1}
    assert per_call == [want] * 4
    timer.reset()
    report = profile_steps(lambda: eng.dispatch({"input": x}), 10, torch.device("cuda"))
    events = {o.name: o.count for o in report.ops if o.category == "hand-written"}
    assert report.launches == {k: 1.0 for k in want}
    assert events == {k: 1.0 for k in want}
    c = timer.counters()
    assert c.get("engine.graph_eager", 0) == 0 and c["engine.graph_replays"] >= 11
