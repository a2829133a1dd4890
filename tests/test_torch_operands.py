"""The model's operand store (engine/compile.py `OperandStore`) over every
kind of plan entry, at FP32 and BF16 on the CPU: an in-place change to a
parameter reaches the next call, a forward on other parameters equals an
engine loaded with them, and nothing outside the engine keeps what it
prepared. This file imports no JAX."""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

import shadernn_tpu_torch as P
from shadernn_tpu_torch.graph.builder import GraphBuilder
from shadernn_tpu_torch.graph.ir import Graph, Node
from shadernn_tpu_torch.utils import timer


def chain_graph() -> Graph:
    return P.build_model("espcn", h=16, w=24)


def single_graph() -> Graph:
    """One k3 conv that AUTO gives the kernel: a chain of one."""
    b = GraphBuilder("single", seed=3)
    b.conv2d(b.input(8, 10, 4), 8, 3, activation="relu", name="conv",
             bias=np.full(8, 0.1, np.float32))
    return b.build()


def block_graph() -> Graph:
    """expand 1x1 -> depthwise 3x3 -> project 1x1 -> add: one block."""
    b = GraphBuilder("block", seed=4)
    x = b.input(8, 8, 8)
    y = b.conv2d(x, 16, 1, activation="relu6", name="expand")
    y = b.depthwise(y, 3, activation="relu6", name="dw")
    y = b.conv2d(y, 8, 1, name="project")
    b.add([x, y], name="add")
    return b.build()


def kernel_conv_graph() -> Graph:
    """A two-input conv, which no chain takes: the implicit-GEMM kernel."""
    rng = np.random.default_rng(5)
    g = Graph("two_input")
    g.add(Node("a", "InputLayer", [], {"height": 6, "width": 7, "channels": 3}))
    g.add(Node("b", "InputLayer", [], {"height": 6, "width": 7, "channels": 5, "index": 1}))
    g.add(Node("conv", "Conv2D", ["a", "b"],
               {"kernel_size": 3, "stride": 1, "padding": "same", "out_channels": 16,
                "use_multi_inputs": True, "use_bias": True, "activation": "relu"},
               {"weight": (rng.standard_normal((3, 3, 8, 16)) * 0.3).astype(np.float32),
                "bias": (rng.standard_normal(16) * 0.3).astype(np.float32)}))
    g.finalize()
    g.infer_shapes(batch_size=1)
    return g


def dense_graph() -> Graph:
    b = GraphBuilder("dense", seed=6)
    b.dense(b.flatten(b.input(4, 4, 3)), 16, activation="relu", name="fc")
    return b.build()


def torch_graph() -> Graph:
    b = GraphBuilder("torch", seed=7)
    b.conv2d(b.input(8, 10, 4), 8, 3, activation="relu", name="conv")
    return b.build()


KERNEL = {"backend": P.BackendKind.KERNEL}
# kind -> (graph, options, the plan that names the entry or None, the entry's kind)
CASES = {
    "chain": (chain_graph, {}, "chain_plan", "chain"),
    "single": (single_graph, {}, "single_conv_plan", "single"),
    "block": (block_graph, {}, "block_plan", "block"),
    "kernel_conv": (kernel_conv_graph, KERNEL, "kernel_conv_plan", "kernel"),
    "kernel_dense": (dense_graph, KERNEL, "kernel_dense_plan", "kernel"),
    "torch": (torch_graph, {"backend": P.BackendKind.TORCH}, None, "torch"),
}
PRECISIONS = [P.Precision.FP32, P.Precision.BF16]


def engine(case, precision) -> tuple:
    """(engine, its inputs, the head of the case's entry)."""
    make, kw, plan, kind = CASES[case]
    eng = P.Engine.from_graph(make(), P.EngineOptions(precision=precision, device="cpu", **kw),
                              optimize=False)
    fwd = eng.model.forward
    (head,) = [e.nodes[0] for e in fwd.entries if e.kind == kind]
    if plan is not None:
        assert head in getattr(fwd, plan)
    rng = np.random.default_rng(8)
    inputs = {n: torch.from_numpy(rng.random(eng.graph.nodes[n].out_spec.shape,
                                             dtype=np.float32))
              for n in eng.graph.input_names}
    return eng, inputs, head


def outputs(model, inputs, params=None):
    out = model.forward(model.params if params is None else params, inputs)
    return torch.cat([out[o].float().reshape(-1) for o in model.graph.output_names])


def scaled(params, head):
    """The parameters with the head's weight halved, as new tensors."""
    return {n: {k: v * 0.5 if n == head and k == "weight" else v.clone() for k, v in d.items()}
            for n, d in params.items()}


def tensors(obj):
    """The tensors inside prepared operands, in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in tensors(o)]
    return []


@pytest.mark.parametrize("precision", PRECISIONS, ids=lambda p: p.value)
@pytest.mark.parametrize("case", sorted(CASES))
def test_an_in_place_change_to_a_parameter_is_seen_by_the_next_call(case, precision):
    eng, inputs, head = engine(case, precision)
    model = eng.model
    before = outputs(model, inputs)
    made = timer.counters().get("engine.operand_prepares", 0)
    with torch.no_grad():
        model.params[head]["weight"].mul_(0.5)
    got = outputs(model, inputs)
    assert timer.counters()["engine.operand_prepares"] > made
    assert head in model.forward.store.entries
    fresh, _, _ = engine(case, precision)
    fresh.model.load_params({n: {k: v.clone() for k, v in d.items()}
                             for n, d in model.params.items()})
    assert torch.equal(got, outputs(fresh.model, inputs))
    assert not torch.equal(got, before)


@pytest.mark.parametrize("precision", PRECISIONS, ids=lambda p: p.value)
@pytest.mark.parametrize("case", sorted(CASES))
def test_a_forward_on_other_params_equals_an_engine_loaded_with_them(case, precision):
    eng, inputs, head = engine(case, precision)
    model = eng.model
    own = outputs(model, inputs)
    other = scaled(model.params, head)
    got = outputs(model, inputs, other)
    loaded, _, _ = engine(case, precision)
    loaded.model.load_params(other)
    assert torch.equal(got, outputs(loaded.model, inputs))
    assert not torch.equal(got, own)
    assert torch.equal(outputs(model, inputs), own)  # and back on its own


@pytest.mark.parametrize("precision", PRECISIONS, ids=lambda p: p.value)
@pytest.mark.parametrize("case", sorted(CASES))
def test_nothing_keeps_a_prepared_operand_after_its_engine(case, precision):
    eng, inputs, head = engine(case, precision)
    outputs(eng.model, inputs)
    prepared = tensors(eng.model.forward.store.entries[head])
    assert prepared
    refs = [weakref.ref(t) for t in prepared]
    del eng, prepared
    gc.collect()
    assert all(r() is None for r in refs)
