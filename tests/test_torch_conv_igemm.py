"""The port's implicit-GEMM conv module
(shadernn_tpu_torch.kernels.conv_igemm) against the JAX package's per-layer
conv kernel (`conv2d_pallas_nhwc`, which reaches `fused_conv2d_nhcw`, in
Pallas interpret mode), and the engine path that carries it: a Conv2D the
caller gives to KERNEL and no chain takes, here the two-input conv. On the
CPU the port's entry point runs the kernel's plain version; the CUDA
kernel itself is held against that plain version on the card by
chip_smoke.py.

Tolerance: the conftest thresholds (0.01 fp32, 0.1 bf16) times
max(1, max|reference|)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shadernn_tpu as J
from shadernn_tpu.graph.ir import Graph as JGraph
from shadernn_tpu.graph.ir import Node as JNode
from shadernn_tpu.kernels.conv_pallas import conv2d_pallas_nhwc

import shadernn_tpu_torch as P
from shadernn_tpu_torch.graph.ir import Graph as PGraph
from shadernn_tpu_torch.graph.ir import Node as PNode
from shadernn_tpu_torch.kernels import conv_igemm
from shadernn_tpu_torch.ops import get_op as p_op
from shadernn_tpu_torch.ops.conv import kernel_conv_supported
from shadernn_tpu_torch.ops.registry import RunCtx as PCtx

TOL = {"fp32": 0.01, "bf16": 0.1}  # tests/conftest.py thresholds
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


# (n, h, w, c, k, o, stride, pads, activation, int8 weights)
CASES = [
    (2, 12, 20, 8, 3, 16, 1, (1, 1, 1, 1), "relu", False),
    (1, 10, 16, 1, 5, 16, 1, (2, 2, 2, 2), "tanh", False),      # C=1: the JAX side pads channels
    (2, 9, 14, 3, 4, 5, 1, (1, 2, 1, 2), "leaky_relu", False),  # even k: top/left one less
    (1, 11, 17, 8, 3, 12, 1, (2, 1, 0, 3), "sigmoid", False),   # asymmetric pads
    (2, 8, 8, 16, 1, 24, 1, (0, 0, 0, 0), "linear", False),
    (1, 12, 16, 8, 3, 16, 1, (1, 1, 1, 1), "relu", True),
    (2, 12, 20, 8, 3, 8, 2, (1, 1, 1, 1), "relu", False),       # stride 2: interpret mode only in JAX
    (1, 12, 12, 4, 4, 4, 2, (1, 2, 1, 2), "linear", False),
]


def operands(rng, c, k, o, int8):
    if int8:
        w = rng.integers(-127, 128, (k, k, c, o)).astype(np.int8)
        scale = (0.02 / np.sqrt(k * k * c) * (1 + 0.1 * rng.standard_normal(o))).astype(np.float32)
    else:
        w = (rng.standard_normal((k, k, c, o)) / np.sqrt(k * k * c)).astype(np.float32)
        scale = (rng.random(o) + 0.5).astype(np.float32)
    return w, scale, (0.3 * rng.standard_normal(o)).astype(np.float32)


def case_id(c):
    return f"c{c[3]}k{c[4]}o{c[5]}s{c[6]}" + ("_int8" if c[9] else "")


@pytest.mark.parametrize("prec", list(TOL))
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_reference_matches_jax_kernel(rng, case, prec):
    n, h, w, c, k, o, stride, pads, act, int8 = case
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt, scale, offset = operands(rng, c, k, o, int8)
    tdt, jdt = DTYPES[prec]
    want = np.asarray(conv2d_pallas_nhwc(
        jnp.asarray(x, jdt), jnp.asarray(wt) if int8 else jnp.asarray(wt, jdt),
        jnp.asarray(scale), jnp.asarray(offset), stride=stride, pads=pads, activation=act,
        interpret=True), np.float32)
    before = dict(conv_igemm.launches)
    got = conv_igemm.conv2d_kernel_nhwc(
        torch.from_numpy(x).to(tdt), torch.from_numpy(wt) if int8 else torch.from_numpy(wt).to(tdt),
        torch.from_numpy(scale), torch.from_numpy(offset), stride=stride, pads=pads,
        activation=act)
    assert conv_igemm.launches == before  # CPU tensors never launch the kernel
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    tol = TOL[prec] * max(1.0, float(np.abs(want).max()))
    assert np.max(np.abs(got.float().numpy() - want)) <= tol


def conv_node(node_cls, k, o, act="relu", stride=1, **params):
    return node_cls("n", "Conv2D", ["x"],
                    dict(kernel_size=k, out_channels=o, padding="same", activation=act,
                         stride=stride, use_bias=False),
                    params or {"weight": np.zeros((k, k, 1, o), np.float32)})


@pytest.mark.parametrize("k,o,stride,c", [
    (3, 128, 1, 128), (3, 129, 1, 16), (3, 16, 1, 129), (5, 8, 1, 128), (6, 8, 1, 113),
    (3, 8, 2, 8), (17, 4, 1, 14), (19, 4, 1, 11),
])
def test_gate_is_the_jax_gate(k, o, stride, c):
    from shadernn_tpu.ops.conv import pallas_conv_supported

    assert kernel_conv_supported(conv_node(PNode, k, o, stride=stride), c) == \
        pallas_conv_supported(conv_node(JNode, k, o, stride=stride), (1, 8, 8, c))


def test_gate_declines_softmax_and_int8_storage():
    """Softmax stays declined; int8 weight storage is taken (the kernel
    reads int8, the scale arrives folded)."""
    assert conv_igemm.igemm_conv_supported(conv_node(PNode, 3, 8), 4)
    assert not conv_igemm.igemm_conv_supported(conv_node(PNode, 3, 8, "softmax"), 4)
    assert conv_igemm.igemm_conv_supported(
        conv_node(PNode, 3, 8, weight_q=np.zeros(1, np.int8)), 4)
    w, s = torch.zeros((3, 3, 4, 8)), torch.ones(8)
    with pytest.raises(ValueError):
        conv_igemm.conv2d_kernel_nhwc(torch.zeros((1, 8, 8, 4), device="meta"), w, s, s)


def two_input_graph(graph_cls, node_cls, rng, h=10, w=12):
    """The reference's use_multi_inputs conv: inputs of 3 and 5 channels,
    one k3 conv over both, 8 -> 16, bias and relu."""
    g = graph_cls()
    g.add(node_cls("a", "InputLayer", [], {"height": h, "width": w, "channels": 3}))
    g.add(node_cls("b", "InputLayer", [], {"height": h, "width": w, "channels": 5, "index": 1}))
    g.add(node_cls("conv", "Conv2D", ["a", "b"],
                   {"kernel_size": 3, "stride": 1, "padding": "same", "out_channels": 16,
                    "use_multi_inputs": True, "use_bias": True, "activation": "relu"},
                   {"weight": (rng.standard_normal((3, 3, 8, 16)) * 0.3).astype(np.float32),
                    "bias": (rng.standard_normal(16) * 0.3).astype(np.float32)}))
    g.finalize()
    g.infer_shapes(batch_size=2)
    return g


@pytest.mark.parametrize("prec", list(TOL))
def test_two_input_conv_under_kernel_matches_jax(prec):
    """Forced to the kernel, the two-input conv is what no chain takes: the
    JAX package runs it on `_conv_kernel`, the port plans it for the
    implicit-GEMM kernel."""
    seed = 7767517
    xa = np.random.default_rng(1).random((2, 10, 12, 3), dtype=np.float32)
    xb = np.random.default_rng(2).random((2, 10, 12, 5), dtype=np.float32)
    jg = two_input_graph(JGraph, JNode, np.random.default_rng(seed))
    jmodel = J.engine.compile.compile_graph(jg, J.EngineOptions(
        precision=getattr(J.Precision, prec.upper()), backend=J.BackendKind.PALLAS, batch_size=2))
    assert jmodel.forward.chain_plan == {}
    want = np.asarray(jmodel({"a": xa, "b": xb})["conv"], np.float32)

    calls = []
    real = conv_igemm.conv2d_kernel_nhwc

    def counted(x, *a, **kw):
        calls.append(tuple(x.shape))
        return real(x, *a, **kw)

    pg = two_input_graph(PGraph, PNode, np.random.default_rng(seed))
    eng = P.Engine.from_graph(pg, P.EngineOptions(
        device="cpu", precision=getattr(P.Precision, prec.upper()),
        backend=P.BackendKind.KERNEL, batch_size=2))
    fwd = eng.model.forward
    assert fwd.kernel_conv_plan == ["conv"]
    assert fwd.chain_plan == {} and fwd.single_conv_plan == [] and fwd.kernel_dense_plan == []
    conv_igemm.conv2d_kernel_nhwc = counted
    try:
        got = eng.run({"a": xa, "b": xb})["conv"].numpy()
    finally:
        conv_igemm.conv2d_kernel_nhwc = real
    assert calls == [(2, 10, 12, 8)]
    assert got.shape == want.shape == (2, 10, 12, 16)
    assert np.max(np.abs(got - want)) <= TOL[prec] * max(1.0, float(np.abs(want).max()))
    # Under AUTO nothing gives a two-input conv to the kernel.
    auto = P.Engine.from_graph(two_input_graph(PGraph, PNode, np.random.default_rng(seed)),
                               P.EngineOptions(device="cpu", batch_size=2)).model.forward
    assert auto.kernel_conv_plan == []


def test_conv_op_honours_the_kernel_backend(rng, caplog):
    """Conv2D.run under KERNEL: concat, then the kernel where the gate
    holds, TORCH with a log line that names the gate where it does not
    (stride 2)."""
    calls = []
    real = conv_igemm.conv2d_kernel_nhwc

    def counted(x, *a, **kw):
        calls.append(kw["stride"])
        return real(x, *a, **kw)

    conv_igemm.conv2d_kernel_nhwc = counted
    try:
        for stride in (1, 2):
            node = conv_node(PNode, 3, 6, stride=stride, weight=torch.from_numpy(
                (rng.standard_normal((3, 3, 5, 6)) / 7).astype(np.float32)))
            xs = [torch.from_numpy(rng.standard_normal((1, 8, 9, c)).astype(np.float32))
                  for c in (2, 3)]
            got = p_op("Conv2D").run(node, xs, PCtx(backend=P.BackendKind.KERNEL))
            want = p_op("Conv2D").run(node, xs, PCtx(backend=P.BackendKind.TORCH))
            assert (got - want).abs().max().item() <= 1e-5
    finally:
        conv_igemm.conv2d_kernel_nhwc = real
    assert calls == [1]
    assert caplog.text.count("conv n given to KERNEL runs on TORCH: outside the implicit-GEMM") == 1


def test_two_input_conv_int8_under_kernel_matches_jax():
    """Under INT8 the two-input conv's weights are int8 and the kernel's
    gate takes them: folded_operands hands the implicit-GEMM kernel the
    int8 weight and the folded scale, as the JAX package hands its
    `_conv_kernel` (Pallas interpret mode) the int8 weight."""
    seed = 7767517
    xa = np.random.default_rng(1).random((2, 10, 12, 3), dtype=np.float32)
    xb = np.random.default_rng(2).random((2, 10, 12, 5), dtype=np.float32)
    jeng = J.Engine.from_graph(two_input_graph(JGraph, JNode, np.random.default_rng(seed)),
                               J.EngineOptions(precision=J.Precision.INT8,
                                               backend=J.BackendKind.PALLAS, batch_size=2),
                               optimize=False)
    want = np.asarray(jeng.run({"a": xa, "b": xb})["conv"], np.float32)
    seen = []
    real = conv_igemm.conv2d_kernel_nhwc

    def counted(x, w, *a, **kw):
        seen.append(w.dtype)
        return real(x, w, *a, **kw)

    eng = P.Engine.from_graph(two_input_graph(PGraph, PNode, np.random.default_rng(seed)),
                              P.EngineOptions(device="cpu", precision=P.Precision.INT8,
                                              backend=P.BackendKind.KERNEL, batch_size=2),
                              optimize=False)
    assert "weight_q" in eng.graph.nodes["conv"].params
    assert eng.model.forward.kernel_conv_plan == ["conv"]
    conv_igemm.conv2d_kernel_nhwc = counted
    try:
        got = eng.run({"a": xa, "b": xb})["conv"].numpy()
    finally:
        conv_igemm.conv2d_kernel_nhwc = real
    assert seen == [torch.int8]
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 0.1 * max(1.0, float(np.abs(want).max()))
