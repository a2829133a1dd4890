"""The port's ONNX tools (tools/onnx_reader.py, onnx_export.py, convert.py)
against the JAX package's: the exported bytes are byte-equal for the zoo
of tests/test_onnx_roundtrip.py; the reader gives the same ONNX graph; the
converter the same nodes, attributes and bit-equal parameters; the four
hand-encoded models of tests/test_onnx.py run through both engines within
the tests/conftest.py limits (0.01 fp32, times max(1, max|JAX|)); the
imported trained models plan as the JAX planner plans them and as their
native graphs do; and the convertTool CLI round trip."""

import numpy as np
import pytest
import torch

import onnx_encoder as enc
import shadernn_tpu as J
from shadernn_tpu.graph.parser import parse_model_file as jparse
from shadernn_tpu.models import build_model as jbuild
from shadernn_tpu.tools.convert import convert_onnx_graph as j_convert
from shadernn_tpu.tools.onnx_export import export_onnx as j_export
from shadernn_tpu.tools.onnx_reader import parse_onnx as j_parse_onnx

import shadernn_tpu_torch as P
from shadernn_tpu_torch.graph.parser import parse_model_file as pparse
from shadernn_tpu_torch.models import zoo
from shadernn_tpu_torch.tools.convert import convert_onnx_graph as p_convert
from shadernn_tpu_torch.tools.onnx_export import export_onnx as p_export
from shadernn_tpu_torch.tools.onnx_reader import parse_onnx as p_parse_onnx

from test_torch_graph import assert_same_graph
from test_torch_zoo import close, options


def opts(pkg, prec, backend, **kw):
    """options() with a backend: "auto", or "kernel" (the JAX PALLAS)."""
    kind = {"auto": "AUTO", "kernel": "KERNEL" if pkg is P else "PALLAS"}[backend]
    return options(pkg, prec, backend=getattr(pkg.BackendKind, kind), **kw)


# tests/test_onnx_roundtrip.py's zoo: (model, build kwargs).
ZOO = [
    ("espcn", dict(h=16, w=24)),
    ("aidenoise", dict(h=32, w=32)),
    ("spatialdenoise", dict(h=16, w=24)),
    ("styletransfer", dict(h=32, w=32)),
    ("unet", dict(h=32, w=32, base_filters=8)),
    ("mobilenetv2", dict(h=32, w=32)),
    ("resnet18", dict()),
    ("yolov3-tiny", dict(h=64, w=64)),
]


def strip_yolo(g):
    """tests/test_onnx_roundtrip.py's _strip_yolo: the YOLO decode head has
    no ONNX mapping; its feature maps become the outputs."""
    yolo = [n for n in g.nodes.values() if n.op == "YOLO"]
    if yolo:
        (node,) = yolo
        del g.nodes[node.name]
        g.finalize(node.inputs)
    return g


def onnx_dict(og):
    """An OnnxGraph (either package's) as plain values."""
    def attr(a):
        return (a.name, a.f, a.i, a.s, list(a.floats), list(a.ints),
                None if a.t is None else (a.t.name, a.t.dims, a.t.data.tobytes()))

    return {
        "name": og.name,
        "nodes": [(n.op_type, n.name, n.inputs, n.outputs,
                   sorted(attr(a) for a in n.attrs.values())) for n in og.nodes],
        "inits": {k: (t.name, t.dims, t.data.dtype.str, t.data.tobytes())
                  for k, t in og.initializers.items()},
        "inputs": og.inputs,
        "outputs": og.outputs,
    }


@pytest.mark.parametrize("name,kw", ZOO, ids=[z[0] for z in ZOO])
def test_export_parse_convert_equal_jax(name, kw):
    jg, pg = strip_yolo(jbuild(name, **kw)), strip_yolo(P.build_model(name, **kw))
    jg.infer_shapes()
    pg.infer_shapes()
    data = p_export(pg)
    assert data == j_export(jg)
    pog, jog = p_parse_onnx(data), j_parse_onnx(data)
    assert onnx_dict(pog) == onnx_dict(jog)
    assert_same_graph(p_convert(pog), j_convert(jog))


def test_export_writes_the_file(tmp_path):
    g = P.build_model("espcn", h=8, w=8)
    data = p_export(g, str(tmp_path / "espcn.onnx"))
    assert (tmp_path / "espcn.onnx").read_bytes() == data
    og = p_parse_onnx(data)
    assert [n.op_type for n in og.nodes].count("Conv") == 3
    assert any(n.op_type == "DepthToSpace" for n in og.nodes)


# --- tests/test_onnx.py's four hand-encoded models --------------------------


def _conv_attrs(k, pad, **extra):
    attrs = [enc.attr_ints("kernel_shape", [k, k]), enc.attr_ints("strides", [1, 1]),
             enc.attr_ints("pads", [pad] * 4)]
    return attrs + [enc.attr_int(key, v) for key, v in extra.items()]


def conv_relu(rng):
    w1 = rng.standard_normal((8, 3, 3, 3)).astype(np.float32) * 0.2
    b1 = rng.standard_normal(8).astype(np.float32)
    return enc.model(
        nodes=[enc.node("Conv", ["x", "w1", "b1"], ["c1"], attrs=_conv_attrs(3, 1)),
               enc.node("Relu", ["c1"], ["r1"])],
        initializers=[enc.tensor("w1", w1), enc.tensor("b1", b1)],
        inputs=[enc.value_info("x", [1, 3, 12, 14])],
        outputs=[enc.value_info("r1", [1, 8, 12, 14])]), 1


def gemm_classifier(rng):
    c, h, w = 4, 6, 6
    w1 = rng.standard_normal((c, 3, 3, 3)).astype(np.float32) * 0.3
    wg = rng.standard_normal((10, c * h * w)).astype(np.float32) * 0.1
    bg = rng.standard_normal(10).astype(np.float32)
    return enc.model(
        nodes=[enc.node("Conv", ["x", "w1"], ["c1"], attrs=_conv_attrs(3, 1)),
               enc.node("Relu", ["c1"], ["r1"]),
               enc.node("Flatten", ["r1"], ["f1"]),
               enc.node("Gemm", ["f1", "wg", "bg"], ["out"], attrs=[enc.attr_int("transB", 1)])],
        initializers=[enc.tensor("w1", w1), enc.tensor("wg", wg), enc.tensor("bg", bg)],
        inputs=[enc.value_info("x", [1, 3, h, w])],
        outputs=[enc.value_info("out", [1, 10])]), 1


def style_ops(rng):
    c = 4
    w1 = rng.standard_normal((c, c, 3, 3)).astype(np.float32) * 0.3
    gamma = rng.standard_normal(c).astype(np.float32)
    beta = rng.standard_normal(c).astype(np.float32)
    wd = rng.standard_normal((c, c, 4, 4)).astype(np.float32) * 0.2
    return enc.model(
        nodes=[enc.node("Conv", ["x", "w1"], ["c1"], attrs=_conv_attrs(3, 1)),
               enc.node("InstanceNormalization", ["c1", "g", "b"], ["n1"],
                        attrs=[enc.attr_float("epsilon", 1e-5)]),
               enc.node("Add", ["x", "n1"], ["a1"]),
               enc.node("ConvTranspose", ["a1", "wd"], ["d1"], attrs=[
                   enc.attr_ints("kernel_shape", [4, 4]), enc.attr_ints("strides", [2, 2]),
                   enc.attr_ints("pads", [1, 1, 1, 1])])],
        initializers=[enc.tensor("w1", w1), enc.tensor("g", gamma), enc.tensor("b", beta),
                      enc.tensor("wd", wd)],
        inputs=[enc.value_info("x", [1, c, 8, 8])],
        outputs=[enc.value_info("d1", [1, c, 16, 16])]), 1


def pool_depthwise(rng):
    c = 6
    wdw = rng.standard_normal((c, 1, 3, 3)).astype(np.float32) * 0.3
    return enc.model(
        nodes=[enc.node("Conv", ["x", "wdw"], ["c1"], attrs=_conv_attrs(3, 1, group=c)),
               enc.node("MaxPool", ["c1"], ["p1"], attrs=[
                   enc.attr_ints("kernel_shape", [2, 2]), enc.attr_ints("strides", [2, 2])]),
               enc.node("GlobalAveragePool", ["p1"], ["gap"])],
        initializers=[enc.tensor("wdw", wdw)],
        inputs=[enc.value_info("x", [1, c, 8, 8])],
        outputs=[enc.value_info("gap", [1, c, 1, 1])]), 2


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("make", [conv_relu, gemm_classifier, style_ops, pool_depthwise])
def test_hand_encoded_models_through_both_engines(rng, make, prec):
    data, batch = make(rng)
    jg, pg = j_convert(j_parse_onnx(data)), p_convert(p_parse_onnx(data))
    assert_same_graph(pg, jg)
    je = J.Engine.from_graph(jg, options(J, prec, batch_size=batch))
    pe = P.Engine.from_graph(pg, options(P, prec, batch_size=batch, device="cpu"))
    spec = pe.graph.nodes["x"].out_spec
    x = rng.standard_normal((batch, *spec.shape[1:])).astype(np.float32)
    close(pe.run_single(x).float().numpy(), np.asarray(je.run_single(x)), prec, make.__name__)


# --- imported trained models: plans and outputs ------------------------------

TRAINED = {
    # name: (artifact, backend, batch, what the native plan holds)
    "espcn": (zoo.ESPCN_TRAINED, "auto", 2),
    "mobilenetv2_cls10": (zoo.MOBILENETV2_TRAINED, "auto", 4),
    "resnet18_cls10": (zoo.RESNET18_TRAINED, "kernel", 4),
}
PLANS = ("chain_plan", "block_plan", "single_conv_plan", "kernel_conv_plan",
         "kernel_dense_plan")


def structure(fwd, graph):
    """A plan by structure, not by node name (the converter's names are
    its own): each chain's length and the ops it takes in, the number of
    blocks and their lengths, and the out_spec of each single conv, conv
    and dense on a layer kernel."""
    def shapes(names):
        return [graph.nodes[n].out_spec.shape for n in names]

    return {
        "chains": [[graph.nodes[n].op for n in m] for m in fwd.chain_plan.values()],
        "chain_out": [graph.nodes[m[-1]].out_spec.shape for m in fwd.chain_plan.values()],
        "blocks": [len(m) for m in fwd.block_plan.values()],
        "block_out": [graph.nodes[m[-1]].out_spec.shape for m in fwd.block_plan.values()],
        "single": shapes(fwd.single_conv_plan),
        "conv": shapes(fwd.kernel_conv_plan),
        "dense": shapes(fwd.kernel_dense_plan),
    }


def imported(pkg_export, pkg_parse_onnx, pkg_convert, graph):
    return pkg_convert(pkg_parse_onnx(pkg_export(graph)))


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(TRAINED))
def test_imported_trained_models_plan_as_jax_and_native(monkeypatch, rng, name, prec):
    """export_onnx -> parse_onnx -> convert_onnx_graph of each trained
    model: the port's plans of the imported graph equal the JAX planner's of
    the JAX import (SNN_AUTO_PALLAS_ANYWHERE=1) name by name and the native
    graph's by structure; ESPCN plans one chain (under BF16 of 4: the d2s2
    tail, tanh folded), MobileNetV2 13 blocks and its stem, ResNet18 under KERNEL 2
    chains, 10 single convs and the dense. The imported engine's output is
    the native engine's: bit for bit where the folded weights are the same
    (ESPCN), else within the limit (the classifiers' BatchNorm comes back
    as a node of its own and folds to weights an ulp away)."""
    monkeypatch.setenv("SNN_AUTO_PALLAS_ANYWHERE", "1")
    path, backend, batch = TRAINED[name]
    jg, pg = jparse(path), pparse(path)
    jg.infer_shapes()
    pg.infer_shapes()
    j_imp = imported(j_export, j_parse_onnx, j_convert, jg)
    p_imp = imported(p_export, p_parse_onnx, p_convert, pg)
    assert len(p_imp.nodes) > len(pg.nodes)  # activations come back as nodes
    native = P.Engine.from_graph(pparse(path), opts(P, prec, backend, batch_size=batch,
                                                    device="cpu"))
    eng = P.Engine.from_graph(p_imp, opts(P, prec, backend, batch_size=batch, device="cpu"))
    jfwd = J.Engine.from_graph(j_imp, opts(J, prec, backend, batch_size=batch)).model.forward
    fwd = eng.model.forward
    if backend == "kernel":  # the JAX chains the port's chain kernel declines run alone
        assert all(jfwd.chain_plan[h] == m for h, m in fwd.chain_plan.items())
    else:
        assert fwd.chain_plan == jfwd.chain_plan
        assert fwd.block_plan == jfwd.block_plan
    assert structure(fwd, eng.graph) == structure(native.model.forward, native.graph)
    counts = {k: len(getattr(fwd, k)) for k in PLANS}
    assert counts == {
        "espcn": dict(chain_plan=1, block_plan=0, single_conv_plan=0, kernel_conv_plan=0,
                      kernel_dense_plan=0),
        "mobilenetv2_cls10": dict(chain_plan=0, block_plan=13, single_conv_plan=1,
                                  kernel_conv_plan=0, kernel_dense_plan=0),
        "resnet18_cls10": dict(chain_plan=2, block_plan=0, single_conv_plan=10,
                               kernel_conv_plan=0, kernel_dense_plan=1),
    }[name]
    if name == "espcn":
        (members,) = fwd.chain_plan.values()
        assert [eng.graph.nodes[n].op for n in members] == [
            "Conv2D", "Conv2D", "Conv2D"] + (["Subpixel"] if prec == "bf16" else [])
    spec = native.graph.nodes[native.graph.input_names[0]].out_spec
    x = rng.random((batch, *spec.shape[1:]), dtype=np.float32)
    want = native.run_single(x)
    got = eng.run({eng.graph.input_names[0]: x})[eng.graph.output_names[0]]
    same_weights = [
        all(torch.equal(a, b) for a, b in zip(pa.values(), pb.values()))
        for pa, pb in zip(native.model.params.values(), eng.model.params.values())]
    if all(same_weights):
        assert torch.equal(got, want)
    else:  # BatchNorm folded from its own node: the weights differ by ulps
        assert name != "espcn"
        close(got.float().numpy(), want.float().numpy(), prec, name)


def test_onnx_nchw_dense_reorder_and_explicit_pads():
    """The converter's known trouble spots come back as the native graph
    has them: the Gemm after an NCHW Flatten is re-ordered to HWC rows
    (bit-equal to the native Dense), DepthToSpace is a Subpixel of scale 2,
    and explicit ONNX pads are padding tuples equal to 'same'."""
    pg = pparse(zoo.RESNET18_TRAINED)
    pg.infer_shapes()
    imp = imported(p_export, p_parse_onnx, p_convert, pg)
    dense = [n for n in imp.nodes.values() if n.op == "Dense"]
    assert len(dense) == 1 and np.array_equal(dense[0].params["weight"], pg.nodes["fc"].params["weight"])
    assert "_onnx_nchw_reorder" not in dense[0].attrs
    es = imported(p_export, p_parse_onnx, p_convert, P.build_model("espcn", h=16, w=24))
    (sub,) = [n for n in es.nodes.values() if n.op == "Subpixel"]
    assert sub.attr("scale") == 2
    convs = [n for n in es.nodes.values() if n.op == "Conv2D"]
    assert [n.attr("padding") for n in convs] == [(2, 2, 2, 2), (1, 1, 1, 1), (1, 1, 1, 1)]


def test_dynamic_input_dims_need_input_hw(rng):
    """An ONNX input of dynamic H/W converts at the given input_hw, as in
    the JAX converter; without one the converter raises (the JAX one
    asserts)."""
    w1 = rng.standard_normal((4, 1, 3, 3)).astype(np.float32)
    data = enc.model(
        nodes=[enc.node("Conv", ["x", "w1"], ["c1"], attrs=_conv_attrs(3, 1))],
        initializers=[enc.tensor("w1", w1)],
        inputs=[enc.value_info("x", [None, 1, None, None])],
        outputs=[enc.value_info("c1", [None, 4, None, None])])
    with pytest.raises(ValueError, match="input_hw"):
        p_convert(p_parse_onnx(data))
    assert_same_graph(p_convert(p_parse_onnx(data), input_hw=(10, 12)),
                      j_convert(j_parse_onnx(data), input_hw=(10, 12)))


def test_convert_cli_onnx_roundtrip(tmp_path, rng):
    """tests/test_onnx_roundtrip.py:84: .onnx in -> artifact out ->
    Engine.from_json runs it, here within the fp32 limit of the native
    engine; the JAX engine reads the port's artifact to the same output."""
    from shadernn_tpu_torch.tools.convert import main as convert_main

    g = P.build_model("espcn", h=16, w=16)
    g.infer_shapes()
    onnx_path = tmp_path / "espcn.onnx"
    p_export(g, str(onnx_path))
    out_path = tmp_path / "espcn.json"
    convert_main(["-f", str(onnx_path), "-o", str(out_path)])
    eng = P.Engine.from_json(out_path, P.EngineOptions(device="cpu"))
    x = rng.random((1, 16, 16, 1), dtype=np.float32)
    want = P.Engine.from_graph(P.build_model("espcn", h=16, w=16),
                               P.EngineOptions(device="cpu")).run_single(x).numpy()
    got = eng.run_single(x).numpy()
    close(got, want, "fp32", "onnx-cli-roundtrip")
    close(got, np.asarray(J.Engine.from_json(out_path, J.EngineOptions()).run_single(x)),
          "fp32", "jax reads the port's artifact")
    convert_main(["-f", str(onnx_path), "-o", str(tmp_path / "dec.json"), "-d"])
    assert (tmp_path / "dec_layers.json").exists() and (tmp_path / "dec_weights.bin").exists()
