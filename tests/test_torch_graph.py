"""The port's graph layer (shadernn_tpu_torch.graph, models) against the JAX
package's: same seeds give bit-identical graphs, the artifact parses to the
same nodes, and the fusion passes rewrite graphs the same way."""

import numpy as np
import pytest

import shadernn_tpu as J
from shadernn_tpu.graph import fusion as jfusion
from shadernn_tpu.graph.builder import GraphBuilder as JBuilder
from shadernn_tpu.graph.parser import parse_model_file as jparse
from shadernn_tpu.models import build_model as jbuild

import shadernn_tpu_torch as P
from shadernn_tpu_torch.graph import fusion as pfusion
from shadernn_tpu_torch.graph.builder import GraphBuilder as PBuilder
from shadernn_tpu_torch.graph.ir import Graph as PGraph, Node as PNode, TensorSpec as PSpec
from shadernn_tpu_torch.graph.parser import parse_model_file as pparse
from shadernn_tpu_torch.models.zoo import ESPCN_TRAINED


def describe(graph):
    """Everything a graph holds, in a form two packages can compare."""
    return {
        "inputs": list(graph.input_names),
        "outputs": list(graph.output_names),
        "nodes": [
            (n.name, n.op, list(n.inputs), dict(n.attrs),
             n.out_spec.shape if n.out_spec else None)
            for n in graph.nodes.values()
        ],
        "params": {
            (n.name, k): np.asarray(v) for n in graph.nodes.values() for k, v in n.params.items()
        },
    }


def assert_same_graph(pg, jg):
    a, b = describe(pg), describe(jg)
    assert a["inputs"] == b["inputs"] and a["outputs"] == b["outputs"]
    assert a["nodes"] == b["nodes"]
    assert a["params"].keys() == b["params"].keys()
    for key, v in a["params"].items():
        assert v.dtype == b["params"][key].dtype, key
        np.testing.assert_array_equal(v, b["params"][key], err_msg=str(key))


def port_copy(jg):
    """A port Graph holding the same nodes as JAX graph `jg` (for ops that
    only the JAX package's builder can make)."""
    g = PGraph(jg.name)
    for n in jg.nodes.values():
        g.add(PNode(n.name, n.op, list(n.inputs), dict(n.attrs),
                    {k: np.array(v) for k, v in n.params.items()}))
        if n.out_spec is not None:
            g.nodes[n.name].out_spec = PSpec(n.out_spec.shape, n.out_spec.dtype)
    g.output_names = list(jg.output_names)
    return g


@pytest.mark.parametrize("seed", [7767517, 3])
def test_build_espcn_matches_jax(seed):
    assert_same_graph(P.build_model("espcn", h=24, w=40, seed=seed),
                      jbuild("espcn", h=24, w=40, seed=seed))


def test_list_models():
    assert P.list_models() == ["espcn"]
    with pytest.raises(KeyError):
        P.build_model("resnet18")


@pytest.mark.parametrize("input_hw", [None, (36, 64)])
def test_parse_trained_artifact_matches_jax(input_hw):
    assert_same_graph(pparse(ESPCN_TRAINED, input_hw=input_hw),
                      jparse(ESPCN_TRAINED, input_hw=input_hw))


@pytest.mark.parametrize("source", ["built", "artifact"])
def test_optimize_matches_jax(source):
    if source == "built":
        pg, jg = P.build_model("espcn", h=24, w=40), jbuild("espcn", h=24, w=40)
    else:
        pg, jg = pparse(ESPCN_TRAINED, input_hw=(36, 64)), jparse(ESPCN_TRAINED, input_hw=(36, 64))
    assert pfusion.optimize(pg) == jfusion.optimize(jg)
    pg.infer_shapes(batch_size=2)
    jg.infer_shapes(batch_size=2)
    assert_same_graph(pg, jg)


def _pad_stride2_graph(builder_cls):
    b = builder_cls("pad_s2", seed=11)
    x = b.input(16, 20, 2)
    x = b.pad(x, 1, 1, 0, 2)
    x = b.conv2d(x, 4, 3, activation="relu")
    x = b.conv2d(x, 4, 3, stride=2, activation="relu")
    x = b.conv2d(x, 4, 3)
    b.activation(x, "sigmoid")
    return b.build(batch_size=2)


def test_pad_and_stride2_folds_match_jax_and_run(rng, fp32_threshold):
    """Pad folding and the stride-2 -> SpaceToDepth rewrite give the same
    graph in both packages, and the port runs the rewritten graph to the
    JAX engine's output."""
    pg, jg = _pad_stride2_graph(PBuilder), _pad_stride2_graph(JBuilder)
    assert_same_graph(pg, jg)
    counts = pfusion.optimize(pg)
    assert counts == jfusion.optimize(jg)
    assert counts["pad_folds"] == 1 and counts["stride2_folds"] == 1
    pg.infer_shapes(batch_size=2)
    jg.infer_shapes(batch_size=2)
    assert_same_graph(pg, jg)
    x = rng.random((2, 16, 20, 2), dtype=np.float32)
    want = np.asarray(J.Engine.from_graph(
        _pad_stride2_graph(JBuilder), J.EngineOptions(batch_size=2)).run_single(x))
    got = P.Engine.from_graph(
        _pad_stride2_graph(PBuilder), P.EngineOptions(batch_size=2, device="cpu")
    ).run_single(x).numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= fp32_threshold


def test_deconv2_fold_matches_jax_and_runs(rng, fp32_threshold):
    """The stride-2 deconv fold (Conv2DTranspose -> Conv2D + Subpixel) gives
    the same nodes in both packages; the port runs the folded graph to the
    JAX engine's output on the unfolded deconv."""
    b = JBuilder("deconv", seed=5)
    x = b.input(8, 10, 4)
    b.deconv(x, 3, 3, stride=2, activation="relu")
    jg = b.build(batch_size=2)
    x = rng.random((2, 8, 10, 4), dtype=np.float32)
    want = np.asarray(J.Engine.from_graph(
        jg, J.EngineOptions(batch_size=2), optimize=False).run_single(x))
    pg = port_copy(jg)
    assert pfusion.fold_deconv2_convs(pg) == jfusion.fold_deconv2_convs(jg) == 1
    assert_same_graph(pg, jg)
    got = P.Engine.from_graph(
        pg, P.EngineOptions(batch_size=2, device="cpu"), optimize=False
    ).run_single(x).numpy()
    assert got.shape == want.shape == (2, 16, 20, 3)
    assert np.max(np.abs(got - want)) <= fp32_threshold


def test_batchnorm_fold_matches_jax():
    """Attached BatchNorm statistics fold into the conv weights identically."""
    pg = pparse(ESPCN_TRAINED, input_hw=(8, 8))
    jg = jparse(ESPCN_TRAINED, input_hw=(8, 8))
    c = np.arange(16, dtype=np.float32)
    for g in (pg, jg):
        n = g.nodes["conv_2"]
        n.attrs["use_batchnorm"] = True
        n.params.update(bn_gamma=1 + c / 10, bn_beta=c / 7, bn_mean=c / 5, bn_variance=1 + c / 3)
    assert pfusion.fold_batchnorm(pg) == jfusion.fold_batchnorm(jg) == 1
    assert_same_graph(pg, jg)
