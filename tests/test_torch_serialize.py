"""The port's model writer (graph/serialize.py) against the JAX package's:
for every zoo builder (small frames) and every trained artifact, the JSON
and the weights `.bin` are byte-equal to the JAX `save_model`'s, inline and
decoupled; each package's parser loads the other's file to the same graph;
and the port's engine on the reloaded graph matches the JAX engine (XLA)
within the tests/conftest.py limits (0.01 fp32, 0.1 bf16, times
max(1, max|JAX|))."""

import json
import os

import numpy as np
import pytest

from shadernn_tpu.graph.parser import parse_model_file as jparse
from shadernn_tpu.graph.serialize import save_model as jsave
from shadernn_tpu.models import build_model as jbuild

import shadernn_tpu_torch as P
from shadernn_tpu_torch.graph.parser import parse_model_file as pparse
from shadernn_tpu_torch.graph.serialize import save_model as psave
from shadernn_tpu_torch.graph.serialize import serialize_graph

from test_torch_graph import assert_same_graph
from test_torch_zoo import ARTIFACTS, art_id, jparse_at, options, outputs_match, small_hw

# Small frames and widths, as tests/test_artifact.py builds them.
BUILDERS = [
    ("espcn", dict(h=16, w=24)),
    ("resnet18", dict(base_filters=16)),
    ("styletransfer", dict(h=32, w=32, num_res_blocks=1)),
    ("unet", dict(h=32, w=32, base_filters=4, depth=2)),
    ("mobilenetv2", dict(h=32, w=32, num_classes=10)),
    ("spatialdenoise", dict(h=16, w=24)),
    ("aidenoise", dict(h=32, w=32)),
    ("yolov3-tiny", dict(h=64, w=64, num_classes=2, max_detections=30, seed=3)),
]
# Inline JSON spells every weight out as text: YOLOv3-tiny's 8.7M weights
# come to 193 MB and 8 s a package, a StyleTransfer artifact's 1.7M to 37 MB
# and 3 s. Graphs of more than HEAVY weights have their decoupled files
# compared byte for byte, and their inline JSON with the weights left out.
HEAVY = 1_000_000
SOURCES = [pytest.param(("builder", name, kw), id=name) for name, kw in BUILDERS] + [
    pytest.param(("artifact", path, None), id=art_id(path)) for path in ARTIFACTS]
# The precision each source's engines are compared at (the artifacts at
# FP32): both are covered.
PRECISION = {"espcn": "bf16", "styletransfer": "bf16", "mobilenetv2": "bf16", "aidenoise": "bf16"}


def graphs(source):
    """(JAX graph, port graph) of one source, shape-inferred."""
    kind, name, kw = source
    if kind == "builder":
        jg, pg = jbuild(name, **kw), P.build_model(name, **kw)
    else:
        hw = small_hw(name)
        jg, pg = jparse_at(name, hw), pparse(name, input_hw=hw)
    jg.infer_shapes()
    pg.infer_shapes()
    return jg, pg


def source_id(source):
    kind, name, _ = source
    return name if kind == "builder" else art_id(name)


def read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("decouple", [False, True], ids=["inline", "decoupled"])
@pytest.mark.parametrize("source", SOURCES)
def test_save_model_bytes_equal_jax(tmp_path, source, decouple):
    jg, pg = graphs(source)
    if not decouple and sum(p.size for n in pg.nodes.values() for p in n.params.values()) > HEAVY:
        # the JSON text with the weights lists dropped: the same schema fields
        def strip(model):
            return json.dumps({k: {f: v for f, v in layer.items() if f != "weights"}
                               if isinstance(layer, dict) else layer
                               for k, layer in model.items()})

        from shadernn_tpu.graph.serialize import serialize_graph as jserialize

        assert strip(serialize_graph(pg)[0]) == strip(jserialize(jg)[0])
        return
    jsave(jg, str(tmp_path / "jax.json"), decouple=decouple)
    psave(pg, str(tmp_path / "port.json"), decouple=decouple)
    if decouple:
        for suffix in ("_layers.json", "_weights.bin"):
            assert read(tmp_path / f"jax{suffix}") == read(tmp_path / f"port{suffix}"), suffix
    else:
        assert read(tmp_path / "jax.json") == read(tmp_path / "port.json")


@pytest.mark.parametrize("source", SOURCES)
def test_each_parser_loads_the_others_file(tmp_path, rng, source):
    """The port's parser reads the JAX package's decoupled files, and the JAX
    parser the port's, to the graph the source holds; the port's engine on
    the reloaded graph against the JAX engine on the source graph."""
    jg, pg = graphs(source)
    jsave(jg, str(tmp_path / "jax.json"), decouple=True)
    psave(pg, str(tmp_path / "port.json"), decouple=True)
    hw = (jg.nodes[jg.input_names[0]].out_spec.h, jg.nodes[jg.input_names[0]].out_spec.w)
    p_from_j = pparse(tmp_path / "jax_layers.json")
    j_from_j = jparse(tmp_path / "jax_layers.json")
    assert_same_graph(p_from_j, j_from_j)
    assert_same_graph(p_from_j, jparse(tmp_path / "port_layers.json"))
    assert (p_from_j.nodes[p_from_j.input_names[0]].attrs["height"],
            p_from_j.nodes[p_from_j.input_names[0]].attrs["width"]) == hw

    outputs_match(j_from_j, p_from_j, PRECISION.get(source_id(source), "fp32"), rng,
                  outputs=("head1", "head2", "yolo") if "yolo" in source_id(source) else None)


def test_save_model_drops_a_batchnorm_leaky_alpha_as_jax_does(tmp_path):
    """Both writers keep `leakyReluAlpha` on Conv2D and Activation layers
    only: YOLOv3-tiny's BatchNormalization layers (leaky_relu, alpha 0.1)
    reload with the parser's default 0.3, in either package (ROADMAP C6).
    The port writes the JAX package's bytes, so it keeps the loss."""
    kw = dict(h=64, w=64, num_classes=2, max_detections=30, seed=3)
    for build, save, parse, tag in ((jbuild, jsave, jparse, "jax"),
                                    (P.build_model, psave, pparse, "port")):
        g = build("yolov3-tiny", **kw)
        save(g, str(tmp_path / f"{tag}.json"), decouple=True)
        back = parse(tmp_path / f"{tag}_layers.json")
        assert g.nodes["l0_bn"].attr("leaky_alpha") == 0.1
        assert back.nodes["l0_bn"].attr("activation") == "leaky_relu"
        assert back.nodes["l0_bn"].attr("leaky_alpha") == 0.3, tag


@pytest.mark.parametrize("decouple", [False, True], ids=["inline", "decoupled"])
def test_engine_from_json_of_a_saved_graph(tmp_path, rng, decouple):
    """save_model -> Engine.from_json: the reloaded engine's output is the
    native engine's, bit for bit (same plan, same weights), and its plans
    are the native ones."""
    g = P.build_model("espcn", h=16, w=24)
    native = P.Engine.from_graph(P.build_model("espcn", h=16, w=24),
                                 options(P, "bf16", device="cpu"))
    psave(g, str(tmp_path / "espcn.json"), decouple=decouple)
    path = tmp_path / ("espcn_layers.json" if decouple else "espcn.json")
    assert os.path.exists(path) and (decouple == os.path.exists(tmp_path / "espcn_weights.bin"))
    eng = P.Engine.from_json(path, options(P, "bf16", device="cpu"))
    assert eng.model.forward.chain_plan == native.model.forward.chain_plan == {
        "conv_1": ["conv_1", "conv_2", "conv_3", "subpixel"]}
    x = rng.random((1, 16, 24, 1), dtype=np.float32)
    assert np.array_equal(eng.run_single(x).numpy(), native.run_single(x).numpy())


def test_save_model_infers_shapes_first(tmp_path):
    """A parsed graph not yet shape-inferred is written as the JAX writer
    writes it after infer_shapes (its pooled and normalized layers need
    their widths)."""
    from shadernn_tpu_torch.models import zoo

    jg = jparse(zoo.MOBILENETV2_TRAINED)
    jg.infer_shapes()
    jsave(jg, str(tmp_path / "jax.json"), decouple=True)
    psave(pparse(zoo.MOBILENETV2_TRAINED), str(tmp_path / "port.json"), decouple=True)
    for suffix in ("_layers.json", "_weights.bin"):
        assert read(tmp_path / f"jax{suffix}") == read(tmp_path / f"port{suffix}"), suffix
