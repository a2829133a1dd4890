"""The rest of the model zoo in the port (SpatialDenoise, AIDenoise, U-Net,
StyleTransfer and its five styles, YOLOv3-tiny), each against the JAX
package on the CPU: the builders' graphs, every trained artifact through
Engine.from_json, FP32 / BF16 / INT8 outputs against the JAX engine, the
kernel plans against the JAX planner's, the runners, and the JAX package's
accuracy gates on the trained weights."""

import glob
import os
import tempfile

import numpy as np
import pytest
import torch

import shadernn_tpu as J
from shadernn_tpu.engine.compile import compile_graph as j_compile
from shadernn_tpu.engine.compile import resolve_backend as j_backend
from shadernn_tpu.graph import fusion as jfusion
from shadernn_tpu.graph.parser import parse_model_file as jparse
from shadernn_tpu.models import build_model as jbuild
from shadernn_tpu.models import list_models as jlist
from shadernn_tpu.ops.conv import pallas_chain_supported
from shadernn_tpu.quant.quantize import quantize_graph_weights as j_quantize

import shadernn_tpu_torch as P
from shadernn_tpu_torch.engine.compile import compile_graph as p_compile
from shadernn_tpu_torch.graph import fusion as pfusion
from shadernn_tpu_torch.graph.parser import parse_model_file as pparse
from shadernn_tpu_torch.models import zoo
from shadernn_tpu_torch.models.runners import RUNNERS, make_engine, run_model
from shadernn_tpu_torch.tools.dump_reader import read_dump
from shadernn_tpu_torch.utils.metrics import detections_agree, psnr

from test_torch_graph import assert_same_graph

TOL = {"fp32": 0.01, "bf16": 0.1, "int8": 0.1}  # tests/conftest.py thresholds
ARTIFACTS = sorted(glob.glob(os.path.join(zoo.ARTIFACTS, "*_trained_layers.json")))


def close(got, want, prec, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL[prec] * max(1.0, float(np.abs(want).max())), (what, err)


def options(pkg, prec, **kw):
    return pkg.EngineOptions(precision=getattr(pkg.Precision, prec.upper()), **kw)


def input_of(graph, rng, batch=2):
    """A frame batch for the (shape-inferred) graph's one input."""
    (name,) = graph.input_names
    return rng.random((batch, *graph.nodes[name].out_spec.shape[1:]), dtype=np.float32)


def engines(jgraph, pgraph, prec, batch=2):
    """(JAX engine on XLA, port engine on the CPU) of the same graph. INT8:
    the JAX engine of the graph quantized as its INT8 gates quantize it,
    with chain_a8 'off' (fault C1 is not copied)."""
    jopts = options(J, prec, batch_size=batch, **({"chain_a8": "off"} if prec == "int8" else {}))
    je = J.Engine.from_graph(jgraph, jopts)
    if prec == "int8":
        g = je.model.graph
        j_quantize(g)
        je = J.Engine.from_graph(g, jopts)
    pe = P.Engine.from_graph(pgraph, options(P, prec, batch_size=batch, device="cpu"))
    return je, pe


def outputs_match(jgraph, pgraph, prec, rng, batch=2, outputs=None, x=None):
    """Every output of the port engine against the JAX engine's on one
    batch. A YOLO head's detections are matched box to box
    (detections_agree); at FP32 also row by row."""
    if outputs:
        jgraph.output_names, pgraph.output_names = list(outputs), list(outputs)
    je, pe = engines(jgraph, pgraph, prec, batch)
    x = input_of(pe.graph, rng, batch) if x is None else x
    name = pe.graph.input_names[0]
    want, got = je.run({name: x}), pe.run({name: x})
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.isfinite(got[k]).all()
        if pe.graph.nodes[k].op == "YOLO":
            detections_agree(got[k].numpy(), np.asarray(want[k]), TOL[prec])
            if prec != "fp32":
                continue
        close(got[k].float().numpy(), want[k], prec, k)
    return pe


def jax_plans(jgraph, prec, batch=2):
    """The JAX planner's (chain plan, single-conv plan): a conv that the
    planner's chain gate admits and no chain of two or more takes runs
    alone on the haloed kernel (engine/compile.py)."""
    opts = options(J, prec, batch_size=batch)
    fwd = j_compile(jgraph, opts).forward
    chained = {n for m in fwd.chain_plan.values() for n in m}
    singles = [n.name for n in jgraph.toposort()
               if n.op == "Conv2D" and len(n.inputs) == 1 and n.name not in chained
               and j_backend(n, jgraph, opts) == J.BackendKind.PALLAS
               and pallas_chain_supported(n, jgraph.nodes[n.inputs[0]].out_spec.c)]
    return fwd.chain_plan, singles


def plans_match(monkeypatch, jgraph, pgraph, prec, batch=2):
    monkeypatch.setenv("SNN_AUTO_PALLAS_ANYWHERE", "1")
    for g, fusion in ((jgraph, jfusion), (pgraph, pfusion)):
        fusion.optimize(g)
        g.infer_shapes(batch_size=batch)
    if prec == "int8":
        j_quantize(jgraph)
        from shadernn_tpu_torch.quant.quantize import quantize_graph_weights

        quantize_graph_weights(pgraph)
    chains, singles = jax_plans(jgraph, prec, batch)
    fwd = p_compile(pgraph, options(P, prec, batch_size=batch, device="cpu")).forward
    assert fwd.chain_plan == chains
    assert fwd.single_conv_plan == singles
    assert fwd.block_plan == {} and fwd.kernel_conv_plan == [] and fwd.kernel_dense_plan == []
    return fwd


# --- builders ----------------------------------------------------------------


@pytest.mark.parametrize("name", jlist())
def test_build_model_every_zoo_name_matches_jax(name):
    """Every name of the JAX zoo, the five styles included, at the runner's
    geometry: the same graph (nodes, attributes, weights)."""
    cfg = RUNNERS[name]
    kw = dict(h=cfg.height, w=cfg.width) if name not in ("mobilenetv2",) else {}
    assert_same_graph(P.build_model(name, **kw), jbuild(name, **kw))


SEEDED = {
    "unet": dict(h=32, w=32, base_filters=4, depth=2, seed=3),
    "styletransfer": dict(h=24, w=24, num_res_blocks=1, seed=3),
    "yolov3-tiny": dict(h=64, w=64, num_classes=2, max_detections=30, seed=3),
    "spatialdenoise": dict(h=20, w=28, features=8, depth=3, merge_source=True, seed=3),
    "aidenoise": dict(h=20, w=28, features=8, depth=2, seed=3),
}


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(SEEDED))
def test_seeded_builder_matches_jax(rng, name, prec):
    """The seeded builders at reduced size (AIDenoise and SpatialDenoise at
    widths without an artifact; SpatialDenoise with its second input),
    every output against the JAX engine."""
    jg, pg = jbuild(name, **SEEDED[name]), P.build_model(name, **SEEDED[name])
    assert_same_graph(pg, jg)
    if name == "spatialdenoise":
        je, pe = engines(jg, pg, prec)
        assert pe.graph.input_names == ["input", "source"]
        feeds = {"input": rng.random((2, 20, 28, 1), dtype=np.float32),
                 "source": rng.random((2, 20, 28, 4), dtype=np.float32)}
        got, want = pe.run(feeds)["merge"], je.run(feeds)["merge"]
        close(got.float().numpy(), want, prec)
        chroma = torch.from_numpy(feeds["source"][..., 1:]).to(pe.options.precision.activation_dtype)
        assert torch.equal(got[..., 1:], chroma.float())
        return
    outputs_match(jg, pg, prec, rng,
                  outputs=("head1", "head2", "yolo") if name == "yolov3-tiny" else None)


@pytest.mark.parametrize("name,prec", [
    (name, prec) for name in sorted(SEEDED) for prec in ("fp32", "bf16", "int8")
    if prec != "int8" or name in ("unet", "spatialdenoise", "aidenoise")])
def test_seeded_plans_match_jax(monkeypatch, name, prec):
    """INT8 on the denoisers, as the JAX package's INT8 gates run it."""
    plans_match(monkeypatch, jbuild(name, **SEEDED[name]), P.build_model(name, **SEEDED[name]),
                prec)


# --- the trained artifacts --------------------------------------------------

def small_hw(path):
    """A small frame for an artifact: the zoo's and ESPCN's are fully
    convolutional; the classifiers keep their 32x32."""
    stem = os.path.basename(path)[: -len("_trained_layers.json")]
    if stem.startswith("styletransfer"):
        return (24, 24)
    return {"yolov3_tiny": (64, 64), "unet": (32, 32), "aidenoise": (20, 28),
            "spatialdenoise": (20, 28), "espcn_2x": (20, 28)}.get(stem)


def test_every_artifact_is_covered():
    names = {os.path.basename(p)[: -len("_trained_layers.json")] for p in ARTIFACTS}
    assert {"aidenoise", "spatialdenoise", "unet", "styletransfer", "yolov3_tiny"} <= names
    assert {f"styletransfer_{s}512" for s in zoo.STYLES} <= names
    assert len(ARTIFACTS) == 13
    assert {zoo.SPATIALDENOISE_TRAINED, zoo.AIDENOISE_TRAINED, zoo.UNET_TRAINED,
            zoo.STYLETRANSFER_TRAINED, zoo.YOLOV3_TINY_TRAINED,
            *zoo.STYLE512_TRAINED.values()} <= set(ARTIFACTS)


@pytest.mark.parametrize("path", ARTIFACTS, ids=lambda p: os.path.basename(p).split("_trained")[0])
def test_from_json_every_artifact_matches_jax(rng, path):
    """Engine.from_json loads every trained artifact of the repo; at FP32
    its output is the JAX engine's (the classifiers' and ESPCN's at their
    own size, the zoo's retargeted to a small frame)."""
    hw = small_hw(path)
    jg, pg = jparse(path, input_hw=hw), pparse(path, input_hw=hw)
    assert_same_graph(pg, jg)
    je = J.Engine.from_json(path, options(J, "fp32", batch_size=2), input_hw=hw)
    pe = P.Engine.from_json(path, options(P, "fp32", batch_size=2, device="cpu"), input_hw=hw)
    x = input_of(pe.graph, rng)
    close(pe.run_single(x).float().numpy(), np.asarray(je.run_single(x)), "fp32", path)


ZOO_ARTIFACTS = [zoo.SPATIALDENOISE_TRAINED, zoo.AIDENOISE_TRAINED, zoo.UNET_TRAINED,
                 zoo.STYLETRANSFER_TRAINED, zoo.STYLE512_TRAINED["candy"],
                 zoo.YOLOV3_TINY_TRAINED]
DENOISERS = ZOO_ARTIFACTS[:3]


def art_id(p):
    return os.path.basename(p).split("_trained")[0]


def with_int8_on_denoisers(precs):
    return [pytest.param(path, prec, id=f"{art_id(path)}-{prec}") for path in ZOO_ARTIFACTS
            for prec in precs if prec != "int8" or path in DENOISERS]


@pytest.mark.parametrize("path,prec", with_int8_on_denoisers(("bf16", "int8")))
def test_trained_zoo_matches_jax_at_low_precision(rng, path, prec):
    """BF16 for every zoo artifact (YOLO on its raw head features and on its
    detections, on 4 of its gate's scenes at 256x256), INT8 weight-only for
    the three denoisers."""
    if path == zoo.YOLOV3_TINY_TRAINED:
        from shadernn_tpu_torch.tools.train_yolo import synth_scenes

        x, _ = synth_scenes(np.random.default_rng(424242), 4)
        outputs_match(jparse(path), pparse(path), prec, rng, batch=4,
                      outputs=("head1", "head2", "yolo"), x=x)
        return
    hw = small_hw(path)
    outputs_match(jparse(path, input_hw=hw), pparse(path, input_hw=hw), prec, rng)


PLANS = {
    art_id(zoo.SPATIALDENOISE_TRAINED): ({"enc": ["enc", "mid0", "mid1", "residual"]}, []),
    art_id(zoo.AIDENOISE_TRAINED): ({"down": ["down", "core0", "core1", "core2", "expand"]}, []),
    art_id(zoo.UNET_TRAINED): ({"enc0_conv1": ["enc0_conv1", "enc0_conv2"],
                                "enc1_conv1": ["enc1_conv1", "enc1_conv2"],
                                "dec0_conv1": ["dec0_conv1", "dec0_conv2"]}, ["dec1_conv2"]),
    art_id(zoo.STYLETRANSFER_TRAINED): ({}, ["stem_conv", "head"]),
    art_id(zoo.STYLE512_TRAINED["candy"]): ({}, ["stem_conv", "head"]),
    art_id(zoo.YOLOV3_TINY_TRAINED): ({}, ["l0_conv"]),
}


@pytest.mark.parametrize("path,prec", with_int8_on_denoisers(("fp32", "bf16", "int8")))
def test_trained_zoo_plans_match_jax(monkeypatch, path, prec):
    """The chain and single-conv plans of each trained model equal the JAX
    planner's (AUTO, SNN_AUTO_PALLAS_ANYWHERE=1): a chain head fed by
    SpaceToDepth (AIDenoise), the d2s2 tail under BF16 and INT8 only, tail
    none under BF16 (U-Net), chain outputs with two consumers (U-Net's
    skips), the c1 tail (SpatialDenoise)."""
    hw = small_hw(path)
    fwd = plans_match(monkeypatch, jparse(path, input_hw=hw), pparse(path, input_hw=hw), prec)
    chains, singles = PLANS[art_id(path)]
    if path == zoo.AIDENOISE_TRAINED and prec != "fp32":
        chains = {"down": chains["down"] + ["up"]}
    assert (fwd.chain_plan, fwd.single_conv_plan) == (chains, singles)


def test_plans_of_a_two_input_graph_under_auto(monkeypatch):
    """SpatialDenoise with its second input (Calculate merge) under AUTO:
    the chain plan is the one-input model's."""
    kw = dict(h=20, w=28, merge_source=True)
    fwd = plans_match(monkeypatch, jbuild("spatialdenoise", **kw),
                      P.build_model("spatialdenoise", **kw), "bf16")
    assert fwd.chain_plan == PLANS["spatialdenoise"][0]


def test_int8_mid_graph_head_differs_from_jax_auto_only_by_c1(monkeypatch):
    """AIDenoise's chain head is fed by SpaceToDepth: under INT8 with
    chain_a8 'auto' and no calibration the port gives it no int8 step (the
    JAX package clips it to +-1, fault C1); its other layers follow relus,
    so no layer of the chain runs int8 activations."""
    pe = P.Engine.from_json(zoo.AIDENOISE_TRAINED, options(P, "int8", batch_size=2, device="cpu"),
                            input_hw=(20, 28))
    specs = pe.model.forward.chain_specs["down"]
    assert len(specs) == 5 and not any(s.in_q for s in specs)


# --- the trained models' gates on the CPU ------------------------------------


@pytest.mark.parametrize("path", DENOISERS, ids=art_id)
def test_trained_denoisers_meet_the_jax_gates(path):
    """tests/test_accuracy_denoiser.py's gates through the port: FP32 PSNR
    over the noisy input's + 3 dB and over 26 dB on noisy_pairs(seed
    20260820, 8, 96), BF16 within 1 dB, INT8 within 1.5 dB; FP32 equal to
    the JAX engine's PSNR within 0.01 dB."""
    from shadernn_tpu_torch.tools.train_denoiser import noisy_pairs

    x, y = noisy_pairs(np.random.default_rng(20260820), 8, 96)
    db = {prec: psnr(P.Engine.from_json(path, options(P, prec, batch_size=8, device="cpu"),
                                        input_hw=(96, 96)).run_single(x), y)
          for prec in ("fp32", "bf16", "int8")}
    want = psnr(np.asarray(J.Engine.from_json(path, options(J, "fp32", batch_size=8),
                                              input_hw=(96, 96)).run_single(x)), y)
    assert abs(db["fp32"] - want) < 0.01
    assert db["fp32"] > psnr(x, y) + 3.0 and db["fp32"] > 26.0, db
    assert db["bf16"] > db["fp32"] - 1.0 and db["int8"] > db["fp32"] - 1.5, db


def test_trained_yolo_detections_and_map_match_jax():
    """The trained detector on 8 of the gate's scenes: the raw head
    features, the detections (N, 100, 6) and the mAP equal to the JAX
    engine's at FP32."""
    from shadernn_tpu_torch.tools.train_yolo import NUM_CLASSES, synth_scenes
    from shadernn_tpu_torch.utils.metrics import mean_average_precision

    x, gts = synth_scenes(np.random.default_rng(424242), 8)
    outs = ("head1", "head2", "yolo")
    jg, pg = jparse(zoo.YOLOV3_TINY_TRAINED), pparse(zoo.YOLOV3_TINY_TRAINED)
    jg.output_names, pg.output_names = list(outs), list(outs)
    je, pe = engines(jg, pg, "fp32", batch=8)
    want, got = je.run({"input": x}), pe.run({"input": x})
    for k in outs:
        close(got[k].numpy(), want[k], "fp32", k)
    worst = detections_agree(got["yolo"].numpy(), np.asarray(want["yolo"]), TOL["fp32"])
    assert worst["unmatched"] == 0 and worst["kept"] > 8, worst
    maps = [mean_average_precision([d[d[:, 1] > 0] for d in np.asarray(o["yolo"])], gts,
                                   NUM_CLASSES) for o in (want, got)]
    assert maps[0] == maps[1] and maps[1] > 0.3, maps


# --- runners -------------------------------------------------------------------


def test_runners_match_jax():
    from shadernn_tpu.models.runners import RUNNERS as JRUNNERS

    assert sorted(RUNNERS) == sorted(JRUNNERS)
    for name, cfg in RUNNERS.items():
        j = JRUNNERS[name]
        assert (cfg.model, cfg.height, cfg.width, cfg.channels, cfg.model_type, cfg.means,
                cfg.norms, cfg.luma_only, cfg.build_kwargs) == (
            j.model, j.height, j.width, j.channels, j.model_type, j.means, j.norms,
            j.luma_only, j.build_kwargs), name


def test_run_model_postprocess():
    cls = run_model("resnet18", precision=P.Precision.FP32, inner_loops=2, device="cpu")
    assert cls["output_shape"] == (1, 10) and cls["class_index"].shape == (1,)
    det = run_model("yolov3-tiny", precision=P.Precision.FP32, inner_loops=1, device="cpu")
    assert det["output_shape"] == (1, 100, 6)
    assert det["detections"].ndim == 2 and (det["detections"][:, 1] > 0).all()
    eng = make_engine("styletransfer-candy", P.Precision.BF16, device="cpu")
    assert eng.graph.nodes["input"].out_spec.shape == (1, 224, 224, 3)
    assert eng.model.forward.single_conv_plan == ["stem_conv", "head"]
    with pytest.raises(FileNotFoundError):  # image_path is loaded (test_torch_serving.py)
        run_model("espcn", image_path="no_such_frame.png", device="cpu")
    with tempfile.TemporaryDirectory() as tmp:  # the layer dumps, read back
        dumped = run_model("espcn", precision=P.Precision.FP32, inner_loops=1, dump_dir=tmp,
                           device="cpu")["dumps"]
        assert sorted(dumped) == ["conv_1", "conv_2", "conv_3", "subpixel"]
        (model_dir,) = {os.path.dirname(p) for p in dumped.values()}  # <dump_dir>/<model>
        assert os.path.dirname(model_dir) == tmp
        out = read_dump(dumped["subpixel"])
        assert out.shape == (1, 1080, 1920, 1) and out.dtype == np.float32
        assert np.array_equal(read_dump(dumped["conv_1"]), np.load(dumped["conv_1"]))
