"""The plain reference against the port, at small sizes on the CPU."""

import json
import logging
import os

import pytest
import torch

from benchmark.harness import check, detections, spec, traffic
from conftest import ROOT, yolo_config

CELLS = {"espcn-2x-540p-bf16": "espcn-540p-b8",
         "styletransfer-candy-512-bf16": "styletransfer-candy-512-b4"}


def config_of(name):
    return yolo_config() if name == "yolov3-tiny" else spec.load_cell(CELLS[name]).config


@pytest.mark.parametrize("config_name", sorted(CELLS) + ["yolov3-tiny"])
def test_layers_match_the_artifact(config_name):
    config = config_of(config_name)
    layers = spec.model(config).layers
    with open(os.path.join(ROOT, config["artifact"])) as f:
        art = json.load(f)
    kinds = {"Conv2D": "conv", "Conv2DTranspose": "conv_transpose",
             "InstanceNormalization": "instance_norm", "MaxPooling2D": "max_pool",
             "UpSampling2D": "upsample", "Concatenate": "concat", "YOLO": "yolo"}
    planes = {"conv", "conv_transpose", "instance_norm"}
    theirs = [art[f"Layer_{i}"] for i in range(art["numLayers"]["count"])]
    theirs = [(kinds[a["type"]], a.get("kernel_size", a.get("pool_size")),
               a.get("strides", 1), a["outputPlanes"] if kinds[a["type"]] in planes else None)
              for a in theirs if a["type"] in kinds]
    mine = [(l["op"], l.get("k"), l.get("stride", 1),
             l.get("cout", l.get("c")) if l["op"] in planes else None)
            for l in layers if l["op"] in kinds.values()]
    assert mine == theirs


def test_a_branched_model_is_wired_as_the_artifact():
    """Every layer of the YOLOv3-tiny reference takes the inputs that its
    namesake in the artifact takes: the previous layer's, or its `from`."""
    config = yolo_config()
    with open(os.path.join(ROOT, config["artifact"])) as f:
        art = json.load(f)
    theirs = [art[f"Layer_{i}"] for i in range(art["numLayers"]["count"])]
    names = [a["name"] for a in theirs]
    theirs = {a["name"]: [names[i] for i in a["inputId"]] for a in theirs[1:]}
    mine, last = {}, names[0]
    for layer in spec.model(config).layers:
        mine[layer["name"]] = list(layer.get("from", [last]))
        last = layer["name"]
    assert mine == theirs


@pytest.mark.parametrize("config_name,hw", [("espcn-2x-540p-bf16", (20, 28)),
                                            ("styletransfer-candy-512-bf16", (24, 20))])
def test_reference_equals_the_port_at_fp32(config_name, hw):
    from shadernn_tpu_torch import Engine, EngineOptions, Precision
    from shadernn_tpu_torch.image.ingest import ingest_frames

    config = spec.load_cell(CELLS[config_name]).config
    c = config["input"]["channels"]
    ref = check.reference_model(ROOT, config, spec.model(config), torch.device("cpu"))
    raw = traffic.device_frames(31, 2, hw[0], hw[1], c, "cpu")
    logging.disable(logging.INFO)
    try:
        eng = Engine.from_json(os.path.join(ROOT, config["artifact"]),
                               EngineOptions(precision=Precision.FP32, batch_size=2, device="cpu"),
                               input_hw=hw)
    finally:
        logging.disable(logging.NOTSET)
    ing = config["ingest"]
    x = ingest_frames(raw, means=tuple(ing["means"]), norms=tuple(ing["norms"]),
                      dtype_name="float32")
    got = eng.run_single(x)
    want = ref(raw)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() < 1e-4 * max(1.0, want.abs().max().item())


def test_the_weight_stream_is_read_whole():
    from benchmark.reference import plain

    config = spec.load_cell("espcn-540p-b8").config
    model = spec.model(config)
    path = plain.artifact_weights(ROOT, config)
    plain.read_weights(model, path)
    with pytest.raises(ValueError, match="left over"):
        plain.read_weights(model._replace(layers=model.layers[:2]), path)
    wider = [dict(l, cout=l["cout"] * 2) if l["op"] == "conv" else l for l in model.layers]
    with pytest.raises(ValueError, match="ends"):
        plain.read_weights(model._replace(layers=wider), path)


def test_yolo_reference_equals_the_port_at_fp32():
    """The heads value by value under the bound above; the detections row to
    row against the reference's decode and NMS of the port's own heads,
    which take every decision from the same numbers: every row paired, the
    scores and boxes to float32's rounding."""
    from benchmark.harness.program import Program
    from benchmark.reference import plain

    config = yolo_config(precision="fp32")
    model = spec.model(config)
    ref = check.reference_model(ROOT, config, model, torch.device("cpu"))
    raw = traffic.device_frames(37, 2, 256, 256, 3, "cpu")
    logging.disable(logging.INFO)
    try:
        got = Program(ROOT, config, 2, "cpu").step("dispatch")(raw)
    finally:
        logging.disable(logging.NOTSET)
    want = ref(raw)
    assert sorted(got) == sorted(want) == ["head1", "head2", "yolo"]
    for name in ("head1", "head2"):
        assert got[name].shape == want[name].shape
        scale = max(1.0, want[name].abs().max().item())
        assert (got[name] - want[name]).abs().max().item() < 1e-4 * scale
    mine = plain.layer_forward(model, "yolo", [got["head1"], got["head2"]])
    n = detections.compare(got["yolo"].numpy(), mine.numpy())
    assert n["det_rows"] > 10 and n["det_unmatched"] == 0
    assert n["det_score_err"] < 1e-6 and n["det_box_err"] < 1e-5
    numbers = check.compare(ref, [(raw, got)], torch.device("cpu"), config, model)
    assert numbers["frames"] == 2 and numbers["det_unmatched"] == 0
    assert numbers["rel_rms_err"] < 1e-4 and numbers["det_rows"] == n["det_rows"]


# The reference's outputs of ESPCN and StyleTransfer-candy, taken with the
# harness before layers could branch: its code for them is unchanged.
BEFORE = {
    "espcn-540p-b8": ((20, 28), (2, 40, 56, 1), 2302.806687953358, 2341.1803083847626,
                      [0.738551139831543, 0.48530420660972595, 0.5548791289329529,
                       0.49959999322891235]),
    "styletransfer-candy-512-b4": ((24, 20), (2, 24, 20, 3), 3049.9244004786015,
                                   3049.9244004786015,
                                   [0.6508097648620605, 0.3203984498977661, 0.40893885493278503,
                                    0.723662793636322]),
}


@pytest.mark.parametrize("cell", sorted(BEFORE))
def test_the_reference_of_a_chain_is_as_it_was(cell):
    hw, shape, total, abs_total, picks = BEFORE[cell]
    config = spec.load_cell(cell).config
    ref = check.reference_model(ROOT, config, spec.model(config), torch.device("cpu"))
    y = ref(traffic.device_frames(31, 2, hw[0], hw[1], config["input"]["channels"], "cpu"))
    y = y.double()
    assert tuple(y.shape) == shape
    assert y.sum().item() == pytest.approx(total, rel=1e-6)
    assert y.abs().sum().item() == pytest.approx(abs_total, rel=1e-6)
    assert y.flatten()[[0, 7, 101, -1]].tolist() == pytest.approx(picks, abs=1e-6)
