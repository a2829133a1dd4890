"""The plain reference against the port, at small sizes on the CPU."""

import json
import logging
import os

import pytest
import torch

from benchmark.harness import check, spec, traffic
from conftest import ROOT

CELLS = {"espcn-2x-540p-bf16": "espcn-540p-b8",
         "styletransfer-candy-512-bf16": "styletransfer-candy-512-b4"}


@pytest.mark.parametrize("config_name", sorted(CELLS))
def test_layers_match_the_artifact(config_name):
    config = spec.load_cell(CELLS[config_name]).config
    layers = spec.model(config).layers
    with open(os.path.join(ROOT, config["artifact"])) as f:
        art = json.load(f)
    kinds = {"Conv2D": "conv", "Conv2DTranspose": "conv_transpose",
             "InstanceNormalization": "instance_norm"}
    theirs = [art[f"Layer_{i}"] for i in range(art["numLayers"]["count"])]
    theirs = [(kinds[a["type"]], a.get("kernel_size"), a.get("strides", 1), a["outputPlanes"])
              for a in theirs if a["type"] in kinds]
    mine = [(l["op"], l.get("k"), l.get("stride", 1), l.get("cout", l.get("c")))
            for l in layers if l["op"] in kinds.values()]
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
