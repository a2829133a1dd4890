"""YOLOv3-tiny at darknet's published widths (80 classes, 416x416) on the
port's normal path, on the CPU.

- The seeded 80-class artifact (`tools/seeded_artifact.py`): the tool
  regenerates the committed files byte for byte, 8,849,182 weight values.
- ROADMAP C9: a YOLO node's `net_hw` follows `input_hw`, so the boxes of an
  artifact parsed at another frame are decoded at that frame.
- The port against the benchmark's plain reference
  (`benchmark/reference/yolov3_tiny.py` on `plain.py`, which import no JAX
  and nothing of the port) on the seeded artifact at 96x96 b2, FP32 and
  BF16: the heads value by value; the detections row to row against the
  reference's decode and NMS of the port's own heads, every row paired.
- Planted faults (a score cutoff of 0.38, an NMS IoU of 0.48, `net_hw` 256)
  fail that check.
"""

import copy
import hashlib
import json
import logging
import os

import numpy as np
import pytest
import torch

import shadernn_tpu_torch as P
from shadernn_tpu_torch.graph.parser import parse_model_file
from shadernn_tpu_torch.models import zoo
from shadernn_tpu_torch.ops.yolo import decode_grid, nms_fixed
from shadernn_tpu_torch.tools import seeded_artifact

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "yolov3-tiny-416-b8"
WEIGHTS_SHA256 = "540700aa65e56351d83fdfbde897a209641678bb7f0d3df938f9c3ec3a2bad7f"


def sha256(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_the_tool_regenerates_the_committed_artifact(tmp_path):
    lpath, wpath = seeded_artifact.write(str(tmp_path))
    committed = seeded_artifact.LAYERS_JSON[: -len("_layers.json")] + "_weights.bin"
    assert sha256(wpath) == sha256(committed) == WEIGHTS_SHA256
    assert os.path.getsize(wpath) == 4 * seeded_artifact.WEIGHT_VALUES == 4 * 8_849_182
    with open(lpath) as a, open(seeded_artifact.LAYERS_JSON) as b:
        assert json.load(a) == json.load(b)
    assert sha256(seeded_artifact.write(str(tmp_path / "again"))[1]) == WEIGHTS_SHA256
    other = seeded_artifact.write(str(tmp_path / "other"), seed=seeded_artifact.SEED + 1)[1]
    assert sha256(other) != WEIGHTS_SHA256


def test_the_artifact_has_darknets_widths():
    g = parse_model_file(seeded_artifact.LAYERS_JSON)
    convs = {n.name: n.params["weight"].shape for n in g.nodes.values() if n.op == "Conv2D"}
    assert [convs[f"l{i}_conv"][-1] for i in range(9)] == [16, 32, 64, 128, 256, 512, 1024, 256,
                                                          128]
    assert convs["head1"] == (1, 1, 512, 255) and convs["head2"] == (1, 1, 256, 255)
    assert convs["h2_conv"] == (3, 3, 384, 256)
    assert all(n.attrs["leaky_alpha"] == 0.1 for n in g.nodes.values()
               if n.attrs.get("activation") == "leaky_relu")
    yolo = g.nodes["yolo"].attrs
    assert yolo["num_classes"] == 80 and yolo["net_hw"] == [416, 416]
    assert yolo["masks"] == [[3, 4, 5], [1, 2, 3]]
    assert g.nodes["route_concat"].inputs == ["up", "l4_conv"]
    total = sum(int(np.prod(p.shape)) for n in g.nodes.values() for p in n.params.values())
    assert total == 8_849_182


@pytest.mark.parametrize("hw", [(416, 416), (96, 128)])
def test_net_hw_follows_the_frame_of_engine_from_json(hw):
    """ROADMAP C9: the 256-trained artifact and the 416 seeded one, each
    loaded by Engine.from_json at a frame, decode their anchors at that
    frame; parsed without one, at the artifact's own."""
    logging.disable(logging.INFO)
    try:
        for path in (zoo.YOLOV3_TINY_TRAINED, seeded_artifact.LAYERS_JSON):
            eng = P.Engine.from_json(path, P.EngineOptions(batch_size=1, device="cpu"),
                                     input_hw=hw)
            assert eng.graph.nodes["yolo"].attrs["net_hw"] == list(hw)
    finally:
        logging.disable(logging.NOTSET)
    assert parse_model_file(zoo.YOLOV3_TINY_TRAINED).nodes["yolo"].attrs["net_hw"] == [256, 256]
    assert parse_model_file(seeded_artifact.LAYERS_JSON).nodes["yolo"].attrs["net_hw"] == [416, 416]


def test_the_boxes_at_416_are_decode_grid_at_net_416():
    """The trained 3-class artifact through Engine.from_json at 416: its rows
    are decode_grid's at net (416, 416) through the same NMS, and not those
    at the artifact's own 256, whose boxes are 416 / 256 times as large."""
    logging.disable(logging.INFO)
    try:
        g = parse_model_file(zoo.YOLOV3_TINY_TRAINED, input_hw=(416, 416))
        g.output_names = ["head1", "head2", "yolo"]
        eng = P.Engine.from_graph(g, P.EngineOptions(batch_size=1, device="cpu"))
    finally:
        logging.disable(logging.NOTSET)
    x = torch.from_numpy(np.random.default_rng(5).random((1, 416, 416, 3), dtype=np.float32))
    out = eng.run({"input": x})
    attrs = eng.graph.nodes["yolo"].attrs

    def rows(net_hw):
        parts = [decode_grid(out[h].float(), [attrs["anchors"][m] for m in mask], net_hw, 3)
                 for h, mask in zip(("head1", "head2"), attrs["masks"])]
        boxes, scores, classes = (torch.cat(p, dim=1) for p in zip(*parts))
        return nms_fixed(boxes, scores, classes, 0.45, 0.35, 100)

    assert (out["yolo"][..., 1] > 0).sum() > 0
    assert torch.equal(out["yolo"], rows((416, 416)))
    assert not torch.equal(out["yolo"], rows((256, 256)))
    mask = attrs["masks"][0]
    wide = decode_grid(out["head1"].float(), [attrs["anchors"][m] for m in mask], (256, 256), 3)
    right = decode_grid(out["head1"].float(), [attrs["anchors"][m] for m in mask], (416, 416), 3)
    ratio = wide[0][..., 2:] / right[0][..., 2:]
    assert torch.allclose(ratio, torch.full_like(ratio, 416 / 256), rtol=1e-5)


# --- against the plain reference, through the benchmark's check ---------------

def small_config(hw: int, precision: str) -> dict:
    from benchmark.harness import spec

    config = copy.deepcopy(spec.load_cell(CELL).config)
    config["input"] = dict(config["input"], height=hw, width=hw)
    config["net_hw"] = [hw, hw]
    config["precision"] = precision
    return config


def check_numbers(config, seed, program_factory=None, batch=2):
    from benchmark.harness import check, spec, traffic
    from benchmark.harness.program import Program

    model = spec.model(config)
    ref = check.reference_model(ROOT, config, model, torch.device("cpu"))
    hw = config["input"]["height"]
    raw = traffic.device_frames(seed, batch, hw, hw, 3, "cpu")
    logging.disable(logging.INFO)
    try:
        got = (program_factory or Program)(ROOT, config, batch, "cpu").step("dispatch")(raw)
    finally:
        logging.disable(logging.NOTSET)
    return got, ref(raw), check.compare(ref, [(raw, got)], torch.device("cpu"), config, model)


# The heads' tolerances. FP32: the port's TORCH convs against the reference's
# float32 convs, both in float32 with TF32 off; only the order of the sums
# differs, ~1e-6 relative (read 1.9e-6 at 96x96), so 1e-4 of the heads' largest
# value. BF16: every layer's activations rounded to bfloat16 (8 bits) through
# 13 convs; read 0.0079-0.0082 relative RMS and 0.041-0.048 absolute on the CPU
# at 96x96, against the cell's card limits (benchmark/limits/) of the same
# precision at 416, which hold here too.
SEEDS = (37, 20261018, 3190000037)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_the_port_agrees_with_the_plain_reference_at_96(precision, seed):
    from benchmark.harness import spec

    got, want, n = check_numbers(small_config(96, precision), seed)
    assert sorted(got) == sorted(want) == ["head1", "head2", "yolo"]
    assert got["head1"].shape == (2, 3, 3, 255) and got["head2"].shape == (2, 6, 6, 255)
    if precision == "fp32":
        for name in ("head1", "head2"):
            scale = max(1.0, want[name].abs().max().item())
            assert (got[name] - want[name]).abs().max().item() < 1e-4 * scale
    else:
        limits = spec.load_cell(CELL).limits
        assert n["rel_rms_err"] <= limits["rel_rms_err"]
        assert n["max_abs_err"] <= limits["max_abs_err"]
    # every decision taken from the same numbers: every row paired, the scores
    # and boxes equal to float32's rounding
    assert n["det_rows"] > 100 and n["det_unmatched"] == 0
    assert n["det_score_err"] < 1e-6 and n["det_box_err"] < 1e-5


FAULTS = {"cutoff_0.38": {"score_threshold": 0.38}, "iou_0.48": {"iou_threshold": 0.48},
          "net_hw_256": {"net_hw": [256, 256]}}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_fails_the_check(fault, seed):
    """A program that decides otherwise on its own heads leaves rows
    unpaired: the check is not passed, by `det_unmatched` alone."""
    from benchmark.harness import spec
    from benchmark.harness.program import Program

    class Faulty(Program):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.engine.graph.nodes["yolo"].attrs.update(FAULTS[fault])

    config = small_config(96, "bf16")
    _, _, sound = check_numbers(config, seed)
    _, _, n = check_numbers(config, seed, Faulty)
    limits = spec.load_cell(CELL).limits
    assert sound["det_unmatched"] == 0
    assert n["det_unmatched"] > limits["det_unmatched"]
    assert n["rel_rms_err"] == sound["rel_rms_err"]  # the same heads
