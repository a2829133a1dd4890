"""A later change adds a configuration, a traffic mix, a per-layer metric
or a model family with ops of its own with new files and new entries only:
shown in a copy of the benchmark, where none of the files already there is
edited."""

import json
import os
import shutil

import numpy as np

from conftest import ROOT, TINY, run_tiny, tiny_cell, yolo_config


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    (root / "shadernn_tpu").mkdir()  # the artifacts are read as files
    os.symlink(os.path.join(ROOT, "shadernn_tpu", "models"), root / "shadernn_tpu" / "models")
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    return root, before


def test_a_new_cell_needs_only_new_files_and_entries(tmp_path):
    root, before = _copy(tmp_path)

    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/espcn-2x-540p-bf16.json").read_text())
    cfg["name"] = "espcn-2x-270p-bf16"
    cfg["input"] = dict(cfg["input"], height=270, width=480)
    (root / "benchmark/configs/espcn-2x-270p-bf16.json").write_text(json.dumps(cfg))
    (root / "benchmark/traffic/offline_b2.json").write_text(json.dumps(
        dict(json.loads((root / "benchmark/traffic/offline_b8.json").read_text()), batch=2)))
    (root / "benchmark/metrics/frames_per_step.py").write_text(
        '"""Frames per step."""\n\n\ndef read(rec):\n    return rec.batch\n')
    bench["configs"].append({"name": "espcn-2x-270p-bf16",
                             "source": "https://example.org/espcn-270p",
                             "file": "benchmark/configs/espcn-2x-270p-bf16.json", "reduced": [],
                             "why": "a smaller frame"})
    bench["workloads"].append({"name": "espcn-270p-b2", "config": "espcn-2x-270p-bf16",
                               "traffic": "offline_b2", "chips": 1, "why": "a new cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("espcn-270p-b2")
    bench["per_layer"].append({"name": "frames_per_step", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "model step",
                               "moves": "frames_per_s", "workloads": ["espcn-270p-b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark/limits/espcn-270p-b2.json").write_text(
        (root / "benchmark/limits/espcn-540p-b8.json").read_text())

    cell = tiny_cell("espcn-270p-b2", root=str(root))
    assert cell.traffic["batch"] == 2 and cell.config["name"] == "espcn-2x-270p-bf16"
    plain = run_tiny(cell, root=str(root))
    assert plain["correct"] and set(plain["metrics"]) == {"frames_per_s", "setup_s"}
    traced = run_tiny(cell, root=str(root), trace=True)
    assert traced["metrics"]["frames_per_step"]["value"] == 2
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no file that was there was edited


# A family whose ops the common tables lack: a max pool and a leaky ReLU.
POOL_FAMILY = '''"""conv 3x3 to ``width`` with a leaky ReLU, max pool, conv 3x3 back."""

import torch.nn.functional as F

from benchmark.reference.plain import Op


def layers(cfg):
    c, w = cfg["channels"], cfg["width"]
    return [{"name": "conv_1", "op": "conv", "k": 3, "cin": c, "cout": w, "stride": 1,
             "act": "leaky_relu"},
            {"name": "pool", "op": "max_pool", "k": 2},
            {"name": "conv_2", "op": "conv", "k": 3, "cin": w, "cout": c, "stride": 1}]


OPS = {"max_pool": Op(lambda l: {}, lambda l, i: (i[0] // l["k"], i[1] // l["k"], i[2]),
                      lambda l, i, o: 0,
                      lambda l, p, y, outs, q: F.max_pool2d(y, l["k"], l["k"]))}
ACTS = {"leaky_relu": lambda t: F.leaky_relu(t, 0.1)}
'''


def _pool_artifact(path, width):
    art = {"numLayers": {"count": 4},
           "Layer_0": {"name": "input", "type": "InputLayer", "numInputs": 0, "inputId": [],
                       "Input Width": 64, "Input Height": 36, "outputPlanes": 1,
                       "inputIndex": 0},
           "Layer_1": {"name": "conv_1", "type": "Conv2D", "numInputs": 1, "inputId": [0],
                       "kernel_size": 3, "strides": 1, "padding": "same", "inputPlanes": 1,
                       "outputPlanes": width, "useBias": "True",
                       "useBatchNormalization": "False", "activation": "leaky_relu",
                       "leakyReluAlpha": 0.1},
           "Layer_2": {"name": "pool", "type": "MaxPooling2D", "numInputs": 1, "inputId": [1],
                       "pool_size": 2, "strides": 2, "padding": "valid", "inputPlanes": width,
                       "outputPlanes": width},
           "Layer_3": {"name": "conv_2", "type": "Conv2D", "numInputs": 1, "inputId": [2],
                       "kernel_size": 3, "strides": 1, "padding": "same", "inputPlanes": width,
                       "outputPlanes": 1, "useBias": "True", "useBatchNormalization": "False",
                       "activation": "linear"}}
    (path.parent / (path.name + "_layers.json")).write_text(json.dumps(art))
    n = (9 * width + width) + (9 * width + 1)
    w = np.random.default_rng(5).standard_normal(n).astype("<f4") * 0.3
    w.tofile(path.parent / (path.name + "_weights.bin"))


def test_a_new_family_with_new_ops_needs_only_new_files(tmp_path):
    from benchmark.harness import cost, spec

    root, before = _copy(tmp_path)
    (root / "artifacts").mkdir()
    _pool_artifact(root / "artifacts" / "tinypool", width=8)
    (root / "benchmark/reference/tinypool.py").write_text(POOL_FAMILY)
    cfg = {"name": "tinypool-bf16", "family": "tinypool", "precision": "bf16",
           "artifact": "artifacts/tinypool_layers.json", "channels": 1, "width": 8,
           "input": {"height": 36, "width": 64, "channels": 1},
           "ingest": {"means": [0.0], "norms": [1 / 255]}}
    (root / "benchmark/configs/tinypool-bf16.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tinypool-bf16", "source": "https://example.org/tinypool",
                             "file": "benchmark/configs/tinypool-bf16.json", "reduced": [],
                             "why": "a family with a pool"})
    bench["workloads"].append({"name": "tinypool-b2", "config": "tinypool-bf16",
                               "traffic": "offline_b8", "chips": 1, "why": "a new family"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "espcn-540p-b8" in m.get("workloads", []):
            m["workloads"].append("tinypool-b2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark/limits/tinypool-b2.json").write_text(
        (root / "benchmark/limits/espcn-540p-b8.json").read_text())

    cell = tiny_cell("tinypool-b2", root=str(root))
    f = cost.frame_cost(spec.model(cell.config, str(root)), 36, 64, 1)
    # the pool halves the frame before the second conv, and costs nothing itself
    assert f["ops"] == 2 * 9 * 8 * 36 * 64 + 2 * 9 * 8 * 18 * 32
    assert f["out_values"] == 18 * 32
    plain = run_tiny(cell, root=str(root))
    assert plain["correct"], plain["check"]
    assert plain["check"]["rel_rms_err"]["value"] > 0
    traced = run_tiny(cell, root=str(root), trace=True)
    assert traced["correct"] and "kernels_roofline.offline" in traced["metrics"]
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no file that was there was edited


def test_a_suffixed_metric_reads_through_its_own_file_or_its_stem(tmp_path):
    import types

    from benchmark.harness import spec

    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))  # every metric has a reader
    root, before = _copy(tmp_path)
    rec = types.SimpleNamespace(batch=8)
    (root / "benchmark/metrics/frames_per_step.py").write_text(
        "def read(rec):\n    return rec.batch\n")
    assert spec.reader("frames_per_step.b1", str(root))(rec) == 8
    (root / "benchmark/metrics/frames_per_step.b1.py").write_text(
        "def read(rec):\n    return 1\n")
    assert spec.reader("frames_per_step.b1", str(root))(rec) == 1
    assert spec.reader("frames_per_step.offline", str(root))(rec) == 8


# A branched family: two convs from one, concatenated, and two named outputs.
BRANCH_FAMILY = '''"""conv 3x3 to ``width``; from it a 1x1 conv and a 3x3 conv; their
concat; a 1x1 conv to the channels."""

import torch

from benchmark.reference.plain import Op


def layers(cfg):
    c, w = cfg["channels"], cfg["width"]
    return [{"name": "conv_a", "op": "conv", "k": 3, "cin": c, "cout": w, "stride": 1,
             "act": "relu"},
            {"name": "conv_b", "op": "conv", "k": 1, "cin": w, "cout": w, "stride": 1},
            {"name": "conv_c", "op": "conv", "k": 3, "cin": w, "cout": w, "stride": 1,
             "from": ["conv_a"]},
            {"name": "cat", "op": "concat", "from": ["conv_b", "conv_c"]},
            {"name": "conv_d", "op": "conv", "k": 1, "cin": 2 * w, "cout": c, "stride": 1}]


OPS = {"concat": Op(lambda l: {}, lambda l, i: (i[0][0], i[0][1], sum(s[2] for s in i)),
                    lambda l, i, o: 0, lambda l, p, ys, outs, q: torch.cat(ys, dim=1))}
'''


def _branch_artifact(path, width):
    def conv(name, k, ci, co, src):
        return {"name": name, "type": "Conv2D", "numInputs": 1, "inputId": [src],
                "kernel_size": k, "strides": 1, "padding": "same", "inputPlanes": ci,
                "outputPlanes": co, "useBias": "True", "useBatchNormalization": "False",
                "activation": "relu" if name == "conv_a" else "linear"}

    art = {"numLayers": {"count": 6},
           "Layer_0": {"name": "input", "type": "InputLayer", "numInputs": 0, "inputId": [],
                       "Input Width": 64, "Input Height": 36, "outputPlanes": 1,
                       "inputIndex": 0},
           "Layer_1": conv("conv_a", 3, 1, width, 0),
           "Layer_2": conv("conv_b", 1, width, width, 1),
           "Layer_3": conv("conv_c", 3, width, width, 1),
           "Layer_4": {"name": "cat", "type": "Concatenate", "numInputs": 2, "inputId": [2, 3]},
           "Layer_5": conv("conv_d", 1, 2 * width, 1, 4)}
    (path.parent / (path.name + "_layers.json")).write_text(json.dumps(art))
    n = (9 * width + width) + (width * width + width) + (9 * width * width + width) + (2 * width + 1)
    w = np.random.default_rng(7).standard_normal(n).astype("<f4") * 0.3
    w.tofile(path.parent / (path.name + "_weights.bin"))


def test_a_branched_family_with_named_outputs_needs_only_new_files(tmp_path):
    from benchmark.harness import cost, spec

    root, before = _copy(tmp_path)
    (root / "artifacts").mkdir()
    _branch_artifact(root / "artifacts" / "tinybranch", width=4)
    (root / "benchmark/reference/tinybranch.py").write_text(BRANCH_FAMILY)
    cfg = {"name": "tinybranch-bf16", "family": "tinybranch", "precision": "bf16",
           "artifact": "artifacts/tinybranch_layers.json", "channels": 1, "width": 4,
           "input": {"height": 36, "width": 64, "channels": 1},
           "ingest": {"means": [0.0], "norms": [1 / 255]},
           "outputs": [{"name": "conv_b", "compare": "dense"},
                       {"name": "conv_d", "compare": "dense"}]}
    (root / "benchmark/configs/tinybranch-bf16.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tinybranch-bf16", "source": "https://example.org/branch",
                             "file": "benchmark/configs/tinybranch-bf16.json", "reduced": [],
                             "why": "a family that branches"})
    bench["workloads"].append({"name": "tinybranch-b2", "config": "tinybranch-bf16",
                               "traffic": "offline_b8", "chips": 1, "why": "a branched family"})
    bench["workloads"].append({"name": "tinybranch-serve", "config": "tinybranch-bf16",
                               "traffic": "video_streams", "chips": 1, "why": "served"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "espcn-540p-b8" in m.get("workloads", []):
            m["workloads"].append("tinybranch-b2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for name in ("tinybranch-b2", "tinybranch-serve"):
        (root / f"benchmark/limits/{name}.json").write_text(
            json.dumps({"rel_rms_err": 0.02, "max_abs_err": 0.05}))

    cell = tiny_cell("tinybranch-b2", root=str(root))
    f = cost.frame_cost(spec.model(cell.config, str(root)), 36, 64, 1)
    # conv_c reads conv_a, not conv_b; conv_d reads both branches; both outputs count
    assert f["ops"] == 2 * (9 * 4 + 4 * 4 + 9 * 4 * 4 + 8) * 36 * 64
    assert f["out_values"] == (4 + 1) * 36 * 64
    plain = run_tiny(cell, root=str(root))
    assert plain["correct"], plain["check"]
    assert set(plain["check"]) == {"rel_rms_err", "max_abs_err"}
    assert 0 < plain["check"]["rel_rms_err"]["value"] and plain["_numbers"]["frames"] > 0
    traced = run_tiny(cell, root=str(root), trace=True)
    assert traced["correct"] and "kernels_roofline.offline" in traced["metrics"]
    served = tiny_cell("tinybranch-serve", root=str(root))
    served.traffic = dict(served.traffic, **TINY["espcn-540p-serve"][1])
    served = run_tiny(served, root=str(root))  # the service's results carry both outputs
    assert served["correct"] and served["_numbers"]["frames"] > 0, served["check"]
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no file that was there was edited


def test_a_detector_needs_only_new_files_and_its_check_sees_a_fault(tmp_path):
    """YOLOv3-tiny's family is in the benchmark; a cell of it takes a
    configuration, limits and entries. Its check holds the program's kept
    rows to the reference's NMS of the program's own heads, so a program
    that suppresses at another IoU is not correct."""
    from benchmark.harness import spec
    from benchmark.harness.program import Program

    root, before = _copy(tmp_path)
    cfg = yolo_config()
    (root / "benchmark/configs/yolo-bf16.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "yolo-bf16", "source": "https://example.org/yolo",
                             "file": "benchmark/configs/yolo-bf16.json", "reduced": [],
                             "why": "a detector"})
    bench["workloads"].append({"name": "yolo-b2", "config": "yolo-bf16", "traffic": "offline_b8",
                               "chips": 1, "why": "a detector"})
    for m in bench["end_to_end"]:
        if "espcn-540p-b8" in m.get("workloads", []):
            m["workloads"].append("yolo-b2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark/limits/yolo-b2.json").write_text(json.dumps(
        {"rel_rms_err": 0.05, "max_abs_err": 1.0, "det_score_err": 1e-6, "det_box_err": 1e-5,
         "det_unmatched": 0}))

    cell = spec.load_cell("yolo-b2", root=str(root))
    cell.traffic = dict(cell.traffic, batch=2, pool_batches=2, warm_steps=1, profile_steps=2,
                        probe_steps=2)
    sound = run_tiny(cell, root=str(root))
    assert sound["correct"], sound["check"]
    assert sound["_numbers"]["det_rows"] > 0 and sound["_numbers"]["det_score_err"] == 0

    class WiderNms(Program):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.engine.graph.nodes["yolo"].attrs["iou_threshold"] = 0.55

    faulty = run_tiny(cell, root=str(root), program_factory=WiderNms)
    assert not faulty["correct"] and faulty["check"]["det_unmatched"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before
