"""A later change adds a configuration, a traffic mix, a per-layer metric
or a model family with ops of its own with new files and new entries only:
shown in a copy of the benchmark, where none of the files already there is
edited."""

import json
import os
import shutil

import numpy as np

from conftest import ROOT, run_tiny, tiny_cell


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
