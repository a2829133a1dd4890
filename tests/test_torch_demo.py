"""The port's demo CLI (shadernn_tpu_torch.demo) on `--device cpu`: every
command of the JAX demo (tests/test_runners_demo.py's list and run, and
profile, stream, serve cold and warm into a temporary directory, run with
its layer dumps), with the JAX demo's printed format; and fault C5: the
port's top level exports every name of the JAX package's, and
Engine.benchmark returns the JAX Engine.benchmark's keys."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import shadernn_tpu as J
from shadernn_tpu.models import build_model as jbuild

import shadernn_tpu_torch as P
from shadernn_tpu_torch.demo import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATENCY = re.compile(r"latency mean ([\d.]+) ms  p50 ([\d.]+) ms  throughput ([\d.]+) frames/s")


def stats_of(out):
    """The JSON object a stream or serve command prints last."""
    return json.loads(out[out.index("{"):])


def test_demo_list_as_a_module():
    out = subprocess.run([sys.executable, "-m", "shadernn_tpu_torch.demo", "list"], cwd=REPO,
                         capture_output=True, text=True, timeout=120, check=True).stdout
    assert "espcn" in out and "540x960x1" in out and "styletransfer-candy" in out


@pytest.mark.parametrize("backend", ["xla", "torch", "pallas", "kernel"])
def test_demo_run_classifier(capsys, backend):
    """The JAX spellings xla and pallas run the TORCH and KERNEL backends."""
    main(["run", "resnet18", "--inner-loops", "2", "--precision", "fp32", "--backend", backend,
          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "device: cpu" in out and "class_index:" in out
    assert LATENCY.search(out), out


def test_demo_run_detector_and_dumps(capsys, tmp_path):
    main(["run", "yolov3-tiny", "--inner-loops", "1", "--precision", "fp32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.search(r"detections \(\d+\):", out), out
    dump_dir = str(tmp_path / "dumps")
    main(["run", "resnet18", "--inner-loops", "1", "--device", "cpu", "--dump-outputs",
          "--dump-dir", dump_dir])
    out = capsys.readouterr().out
    (n,) = re.findall(rf"dumped (\d+) layer outputs to {re.escape(dump_dir)}/", out)
    files = [f for _, _, fs in os.walk(dump_dir) for f in fs if f.endswith(".npy")]
    assert int(n) == len(files) > 10


def test_demo_profile(capsys):
    main(["profile", "espcn", "--inner-loops", "1", "--precision", "bf16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "===== Time stats =====" in out and "[conv_1" in out and "Total GPU runtime" in out


def test_demo_stream(capsys):
    main(["stream", "resnet18", "--frames", "10", "--batch", "4", "--device", "cpu"])
    st = stats_of(capsys.readouterr().out)
    assert st["frames_done"] == 10 and st["batches_run"] == 3 and st["padded_frames"] == 2


def test_demo_serve_cold_then_warm(capsys, tmp_path):
    """The first start exports the engine into --export-dir, the second
    serves the exported files; --no-aot serves the built engine. Each
    serves every frame."""
    export_dir = str(tmp_path / "exported")
    args = ["serve", "resnet18", "--frames", "12", "--batch", "4", "--precision", "fp32",
            "--device", "cpu", "--export-dir", export_dir]
    for start in ("cold", "warm", "no-aot"):
        main(args + (["--no-aot"] if start == "no-aot" else []))
        out = capsys.readouterr().out
        assert ("exported engine to" in out) == (start == "cold"), (start, out)
        ready = re.search(r"serving ready in ([\d.]+)s \((\w+); model resnet18, batch 4\)", out)
        assert ready and ready.group(2) == ("engine" if start == "no-aot" else "exported")
        assert stats_of(out)["frames_done"] == 12, start
    assert sorted(os.listdir(export_dir)) == ["graph.json", "meta.json", "params.npz"]


def test_demo_needs_the_card_by_default():
    """No code path carries on on the CPU when it finds no GPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["run", "espcn", "--inner-loops", "1"])


# --- C5: the public API against the JAX package's --------------------------


def test_top_level_exports_every_jax_name():
    names = [n for n in dir(J) if not n.startswith("_") and n[0].isupper()]
    assert sorted(names) == ["BackendKind", "Engine", "EngineOptions", "Graph",
                             "InferenceProcessor", "Node", "Precision", "TensorSpec"]
    for n in names:
        assert hasattr(P, n), n
    assert P.InferenceProcessor.__module__ == "shadernn_tpu_torch.engine.processor"


def test_benchmark_keys_equal_jax():
    x = {"input": np.random.default_rng(0).random((1, 16, 24, 1), dtype=np.float32)}
    want = J.Engine.from_graph(jbuild("espcn", h=16, w=24)).benchmark(x, loops=7)
    got = P.Engine.from_graph(P.build_model("espcn", h=16, w=24),
                              P.EngineOptions(device="cpu")).benchmark(x, loops=7)
    assert sorted(got) == sorted(want)
    assert got["loops"] == want["loops"] == 2 and got["stdev_ms"] >= 0.0
