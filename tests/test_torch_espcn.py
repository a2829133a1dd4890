"""The port's slice end to end: ESPCN through shadernn_tpu_torch.Engine on
the CPU against the JAX Engine on the same frames, plus the engine's
contracts and the package's independence from JAX."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import shadernn_tpu as J
from shadernn_tpu.engine.compile import compile_graph as j_compile
from shadernn_tpu.engine.compile import extract_params as j_extract
from shadernn_tpu.models import build_model as jbuild

import shadernn_tpu_torch as P
from shadernn_tpu_torch.engine.compile import compile_graph as p_compile
from shadernn_tpu_torch.models.zoo import ESPCN_TRAINED
from shadernn_tpu_torch.weights import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRECISIONS = {"fp32": 0.01, "bf16": 0.1}  # tests/conftest.py thresholds


def options(pkg, prec, **kw):
    return pkg.EngineOptions(precision=getattr(pkg.Precision, prec.upper()), **kw)


@pytest.mark.parametrize("prec", list(PRECISIONS))
def test_from_graph_matches_jax(rng, prec):
    x = rng.random((2, 24, 40, 1), dtype=np.float32)
    want = np.asarray(J.Engine.from_graph(
        jbuild("espcn", h=24, w=40, seed=5), options(J, prec, batch_size=2)
    ).run_single(x), np.float32)
    eng = P.Engine.from_graph(P.build_model("espcn", h=24, w=40, seed=5),
                              options(P, prec, batch_size=2, device="cpu"))
    got = eng.run_single(x)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 48, 80, 1)
    assert np.max(np.abs(got.numpy() - want)) <= PRECISIONS[prec]
    assert list(eng.model.forward.chain_plan) == ["conv_1"]


@pytest.mark.parametrize("prec", list(PRECISIONS))
def test_from_json_trained_matches_jax(rng, prec):
    x = rng.random((2, 36, 64, 1), dtype=np.float32)
    want = np.asarray(J.Engine.from_json(
        ESPCN_TRAINED, options(J, prec, batch_size=2), input_hw=(36, 64)
    ).run_single(x), np.float32)
    got = P.Engine.from_json(
        ESPCN_TRAINED, options(P, prec, batch_size=2, device="cpu"), input_hw=(36, 64)
    ).run_single(x).numpy()
    assert got.shape == want.shape == (2, 72, 128, 1)
    assert np.abs(got).max() <= 1.0
    assert np.max(np.abs(got - want)) <= PRECISIONS[prec]


@pytest.mark.parametrize("prec", list(PRECISIONS))
def test_chain_plan_matches_jax(monkeypatch, prec):
    """The static chain plan (which nodes fuse into one kernel launch)."""
    monkeypatch.setenv("SNN_AUTO_PALLAS_ANYWHERE", "1")
    jm = j_compile(_optimized(jbuild, J), options(J, prec, batch_size=2))
    pm = p_compile(_optimized(P.build_model, P), options(P, prec, batch_size=2, device="cpu"))
    assert pm.forward.chain_plan == jm.forward.chain_plan
    expected = ["conv_1", "conv_2", "conv_3"] + (["subpixel"] if prec == "bf16" else [])
    assert pm.forward.chain_plan == {"conv_1": expected}


def _optimized(build, pkg):
    from importlib import import_module

    g = build("espcn", h=24, w=40)
    import_module(pkg.__name__ + ".graph.fusion").optimize(g)
    g.infer_shapes(batch_size=2)
    return g


def test_torch_backend_and_dump_outputs_match_jax(rng):
    """The plain per-op forward (no chain) with every layer dumped."""
    x = rng.random((1, 20, 28, 1), dtype=np.float32)
    j = J.Engine.from_json(ESPCN_TRAINED, options(J, "fp32", dump_outputs=True),
                           input_hw=(20, 28)).model
    p = P.Engine.from_json(ESPCN_TRAINED, options(P, "fp32", dump_outputs=True, device="cpu"),
                           input_hw=(20, 28)).model
    assert p.forward.chain_plan == {}
    # As in the JAX package, the convs run one by one on the single-conv kernel.
    assert p.forward.single_conv_plan == ["conv_1", "conv_2", "conv_3"]
    want = j({"input": x})["__dumps__"]
    got = p({"input": torch.from_numpy(x)})["__dumps__"]
    assert sorted(got) == sorted(want)
    for name in want:
        assert np.max(np.abs(got[name].numpy() - np.asarray(want[name]))) <= 0.01, name


def test_weights_carried_from_jax(rng):
    """A JAX engine's extract_params, loaded into a port engine built with
    another seed, gives the JAX outputs."""
    x = rng.random((2, 16, 24, 1), dtype=np.float32)
    jg = jbuild("espcn", h=16, w=24, seed=1)
    for n in ("conv_1", "conv_2", "conv_3"):  # non-zero biases
        jg.nodes[n].params["bias"] = rng.standard_normal(
            jg.nodes[n].params["bias"].shape).astype(np.float32) * 0.1
    jm = j_compile(jg, options(J, "fp32", batch_size=2))
    want = np.asarray(jm.run_single(x))
    eng = P.Engine.from_graph(P.build_model("espcn", h=16, w=24, seed=2),
                              options(P, "fp32", batch_size=2, device="cpu"))
    before = eng.run_single(x).numpy()
    assert np.max(np.abs(before - want)) > 0.01
    eng.model.load_params(params_from_numpy(j_extract(jg), "cpu"))
    assert np.max(np.abs(eng.run_single(x).numpy() - want)) <= 0.01
    with pytest.raises(ValueError):
        eng.model.load_params({"conv_1": {}})


def test_engine_contracts(rng):
    eng = P.Engine.from_graph(P.build_model("espcn", h=16, w=24),
                              P.EngineOptions(device="cpu"))
    with pytest.raises(ValueError):
        eng.run_single(rng.random((1, 16, 25, 1), dtype=np.float32))
    with pytest.raises(KeyError):
        eng.run({"frames": np.zeros((1, 16, 24, 1), np.float32)})
    out = eng.run_single(rng.random((3, 16, 24, 1), dtype=np.float32))  # other batch
    assert tuple(out.shape) == (3, 32, 48, 1)
    stats = eng.benchmark({"input": np.zeros((1, 16, 24, 1), np.float32)}, loops=3)
    assert stats["loops"] == 1 and stats["stdev_ms"] == 0.0
    int8 = P.EngineOptions(precision=P.Precision.INT8)
    assert int8.precision.is_quantized and int8.precision.activation_dtype == torch.bfloat16
    assert int8.chain_a8 == "auto"
    with pytest.raises(ValueError):
        P.EngineOptions(chain_a8="on")
    with pytest.raises(ValueError):
        P.EngineOptions(chain_format="tiles")


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        P.Engine.from_graph(P.build_model("espcn", h=16, w=24))


def test_package_imports_no_jax():
    code = (
        "import sys, shadernn_tpu_torch as p\n"
        "import shadernn_tpu_torch.engine.streaming, shadernn_tpu_torch.engine.deploy\n"
        "import shadernn_tpu_torch.engine.processor, shadernn_tpu_torch.image\n"
        "import shadernn_tpu_torch.utils.profiler, shadernn_tpu_torch.utils.trace_profile\n"
        "import shadernn_tpu_torch.graph.serialize, shadernn_tpu_torch.demo\n"
        "from shadernn_tpu_torch.tools import onnx_reader, onnx_export, convert, dump_reader\n"
        "from shadernn_tpu_torch.tools import compare, optim, accuracy_report\n"
        "from shadernn_tpu_torch.tools import train_espcn, train_resnet18, train_mobilenetv2\n"
        "from shadernn_tpu_torch.tools import train_denoiser, train_styletransfer, train_yolo\n"
        "p.build_model('espcn', h=8, w=8)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'shadernn_tpu' or m.startswith('shadernn_tpu.')]\n"
        "assert not bad, bad\n"
        "heavy = [m for m in sys.modules if m.split('.')[0] in ('keras', 'tensorflow', 'h5py', 'optax', 'PIL')]\n"
        "assert not heavy, heavy\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_sources_name_no_jax_import():
    pat = re.compile(r"^\s*(import|from)\s+(jax|shadernn_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(REPO, "shadernn_tpu_torch"))
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 15
    for path in files:
        with open(path) as fh:
            assert not pat.search(fh.read()), path
