"""The trained MobileNetV2 artifact (10 classes, 32x32) through the port's
Engine on the CPU against the JAX Engine (blocks in Pallas interpret mode)
on the same images of the task it was trained on.

Tolerance: the conftest thresholds (0.01 fp32, 0.1 bf16) times
max(1, max|reference|)."""

import numpy as np
import pytest
import torch

import shadernn_tpu as J

import shadernn_tpu_torch as P
from shadernn_tpu_torch.kernels import launch_counts
from shadernn_tpu_torch.models.zoo import MOBILENETV2_TRAINED
from shadernn_tpu_torch.tools.train_resnet18 import synth_cls

TOL = {"fp32": 0.01, "bf16": 0.1}  # tests/conftest.py thresholds


def options(pkg, prec, **kw):
    return pkg.EngineOptions(precision=getattr(pkg.Precision, prec.upper()), **kw)


@pytest.mark.parametrize("prec", list(TOL))
def test_trained_matches_jax(monkeypatch, prec):
    monkeypatch.setenv("SNN_AUTO_PALLAS_ANYWHERE", "1")
    x, _labels = synth_cls(np.random.default_rng(424242), 8)
    want = J.Engine.from_json(MOBILENETV2_TRAINED, options(J, prec, batch_size=8)).run_single(x)
    eng = P.Engine.from_json(MOBILENETV2_TRAINED, options(P, prec, batch_size=8, device="cpu"))
    assert len(eng.model.forward.block_plan) == 13
    assert eng.model.forward.single_conv_plan == ["stem_conv"]
    before = launch_counts()
    got = eng.run_single(x)
    # A CPU run takes the plain versions: no kernel launches.
    assert launch_counts() == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 10)
    want = np.asarray(want, np.float32)
    assert np.max(np.abs(got.numpy() - want)) <= TOL[prec] * max(1.0, float(np.abs(want).max()))
    assert np.array_equal(got.numpy().argmax(-1), want.argmax(-1))
