"""The port's accuracy report (shadernn_tpu_torch/tools/accuracy_report.py)
against the JAX package's, on the CPU.

- `measure_model` for ESPCN (540p) and MobileNetV2 (224): the same keys
  as the JAX one's; `max_abs_diff` under the bf16 threshold (0.1) in both
  and within a factor of 2 of JAX's (two packages' roundings of the same
  seeded model); ESPCN's `psnr_db` above the JAX gates (35 dB bf16, 30 dB
  int8) in both and within 3 dB of JAX's. MobileNetV2's `top1_agreement`
  is not held: its seeded image gives 1000 probabilities of about 1e-3,
  which round to many equal bf16 values, so the bf16 argmax is a
  tie-break (FP32's argmax is held equal across the packages instead).
- The trained ResNet18 section: the JAX section's rows, each top-1 within
  one image of 256.
- The whole report on the CPU held to docs/Accuracy.md, which the JAX
  package wrote on the CPU (`check_against`: trained rows within 0.1 dB,
  0.02 top-1, 0.03 mAP; zoo rows above the gates), and a report with a
  row off by more than its limit is caught.
- A zoo model whose build raises: its row written as FAILED, `main`
  returns 1 (the CLI exits non-zero).
"""

import os

import numpy as np
import pytest

from shadernn_tpu.tools import accuracy_report as JA

from shadernn_tpu_torch.tools import accuracy_report as PA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(REPO, "docs", "Accuracy.md")
quiet = lambda *_: None  # noqa: E731


@pytest.mark.parametrize("name", ["espcn", "mobilenetv2"])
def test_measure_model_matches_jax(name):
    kind, kw = PA.ZOO_KINDS[name]
    assert JA.ZOO_KINDS == PA.ZOO_KINDS
    want = JA.measure_model(name, kind, log=quiet, **kw)
    got = PA.measure_model(name, kind, log=quiet, device="cpu", **kw)
    assert sorted(got) == sorted(want) == ["bf16", "int8"]
    for prec in ("bf16", "int8"):
        assert sorted(got[prec]) == sorted(want[prec]), prec
        g, w = got[prec]["max_abs_diff"], want[prec]["max_abs_diff"]
        assert g < 0.1 and w < 0.1 and 0.5 <= g / w <= 2.0, (prec, g, w)
        if kind == "sr":
            gate = 35.0 if prec == "bf16" else 30.0
            g, w = got[prec]["psnr_db"], want[prec]["psnr_db"]
            assert g > gate and w > gate and abs(g - w) <= 3.0, (prec, g, w)


def test_mobilenetv2_fp32_argmax_matches_jax():
    """The classifier row's FP32 engine picks JAX's class on the seeded
    image (its bf16 argmax is a tie-break, see above)."""
    import shadernn_tpu as J
    from shadernn_tpu.models import build_model as j_build

    import shadernn_tpu_torch as P

    x = np.random.default_rng(0).random((1, 224, 224, 3), dtype=np.float32)
    want = np.asarray(J.Engine.from_graph(j_build("mobilenetv2"), J.EngineOptions())
                      .model.run_single(x))
    got = P.Engine.from_graph(P.build_model("mobilenetv2"), P.EngineOptions(device="cpu")) \
        .run_single(x).numpy()
    assert got.argmax() == want.argmax()
    assert np.abs(got - want).max() <= 0.01


def test_trained_resnet18_section_matches_jax():
    want = JA.trained_resnet18_section(log=quiet)
    got = PA.trained_resnet18_section(log=quiet, device="cpu")
    assert len(got) == len(want) == 5 and got[:2] == want[:2]
    for g, w in zip(got[2:], want[2:]):
        gl, gv = g.strip("|").split("|")
        wl, wv = w.strip("|").split("|")
        assert gl == wl and abs(float(gv) - float(wv)) <= 1 / 256 + 1e-9, (g, w)


def test_report_holds_to_docs(tmp_path):
    out = str(tmp_path / "Accuracy.md")
    assert PA.main(["--out", out, "--device", "cpu"]) == 0
    got, want = open(out).read(), open(DOCS).read()
    assert PA.check_against(got, want) == []
    assert PA.read_report(got).keys() == PA.read_report(want).keys()
    # a trained row one limit off is caught
    off = got.replace("| trained SpatialDenoise, fp32 | ", "| trained SpatialDenoise, fp32 | 1")
    assert any("SpatialDenoise, fp32" in b for b in PA.check_against(off, want))


def test_failed_row_makes_main_fail(tmp_path, monkeypatch):
    for section in ("espcn", "resnet18", "denoiser", "mobilenetv2", "styletransfer", "yolo"):
        monkeypatch.setattr(PA, f"trained_{section}_section", lambda **_: ["(skipped)"])
    monkeypatch.setattr(PA, "ZOO_KINDS", {"espcn": ("sr", {"h": 16, "w": 24}),
                                          "no_such_model": ("sr", {})})
    out = str(tmp_path / "Accuracy.md")
    assert PA.main(["--out", out, "--device", "cpu"]) == 1
    rows = PA.read_report(open(out).read())["Precision deltas across the zoo (seeded weights)"]
    assert rows["no_such_model"] == [] and len(rows["espcn"]) == 4
    assert "| no_such_model | FAILED: KeyError:" in open(out).read()
    monkeypatch.setattr(PA, "ZOO_KINDS", {"espcn": ("sr", {"h": 16, "w": 24})})
    assert PA.main(["--out", out, "--device", "cpu"]) == 0
