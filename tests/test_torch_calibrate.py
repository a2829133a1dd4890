"""The port's calibration (shadernn_tpu_torch.quant.calibrate) against the
JAX package's: activation scales of the same graph on the same batch
within 1%, the same nodes stamped by propagate_input_scales, the numpy
helpers, and a calibrated graph's scales inert when it is rebuilt at
FP32/BF16."""

import numpy as np
import pytest
import torch

import shadernn_tpu as J
from shadernn_tpu.models import build_model as jbuild
from shadernn_tpu.quant import calibrate as jcal

import shadernn_tpu_torch as P
from shadernn_tpu_torch.models.zoo import MOBILENETV2_TRAINED
from shadernn_tpu_torch.quant import calibrate as pcal
from shadernn_tpu_torch.weights import calibration_from_graph


def _pair(model, prec="int8", **kw):
    opts = lambda pkg, **o: pkg.EngineOptions(  # noqa: E731
        precision=getattr(pkg.Precision, prec.upper()), **o)
    if model == "mobilenetv2_cls10":
        from shadernn_tpu.graph.parser import parse_model_file as jparse

        from shadernn_tpu_torch.graph.parser import parse_model_file as pparse

        return (J.Engine.from_graph(jparse(MOBILENETV2_TRAINED), opts(J, batch_size=4)),
                P.Engine.from_graph(pparse(MOBILENETV2_TRAINED), opts(P, batch_size=4,
                                                                     device="cpu")))
    return (J.Engine.from_graph(jbuild(model, **kw), opts(J, batch_size=2)),
            P.Engine.from_graph(P.build_model(model, **kw), opts(P, batch_size=2, device="cpu")))


@pytest.mark.parametrize("percentile", [99.9, None], ids=["p99.9", "absmax"])
@pytest.mark.parametrize("model,shape,prec", [
    ("espcn", (2, 20, 28, 1), "int8"),
    ("espcn", (2, 20, 28, 1), "fp32"),
    ("mobilenetv2_cls10", (4, 32, 32, 3), "fp32"),
])
def test_scales_match_jax_within_one_percent(model, shape, prec, percentile):
    """On the same graph and batches. Deep in a bf16 network the two
    packages' dumps part by more than bf16 rounding (their epilogues round
    at other places), so the 54-layer classifier is calibrated at FP32."""
    kw = dict(h=shape[1], w=shape[2]) if model == "espcn" else {}
    jeng, peng = _pair(model, prec, **kw)
    batches = [{"input": np.random.default_rng(s).random(shape, dtype=np.float32)} for s in (7, 8)]
    want = jcal.calibrate_activations(jeng, batches, percentile=percentile)
    got = pcal.calibrate_activations(peng, batches, percentile=percentile)
    assert sorted(got) == sorted(want) and len(got) > 4
    for name, v in want.items():
        assert got[name] == pytest.approx(v, rel=0.01), name
        assert peng.graph.nodes[name].attrs["act_scale"] == got[name]
    assert peng.graph.meta["act_scales"] == got
    # The same nodes stamped with their producers' scales (int8 weights).
    if prec == "fp32":
        from shadernn_tpu.quant.quantize import quantize_graph_weights as jq

        from shadernn_tpu_torch.quant.quantize import quantize_graph_weights as pq

        assert pq(peng.graph) == jq(jeng.graph) > 0
    assert pcal.propagate_input_scales(peng.graph) == jcal.propagate_input_scales(jeng.graph) > 0
    stamped = lambda g: sorted(n for n, v in g.nodes.items() if "in_act_scale" in v.attrs)  # noqa: E731
    assert stamped(peng.graph) == stamped(jeng.graph)
    for name in stamped(peng.graph):
        src = peng.graph.nodes[name].inputs[0]
        assert peng.graph.nodes[name].attrs["in_act_scale"] == got[src]


def test_percentile_is_numpys(rng):
    for n in (1, 2, 17, 1000, 4099):
        a = torch.from_numpy(np.abs(rng.standard_normal(n)).astype(np.float32))
        for q in (0.0, 50.0, 99.9, 100.0):
            assert pcal._percentile(a, q) == pytest.approx(float(np.percentile(a.numpy(), q)),
                                                           rel=1e-5, abs=1e-7)


def test_quantizer_helpers_match_jax(rng):
    x = (rng.standard_normal(1000) * 2).astype(np.float32)
    x[:4] = [0.5 * 0.02, 1.5 * 0.02, -2.5 * 0.02, 1e9]  # ties round to even; saturation
    for scale in (0.02, 0.1):
        np.testing.assert_array_equal(pcal.quantize_activation(x, scale),
                                      jcal.quantize_activation(x, scale))
        assert pcal.quantization_snr_db(x[4:], scale) == jcal.quantization_snr_db(x[4:], scale)
    assert pcal.quantization_snr_db(np.zeros(4), 1.0) == float("inf")


def test_propagate_skips_float_multi_input_and_uncalibrated():
    """Only single-input Conv2D/Dense nodes with int8 weights whose producer
    has an act_scale are stamped."""
    g = P.build_model("espcn", h=8, w=8)
    g.infer_shapes(batch_size=1)
    g.nodes["input"].attrs["act_scale"] = 0.01
    g.nodes["conv_1"].attrs["act_scale"] = 0.02
    assert pcal.propagate_input_scales(g) == 0  # float weights
    from shadernn_tpu_torch.quant.quantize import quantize_graph_weights

    quantize_graph_weights(g)
    assert pcal.propagate_input_scales(g) == 2
    assert g.nodes["conv_1"].attrs["in_act_scale"] == 0.01
    assert g.nodes["conv_2"].attrs["in_act_scale"] == 0.02
    assert "in_act_scale" not in g.nodes["conv_3"].attrs


def test_calibration_carried_across_and_inert_outside_int8(rng):
    """calibration_from_graph copies act_scale / in_act_scale from a JAX
    graph; rebuilt at BF16 a calibrated, quantized graph runs float
    activations (the same as uncalibrated), at INT8 its chain takes in_q."""
    jeng, peng = _pair("espcn", h=16, w=24)
    x = rng.random((2, 16, 24, 1), dtype=np.float32)
    jcal.calibrate_activations(jeng, [{"input": x}])
    jcal.propagate_input_scales(jeng.graph)
    n = calibration_from_graph(jeng.graph, peng.graph)
    assert n == sum(("act_scale" in v.attrs) + ("in_act_scale" in v.attrs)
                    for v in jeng.graph.nodes.values())
    assert peng.graph.meta["act_scales"] == pytest.approx(jeng.graph.meta["act_scales"])
    bf16 = P.EngineOptions(precision=P.Precision.BF16, batch_size=2, device="cpu")
    plain = P.Engine.from_graph(P.build_model("espcn", h=16, w=24), bf16)
    from shadernn_tpu_torch.quant.quantize import quantize_graph_weights

    quantize_graph_weights(plain.graph)
    uncal = P.Engine.from_graph(plain.graph, bf16, optimize=False)
    cal = P.Engine.from_graph(peng.graph, bf16, optimize=False)
    assert not any(s.in_q for s in cal.model.forward.chain_specs["conv_1"])
    assert torch.equal(cal.run_single(x), uncal.run_single(x))
    int8 = P.Engine.from_graph(peng.graph, P.EngineOptions(
        precision=P.Precision.INT8, batch_size=2, device="cpu"), optimize=False)
    assert [bool(s.in_q) for s in int8.model.forward.chain_specs["conv_1"]] == [False, True, True]
