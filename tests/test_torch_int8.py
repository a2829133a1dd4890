"""The port's INT8 engine against the JAX package's: weight quantization
bit for bit, fault C4 (a quantized graph at FP32, BF16 and INT8), the
TORCH path's A8W8 Conv2D and Dense (exact int32 sums), and whole engines
(ESPCN, a two-block MobileNetV2, the trained ResNet18) weight-only and
calibrated on one set of scales carried across, with the int8 plans (a
chain layer's in_q, a block's ax1/ax2) equal to the JAX package's. Where
the JAX engine runs Pallas kernels it runs them in interpret mode
(SNN_AUTO_PALLAS_ANYWHERE), as its own tests do on the CPU.

Tolerance: 0.1 x max(1, max|reference|) for bf16/int8 activations, 0.01
for fp32 (tests/conftest.py thresholds)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shadernn_tpu as J
from shadernn_tpu.graph.builder import GraphBuilder as JBuilder
from shadernn_tpu.graph.ir import Node as JNode
from shadernn_tpu.models import build_model as jbuild
from shadernn_tpu.models.mobilenetv2 import _inv_res_block as j_block
from shadernn_tpu.ops.registry import RunCtx as JCtx
from shadernn_tpu.ops.registry import get_op as j_op
from shadernn_tpu.quant.calibrate import calibrate_activations as j_calibrate
from shadernn_tpu.quant.quantize import quantize_graph_weights as j_quantize

import shadernn_tpu_torch as P
from shadernn_tpu_torch.graph.builder import GraphBuilder as PBuilder
from shadernn_tpu_torch.graph.ir import Node as PNode
from shadernn_tpu_torch.models.mobilenetv2 import _inv_res_block as p_block
from shadernn_tpu_torch.models.zoo import RESNET18_TRAINED
from shadernn_tpu_torch.ops import get_op as p_op
from shadernn_tpu_torch.ops.conv import conv2d_nhwc_int8, quantize_act
from shadernn_tpu_torch.ops.registry import RunCtx as PCtx
from shadernn_tpu_torch.quant.quantize import quantize_graph_weights as p_quantize
from shadernn_tpu_torch.tools.train_resnet18 import synth_cls
from shadernn_tpu_torch.weights import calibration_from_graph

TOL = {"fp32": 0.01, "bf16": 0.1, "int8": 0.1}


def close(got, want, prec):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    assert err <= TOL[prec] * max(1.0, float(np.abs(want).max())), err


def options(pkg, prec, **kw):
    if pkg is P:
        kw.setdefault("device", "cpu")
    return pkg.EngineOptions(precision=getattr(pkg.Precision, prec.upper()), **kw)


def two_block(builder, block):
    """Two MobileNetV2 inverted-residual blocks (t=6, the first with its
    residual) between an input and a 10-class head, BatchNorm folded."""
    b = builder("mnv2_two_blocks", seed=11)
    x = b.input(8, 8, 16)
    x = block(b, x, 6, 16, 1, "block0")
    x = block(b, x, 6, 24, 1, "block1")
    x = b.adaptive_avgpool(x, 1, name="gap")
    x = b.flatten(x, name="flatten")
    b.dense(x, 10, activation="softmax", name="fc")
    return b.build()


# -- quantization ----------------------------------------------------------

@pytest.mark.parametrize("model", ["espcn", "mobilenetv2", "resnet18"])
def test_quantize_graph_weights_is_bit_equal_to_jax(model):
    kw = dict(h=32, w=32) if model != "espcn" else dict(h=16, w=24)
    jg, pg = jbuild(model, **kw), P.build_model(model, **kw)
    for g, fusion in ((jg, J.graph.fusion), (pg, __import__(
            "shadernn_tpu_torch.graph.fusion", fromlist=["optimize"]))):
        fusion.optimize(g)
    assert p_quantize(pg) == j_quantize(jg) > 0
    assert p_quantize(pg) == 0  # twice is a no-op
    # Carried across from the JAX graph, int8 storage keeps its dtypes.
    from shadernn_tpu.engine.compile import extract_params as j_extract

    from shadernn_tpu_torch.weights import params_from_numpy

    carried = params_from_numpy(j_extract(jg), "cpu")
    for name, params in carried.items():
        for k, t in params.items():
            assert t.dtype == torch.from_numpy(np.asarray(pg.nodes[name].params[k])).dtype, k
    for name, jn in jg.nodes.items():
        pn = pg.nodes[name]
        assert sorted(pn.params) == sorted(jn.params), name
        for k, v in jn.params.items():
            got = np.asarray(pn.params[k])
            assert got.dtype == np.asarray(v).dtype, (name, k)
            np.testing.assert_array_equal(got, np.asarray(v), err_msg=f"{name}.{k}")


# -- fault C4: a quantized graph at every precision ----------------------------

@pytest.mark.parametrize("prec", ["fp32", "bf16", "int8"])
def test_quantized_graph_runs_at_every_precision_c4(rng, prec):
    """A graph whose Conv2D, SeparableConv2D and Dense weights are int8
    (weight_q, weight_scale; no float weight) runs in the port as in the
    JAX package, at FP32, BF16 and INT8 (it raised KeyError before)."""
    jg, pg = two_block(JBuilder, j_block), two_block(PBuilder, p_block)
    for g, fusion, quantize in ((jg, J.graph.fusion, j_quantize), (pg, __import__(
            "shadernn_tpu_torch.graph.fusion", fromlist=["optimize"]), p_quantize)):
        fusion.optimize(g)
        quantize(g)
    assert not any("weight" in n.params for n in pg.nodes.values())
    x = rng.random((2, 8, 8, 16), dtype=np.float32)
    want = np.asarray(J.Engine.from_graph(jg, options(J, prec, batch_size=2),
                                          optimize=False).run_single(x), np.float32)
    eng = P.Engine.from_graph(pg, options(P, prec, batch_size=2), optimize=False)
    assert sorted(eng.model.forward.block_plan) == ["block0_expand", "block1_expand"]
    close(eng.run_single(x), want, prec)


def test_both_weights_run_the_int8_one(rng):
    """A node that carries a float weight and int8 storage runs the int8 one,
    as in the JAX package (ops/conv.py get_weight)."""
    w = rng.standard_normal((3, 3, 4, 8)).astype(np.float32)
    q = rng.integers(-127, 128, (3, 3, 4, 8)).astype(np.int8)
    s = (rng.random((1, 1, 1, 8)) / 100).astype(np.float32)
    attrs = dict(kernel_size=3, out_channels=8, padding="same", stride=1, activation="linear",
                 use_bias=False)
    x = rng.standard_normal((1, 6, 6, 4)).astype(np.float32)
    got = p_op("Conv2D").run(PNode("c", "Conv2D", ["x"], attrs, {
        "weight": torch.from_numpy(w), "weight_q": torch.from_numpy(q),
        "weight_scale": torch.from_numpy(s)}), [torch.from_numpy(x)], PCtx(precision=P.Precision.FP32))
    want = j_op("Conv2D").run(JNode("c", "Conv2D", ["x"], attrs, {
        "weight": jnp.asarray(w), "weight_q": jnp.asarray(q), "weight_scale": jnp.asarray(s)}),
        [jnp.asarray(x)], JCtx(precision=J.Precision.FP32))
    close(got, want, "fp32")
    assert np.max(np.abs(got.numpy() - np.asarray(p_op("Conv2D").run(PNode(
        "c", "Conv2D", ["x"], attrs, {"weight": torch.from_numpy(w)}), [torch.from_numpy(x)],
        PCtx()).numpy()))) > 0.1


# -- the TORCH path's A8W8 -----------------------------------------------------

# (op, attrs, input shape, in_act_scale): the last conv has K = 9 * 128 = 1152,
# so its int32 sums reach 1152 * 127^2 > 2^24, where a float32 sum is not exact.
A8W8_CASES = [
    ("Conv2D", dict(kernel_size=3, out_channels=32, stride=1, padding="same"), (2, 7, 9, 32), 0.02),
    ("Conv2D", dict(kernel_size=3, out_channels=64, stride=2, padding="same"), (2, 9, 8, 32), 0.03),
    ("Conv2D", dict(kernel_size=3, out_channels=32, stride=1, padding="same"), (1, 6, 6, 128), 0.05),
    ("Dense", dict(units=40), (3, 2048), 0.01),
]


def a8w8_node(pkg_node, to, op, attrs, shape, sa, rng):
    cin = shape[-1]
    k = attrs.get("kernel_size", 1)
    wshape = (k, k, cin, attrs["out_channels"]) if op == "Conv2D" else (cin, attrs["units"])
    params = {"weight_q": rng.integers(-127, 128, wshape).astype(np.int8),
              "weight_scale": (rng.random((1,) * (len(wshape) - 1) + (wshape[-1],)) / 2000
                               ).astype(np.float32),
              "bias": rng.standard_normal(wshape[-1]).astype(np.float32) * 0.1}
    a = dict(attrs, activation="relu", use_bias=True, in_act_scale=sa)
    return pkg_node("n", op, ["x"], a, {k_: to(v) for k_, v in params.items()})


@pytest.mark.parametrize("case", A8W8_CASES, ids=lambda c: f"{c[0]}_{'x'.join(map(str, c[2]))}")
def test_torch_a8w8_matches_jax_xla(case):
    op, attrs, shape, sa = case
    r = np.random.default_rng(3)
    x = (r.standard_normal(shape) * 127 * sa / 3).astype(np.float32)
    jn = a8w8_node(JNode, jnp.asarray, op, attrs, shape, sa, np.random.default_rng(5))
    pn = a8w8_node(PNode, torch.from_numpy, op, attrs, shape, sa, np.random.default_rng(5))
    want = j_op(op).run(jn, [jnp.asarray(x, jnp.bfloat16)],
                        JCtx(precision=J.Precision.INT8, backend=J.BackendKind.XLA))
    got = p_op(op).run(pn, [torch.from_numpy(x).to(torch.bfloat16)],
                       PCtx(precision=P.Precision.INT8, backend=P.BackendKind.TORCH))
    assert got.dtype == torch.bfloat16
    close(got, want, "int8")
    # Rebuilt at BF16 the calibrated scale is inert: float activations.
    bf16 = p_op(op).run(pn, [torch.from_numpy(x).to(torch.bfloat16)],
                        PCtx(precision=P.Precision.BF16, backend=P.BackendKind.TORCH))
    assert not torch.equal(bf16, got)


def test_a8w8_int32_sums_are_jax_exactly(rng):
    """Past 2^24 (K = 1152 taps of 127^2) the int32 sums before the scale
    equal the JAX XLA path's int32 convolution, bit for bit."""
    x = np.abs(rng.standard_normal((2, 6, 7, 128))).astype(np.float32) + 1
    wq = np.full((3, 3, 128, 8), 127, np.int8)
    wq[..., 4:] = rng.integers(-127, 128, (3, 3, 128, 4)).astype(np.int8)
    xq = quantize_act(torch.from_numpy(x), 0.001)  # saturates: every tap at +-127
    got = conv2d_nhwc_int8(xq, torch.from_numpy(wq), (1, 1, 1, 1)).numpy()
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq.numpy()), jnp.asarray(wq), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
    assert np.abs(want).max() == 9 * 128 * 127 * 127 > 2 ** 24
    np.testing.assert_array_equal(got, want)


# -- engines, weight-only and calibrated -------------------------------------------

def _engines(jgraph, pgraph, batch, x, calib, check):
    """Weight-only INT8 (JAX, port) engines on frames x, then both rebuilt
    after calibrating the JAX engine (`calib`, a list of batches) with the
    scales carried onto the port's graph: check(calibrated, jeng, peng,
    want, got) for each pair. The weight-only pair runs before calibration:
    the JAX engine plans its kernels when it first traces."""
    opts_j, opts_p = options(J, "int8", batch_size=batch), options(P, "int8", batch_size=batch)
    jw, pw = J.Engine.from_graph(jgraph, opts_j), P.Engine.from_graph(pgraph, opts_p)
    check(0, jw, pw, np.asarray(jw.run_single(x), np.float32), pw.run_single(x))
    j_calibrate(jw, calib)
    assert calibration_from_graph(jw.graph, pw.graph) > 0
    jc = J.Engine.from_graph(jw.graph, opts_j, optimize=False)
    pc = P.Engine.from_graph(pw.graph, opts_p, optimize=False)
    check(1, jc, pc, np.asarray(jc.run_single(x), np.float32), pc.run_single(x))


def _same_int8_plan(jeng, peng):
    """in_q per chain layer (JAX: packed_chain_specs, recorded at trace time)
    and ax1/ax2 per block equal to the JAX plan's; the same nodes stamped
    with in_act_scale."""
    jf, pf = jeng.model.forward, peng.model.forward
    for head, (jspecs, _h, _w) in jf.packed_chain_specs.items():
        assert [s.in_q for s in pf.chain_specs[head]] == [s.in_q for s in jspecs], head
    for head, specs in pf.chain_specs.items():
        if head not in jf.packed_chain_specs:  # tail none: the im2col entry has no a8
            assert not any(s.in_q for s in specs), head
    assert sorted(pf.block_specs) == sorted(jf.block_specs)
    for head, (jspec, _n) in jf.block_specs.items():
        assert (pf.block_specs[head].ax1, pf.block_specs[head].ax2) == (jspec.ax1, jspec.ax2)
    stamped = lambda g: {n: v.attrs["in_act_scale"] for n, v in g.nodes.items()  # noqa: E731
                         if "in_act_scale" in v.attrs}
    assert stamped(peng.graph) == stamped(jeng.graph)


def test_espcn_int8_engine_matches_jax(monkeypatch):
    """ESPCN 2x at 48x64: weight-only, one chain launch with int8 weights;
    calibrated, layers 2-3 take in_q (C = 16 after relu) and the head (C =
    1) keeps bf16."""
    monkeypatch.setenv("SNN_AUTO_PALLAS_ANYWHERE", "1")
    x = np.random.default_rng(7).random((2, 48, 64, 1), dtype=np.float32)
    calib = [{"input": np.random.default_rng(8).random((2, 48, 64, 1), dtype=np.float32)}]

    def check(calibrated, jeng, peng, want, got):
        close(got, want, "int8")
        _same_int8_plan(jeng, peng)
        in_q = [s.in_q for s in peng.model.forward.chain_specs["conv_1"]]
        assert (in_q[0] == 0 and all(in_q[1:])) if calibrated else not any(in_q)
        assert list(peng.model.forward.chain_plan) == ["conv_1"]
        if calibrated:  # chain_a8="off" keeps every layer on the bf16 dot, as in JAX
            off = {"batch_size": 2, "chain_a8": "off"}
            poff = P.Engine.from_graph(peng.graph, options(P, "int8", **off), optimize=False)
            joff = J.Engine.from_graph(jeng.graph, options(J, "int8", **off), optimize=False)
            assert not any(s.in_q for s in poff.model.forward.chain_specs["conv_1"])
            want_off = np.asarray(joff.run_single(x), np.float32)
            assert not any(s.in_q for s in joff.model.forward.packed_chain_specs["conv_1"][0])
            close(poff.run_single(x), want_off, "int8")

    _engines(jbuild("espcn", h=48, w=64, seed=5), P.build_model("espcn", h=48, w=64, seed=5), 2,
             x, calib, check)


def test_two_block_mobilenetv2_int8_engine_matches_jax(monkeypatch):
    """The two blocks take int8 weights; calibrated, ax1/ax2 as the JAX
    planner sets them."""
    monkeypatch.setenv("SNN_AUTO_PALLAS_ANYWHERE", "1")
    x = np.random.default_rng(7).random((2, 8, 8, 16), dtype=np.float32)
    calib = [{"input": np.random.default_rng(8).random((2, 8, 8, 16), dtype=np.float32)}]

    def check(calibrated, jeng, peng, want, got):
        close(got, want, "int8")
        _same_int8_plan(jeng, peng)
        specs = peng.model.forward.block_specs
        assert sorted(specs) == ["block0_expand", "block1_expand"]
        assert all(bool(s.ax1) == bool(s.ax2) == bool(calibrated) for s in specs.values())

    _engines(two_block(JBuilder, j_block), two_block(PBuilder, p_block), 2, x, calib, check)


def test_trained_resnet18_int8_engine_matches_jax():
    """The trained ResNet18 under AUTO: its chains and single convs take
    int8 weights (the chains' im2col entry has no a8); calibrated, the
    TORCH convs and Dense where a8w8_profitable holds run A8W8 on the
    stamped in_act_scale (more than 5 nodes), against the JAX XLA path."""
    x, _ = synth_cls(np.random.default_rng(424242), 8)
    calib = [{"input": synth_cls(np.random.default_rng(7), 8)[0]}]
    from shadernn_tpu.graph.parser import parse_model_file as jparse

    from shadernn_tpu_torch.graph.parser import parse_model_file as pparse

    jg, pg = jparse(RESNET18_TRAINED), pparse(RESNET18_TRAINED)

    def check(calibrated, jeng, peng, want, got):
        fwd = peng.model.forward
        assert sorted(fwd.chain_plan) == ["s0b0_conv1", "s0b1_conv1"]
        assert len(fwd.single_conv_plan) >= 1
        assert not any(s.in_q for specs in fwd.chain_specs.values() for s in specs)
        stamped = {n for n, v in peng.graph.nodes.items() if "in_act_scale" in v.attrs}
        assert stamped == {n for n, v in jeng.graph.nodes.items() if "in_act_scale" in v.attrs}
        assert (len(stamped) > 5) if calibrated else not stamped
        close(got, want, "int8")
        np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))

    _engines(jg, pg, 8, x, calib, check)


def test_engine_prepares_each_torch_layer_weight_once(monkeypatch):
    """The TORCH layers of an INT8 engine (the trained ResNet18's stride-2
    and 1x1 convs and its Dense, A8W8 once calibrated) dequantize or lay
    out their int8 weights once per parameter set, not on every step; new
    parameters are prepared anew."""
    from shadernn_tpu_torch.graph.parser import parse_model_file as pparse
    from shadernn_tpu_torch.ops import conv as pconv
    from shadernn_tpu_torch.quant.calibrate import calibrate_activations

    made = {"rhs": 0, "dequant": 0}

    def counted(key, fn):
        def run(*a, **k):
            made[key] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(pconv, "int8_rhs", counted("rhs", pconv.int8_rhs))
    monkeypatch.setattr(pconv, "get_weight", counted("dequant", pconv.get_weight))
    x, _ = synth_cls(np.random.default_rng(424242), 4)
    opts = options(P, "int8", batch_size=4)
    eng = P.Engine.from_graph(pparse(RESNET18_TRAINED), opts)
    calibrate_activations(eng, [{"input": x}], percentile=None)
    eng = P.Engine.from_graph(eng.graph, opts, optimize=False)
    made.update(rhs=0, dequant=0)
    first = eng.run_single(x)
    once = dict(made)
    assert once["rhs"] >= 5 and once["dequant"] >= 1, once
    torch.testing.assert_close(eng.run_single(x), first, rtol=0, atol=0)
    assert made == once, (made, once)
    eng.model.load_params({n: {k: v.clone() for k, v in d.items()}
                           for n, d in eng.model.params.items()})
    torch.testing.assert_close(eng.run_single(x), first, rtol=0, atol=0)
    assert made == {k: 2 * v for k, v in once.items()}, (made, once)


def test_mid_graph_chain_head_gets_no_step_without_calibration(monkeypatch, caplog):
    """Fault C1 of the JAX package is not copied: a packed chain whose head
    a mid-graph conv feeds gets no in_q without calibration (the JAX
    package gives it 1/127, clipping its input to +-1); the port's engine
    equals the JAX engine run with chain_a8="off"."""
    import logging

    monkeypatch.setenv("SNN_AUTO_PALLAS_ANYWHERE", "1")

    def graph(builder):
        b = builder("c1", seed=9)
        x = b.input(10, 12, 1)
        x = b.conv2d(x, 16, 1, activation="relu", name="pre")  # k1: TORCH under AUTO
        x = b.conv2d(x, 16, 3, activation="relu", name="head")
        x = b.conv2d(x, 4, 3, name="last")
        x = b.subpixel(x, 2, name="subpixel")
        b.activation(x, "tanh", name="out")
        return b.build()

    x = np.random.default_rng(3).random((2, 10, 12, 1), dtype=np.float32) * 4
    with caplog.at_level(logging.INFO, logger="snn_torch.compile"):
        peng = P.Engine.from_graph(graph(PBuilder), options(P, "int8", batch_size=2))
    assert peng.model.forward.chain_plan["head"][:3] == ["head", "last", "subpixel"]
    assert [s.in_q for s in peng.model.forward.chain_specs["head"]] == [0.0, 0.0]
    assert "head bf16 (a mid-graph head without a calibrated in_act_scale)" in caplog.text
    jauto = J.Engine.from_graph(graph(JBuilder), options(J, "int8", batch_size=2))
    joff = J.Engine.from_graph(graph(JBuilder), options(J, "int8", batch_size=2, chain_a8="off"))
    want = np.asarray(joff.run_single(x), np.float32)
    np.asarray(jauto.run_single(x))
    assert jauto.model.forward.packed_chain_specs["head"][0][0].in_q == pytest.approx(1 / 127)
    assert not any(s.in_q for s in joff.model.forward.packed_chain_specs["head"][0])
    assert peng.model.forward.chain_plan == joff.model.forward.chain_plan
    close(peng.run_single(x), want, "int8")


def test_trained_espcn_int8_precision_delta(rng):
    """ESPCN's INT8 gate (tests/test_accuracy_trained.py): the trained model
    at INT8 weight-only keeps PSNR > 30 dB against FP32 (the port's
    utils/metrics, equal to the JAX package's on the same arrays)."""
    from shadernn_tpu.utils import metrics as jm

    from shadernn_tpu_torch.models.zoo import ESPCN_TRAINED
    from shadernn_tpu_torch.utils import metrics as pm

    x = rng.random((2, 36, 64, 1), dtype=np.float32)
    fp32, int8 = (P.Engine.from_json(ESPCN_TRAINED, options(P, prec, batch_size=2),
                                     input_hw=(36, 64)) for prec in ("fp32", "int8"))
    rep = pm.precision_delta_report(fp32, int8, {"input": x}, kind="sr")
    assert rep["psnr_db"] > 30.0 and rep["max_abs_diff"] < 0.1, rep
    a, b = fp32.run_single(x).numpy(), int8.run_single(x).numpy()
    assert pm.psnr(a, b) == jm.psnr(a, b) == rep["psnr_db"]
    assert pm.psnr(torch.from_numpy(a), b) == rep["psnr_db"]
    logits = rng.standard_normal((16, 10))
    assert pm.agreement_rate(logits, logits + 0.01) == jm.agreement_rate(logits, logits + 0.01)
