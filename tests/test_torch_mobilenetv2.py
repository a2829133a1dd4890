"""The port's MobileNetV2 slice against the JAX package: the ops it adds,
the builder, the block plan, and a reduced builder model through both
engines on the same inputs (the JAX engine runs its block kernel in Pallas
interpret mode, the port the kernel's plain version). The trained model
is in test_torch_mobilenetv2_trained.py.

Tolerance: the conftest thresholds (0.01 fp32, 0.1 bf16) times
max(1, max|reference|)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shadernn_tpu as J
from shadernn_tpu.engine.compile import compile_graph as j_compile
from shadernn_tpu.engine.compile import extract_params as j_extract
from shadernn_tpu.graph import fusion as jfusion
from shadernn_tpu.graph.ir import Node as JNode
from shadernn_tpu.graph.parser import parse_model_file as jparse
from shadernn_tpu.models.mobilenetv2 import build_mobilenetv2 as j_build
from shadernn_tpu.ops.registry import RunCtx as JCtx
from shadernn_tpu.ops.registry import get_op as j_op
from shadernn_tpu.tools.train_resnet18 import synth_cls as j_synth

import shadernn_tpu_torch as P
from shadernn_tpu_torch.engine.compile import compile_graph as p_compile
from shadernn_tpu_torch.graph import fusion as pfusion
from shadernn_tpu_torch.graph.ir import Node as PNode
from shadernn_tpu_torch.graph.parser import parse_model_file as pparse
from shadernn_tpu_torch.models.mobilenetv2 import build_mobilenetv2 as p_build
from shadernn_tpu_torch.models.zoo import MOBILENETV2_TRAINED
from shadernn_tpu_torch.ops import get_op as p_op
from shadernn_tpu_torch.ops.registry import RunCtx as PCtx
from shadernn_tpu_torch.tools.train_resnet18 import synth_cls as p_synth
from shadernn_tpu_torch.weights import params_from_numpy

TOL = {"fp32": 0.01, "bf16": 0.1}  # tests/conftest.py thresholds
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
REDUCED = dict(h=32, w=32, num_classes=10, width_mult=0.35, seed=11)


def close(got, want, prec):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= TOL[prec] * max(1.0, float(np.abs(want).max()))


def options(pkg, prec, **kw):
    if pkg is P:
        kw.setdefault("device", "cpu")
    return pkg.EngineOptions(precision=getattr(pkg.Precision, prec.upper()), **kw)


# -- ops -------------------------------------------------------------------

OP_CASES = [
    ("MaxPooling2D", dict(kernel_size=3, stride=2, padding="same"), (2, 9, 11, 5)),
    ("AveragePooling2D", dict(kernel_size=3, stride=2, padding="same"), (2, 9, 11, 5)),
    ("AveragePooling2D", dict(kernel_size=2, stride=2, padding="valid"), (1, 8, 6, 3)),
    ("AdaptiveAvgPool2d", dict(output_height=1, output_width=1), (2, 7, 7, 16)),   # divides
    ("AdaptiveAvgPool2d", dict(output_height=3, output_width=2), (2, 7, 5, 4)),    # integral
    ("BatchNormalization", dict(epsilon=1e-3, activation="relu6"), (2, 5, 6, 8)),
    ("SeparableConv2D", dict(kernel_size=3, stride=2, padding="same", multiplier=2,
                             activation="relu6", use_bias=True), (2, 10, 9, 4)),
    ("SeparableConv2D", dict(kernel_size=3, stride=1, padding="same", multiplier=1,
                             activation="linear", use_bias=False), (1, 6, 7, 8)),
    ("Flatten", {}, (2, 3, 4, 5)),
    ("Dense", dict(units=7, activation="softmax", use_bias=True), (3, 2, 2, 6)),
]


def op_params(rng, op, attrs, shape):
    c = shape[-1]
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    if op == "BatchNormalization":
        return dict(gamma=1 + 0.1 * r(c), beta=r(c), mean=r(c), variance=1 + np.abs(r(c)))
    if op == "SeparableConv2D":
        m = attrs["multiplier"]
        p = {"weight": r(3, 3, 1, c * m) / 3}
        if attrs["use_bias"]:
            p["bias"] = r(c * m)
        return p
    if op == "Dense":
        return {"weight": r(int(np.prod(shape[1:])), attrs["units"]) / 4, "bias": r(attrs["units"])}
    return {}


@pytest.mark.parametrize("prec", list(TOL))
@pytest.mark.parametrize("case", OP_CASES, ids=lambda c: c[0] + "_" + "x".join(map(str, c[2])))
def test_op_matches_jax(rng, case, prec):
    """Each op the slice adds, on the same input in both packages. Pools
    reduce in the input dtype and the non-divisible adaptive pool in
    float32, as the JAX ops do; the result dtype shows it."""
    op, attrs, shape = case
    params = op_params(rng, op, attrs, shape)
    x = rng.standard_normal(shape).astype(np.float32)
    tdt, jdt = DTYPES[prec]
    jn = JNode("n", op, ["x"], dict(attrs), {k: jnp.asarray(v) for k, v in params.items()})
    pn = PNode("n", op, ["x"], dict(attrs), {k: torch.from_numpy(v) for k, v in params.items()})
    want = j_op(op).run(jn, [jnp.asarray(x, jdt)], JCtx())
    got = p_op(op).run(pn, [torch.from_numpy(x).to(tdt)], PCtx(backend=P.BackendKind.TORCH))
    assert got.dtype == tdt and str(want.dtype) == str(tdt).split(".")[1]
    close(got, want, prec)
    spec = J.TensorSpec(shape)
    assert p_op(op).infer(pn, [P.TensorSpec(shape)]).shape == j_op(op).infer(jn, [spec]).shape


def test_dense_outside_the_kernel_gate_says_so(rng, caplog, monkeypatch):
    """A direct caller's KERNEL Dense that the fused-matmul kernel's gate
    declines runs the TORCH body and logs the gate; one inside the gate
    logs nothing, float or int8 weights alike (the gate takes int8
    storage, and its activations are all of the TORCH body's, so a
    declining gate is stood in for). (The engine decides at plan time and
    never hands a declined node KERNEL.)"""
    import logging

    from shadernn_tpu_torch.kernels import matmul

    params = {"weight": torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)),
              "bias": torch.from_numpy(rng.standard_normal(3).astype(np.float32))}
    int8 = {"weight_q": torch.from_numpy(rng.integers(-127, 128, (4, 3)).astype(np.int8)),
            "weight_scale": torch.from_numpy(rng.random((1, 3)).astype(np.float32) / 64)}
    x = torch.from_numpy(rng.standard_normal((2, 4)).astype(np.float32))
    for extra, declined in (({}, False), (int8, False), ({}, True)):
        if declined:
            monkeypatch.setattr(matmul, "dense_supported", lambda node: False)
        node = PNode("fc", "Dense", ["x"], dict(units=3, activation="relu"), {**params, **extra})
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="snn_torch.ops"):
            got = p_op("Dense").run(node, [x], PCtx(backend=P.BackendKind.KERNEL))
        close(got, p_op("Dense").run(node, [x], PCtx(backend=P.BackendKind.TORCH)), "fp32")
        said = "dense fc given to KERNEL runs on TORCH: outside the fused-matmul" in caplog.text
        assert said == declined, caplog.text


# -- builder and plan --------------------------------------------------------

def describe(graph):
    return [(n.name, n.op, list(n.inputs), dict(n.attrs), n.out_spec.shape,
             {k: np.asarray(v) for k, v in n.params.items()}) for n in graph.nodes.values()]


@pytest.mark.parametrize("kw", [{}, REDUCED], ids=["224_full_width", "32_width035"])
def test_builder_gives_jax_weights(kw):
    pg, jg = describe(p_build(**kw)), describe(j_build(**kw))
    assert [d[:5] for d in pg] == [d[:5] for d in jg]
    for (name, *_, pp), (*_, jp) in zip(pg, jg):
        assert pp.keys() == jp.keys(), name
        for k in pp:
            np.testing.assert_array_equal(pp[k], jp[k], err_msg=f"{name}.{k}")


def _planned(pkg, build, parse, fusion, source, prec):
    g = build() if source == "224" else parse(MOBILENETV2_TRAINED)
    fusion.optimize(g)
    g.infer_shapes(batch_size=8)
    compile_graph = p_compile if pkg is P else j_compile
    return compile_graph(g, options(pkg, prec, batch_size=8)).forward


@pytest.mark.parametrize("prec", list(TOL))
@pytest.mark.parametrize("source", ["224", "cls10"])
def test_block_plan_matches_jax(monkeypatch, source, prec):
    """The static plan only (no forward is run): 11 fused blocks at 224, 13
    on the trained model, whose folded stem is the one single conv."""
    monkeypatch.setenv("SNN_AUTO_PALLAS_ANYWHERE", "1")
    pf = _planned(P, p_build, pparse, pfusion, source, prec)
    jf = _planned(J, j_build, jparse, jfusion, source, prec)
    assert pf.block_plan == jf.block_plan
    assert len(pf.block_plan) == {"224": 11, "cls10": 13}[source]
    assert pf.chain_plan == jf.chain_plan == {}
    assert pf.single_conv_plan == ([] if source == "224" else ["stem_conv"])


# -- whole models ------------------------------------------------------------

def _reduced(build, seed=REDUCED["seed"]):
    """The reduced model with BatchNorm statistics drawn from a seed (the
    builder's are the identity, under which the signal fades to logits of
    about 1e-3) and a linear head: softmax over seeded weights is
    near-uniform, so the logits are what is held."""
    g = build(**dict(REDUCED, seed=seed))
    rng = np.random.default_rng(seed)
    for n in g.nodes.values():
        if n.op == "BatchNormalization":
            c = n.params["gamma"].shape[0]
            n.params.update(
                gamma=(1.5 + 0.2 * rng.standard_normal(c)).astype(np.float32),
                beta=(0.2 * rng.standard_normal(c)).astype(np.float32),
                mean=(0.1 * rng.standard_normal(c)).astype(np.float32),
                variance=(1 + 0.1 * np.abs(rng.standard_normal(c))).astype(np.float32))
    g.nodes["fc"].attrs["activation"] = "linear"
    return g


@pytest.fixture(scope="module")
def reduced_jax():
    """JAX engine outputs of the reduced model (blocks in interpret mode)
    and its parameters."""
    import os

    x = np.random.default_rng(5).random((4, 32, 32, 3), dtype=np.float32)
    os.environ["SNN_AUTO_PALLAS_ANYWHERE"] = "1"
    try:
        out = {}
        for prec in TOL:
            eng = J.Engine.from_graph(_reduced(j_build), options(J, prec, batch_size=4))
            assert len(eng.model.forward.block_plan) == 13
            out[prec] = np.asarray(eng.run_single(x), np.float32)
        params = j_extract(eng.model.graph)
    finally:
        del os.environ["SNN_AUTO_PALLAS_ANYWHERE"]
    return x, out, params


@pytest.mark.parametrize("prec", list(TOL))
def test_reduced_builder_model_matches_jax(reduced_jax, prec):
    x, want, _ = reduced_jax
    eng = P.Engine.from_graph(_reduced(p_build), options(P, prec, batch_size=4))
    assert len(eng.model.forward.block_plan) == 13
    assert np.abs(want[prec]).max() > 1.0
    close(eng.run_single(x), want[prec], prec)


def test_params_from_jax_give_jax_outputs(reduced_jax):
    """params_from_numpy carries MobileNetV2's parameters across (depthwise
    (3,3,1,E) weights, BN-folded biases, the dense layer)."""
    x, want, params = reduced_jax
    eng = P.Engine.from_graph(_reduced(p_build, seed=12), options(P, "bf16", batch_size=4))
    assert np.max(np.abs(eng.run_single(x).numpy() - want["bf16"])) > 0.1
    eng.model.load_params(params_from_numpy(params, "cpu"))
    assert tuple(eng.model.params["block5_dw"]["weight"].shape[:3]) == (3, 3, 1)
    close(eng.run_single(x), want["bf16"], "bf16")


def test_synth_cls_is_the_jax_task():
    px, py = p_synth(np.random.default_rng(3), 6)
    jx, jy = j_synth(np.random.default_rng(3), 6)
    np.testing.assert_array_equal(px, jx)
    np.testing.assert_array_equal(py, jy)
