"""The port's ResNet18 slice against the JAX package: the builder, the ops
node by node on the plain backends, the plan under a backend forced to the
kernel, and a reduced model (base_filters=8, 16x16, batch 2) through both
engines on the same inputs. Under PALLAS the JAX engine runs its kernels in
Pallas interpret mode; under KERNEL the port runs its kernels' plain
versions (the CPU). Last, the trained artifact (10 classes, 32x32,
base_filters=16) under KERNEL against the JAX engine's plain backend on
images of the task it was trained on, and its top-1 at a small sample.

The JAX fused matmul's softmax is wrong (it counts the padded columns of
its tile, tests/test_torch_matmul.py), so the forced-kernel engines are
compared on logits (fc set to linear in both) and the port's probabilities
against the JAX XLA backend.

Tolerance: the conftest thresholds (0.01 fp32, 0.1 bf16) times
max(1, max|reference|)."""

import logging

import numpy as np
import pytest
import torch

import shadernn_tpu as J
from shadernn_tpu.models.resnet18 import build_resnet18_cifar10 as j_build
from shadernn_tpu.ops.conv import pallas_chain_supported, pallas_conv_supported

import shadernn_tpu_torch as P
from shadernn_tpu_torch.graph.builder import GraphBuilder
from shadernn_tpu_torch.kernels import launch_counts
from shadernn_tpu_torch.models.resnet18 import build_resnet18_cifar10 as p_build
from shadernn_tpu_torch.models.zoo import RESNET18_TRAINED
from shadernn_tpu_torch.models.zoo import build_model as p_build_model
from shadernn_tpu_torch.tools.train_resnet18 import synth_cls

TOL = {"fp32": 0.01, "bf16": 0.1}  # tests/conftest.py thresholds
REDUCED = dict(h=16, w=16, base_filters=8, seed=11)


def close(got, want, prec):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= TOL[prec] * max(1.0, float(np.abs(want).max()))


def options(pkg, prec, backend, **kw):
    if pkg is P:
        kw.setdefault("device", "cpu")
    names = {"kernel": "KERNEL" if pkg is P else "PALLAS", "plain": "TORCH" if pkg is P else "XLA"}
    return pkg.EngineOptions(precision=getattr(pkg.Precision, prec.upper()),
                             backend=getattr(pkg.BackendKind, names[backend]), **kw)


def reduced(build, head="softmax"):
    """The reduced model with BatchNorm statistics drawn from a seed, so
    that the folds are not the identity and the logits are O(1)."""
    g = build(**REDUCED)
    rng = np.random.default_rng(REDUCED["seed"])
    for n in g.nodes.values():
        if n.op == "BatchNormalization":
            c = n.params["gamma"].shape[0]
            n.params.update(
                gamma=(1.2 + 0.2 * rng.standard_normal(c)).astype(np.float32),
                beta=(0.2 * rng.standard_normal(c)).astype(np.float32),
                mean=(0.1 * rng.standard_normal(c)).astype(np.float32),
                variance=(1 + 0.1 * np.abs(rng.standard_normal(c))).astype(np.float32))
    g.nodes["fc"].attrs["activation"] = head
    return g


def describe(graph):
    return [(n.name, n.op, list(n.inputs), dict(n.attrs), n.out_spec.shape,
             {k: np.asarray(v) for k, v in n.params.items()}) for n in graph.nodes.values()]


@pytest.mark.parametrize("kw", [{}, REDUCED, dict(base_filters=16)],
                         ids=["zoo_width", "base8_16x16", "base16"])
def test_builder_gives_jax_weights(kw):
    pg, jg = describe(p_build(**kw)), describe(j_build(**kw))
    assert [d[:5] for d in pg] == [d[:5] for d in jg]
    for (name, *_, pp), (*_, jp) in zip(pg, jg):
        assert pp.keys() == jp.keys(), name
        for k in pp:
            np.testing.assert_array_equal(pp[k], jp[k], err_msg=f"{name}.{k}")
    assert len(p_build_model("resnet18", **kw).nodes) == len(pg)


@pytest.mark.parametrize("prec", list(TOL))
def test_every_layer_matches_jax_on_the_plain_backends(prec):
    """Node by node (dump_outputs) on TORCH against XLA: the BatchNorm
    folds over the bias-free convs (20 of them) and the Add's fused relu."""
    x = np.random.default_rng(5).random((2, 16, 16, 3), dtype=np.float32)
    jeng = J.Engine.from_graph(reduced(j_build), options(J, prec, "plain", batch_size=2,
                                                         dump_outputs=True))
    peng = P.Engine.from_graph(reduced(p_build), options(P, prec, "plain", batch_size=2,
                                                         dump_outputs=True))
    jd = jeng.run({"input": x})["__dumps__"]
    pd = peng.run({"input": x})["__dumps__"]
    assert set(pd) == set(jd) and len(pd) == 31
    assert not any(n.op == "BatchNormalization" for n in peng.graph.nodes.values())
    for name in pd:
        close(pd[name], jd[name], prec)
    assert float(pd["s0b0_out"].min()) == 0.0  # the Add applied its relu


def conv_routes_jax(graph):
    """Where the JAX package sends each Conv2D when every node is forced to
    PALLAS (engine/compile.py and ops/conv.py): the chain planner's kernels,
    the per-layer kernel, or XLA."""
    routes = {}
    for n in graph.nodes.values():
        if n.op != "Conv2D":
            continue
        cin = sum(graph.nodes[i].out_spec.c for i in n.inputs)
        if len(n.inputs) == 1 and pallas_chain_supported(n, cin):
            routes[n.name] = "chain planner"
        elif pallas_conv_supported(n, (1, 1, 1, cin)):
            routes[n.name] = "per-layer kernel"
        else:
            routes[n.name] = "plain"
    return routes


@pytest.mark.parametrize("kw", [REDUCED, dict(base_filters=16), {}],
                         ids=["base8_16x16", "base16", "zoo_width"])
def test_forced_kernel_plan_matches_jax(kw):
    """The static plans only. Every chain of the port is a chain of the JAX
    plan; a JAX chain that the port's chain kernel declines (o > 32, or its
    shared memory) runs conv by conv on the single-conv kernel; the convs
    the port leaves to TORCH are the ones the JAX package leaves to XLA
    (stride 2, or more than 128 channels); fc is on the fused matmul."""
    jf = J.Engine.from_graph(j_build(**kw), options(J, "bf16", "kernel", batch_size=2)).model
    pf = P.Engine.from_graph(p_build(**kw), options(P, "bf16", "kernel", batch_size=2)).model
    jplan, fwd = jf.forward.chain_plan, pf.forward
    routes = conv_routes_jax(jf.graph)
    assert all(jplan[head] == members for head, members in fwd.chain_plan.items())
    chained = {n for members in fwd.chain_plan.values() for n in members}
    declined = {n for head, members in jplan.items() if head not in fwd.chain_plan
                for n in members}
    assert chained | set(fwd.single_conv_plan) == {
        n for n, r in routes.items() if r == "chain planner"}
    assert declined <= set(fwd.single_conv_plan)
    assert fwd.kernel_conv_plan == [n for n, r in routes.items() if r == "per-layer kernel"] == []
    on_torch = [n.name for n in pf.graph.nodes.values() if n.op == "Conv2D"
                and n.name not in chained | set(fwd.single_conv_plan)]
    assert on_torch == [n for n, r in routes.items() if r == "plain"]
    assert all(int(pf.graph.nodes[n].attr("stride", 1)) == 2
               or pf.graph.nodes[n].out_spec.c > 128 for n in on_torch)
    assert fwd.kernel_dense_plan == ["fc"] and fwd.block_plan == {}
    if not kw:  # zoo width: stem and the stride-1 convs of stages 0-1
        assert fwd.chain_plan == {}
        assert fwd.single_conv_plan == [
            "stem_conv", "s0b0_conv1", "s0b0_conv2", "s0b1_conv1", "s0b1_conv2",
            "s1b0_conv2", "s1b1_conv1", "s1b1_conv2"]


def test_auto_plans_no_layer_kernel():
    fwd = P.Engine.from_graph(p_build(**REDUCED), P.EngineOptions(device="cpu")).model.forward
    assert fwd.kernel_dense_plan == [] and fwd.kernel_conv_plan == []


@pytest.fixture(scope="module")
def reduced_jax():
    """JAX outputs of the reduced model: logits under PALLAS (interpret
    mode) and probabilities under XLA, per precision."""
    x = np.random.default_rng(5).random((2, 16, 16, 3), dtype=np.float32)
    out = {}
    for prec in TOL:
        logits = J.Engine.from_graph(reduced(j_build, "linear"),
                                     options(J, prec, "kernel", batch_size=2)).run_single(x)
        probs = J.Engine.from_graph(reduced(j_build),
                                    options(J, prec, "plain", batch_size=2)).run_single(x)
        out[prec] = (np.asarray(logits, np.float32), np.asarray(probs, np.float32))
    return x, out


@pytest.mark.parametrize("prec", list(TOL))
def test_forced_kernel_logits_match_jax(reduced_jax, prec):
    x, want = reduced_jax
    eng = P.Engine.from_graph(reduced(p_build, "linear"), options(P, prec, "kernel", batch_size=2))
    assert eng.model.forward.kernel_dense_plan == ["fc"]
    before = launch_counts()
    got = eng.run_single(x)
    # A CPU run takes the plain versions: no kernel launches.
    assert launch_counts() == before
    assert np.abs(want[prec][0]).max() > 1.0
    close(got, want[prec][0], prec)


@pytest.mark.parametrize("prec", list(TOL))
def test_forced_kernel_probabilities_match_jax_xla(reduced_jax, prec):
    x, want = reduced_jax
    got = P.Engine.from_graph(reduced(p_build), options(P, prec, "kernel", batch_size=2)).run_single(x)
    assert torch.allclose(got.sum(-1), torch.ones(2), atol=1e-5 if prec == "fp32" else 1e-2)
    close(got, want[prec][1], prec)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want[prec][1].argmax(-1))


def test_forced_kernel_matches_the_torch_backend(reduced_jax):
    x, _ = reduced_jax
    got = P.Engine.from_graph(reduced(p_build, "linear"),
                              options(P, "fp32", "kernel", batch_size=2)).run_single(x)
    want = P.Engine.from_graph(reduced(p_build, "linear"),
                               options(P, "fp32", "plain", batch_size=2)).run_single(x)
    close(got, want, "fp32")
    assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


def test_declined_nodes_are_logged_with_their_gate(caplog):
    """A node given to KERNEL that no kernel takes runs on TORCH, decided at
    plan time, with a log line naming the gate."""
    b = GraphBuilder("declined", seed=3)
    x = b.input(8, 8, 4)
    x = b.conv2d(x, 8, 3, activation="softmax", name="softmax_conv")
    x = b.conv2d(x, 136, 3, name="wide")
    x = b.flatten(x)
    b.dense(x, 5, activation="softmax", name="int8_fc")
    g = b.build()
    # int8 weight storage (weight-only INT8): the fused matmul takes it.
    fc = g.nodes["int8_fc"].params
    fc["weight_q"] = np.zeros((8 * 8 * 136, 5), np.int8)
    fc["weight_scale"] = np.ones((1, 5), np.float32)
    del fc["weight"]
    with caplog.at_level(logging.INFO, logger="snn_torch.compile"):
        eng = P.Engine.from_graph(g, P.EngineOptions(
            device="cpu", backend=P.BackendKind.KERNEL))
    fwd = eng.model.forward
    assert fwd.kernel_conv_plan == [] and fwd.kernel_dense_plan == ["int8_fc"]
    assert fwd.single_conv_plan == [] and fwd.chain_plan == {}
    text = caplog.text
    for name in ("softmax_conv", "wide"):
        assert f"conv {name} given to KERNEL runs on TORCH: outside the implicit-GEMM" in text
    assert "dense int8_fc runs on the fused-matmul kernel" in text
    y = eng.run_single(np.random.default_rng(0).random((1, 8, 8, 4), dtype=np.float32))
    assert torch.allclose(y.sum(-1), torch.ones(1), atol=1e-4)


# -- the trained artifact ----------------------------------------------------

@pytest.fixture(scope="module")
def sample():
    return synth_cls(np.random.default_rng(424242), 64)


@pytest.mark.parametrize("prec", list(TOL))
def test_trained_under_kernel_matches_jax(sample, prec):
    x = sample[0][:16]
    want = np.asarray(J.Engine.from_json(
        RESNET18_TRAINED, options(J, prec, "plain", batch_size=16)).run_single(x), np.float32)
    eng = P.Engine.from_json(RESNET18_TRAINED, options(P, prec, "kernel", batch_size=16))
    fwd = eng.model.forward
    assert fwd.kernel_dense_plan == ["fc"] and fwd.kernel_conv_plan == []
    assert sorted(fwd.chain_plan) == ["s0b0_conv1", "s0b1_conv1"]
    # Every stride-1 conv is on a kernel; the stride-2 convs are not.
    kernel_convs = {n for m in fwd.chain_plan.values() for n in m} | set(fwd.single_conv_plan)
    convs = [n for n in eng.graph.nodes.values() if n.op == "Conv2D"]
    assert {n.name for n in convs if int(n.attr("stride", 1)) == 1} == kernel_convs
    assert len(convs) - len(kernel_convs) == 6
    got = eng.run_single(x)
    assert got.dtype == torch.float32 and tuple(got.shape) == (16, 10)
    assert torch.allclose(got.sum(-1), torch.ones(16), atol=1e-5 if prec == "fp32" else 1e-2)
    assert np.max(np.abs(got.numpy() - want)) <= TOL[prec] * max(1.0, float(np.abs(want).max()))
    assert np.array_equal(got.numpy().argmax(-1), want.argmax(-1))


def test_trained_top1_under_kernel(sample):
    """The accuracy gates of tests/test_accuracy_resnet18.py at a small
    sample: top-1 >= 0.95 at FP32, BF16 within 0.03 of it."""
    x, y = sample
    top1 = {}
    for prec in TOL:
        eng = P.Engine.from_json(RESNET18_TRAINED, options(P, prec, "kernel", batch_size=64))
        top1[prec] = float((eng.run_single(x).numpy().argmax(-1) == y).mean())
    assert top1["fp32"] >= 0.95, top1
    assert top1["bf16"] >= top1["fp32"] - 0.03, top1
