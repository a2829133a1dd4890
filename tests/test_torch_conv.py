"""The port's single-conv module (shadernn_tpu_torch.kernels.conv) against
the JAX package's haloed conv kernel, reached through
`shadernn_tpu.ops.conv.conv_run_pallas_chain` in Pallas interpret mode, and
the compile step's use of it: singletons and the convs of a chain that the
chain kernel's gate declines. On the CPU the port's entry point runs the
kernel's plain version; the CUDA kernel itself is held against that plain
version on the card by chip_smoke.py.

Tolerance: the conftest thresholds (0.01 fp32, 0.1 bf16) times
max(1, max|reference|)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shadernn_tpu as J
from shadernn_tpu.graph.builder import GraphBuilder as JBuilder
from shadernn_tpu.graph.ir import Node as JNode
from shadernn_tpu.kernels.conv_pallas import from_haloed
from shadernn_tpu.ops.conv import conv_run_pallas_chain
from shadernn_tpu.ops.registry import RunCtx as JCtx

import shadernn_tpu_torch as P
from shadernn_tpu_torch.graph.builder import GraphBuilder as PBuilder
from shadernn_tpu_torch.graph.ir import Node as PNode
from shadernn_tpu_torch.kernels import conv

TOL = {"fp32": 0.01, "bf16": 0.1}  # tests/conftest.py thresholds
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}

# (n, h, w, c, k, o, padding, activation)
CASES = [
    (2, 12, 20, 1, 5, 16, "same", "relu"),          # C=1: the JAX side row-packs
    (2, 16, 16, 12, 2, 16, (1, 0, 1, 0), "relu6"),  # the folded MobileNetV2 stem
    (1, 11, 17, 8, 3, 12, (2, 1, 0, 3), "tanh"),    # asymmetric pads
    (2, 9, 14, 3, 4, 5, "same", "leaky_relu"),      # even k: top/left one less
]


def attrs(k, o, padding, act):
    return dict(kernel_size=k, out_channels=o, padding=padding, activation=act,
                stride=1, use_bias=True, leaky_alpha=0.3)


@pytest.mark.parametrize("prec", list(TOL))
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"c{c[3]}k{c[4]}o{c[5]}")
def test_reference_matches_jax_haloed_kernel(rng, case, prec):
    n, h, w, c, k, o, padding, act = case
    x = rng.random((n, h, w, c), dtype=np.float32)
    params = {"weight": (rng.standard_normal((k, k, c, o)) / np.sqrt(k * k * c)).astype(np.float32),
              "bias": (rng.standard_normal(o) * 0.1).astype(np.float32)}
    tdt, jdt = DTYPES[prec]
    jnode = JNode("conv", "Conv2D", ["x"], attrs(k, o, padding, act),
                  {key: jnp.asarray(v) for key, v in params.items()})
    want = conv_run_pallas_chain(jnode, jnp.asarray(x, jdt), JCtx())
    want = np.asarray(from_haloed(want), np.float32)

    pnode = PNode("conv", "Conv2D", ["x"], attrs(k, o, padding, act),
                  {key: torch.from_numpy(v) for key, v in params.items()})
    assert conv.single_conv_supported(pnode, c)
    before = dict(conv.launches)
    got = conv.conv_run_kernel(pnode, torch.from_numpy(x).to(tdt), tdt)
    assert conv.launches == before  # CPU tensors never launch the kernel
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    tol = TOL[prec] * max(1.0, float(np.abs(want).max()))
    assert np.max(np.abs(got.float().numpy() - want)) <= tol


def test_gate():
    def node(k, c_out, act="relu", padding="same", **params):
        return PNode("n", "Conv2D", ["x"], attrs(k, c_out, padding, act),
                     params or {"weight": np.zeros((k, k, 1, c_out), np.float32)})

    assert conv.single_conv_supported(node(3, 128), 128)
    assert not conv.single_conv_supported(node(3, 129), 16)     # o > 128
    assert not conv.single_conv_supported(node(3, 16), 512)     # k*k*c > 4096
    assert not conv.single_conv_supported(node(3, 8, "softmax"), 4)
    assert not conv.single_conv_supported(node(3, 8, weight_q=np.zeros(1)), 4)
    assert conv.smem_bytes(2, 2, 16) == 4 * ((9 * 17 + 3) // 4 * 4 + 4 * 16)
    assert conv.smem_bytes(48, 48, 64) > conv.MAX_SMEM_BYTES


def test_entry_point_rejects_other_devices():
    w, s = torch.zeros((3, 3, 4, 8)), torch.ones(8)
    with pytest.raises(ValueError):
        conv.fused_conv2d_haloed(torch.zeros((1, 8, 8, 4), device="meta"), w, s, s)


def _declined_chain(builder_cls):
    """ESPCN-shaped, but an 11x11 head: AUTO gives each conv the kernel, the
    chain kernel's gate (k <= 9) declines the chain."""
    b = builder_cls("wide_head", seed=9)
    x = b.input(14, 18, 1)
    x = b.conv2d(x, 16, 11, activation="relu", name="conv_1")
    x = b.conv2d(x, 16, 3, activation="relu", name="conv_2")
    x = b.conv2d(x, 4, 3, name="conv_3")
    x = b.subpixel(x, 2, name="subpixel")
    b.activation(x, "tanh", name="tanh_out")
    return b.build(batch_size=2)


@pytest.mark.parametrize("prec", list(TOL))
def test_declined_chain_runs_convs_on_the_kernel(monkeypatch, rng, prec):
    """The chain the gate declines runs conv by conv on the single-conv
    kernel (no longer on TORCH), then the Subpixel and tanh as ops, as the
    JAX package falls back to its haloed kernel; a conv of one does too."""
    monkeypatch.setenv("SNN_AUTO_PALLAS_ANYWHERE", "1")
    x = rng.random((2, 14, 18, 1), dtype=np.float32)
    opts = dict(precision=getattr(P.Precision, prec.upper()), batch_size=2)
    want = np.asarray(J.Engine.from_graph(
        _declined_chain(JBuilder), J.EngineOptions(precision=getattr(J.Precision, prec.upper()),
                                                   batch_size=2)).run_single(x), np.float32)
    eng = P.Engine.from_graph(_declined_chain(PBuilder), P.EngineOptions(device="cpu", **opts))
    fwd = eng.model.forward
    assert fwd.chain_plan == {} and fwd.block_plan == {}
    assert fwd.single_conv_plan == ["conv_1", "conv_2", "conv_3"]
    got = eng.run_single(x).numpy()
    assert got.shape == want.shape == (2, 28, 36, 1)
    assert np.max(np.abs(got - want)) <= TOL[prec]
    torch_fwd = P.Engine.from_graph(
        _declined_chain(PBuilder),
        P.EngineOptions(device="cpu", backend=P.BackendKind.TORCH, **opts)).model.forward
    assert torch_fwd.single_conv_plan == []


def test_singleton_runs_on_the_kernel():
    b = PBuilder("one", seed=1)
    x = b.input(10, 12, 2)
    x = b.conv2d(x, 8, 3, activation="relu", name="k3")
    b.conv2d(x, 8, 1, name="pointwise")  # k=1 stays on TORCH under AUTO
    eng = P.Engine.from_graph(b.build(), P.EngineOptions(device="cpu"))
    assert eng.model.forward.single_conv_plan == ["k3"]
    assert eng.model.forward.chain_plan == {}
