"""The port's conv-chain module (shadernn_tpu_torch.kernels.chain) against
the JAX package's two chain kernels, run in Pallas interpret mode as
tests/test_chain_packed.py runs them. On the CPU the port's entry points
run the kernel's plain version; the CUDA kernel itself is held against
that plain version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadernn_tpu.kernels.chain_packed_pallas import build_chain_packed
from shadernn_tpu.kernels.chain_packed_pallas import fused_conv_chain_packed as j_packed
from shadernn_tpu.kernels.chain_pallas import build_chain
from shadernn_tpu.kernels.chain_pallas import fused_conv_chain as j_chain
from shadernn_tpu.kernels.conv_pallas import from_haloed

from shadernn_tpu_torch.kernels import chain

ESPCN_BODY = [(5, 16, "relu"), (3, 16, "relu"), (3, 4, "linear")]


class FakeNode:
    def __init__(self, k, o, act, w, b, padding="same", stride=1):
        self._a = dict(kernel_size=k, out_channels=o, activation=act,
                       padding=padding, stride=stride, use_bias=True)
        self.params = dict(weight=w, bias=b)

    def attr(self, key, d=None):
        return self._a.get(key, d)


def make_nodes(rng, cfg, cin, **kw):
    nodes, c = [], cin
    for k, o, act in cfg:
        w = (rng.standard_normal((k, k, c, o)) * 0.25).astype(np.float32)
        b = (rng.standard_normal(o) * 0.1).astype(np.float32)
        nodes.append(FakeNode(k, o, act, w, b, **kw))
        c = o
    return nodes


def port_chain(entry, nodes, cin, x, dtype, tail, act_override=None):
    specs = chain.build_chain_specs(nodes, cin, dtype, act_override=act_override, tail=tail)
    assert specs is not None
    ops = chain.chain_operands(nodes, dtype)
    before = dict(chain.launches)
    y = entry(torch.from_numpy(x), ops, specs, tail=tail, compute_dtype=dtype)
    assert chain.launches == before  # CPU tensors never launch the kernel
    return y.float().numpy()


def test_d2s2_bf16_matches_jax_packed_kernel(rng, fp16_threshold):
    """ESPCN-shaped 1->16->16->4 chain, tanh folded, depth_to_space tail."""
    nodes = make_nodes(rng, ESPCN_BODY, 1)
    x = rng.random((2, 24, 40, 1), dtype=np.float32)
    lp, specs = build_chain_packed(nodes, 1, jnp.bfloat16, act_override=("tanh", 0.3),
                                   width=40, tail="d2s2")
    want = np.asarray(j_packed(jnp.asarray(x), lp, specs, interpret=True, tail="d2s2",
                               compute_dtype=jnp.bfloat16), np.float32)
    got = port_chain(chain.fused_conv_chain_packed, nodes, 1, x, torch.bfloat16, "d2s2",
                     act_override=("tanh", 0.3))
    assert got.shape == want.shape == (2, 48, 80, 1)
    assert np.max(np.abs(got - want)) <= fp16_threshold


@pytest.mark.parametrize("cfg,tail", [
    (ESPCN_BODY, "none"),
    ([(5, 16, "relu"), (3, 8, "relu"), (3, 1, "sigmoid")], "c1"),
])
def test_fp32_matches_jax_im2col_kernel(rng, fp32_threshold, cfg, tail):
    nodes = make_nodes(rng, cfg, 1)
    x = rng.random((2, 24, 40, 1), dtype=np.float32)
    lp, specs = build_chain(nodes, 1, jnp.float32)
    want = j_chain(jnp.asarray(x), lp, specs, interpret=True, tail=tail)
    want = np.asarray(from_haloed(want) if tail == "none" else want, np.float32)
    got = port_chain(chain.fused_conv_chain, nodes, 1, x, torch.float32, tail)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= fp32_threshold


def test_reference_matches_float64_oracle_on_even_kernel(rng):
    """Even k (asymmetric 'same' pads: top/left one less) and a ragged
    frame, against a float64 numpy loop."""
    nodes = make_nodes(rng, [(4, 6, "leaky_relu"), (2, 3, "gelu")], 2)
    x = rng.random((3, 13, 17, 2), dtype=np.float32)
    got = port_chain(chain.fused_conv_chain, nodes, 2, x, torch.float32, "none")
    ref = x.astype(np.float64)
    for node in nodes:
        k, w, b = node.attr("kernel_size"), node.params["weight"], node.params["bias"]
        t = k // 2 - (1 - k % 2)  # even k: the top/left pad is one less
        xp = np.pad(ref, ((0, 0), (t, k - 1 - t), (t, k - 1 - t), (0, 0)))
        n, h, wd, _ = ref.shape
        y = sum(np.einsum("nhwc,co->nhwo", xp[:, dy:dy + h, dx:dx + wd], w[dy, dx])
                for dy in range(k) for dx in range(k)) + b
        act = node.attr("activation")
        if act == "leaky_relu":
            y = np.where(y >= 0, y, 0.3 * y)
        else:
            y = 0.5 * y * (1 + np.tanh(np.sqrt(2 / np.pi) * (y + 0.044715 * y ** 3)))
        ref = y
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_plan_declines_what_the_kernel_cannot_take(rng):
    """The gate declines at planning time: stride 2, k > 9, o > 32, a
    non-elementwise activation, a tail that does not fit, too much shared
    memory."""
    ok = make_nodes(rng, ESPCN_BODY, 1)
    assert chain.build_chain_specs(ok, 1, torch.bfloat16, tail="d2s2") is not None
    assert chain.build_chain_specs(ok, 1, torch.float32, tail="c1") is None
    assert chain.build_chain_specs(make_nodes(rng, ESPCN_BODY, 1, stride=2), 1, torch.float32) is None
    assert chain.build_chain_specs(make_nodes(rng, [(11, 4, "relu")], 1), 1, torch.float32) is None
    assert chain.build_chain_specs(make_nodes(rng, [(3, 48, "relu")], 1), 1, torch.float32) is None
    assert chain.build_chain_specs(make_nodes(rng, [(3, 8, "softmax")], 1), 1, torch.float32) is None
    wide = make_nodes(rng, [(9, 32, "relu")] * 3, 32)
    assert chain.smem_bytes(
        [chain.ChainLayerSpec(9, 32, 32, 4, 4, 4, 4, "relu", 0.3)] * 3
    ) > chain.MAX_SMEM_BYTES
    assert chain.build_chain_specs(wide, 32, torch.float32) is None


def test_espcn_shared_memory_fits_two_ctas_per_sm():
    specs = [chain.ChainLayerSpec(5, 1, 16, 2, 2, 2, 2, "relu", 0.3),
             chain.ChainLayerSpec(3, 16, 16, 1, 1, 1, 1, "relu", 0.3),
             chain.ChainLayerSpec(3, 16, 4, 1, 1, 1, 1, "tanh", 0.3)]
    # weights 432 + 2336 + 584 floats; ping-pong regions 16*18*34 and 16*20*36
    assert chain.smem_bytes(specs) == 4 * (432 + 2336 + 584 + 9792 + 11520)
    assert 2 * chain.smem_bytes(specs) < 228 * 1024


def test_entry_points_reject_other_devices(rng):
    nodes = make_nodes(rng, ESPCN_BODY, 1)
    specs = chain.build_chain_specs(nodes, 1, torch.float32)
    ops = chain.chain_operands(nodes, torch.float32)
    x = torch.zeros((1, 8, 8, 1), device="meta")
    with pytest.raises(ValueError):
        chain.fused_conv_chain(x, ops, specs)
    with pytest.raises(ValueError):
        chain.fused_conv_chain_packed(torch.zeros((1, 8, 8, 1)), ops, specs, tail="bogus")
