"""The bfloat16 InstanceNormalization kernel on the card
(csrc/instance_norm.cu, kernels/instnorm.py; tests marked `card`, which
skip without a CUDA device).

At StyleTransfer 512 b4's three shapes (32 channels at 512², 64 at 256²,
128 at 128²) and at odd sizes: the kernel equal to its plain version, which
repeats its arithmetic op by op; within one bfloat16 ulp (plus 1e-5) of
the op's ATen route; its statistics within 1e-5 of float64; an input whose
mean is several hundred times its std; each activation; two calls bit-equal;
one launch of each kernel a call; what it does not take raises. This file
imports no JAX, so that on the card it runs without the test configuration:

    python -m pytest tests/test_torch_instnorm_card.py -q --noconftest -p no:cacheprovider
"""

import pytest
import torch

from shadernn_tpu_torch.graph.ir import Node
from shadernn_tpu_torch.kernels import KERNELS, launch_counts
from shadernn_tpu_torch.kernels import instnorm as K
from shadernn_tpu_torch.ops.registry import RunCtx, get_op

BF16 = torch.bfloat16
STYLE = {"c32_512": (4, 512, 512, 32), "c64_256": (4, 256, 256, 64),
         "c128_128": (4, 128, 128, 128)}
ODD = {"c24_7x5": (1, 7, 5, 24), "c1024_9x11": (3, 9, 11, 1024), "c256_13x3": (2, 13, 3, 256),
       "c8_1x1": (2, 1, 1, 8), "c48_99x37": (5, 99, 37, 48)}
ACTS = ("linear", "relu", "relu6", "leaky_relu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def operands(shape, seed, offset=False):
    g = torch.Generator().manual_seed(seed)
    n, h, w, c = shape
    if offset:  # bfloat16 resolves 1000 to steps of 4: mean ~450 x std
        x = 1000.0 + 2.0 * torch.randn(shape, generator=g)
    else:  # a conv output with a per-channel bias
        x = 1.5 * torch.randn(shape, generator=g) + 2.0 * torch.randn(c, generator=g)
    gamma = torch.randn(c, generator=g) * 0.5 + 1
    beta = torch.randn(c, generator=g) * 0.3
    return x.to("cuda", BF16), gamma.cuda(), beta.cuda()


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each value of float32 `v` (8 significant bits)."""
    _, e = torch.frexp(v.abs().clamp_min(torch.finfo(BF16).tiny))
    return torch.ldexp(torch.ones_like(v), e - 8)


def aten_route(x, gamma, beta, act, alpha=0.1):
    """The op's ATen route: an input that wants a gradient keeps it."""
    node = Node("in", "InstanceNormalization", ["x"],
                {"epsilon": 1e-5, "activation": act, "leaky_alpha": alpha},
                {"gamma": gamma, "beta": beta})
    with torch.enable_grad():  # an autograd input keeps the ATen route
        xr = x.detach().requires_grad_(True)
        return get_op("InstanceNormalization").run(node, [xr], RunCtx()).detach()


def within_one_ulp(got, want):
    g, r = got.float(), want.float()
    diff = (g - r).abs()
    assert bool((diff <= bf16_ulp(torch.maximum(g.abs(), r.abs())) + 1e-5).all()), \
        diff.max().item()
    assert (diff > 0).float().mean().item() < 1e-2


@pytest.mark.card
@pytest.mark.parametrize("act", ["relu", "linear"])
@pytest.mark.parametrize("case", sorted(STYLE))
def test_the_kernel_at_the_style_shapes(card, case, act):
    x, gamma, beta = operands(STYLE[case], seed=1)
    n, h, w, c = x.shape
    before = launch_counts("kernel")
    stats = torch.empty((n, 2, c), device="cuda")
    y = K.run(x, gamma, beta, 1e-5, act, 0.3, stats=stats)
    torch.cuda.synchronize()
    after = launch_counts("kernel")
    names = KERNELS["instance_norm"]
    assert {k: after[k] - before.get(k, 0) for k in names} == dict.fromkeys(names, 1)
    assert y.dtype == BF16 and y.shape == x.shape and y.is_contiguous()
    want, want_stats = K.plain(x, gamma, beta, 1e-5, act, 0.3)
    assert torch.equal(y, want) and torch.equal(stats, want_stats)
    within_one_ulp(y, aten_route(x, gamma, beta, act))
    x64 = x.double()
    mean64, var64 = x64.mean((1, 2)), x64.var((1, 2), unbiased=False)
    # f32 Welford runs over exact shifted values and Chan's merges.
    assert bool(((stats[:, 0].double() - mean64).abs()
                 <= 1e-5 * (mean64.abs() + var64.sqrt())).all())
    assert bool(((stats[:, 1].double() - var64).abs() <= 1e-5 * var64).all())


@pytest.mark.card
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("case", sorted(ODD))
def test_the_kernel_at_odd_sizes(card, case, act):
    x, gamma, beta = operands(ODD[case], seed=2)
    n, h, w, c = x.shape
    y = K.run(x, gamma, beta, 1e-5, act, 0.1)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    want, _ = K.plain(x, gamma, beta, 1e-5, act, 0.1, K.launch_geometry(n, h * w, c, sms))
    assert torch.equal(y, want)
    within_one_ulp(y, aten_route(x, gamma, beta, act, 0.1))


@pytest.mark.card
@pytest.mark.parametrize("affine", ["gamma_beta", "gamma", "none"])
def test_the_offset_input_and_absent_affine(card, affine):
    x, gamma, beta = operands((4, 128, 128, 128), seed=3, offset=True)
    gamma = None if affine == "none" else gamma
    beta = beta if affine == "gamma_beta" else None
    n, h, w, c = x.shape
    stats = torch.empty((n, 2, c), device="cuda")
    y = K.run(x, gamma, beta, stats=stats)
    x64 = x.double()
    mean64, var64 = x64.mean((1, 2)), x64.var((1, 2), unbiased=False)
    assert bool(((stats[:, 0].double() - mean64).abs() <= 1e-5 * var64.sqrt() + 1e-7 * mean64)
                .all())
    assert bool(((stats[:, 1].double() - var64).abs() <= 1e-5 * var64).all())
    y64 = (x64 - mean64[:, None, None]) / torch.sqrt(var64[:, None, None] + 1e-5)
    if gamma is not None:
        y64 = y64 * gamma.double()
    if beta is not None:
        y64 = y64 + beta.double()
    # one rounding to bfloat16 of a float32 value whose mean is off by half
    # an ulp of 1000 (3e-5) against a std near 2
    diff = (y.double() - y64).abs()
    assert bool((diff <= bf16_ulp(y64.float()).double() + 1e-4).all()), diff.max().item()


@pytest.mark.card
def test_two_calls_are_bit_equal(card):
    x, gamma, beta = operands(STYLE["c32_512"], seed=4)
    a = K.run(x, gamma, beta, 1e-5, "relu")
    b = K.run(x, gamma, beta, 1e-5, "relu")
    assert torch.equal(a, b)


@pytest.mark.card
def test_what_the_kernel_does_not_take_raises(card):
    x, gamma, beta = operands((2, 8, 8, 32), seed=5)
    with pytest.raises(ValueError, match="dtype"):
        K.run(x.float(), gamma, beta)
    with pytest.raises(ValueError, match="non-contiguous"):
        K.run(x.permute(0, 2, 1, 3), gamma, beta)
    with pytest.raises(ValueError, match="channels"):
        K.run(x[..., :12].contiguous(), gamma[:12], beta[:12])
    with pytest.raises(ValueError, match="gamma"):
        K.run(x, gamma.double(), beta)
    with pytest.raises(ValueError, match="activation"):
        K.run(x, gamma, beta, activation="tanh")


@pytest.mark.card
def test_the_op_takes_the_kernel_for_bf16_and_the_aten_route_otherwise(card):
    x, gamma, beta = operands((2, 32, 32, 64), seed=6)
    node = Node("in", "InstanceNormalization", ["x"], {"epsilon": 1e-5, "activation": "relu"},
                {"gamma": gamma, "beta": beta})
    op = get_op("InstanceNormalization")
    for inp, launched in ((x, 1), (x.float(), 0), (x.cpu(), 0)):
        before = launch_counts()["instance_norm"]
        y = op.run(node, [inp], RunCtx())
        assert launch_counts()["instance_norm"] - before == 2 * launched
        assert y.dtype == inp.dtype and y.device == inp.device
