"""The bfloat16 cuDNN route of the TORCH Conv2D and Conv2DTranspose
(ops/conv.py `cudnn_bf16`, `conv2d_nhwc_cudnn`,
`conv_transpose2d_nhwc_cudnn`).

On the CPU: the rule that picks the route (bfloat16 on a CUDA device;
float32, the CPU, A8W8 and depthwise keep their routes), the counter
`ops.conv_bf16_cudnn` (0 on the CPU), a BF16 Conv2D and Conv2DTranspose on
the CPU bit-equal to the float32 route rounded once, the route's padding
and its transposed window against the float32 route, and the window's
slice, which both routes take, against the `F.pad` crop of the whole
transposed conv. On the card (tests marked `card`, which
skip without a CUDA device): StyleTransfer's and YOLOv3-tiny's TORCH conv
shapes, the route within one bfloat16 ulp of the float32 route rounded
once, its output contiguous NHWC. This file imports no JAX, so that on
the card it runs without the test configuration:

    python -m pytest tests/test_torch_conv_cudnn.py -q --noconftest -p no:cacheprovider
"""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from shadernn_tpu_torch.config import Precision
from shadernn_tpu_torch.graph.ir import Node
from shadernn_tpu_torch.ops import conv as C
from shadernn_tpu_torch.ops.registry import RunCtx, get_op
from shadernn_tpu_torch.utils import timer

COUNTER = "ops.conv_bf16_cudnn"
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def clean_recorder():
    timer.reset()
    try:
        yield
    finally:
        timer.reset()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def count() -> int:
    return timer.counters().get(COUNTER, 0)


def conv_node(op, k, cin, cout, stride=1, padding="same", seed=0, **attrs):
    g = np.random.default_rng(seed)
    w = (g.standard_normal((k, k, cin, cout)) * (2.0 / (k * k * cin)) ** 0.5).astype(np.float32)
    params = {"weight": w, "bias": (g.standard_normal(cout) * 0.1).astype(np.float32)}
    attrs = dict(kernel_size=k, stride=stride, padding=padding, out_channels=cout,
                 activation="leaky_relu", leaky_alpha=0.1, **attrs)
    return Node("conv", op, ["x"], attrs, params)


def depthwise_node(k, c, seed=0):
    g = np.random.default_rng(seed)
    w = (g.standard_normal((k, k, 1, c)) * 0.3).astype(np.float32)
    return Node("dw", "SeparableConv2D", ["x"], dict(kernel_size=k, stride=1, padding="same",
                                                      multiplier=1, activation="relu"),
                {"weight": w, "bias": np.zeros(c, np.float32)})


def a8w8_node(k=3, cin=32, cout=32, seed=0):
    """A calibrated Conv2D inside `a8w8_profitable`: int8 weights with a
    per-channel scale and an input activation scale."""
    g = np.random.default_rng(seed)
    node = conv_node("Conv2D", k, cin, cout, seed=seed, in_act_scale=0.02)
    node.params["weight_q"] = g.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    node.params["weight_scale"] = np.full(cout, 0.01, np.float32)
    del node.params["weight"]
    return node


def frames(shape, seed=0, dtype=BF16, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device, dtype)


# --- the rule ----------------------------------------------------------------

RULE = {
    "bf16_cuda": (BF16, "cuda", True),
    "bf16_cuda1": (BF16, "cuda:1", True),
    "f32_cuda": (torch.float32, "cuda", False),
    "bf16_cpu": (BF16, "cpu", False),
    "f32_cpu": (torch.float32, "cpu", False),
    "f16_cuda": (torch.float16, "cuda", False),
}


@pytest.mark.parametrize("case", sorted(RULE))
def test_the_route_is_bf16_on_a_cuda_device(case):
    dtype, device, want = RULE[case]
    assert C.cudnn_bf16(types.SimpleNamespace(dtype=dtype, device=torch.device(device))) is want


def _run(node, x, precision=Precision.BF16):
    return get_op(node.op).run(node, [x], RunCtx(precision=precision))


# What each op takes with the rule held true for bfloat16 on the CPU, as it is
# on a CUDA device: 1 call of the route, or 0 where the op keeps its own.
ROUTES = {
    "conv2d_bf16": (lambda: conv_node("Conv2D", 3, 8, 16), BF16, Precision.BF16, 1),
    "conv2d_s2_bf16": (lambda: conv_node("Conv2D", 3, 8, 16, stride=2), BF16, Precision.BF16, 1),
    "conv2d_1x1_bf16": (lambda: conv_node("Conv2D", 1, 8, 16), BF16, Precision.BF16, 1),
    "conv2d_transpose_bf16": (lambda: conv_node("Conv2DTranspose", 3, 8, 4, stride=2), BF16,
                              Precision.BF16, 1),
    "conv2d_int8_weight_only": (lambda: a8w8_node(), BF16, Precision.BF16, 1),
    "conv2d_a8w8": (lambda: a8w8_node(), BF16, Precision.INT8, 0),
    "depthwise_bf16": (lambda: depthwise_node(3, 8), BF16, Precision.BF16, 0),
    "conv2d_f32": (lambda: conv_node("Conv2D", 3, 8, 16), torch.float32, Precision.FP32, 0),
    "conv2d_transpose_f32": (lambda: conv_node("Conv2DTranspose", 3, 8, 4, stride=2),
                             torch.float32, Precision.FP32, 0),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_which_ops_take_the_route(case, monkeypatch):
    make, dtype, precision, want = ROUTES[case]
    node = make()
    cin = 8 if node.op == "SeparableConv2D" else C.get_weight(node, dtype).shape[2]
    x = frames((2, 9, 11, cin), dtype=dtype)
    if case == "conv2d_a8w8":
        assert C.a8w8_engaged(node, RunCtx(precision=precision), 3, cin, 32) > 0
    assert count() == 0
    _run(node, x, precision)
    assert count() == 0  # the CPU keeps the float32 route
    monkeypatch.setattr(C, "cudnn_bf16", lambda t: t.dtype == BF16)
    y = _run(node, x, precision)
    assert count() == want and y.dtype == dtype


# --- the CPU keeps the parent's arithmetic ----------------------------------

CPU_CASES = {
    "conv_k3_s1": ("Conv2D", 3, 1, "same"),
    "conv_k3_s2": ("Conv2D", 3, 2, "same"),
    "conv_k1_s2": ("Conv2D", 1, 2, "same"),
    "conv_k2_s1_asymmetric": ("Conv2D", 2, 1, "same"),
    "conv_k3_valid": ("Conv2D", 3, 1, "valid"),
    "transpose_k3_s2_same": ("Conv2DTranspose", 3, 2, "same"),
    "transpose_k2_s2_same": ("Conv2DTranspose", 2, 2, "same"),
    "transpose_k3_s1_valid": ("Conv2DTranspose", 3, 1, "valid"),
}


@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_a_bf16_conv_on_the_cpu_is_the_f32_route_rounded_once(case):
    op, k, stride, padding = CPU_CASES[case]
    node = conv_node(op, k, 8, 16, stride=stride, padding=padding, seed=1)
    x = frames((2, 10, 13, 8), seed=2)
    got = _run(node, x)
    w = C.get_weight(node, BF16)
    if op == "Conv2D":
        y = C.conv2d_nhwc_f32(x, w, C._conv_pads(node), stride)
    else:
        y = C.conv_transpose2d_nhwc_f32(x, w, stride, padding == "same")
    want = C._epilogue(node, y.to(BF16))
    assert count() == 0
    assert got.dtype == BF16 and torch.equal(got, want)


# --- the route's padding and window, in float32 on the CPU --------------------

PADS = [(1, 1, 1, 1), (0, 1, 0, 1), (1, 0, 2, 1), (0, 0, 0, 0), (2, 2, 1, 1)]


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("pads", PADS, ids=lambda p: "".join(map(str, p)))
def test_the_route_pads_as_the_f32_route(pads, stride):
    x = frames((2, 9, 10, 8), seed=3, dtype=torch.float32)
    w = frames((3, 3, 8, 16), seed=4, dtype=torch.float32)
    got = C.conv2d_nhwc_cudnn(x, C.cudnn_weight(w), pads, stride)
    want = C.conv2d_nhwc_f32(x, w, pads, stride)
    assert got.shape == want.shape and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _fpad_crop(y_nchw, hw_in, k, stride, same):
    """The float32 route's crop: F.pad of the NCHW output with negative
    pads where the window lies inside it, positive where it reaches past."""
    pads = []
    for n_in, full in ((hw_in[1], y_nchw.shape[3]), (hw_in[0], y_nchw.shape[2])):
        pad_a, pad_b = C.conv_transpose_padding(k, stride, same)
        start, size = k - 1 - pad_a, (n_in - 1) * stride + pad_a + pad_b - k + 2
        pads += [-start, start + size - full]
    return F.pad(y_nchw, pads).permute(0, 2, 3, 1)


@pytest.mark.parametrize("same", [True, False], ids=["same", "valid"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_the_window_slice_equals_the_pad_crop(k, stride, same):
    hw = (5, 7)
    full = frames((2, 3, (hw[0] - 1) * stride + k, (hw[1] - 1) * stride + k), seed=k,
                  dtype=torch.float32)
    got = C.transpose_window(full.permute(0, 2, 3, 1), hw, (k, k), stride, same)
    want = _fpad_crop(full, hw, k, stride, same)
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("same", [True, False], ids=["same", "valid"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_the_f32_transposed_conv_is_the_pad_crop_of_the_whole_one(k, stride, same):
    x = frames((2, 5, 6, 8), seed=7, dtype=torch.float32)
    w = frames((k, k, 8, 4), seed=8, dtype=torch.float32)
    whole = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1), stride=stride)
    got = C.conv_transpose2d_nhwc_f32(x, w, stride, same)
    assert torch.equal(got, _fpad_crop(whole, x.shape[1:3], k, stride, same))


@pytest.mark.parametrize("same", [True, False], ids=["same", "valid"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_the_transposed_route_is_the_f32_route(k, stride, same):
    x = frames((2, 5, 6, 8), seed=5, dtype=torch.float32)
    w = frames((k, k, 8, 4), seed=6, dtype=torch.float32)
    got = C.conv_transpose2d_nhwc_cudnn(x, C.cudnn_weight(w, transposed=True), stride, same)
    want = C.conv_transpose2d_nhwc_f32(x, w, stride, same)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_the_weight_is_laid_out_once_per_parameter_set():
    node = conv_node("Conv2D", 3, 8, 16)
    made = []

    def cache(make):
        if not made:
            made.append(make())
        return made[0]

    ctx = RunCtx(precision=Precision.BF16, cache=cache)
    w = C.layer_weight(node, ctx, BF16, torch.device("cpu"), 0.0, C.cudnn_weight)
    assert w is C.layer_weight(node, ctx, BF16, torch.device("cpu"), 0.0, C.cudnn_weight)
    assert w.shape == (16, 8, 3, 3) and w.dtype == BF16
    assert w.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(w.permute(2, 3, 1, 0), C.get_weight(node, BF16))


# --- on the card --------------------------------------------------------------

def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each value of float32 `v` (8 significant bits)."""
    _, e = torch.frexp(v.abs().clamp_min(torch.finfo(BF16).tiny))
    return torch.ldexp(torch.ones_like(v), e - 8)


# StyleTransfer's and YOLOv3-tiny's TORCH convs: (batch, H, W, Cin), k, Cout,
# stride, transposed.
CARD_SHAPES = {
    "style_down1_k3s2_32_64": ((2, 512, 512, 32), 3, 64, 2, False),
    "style_down2_k3s2_64_128": ((4, 256, 256, 64), 3, 128, 2, False),
    "style_res_k3s1_128_128": ((4, 128, 128, 128), 3, 128, 1, False),
    "yolo_l1_k3s1_16_32": ((8, 208, 208, 16), 3, 32, 1, False),
    "yolo_l3_k3s1_64_128": ((8, 52, 52, 64), 3, 128, 1, False),
    "yolo_l5_k3s1_256_512": ((8, 13, 13, 256), 3, 512, 1, False),
    "yolo_l6_k3s1_512_1024": ((8, 13, 13, 512), 3, 1024, 1, False),
    "yolo_bottleneck_k1_1024_256": ((8, 13, 13, 1024), 1, 256, 1, False),
    "yolo_head_k1_512_255": ((8, 13, 13, 512), 1, 255, 1, False),
    "style_up1_t3s2_128_64": ((4, 128, 128, 128), 3, 64, 2, True),
    "style_up2_t3s2_64_32": ((4, 256, 256, 64), 3, 32, 2, True),
}


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(CARD_SHAPES))
def test_the_route_is_within_one_ulp_of_the_f32_route(card, case):
    shape, k, cout, stride, transposed = CARD_SHAPES[case]
    cin = shape[-1]
    x = frames(shape, seed=11, device="cuda")
    w = (frames((k, k, cin, cout), seed=12) * (2.0 / (k * k * cin)) ** 0.5).to("cuda", BF16)
    if transposed:
        got = C.conv_transpose2d_nhwc_cudnn(x, C.cudnn_weight(w, transposed=True), stride, True)
        exact = C.conv_transpose2d_nhwc_f32(x, w, stride, True)
        size = C.conv_transpose2d_nhwc_f32(x.abs(), w.abs(), stride, True)
    else:
        pads = C.padding_offsets("same", k)
        got = C.conv2d_nhwc_cudnn(x, C.cudnn_weight(w), pads, stride)
        exact = C.conv2d_nhwc_f32(x, w, pads, stride)
        size = C.conv2d_nhwc_f32(x.abs(), w.abs(), pads, stride)
        assert got.is_contiguous()  # a transposed window is a view: its op's bias copies it
    assert count() == 1
    want = exact.to(BF16)
    assert got.dtype == BF16 and got.shape == want.shape and got.stride(-1) == 1
    g, r = got.float(), want.float()
    diff = (g - r).abs()
    ulp = bf16_ulp(torch.maximum(g.abs(), r.abs()))
    # Both sum the same bfloat16 products in float32 in different orders:
    # beyond one ulp only by float32 summation's bound, K u sum|x||w| for each
    # side, with u = 2^-23 (tensor cores may truncate where they accumulate).
    slack = 2 * k * k * cin * 2.0 ** -23 * size
    assert bool((diff <= ulp + slack).all()), (diff - ulp).max().item()
    assert (diff > ulp).float().mean().item() <= 1e-3


@pytest.mark.card
@pytest.mark.parametrize("op", ["Conv2D", "Conv2DTranspose"])
def test_the_ops_output_on_the_route_is_contiguous_nhwc(card, op):
    node = conv_node(op, 3, 64, 32, stride=2, seed=3)
    node.params = {k: torch.as_tensor(v).cuda() for k, v in node.params.items()}
    x = frames((2, 64, 64, 64), seed=4, device="cuda")
    y = get_op(op).run(node, [x], RunCtx(precision=Precision.BF16))
    assert count() == 1 and y.dtype == BF16 and y.is_contiguous()
