"""Conv2D, SeparableConv2D (depthwise) and Conv2DTranspose on NHWC tensors
with HWIO weights (counterpart of shadernn_tpu/ops/conv.py).
Weights are float (`weight`) or int8 with per-output-channel scales
(`weight_q`, `weight_scale`; quant/quantize.py).

The TORCH backend runs `F.conv2d` on NCHW views, the analog of the XLA
convolution the JAX package uses; under KERNEL a Conv2D inside the
implicit-GEMM kernel's gate runs on that kernel (kernels/conv_igemm.py),
as the JAX op does under PALLAS. Every convolution accumulates in float32
on the compute-dtype values, as `lax.conv_general_dilated(...,
preferred_element_type=float32)` does, with TF32 off: cuDNN would
otherwise round float32 operands to TF32 (about three decimal digits),
where the JAX package runs float32 at HIGHEST precision. bfloat16 values
are exact in TF32, so the rule costs bfloat16 nothing in accuracy.

A Conv2D or Conv2DTranspose on bfloat16 activations on a CUDA device
(`cudnn_bf16`: BF16 engines and INT8 weight-only ones) runs bfloat16
cuDNN in channels_last (`conv2d_nhwc_cudnn`,
`conv_transpose2d_nhwc_cudnn`): the tensor cores multiply the bfloat16
values, sum the products in float32 and round the sum once to bfloat16,
which is the JAX op's float32 sum and cast. float32 activations, and every
input on the CPU, keep the float32 route (`conv2d_nhwc_f32`).

Under a calibrated INT8 engine a Conv2D with int8 weights and an
`in_act_scale` runs A8W8 where `a8w8_profitable` holds, as the JAX XLA
path does: the input quantized to int8, an exact int32 sum (an int8
im2col times the weight through `torch._int_mm`; a float32 sum is not
exact past 2^24), then (sa * weight_scale) and the epilogue.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from shadernn_tpu_torch.config import BackendKind
from shadernn_tpu_torch.graph.ir import Node, TensorSpec, Transform, transform_output_dims
from shadernn_tpu_torch.ops.common import apply_activation, is_same_padding, padding_offsets
from shadernn_tpu_torch.ops.registry import OpDef, RunCtx, register
from shadernn_tpu_torch.utils import get_logger, timer

log = get_logger("snn_torch.ops")

# Limits of the JAX package's haloed chain format
# (shadernn_tpu/kernels/conv_pallas.py MH, ML), kept so that AUTO plans
# the same chains as the reference.
_MAX_TOP_PAD = 32
_MAX_LEFT_PAD = 8


def full_precision():
    """Context in which cuDNN convolutions run float32 without TF32."""
    if not torch.backends.cudnn.is_available():
        return contextlib.nullcontext()
    return torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled,
        benchmark=torch.backends.cudnn.benchmark,
        deterministic=torch.backends.cudnn.deterministic,
        allow_tf32=False,
    )


def conv2d_nhwc_f32(x: torch.Tensor, w_hwio: torch.Tensor, pads, stride: int = 1,
                    groups: int = 1):
    """float32 convolution of NHWC `x` with HWIO `w_hwio`; explicit
    (top, bottom, left, right) zero pads. Returns NHWC float32. With
    groups=C (depthwise) `w_hwio` is (k, k, 1, C*m) and output channel o
    reads input channel o // m, as XLA's feature_group_count does."""
    t, b, l, r = pads
    if w_hwio.shape[0] == w_hwio.shape[1] == 1 and stride > 1 and not any(pads):
        # A 1x1 conv at stride s reads every s-th pixel: run it on that
        # subsample at stride 1, the same sums. (PyTorch's CPU backward of
        # a channels-last strided 1x1 conv corrupts the heap, torch 2.13.)
        x, stride = x[:, ::stride, ::stride], 1
    xin = F.pad(x.float().permute(0, 3, 1, 2), (l, r, t, b))
    with full_precision():
        y = F.conv2d(xin, w_hwio.float().permute(3, 2, 0, 1), stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def cudnn_bf16(x: torch.Tensor) -> bool:
    """Does a Conv2D or Conv2DTranspose on `x` run bfloat16 cuDNN
    (`conv2d_nhwc_cudnn`, `conv_transpose2d_nhwc_cudnn`)? bfloat16
    activations on a CUDA device; float32 and the CPU keep the float32
    route."""
    return x.dtype == torch.bfloat16 and x.device.type == "cuda"


def cudnn_weight(w_hwio: torch.Tensor, transposed: bool = False) -> torch.Tensor:
    """HWIO `w_hwio` as `F.conv2d`'s OIHW (`F.conv_transpose2d`'s IOHW, where
    `transposed`) in channels_last, the layout cuDNN reads beside a
    channels_last input without a copy."""
    perm = (2, 3, 0, 1) if transposed else (3, 2, 0, 1)
    return w_hwio.permute(*perm).contiguous(memory_format=torch.channels_last)


def conv2d_nhwc_cudnn(x: torch.Tensor, w: torch.Tensor, pads, stride: int = 1) -> torch.Tensor:
    """Convolution of NHWC `x` with `w` (`cudnn_weight`) in x's dtype, on
    the channels_last NCHW view of `x` (no copy); (top, bottom, left, right)
    zero pads, the symmetric part inside the call and only an asymmetric
    excess padded first, in NHWC. For bfloat16 on a CUDA device cuDNN sums
    the bfloat16 products in float32 and rounds once. Returns contiguous
    NHWC: the permuted channels_last output."""
    timer.count("ops.conv_bf16_cudnn")
    t, b, l, r = pads
    ph, pw = min(t, b), min(l, r)
    if (t, b, l, r) != (ph, ph, pw, pw):
        x = F.pad(x, (0, 0, l - pw, r - pw, t - ph, b - ph))
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=(ph, pw))
    return y.permute(0, 2, 3, 1)


def get_weight(node: Node, dtype: torch.dtype) -> torch.Tensor:
    """The node's weight in `dtype`. Int8 storage (quant/quantize.py:
    `weight_q` and a per-output-channel `weight_scale`) is dequantized as
    the JAX package's get_weight does it: both factors cast to `dtype`
    first, so that under BF16/INT8 the product is rounded to bfloat16. A
    node that carries both runs the int8 one."""
    if "weight_q" in node.params:
        wq = torch.as_tensor(node.params["weight_q"])
        ws = torch.as_tensor(node.params["weight_scale"]).to(wq.device)
        return wq.to(dtype) * ws.to(dtype)
    return torch.as_tensor(node.params["weight"]).to(dtype)


def quantize_act(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Symmetric int8 activation quantization of the A8W8 path: float32
    x times the float32 constant 1/scale, rounded half to even, clipped to
    +-127 (the JAX package's quantize_act)."""
    return torch.clamp(torch.round(x.float() * (1.0 / scale)), -127, 127).to(torch.int8)


def a8w8_profitable(k: int, cin: int, cout: int) -> bool:
    """Does a Conv2D/Dense run int8 activations on the TORCH path under a
    calibrated INT8 engine? The JAX package's rule (measured on its TPU),
    kept so that both packages run the same layers at A8W8: a reasonably
    full contraction (k*k*cin >= 256, cin >= 16) and cout >= 32."""
    return cin >= 16 and cout >= 32 and k * k * cin >= 256


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    if t.shape[dim] >= size:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim % t.dim()) + [0, size - t.shape[dim]]
    return F.pad(t, pad)


def int8_rhs(b: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """int8 (K, N) `b` laid out as `torch._int_mm`'s B operand on its
    device, with N. On the card cuBLASLt's int8 product wants N a multiple
    of 8 and (measured on the H100: K = 16 is refused) K a multiple of 32,
    with B column-major: B is zero-padded there, which adds nothing to the
    sums."""
    n = b.shape[1]
    if b.device.type == "cuda":
        k32 = -(-b.shape[0] // 32) * 32
        return _pad_to(_pad_to(b, 0, k32), 1, -(-n // 8) * 8).t().contiguous().t(), n
    return b.contiguous(), n


def int8_matmul(a: torch.Tensor, b) -> torch.Tensor:
    """Exact int32 product of int8 (M, K) `a` and (K, N) `b` through
    `torch._int_mm` (the XLA int8 dot's analog: a library call, no Pallas
    kernel computes it). `b` is the int8 tensor or `int8_rhs(b)`, laid out
    once by the caller. On the card A is zero-padded to B's K and to M
    above 16, as cuBLASLt wants."""
    bb, n = b if isinstance(b, tuple) else int8_rhs(b)
    m = a.shape[0]
    if a.device.type == "cuda":
        a = _pad_to(_pad_to(a, 1, bb.shape[0]), 0, max(m, 17)).contiguous()
        return torch._int_mm(a, bb)[:m, :n]
    return torch._int_mm(a.contiguous(), bb)


def conv2d_nhwc_int8(xq: torch.Tensor, wq_hwio: torch.Tensor, pads, stride: int = 1,
                     rhs: Optional[Tuple[torch.Tensor, int]] = None):
    """int32 convolution of NHWC int8 `xq` with HWIO int8 `wq_hwio`: an int8
    im2col (exact: zero-point 0, so the padding is zeros) times the weight
    as a (kh*kw*C, O) matrix (`rhs`: that matrix as int8_rhs laid it out,
    where the caller has). Returns NHWC int32."""
    t, b, l, r = pads
    kh, kw, c, o = wq_hwio.shape
    xp = F.pad(xq, (0, 0, l, r, t, b))
    n, hp, wp, _ = xp.shape
    ho, wo = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    cols = torch.cat([
        xp[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride, :]
        for dy in range(kh) for dx in range(kw)], dim=-1)
    acc = int8_matmul(cols.reshape(n * ho * wo, kh * kw * c),
                      rhs if rhs is not None else wq_hwio.reshape(kh * kw * c, o))
    return acc.reshape(n, ho, wo, o)


def a8w8_engaged(node: Node, ctx: RunCtx, k: int, cin: int, cout: int) -> float:
    """The input activation scale where this node runs A8W8 on the TORCH
    path (int8 weights, a calibrated `in_act_scale`, an INT8 engine and
    `a8w8_profitable`), else 0: a calibrated graph rebuilt at FP32/BF16
    runs float activations."""
    from shadernn_tpu_torch.config import Precision

    sa = float(node.attr("in_act_scale", 0.0) or 0.0)
    if ("weight_q" in node.params and sa > 0.0 and ctx.precision == Precision.INT8
            and a8w8_profitable(k, cin, cout)):
        return sa
    return 0.0


def layer_weight(node: Node, ctx: RunCtx, dtype: torch.dtype, device: torch.device,
                 sa: float, layout=None):
    """What a TORCH Conv2D, SeparableConv2D, Conv2DTranspose or Dense body
    multiplies by, made once per parameter set through the engine's
    `ctx.cache` (on every call without one). Under A8W8 (`sa` > 0) the pair
    (int8_rhs of the int8 weight as a (k*k*Cin, O) matrix, the float32
    column scale sa * weight_scale that dequantizes its int32 sums, in the
    JAX package's order); else get_weight in `dtype` on `device`, laid out
    by `layout` where one is given (`cudnn_weight`)."""

    def make():
        if sa:
            wq = torch.as_tensor(node.params["weight_q"]).to(device)
            ws = torch.as_tensor(node.params["weight_scale"]).to(device, torch.float32)
            return int8_rhs(wq.reshape(-1, wq.shape[-1])), sa * ws.reshape(-1)
        w = get_weight(node, dtype).to(device)
        return w if layout is None else layout(w)

    return make() if ctx.cache is None else ctx.cache(make)


def bn_scale_offset(node: Node, out_dtype: torch.dtype):
    """Per-channel (scale, offset) of an unfolded BatchNorm epilogue:
    y = gamma * (x - mean) / sqrt(var + eps) + beta."""
    eps = float(node.attr("bn_epsilon", 1e-3))
    g, b, m, v = (
        torch.as_tensor(node.params[k], dtype=torch.float32)
        for k in ("bn_gamma", "bn_beta", "bn_mean", "bn_variance")
    )
    scale = g * torch.rsqrt(v + eps)
    offset = b - m * scale
    return scale.to(out_dtype), offset.to(out_dtype)


def _epilogue(node: Node, y: torch.Tensor) -> torch.Tensor:
    """bias -> BN -> activation, in y's dtype (the reference shader order)."""
    if "bias" in node.params and node.attr("use_bias", True):
        y = y + torch.as_tensor(node.params["bias"]).to(y.dtype)
    if node.attr("use_batchnorm", False) and "bn_gamma" in node.params:
        scale, offset = bn_scale_offset(node, y.dtype)
        y = y * scale + offset
    return apply_activation(y, node.attr("activation", "linear"), float(node.attr("leaky_alpha", 0.3)))


def _conv_pads(node: Node):
    k = int(node.attr("kernel_size"))
    return padding_offsets(node.attr("padding", "same"), k)


def epilogue_scale_offset(node: Node):
    """Fold the int8 dequantization scale, bias and BatchNorm into one
    per-output-channel float32 (scale, offset) pair: y = act(acc * scale +
    offset)."""
    if "weight_q" in node.params:
        w = torch.as_tensor(node.params["weight_q"])
        o = w.shape[-1]
        scale = torch.as_tensor(node.params["weight_scale"]).to(w.device, torch.float32)
        scale = scale.reshape(o)
    else:
        w = torch.as_tensor(node.params["weight"])
        o = w.shape[-1]
        scale = torch.ones(o, dtype=torch.float32, device=w.device)
    offset = torch.zeros(o, dtype=torch.float32, device=w.device)
    if "bias" in node.params and node.attr("use_bias", True):
        offset = torch.as_tensor(node.params["bias"]).to(device=w.device, dtype=torch.float32)
    if node.attr("use_batchnorm", False) and "bn_gamma" in node.params:
        bn_s, bn_o = bn_scale_offset(node, torch.float32)
        bn_s, bn_o = bn_s.to(w.device), bn_o.to(w.device)
        scale = scale * bn_s
        offset = offset * bn_s + bn_o
    return scale, offset


def folded_operands(node: Node, compute_dtype: torch.dtype):
    """(weight, float32 scale, float32 offset) of a Conv2D or Dense node, as
    the kernels take them: the weight in the compute dtype, or the int8
    weight itself with its scale folded into the epilogue with bias and
    BatchNorm."""
    scale, offset = epilogue_scale_offset(node)
    if "weight_q" in node.params:
        return torch.as_tensor(node.params["weight_q"]), scale, offset
    return torch.as_tensor(node.params["weight"]).to(compute_dtype), scale, offset


def kernel_conv_supported(node: Node, in_channels: int) -> bool:
    """May this conv run on the per-layer implicit-GEMM kernel? (The JAX
    package's `pallas_conv_supported` gate, with the same limits; stride 2
    stays out so that both packages plan alike, though the CUDA kernel
    computes it.)"""
    k = int(node.attr("kernel_size"))
    return (
        int(node.attr("stride", 1)) == 1
        and in_channels <= 128
        and int(node.attr("out_channels")) <= 128
        and k * k * in_channels <= 4096
    )


def kernel_chain_supported(node: Node, in_channels: int) -> bool:
    """May this conv join a kernel conv chain? (The JAX package's
    `pallas_chain_supported` gate, with the same limits.)"""
    if int(node.attr("stride", 1)) != 1:
        return False
    k = int(node.attr("kernel_size"))
    t, b, l, r = _conv_pads(node)
    o = int(node.attr("out_channels"))
    return (
        t <= _MAX_TOP_PAD and l <= _MAX_LEFT_PAD and b <= 9 and r <= 8
        and in_channels <= 128 and o <= 128 and k * k * in_channels <= 4096
    )


@register("Conv2D", "Convolution")
class Conv2D(OpDef):
    """2D convolution with fused bias/BN/activation epilogue.

    out = floor((H+padT+padB-k)/s)+1, through the reference's Transform
    arithmetic (conv2d.cpp:162-174).
    """

    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        s = in_specs[0]
        k, st = int(node.attr("kernel_size")), int(node.attr("stride", 1))
        t_pad, b_pad, l_pad, r_pad = _conv_pads(node)
        if isinstance(node.attr("padding", "same"), (list, tuple)):
            tr_h = 1 + (t_pad + b_pad - k) / st
            tr_w = 1 + (l_pad + r_pad - k) / st
        elif k % 2 != 0:
            tr_h = tr_w = 1 + (t_pad + b_pad - k) / st
        else:
            tr_h = tr_w = 1 + (t_pad + b_pad - 1 - k) / st
        t = Transform(scale_w=1 / st, scale_h=1 / st, translate_w=tr_w, translate_h=tr_h)
        h, w = transform_output_dims(t, in_specs)
        return s.with_shape((s.n, h, w, int(node.attr("out_channels"))))

    def flops(self, node: Node, in_specs: Sequence[TensorSpec]) -> int:
        o = self.infer(node, in_specs)
        k = int(node.attr("kernel_size"))
        cin = in_specs[0].c * (len(in_specs) if len(in_specs) > 1 else 1)
        return 2 * o.n * o.h * o.w * k * k * cin * o.c

    def run(self, node: Node, xs: List, ctx: RunCtx):
        # Multi-input conv: extra inputs are channel-concatenated first.
        x = xs[0] if len(xs) == 1 else torch.cat(xs, dim=-1)
        if ctx.backend == BackendKind.KERNEL:
            from shadernn_tpu_torch.kernels.conv_igemm import (
                GATE, conv_run_igemm, igemm_conv_supported,
            )

            # Prepared operands mean the planner has asked the gate already.
            if ctx.operands is not None or igemm_conv_supported(node, x.shape[-1]):
                return conv_run_igemm(node, x, ctx.operands)
            log.warning("conv %s given to KERNEL runs on TORCH: outside the %s", node.name, GATE)
        k, stride = int(node.attr("kernel_size")), int(node.attr("stride", 1))
        sa = a8w8_engaged(node, ctx, k, x.shape[-1], int(node.attr("out_channels")))
        if sa:  # A8W8: int8 x int8 -> exact int32, (sa * weight_scale) folded after
            rhs, col_scale = layer_weight(node, ctx, x.dtype, x.device, sa)
            acc = conv2d_nhwc_int8(quantize_act(x, sa), torch.as_tensor(node.params["weight_q"]),
                                   _conv_pads(node), stride, rhs)
            return _epilogue(node, (acc.float() * col_scale).to(x.dtype))
        if cudnn_bf16(x):
            w = layer_weight(node, ctx, x.dtype, x.device, 0.0, cudnn_weight)
            return _epilogue(node, conv2d_nhwc_cudnn(x, w, _conv_pads(node), stride))
        w = layer_weight(node, ctx, x.dtype, x.device, 0.0)
        y = conv2d_nhwc_f32(x, w, _conv_pads(node), stride)
        return _epilogue(node, y.to(x.dtype))


@register("SeparableConv2D", "DepthwiseConv2D")
class SeparableConv2D(OpDef):
    """Depthwise convolution with channel multiplier (HWIO weight with I=1,
    O=C*multiplier), stride 1 or 2, fused epilogue. The weight is cast to
    the activation dtype, the sum is float32 and the result is rounded to
    the activation dtype before the epilogue, as the JAX op does."""

    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        s = in_specs[0]
        k, st = int(node.attr("kernel_size")), int(node.attr("stride", 1))
        t_pad, b_pad, _, _ = _conv_pads(node)
        if k % 2 != 0:
            tr = 1 + (t_pad + b_pad - k) / st
        else:
            tr = 1 + (t_pad + b_pad - 1 - k) / st
        t = Transform(scale_w=1 / st, scale_h=1 / st, translate_w=tr, translate_h=tr)
        h, w = transform_output_dims(t, in_specs)
        return s.with_shape((s.n, h, w, s.c * int(node.attr("multiplier", 1))))

    def flops(self, node: Node, in_specs: Sequence[TensorSpec]) -> int:
        o = self.infer(node, in_specs)
        k = int(node.attr("kernel_size"))
        return 2 * o.n * o.h * o.w * k * k * o.c

    def run(self, node: Node, xs: List, ctx: RunCtx):
        x = xs[0]
        w = layer_weight(node, ctx, x.dtype, x.device, 0.0)  # (k, k, 1, C*mult)
        y = conv2d_nhwc_f32(x, w, _conv_pads(node), int(node.attr("stride", 1)),
                            groups=x.shape[-1])
        return _epilogue(node, y.to(x.dtype))


def conv_transpose_padding(k: int, s: int, same: bool) -> Tuple[int, int]:
    """(before, after) zero padding of the stride-dilated input that
    `lax.conv_transpose` takes for a "SAME" or "VALID" transposed conv, per
    spatial dimension (lax's own rule: "SAME" is asymmetric)."""
    if same:
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    else:
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    return pad_a, pad_len - pad_a


def transpose_window(y: torch.Tensor, hw_in, k_hw, stride: int, same: bool) -> torch.Tensor:
    """lax.conv_transpose's window of NHWC `y`, the whole transposed conv of
    an `hw_in` input: the scatter y[i*s + a] += x[i] * w[a]
    (`F.conv_transpose2d` without padding gives all of it, (H-1)*s + k rows)
    seen through lax's window, which starts k - 1 - pad_a rows in and spans
    (H-1)*s + 1 + pad_a + pad_b - k + 1 rows. A slice where the window lies
    inside `y`; zero rows (padded in NHWC) only where it reaches past an
    edge."""
    cuts, fill = [], []
    for k, n_in, full in zip(k_hw, hw_in, y.shape[1:3]):
        pad_a, pad_b = conv_transpose_padding(k, stride, same)
        start, size = k - 1 - pad_a, (n_in - 1) * stride + pad_a + pad_b - k + 2
        lo, hi = max(start, 0), min(start + size, full)
        cuts.append(slice(lo, hi))
        fill += [lo - start, start + size - hi]
    y = y[:, cuts[0], cuts[1]]
    if any(fill):
        y = F.pad(y, (0, 0, fill[2], fill[3], fill[0], fill[1]))
    return y


def conv_transpose2d_nhwc_f32(x: torch.Tensor, w_hwio: torch.Tensor, stride: int,
                              same: bool) -> torch.Tensor:
    """float32 transposed convolution of NHWC `x` with HWIO `w_hwio` (I = x's
    channels), the function of the JAX op: `lax.conv_transpose` of the
    spatially flipped kernel, i.e. `transpose_window` of the whole
    `F.conv_transpose2d`. Returns NHWC float32."""
    with full_precision():
        y = F.conv_transpose2d(x.float().permute(0, 3, 1, 2), w_hwio.float().permute(2, 3, 0, 1),
                               stride=stride)
    return transpose_window(y.permute(0, 2, 3, 1), x.shape[1:3], w_hwio.shape[:2], stride, same)


def conv_transpose2d_nhwc_cudnn(x: torch.Tensor, w: torch.Tensor, stride: int,
                                same: bool) -> torch.Tensor:
    """`conv_transpose2d_nhwc_f32`'s function in x's dtype, with `w` as
    `cudnn_weight(w_hwio, transposed=True)`: `F.conv_transpose2d` on the
    channels_last view of `x`, then `transpose_window`. For bfloat16 on a
    CUDA device cuDNN sums in float32 and rounds once. Returns NHWC."""
    timer.count("ops.conv_bf16_cudnn")
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=stride).permute(0, 2, 3, 1)
    return transpose_window(y, x.shape[1:3], w.shape[2:], stride, same)


@register("Conv2DTranspose", "Deconvolution")
class Conv2DTranspose(OpDef):
    """Transposed convolution with the Conv2D epilogue. out = s*H ("same")
    or s*H + (k - s) otherwise. HWIO weight (I = input channels, O = output
    channels), in the Keras/torch gradient-of-conv orientation; float or
    int8 (dequantized as get_weight does). Sums in float32 on the compute-
    dtype values, then rounded, as the JAX op's preferred_element_type=
    float32 does; TORCH on every backend (the JAX op has no Pallas
    branch)."""

    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        s = in_specs[0]
        k, st = int(node.attr("kernel_size")), int(node.attr("stride", 1))
        tr = 0.0 if is_same_padding(node.attr("padding", "same")) else float(k - st)
        t = Transform(scale_w=float(st), scale_h=float(st), translate_w=tr, translate_h=tr)
        h, w = transform_output_dims(t, in_specs)
        return s.with_shape((s.n, h, w, int(node.attr("out_channels"))))

    def flops(self, node: Node, in_specs: Sequence[TensorSpec]) -> int:
        s = in_specs[0]
        k = int(node.attr("kernel_size"))
        return 2 * s.n * s.h * s.w * k * k * s.c * int(node.attr("out_channels"))

    def run(self, node: Node, xs: List, ctx: RunCtx):
        x = xs[0]
        stride, same = int(node.attr("stride", 1)), is_same_padding(node.attr("padding", "same"))
        if cudnn_bf16(x):
            w = layer_weight(node, ctx, x.dtype, x.device, 0.0,
                             lambda w: cudnn_weight(w, transposed=True))
            return _epilogue(node, conv_transpose2d_nhwc_cudnn(x, w, stride, same))
        w = layer_weight(node, ctx, x.dtype, x.device, 0.0)
        return _epilogue(node, conv_transpose2d_nhwc_f32(x, w, stride, same).to(x.dtype))
