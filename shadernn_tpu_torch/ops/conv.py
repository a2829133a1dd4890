"""Conv2D and SeparableConv2D (depthwise) on NHWC tensors with HWIO weights
(counterpart of shadernn_tpu/ops/conv.py; Conv2DTranspose comes later).

The TORCH backend runs `F.conv2d` on NCHW views, the analog of the XLA
convolution the JAX package uses; under KERNEL a Conv2D inside the
implicit-GEMM kernel's gate runs on that kernel (kernels/conv_igemm.py),
as the JAX op does under PALLAS. Every convolution accumulates in float32
on the compute-dtype values, as `lax.conv_general_dilated(...,
preferred_element_type=float32)` does, with TF32 off: cuDNN would
otherwise round float32 operands to TF32 (about three decimal digits),
where the JAX package runs float32 at HIGHEST precision. bfloat16 values
are exact in TF32, so the rule costs bfloat16 nothing in accuracy.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence

import torch
import torch.nn.functional as F

from shadernn_tpu_torch.config import BackendKind
from shadernn_tpu_torch.graph.ir import Node, TensorSpec, Transform, transform_output_dims
from shadernn_tpu_torch.ops.common import apply_activation, padding_offsets
from shadernn_tpu_torch.ops.registry import OpDef, RunCtx, register
from shadernn_tpu_torch.utils import get_logger

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
    xin = F.pad(x.float().permute(0, 3, 1, 2), (l, r, t, b))
    with full_precision():
        y = F.conv2d(xin, w_hwio.float().permute(3, 2, 0, 1), stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def get_weight(node: Node, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(node.params["weight"]).to(dtype)


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
    """Fold bias + BatchNorm into one per-output-channel float32
    (scale, offset) pair: y = act(acc * scale + offset)."""
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
    """(weight in the compute dtype, float32 scale, float32 offset) of a
    Conv2D or Dense node, as the kernels take them: bias and BatchNorm
    folded into the epilogue."""
    scale, offset = epilogue_scale_offset(node)
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
        w = get_weight(node, x.dtype).to(x.device)
        y = conv2d_nhwc_f32(x, w, _conv_pads(node), int(node.attr("stride", 1)))
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

    def run(self, node: Node, xs: List, ctx: RunCtx):
        x = xs[0]
        w = get_weight(node, x.dtype).to(x.device)  # (k, k, 1, C*mult)
        y = conv2d_nhwc_f32(x, w, _conv_pads(node), int(node.attr("stride", 1)),
                            groups=x.shape[-1])
        return _epilogue(node, y.to(x.dtype))
