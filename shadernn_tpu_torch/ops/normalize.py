"""Normalization ops (counterparts of shadernn_tpu/ops/normalize.py):
BatchNormalization with stored moving statistics, and
InstanceNormalization with per-(sample, channel) statistics over H and W
computed at run time.

`graph.fusion.fold_batchnorm` folds every BatchNormalization that follows a
conv into the conv's weights, so a run of MobileNetV2 never reaches its
`run`; shape inference still needs `infer`.

An InstanceNormalization of bfloat16 activations on a CUDA device runs the
hand-written kernel (kernels/instnorm.py, csrc/instance_norm.cu) where it
takes the input and no gradient is wanted (`kernel_route`): the same
arithmetic in two launches, the activation fused where the kernel has it.
float32, the CPU, autograd and any input the kernel does not take keep the
ATen route.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from shadernn_tpu_torch.graph.ir import Node, TensorSpec
from shadernn_tpu_torch.kernels import instnorm
from shadernn_tpu_torch.ops.common import apply_activation
from shadernn_tpu_torch.ops.registry import OpDef, RunCtx, register


@register("BatchNormalization", "BatchNorm")
class BatchNormalization(OpDef):
    """y = act(x * scale + offset), scale = gamma / sqrt(var + eps),
    offset = beta - mean * scale; both cast to x's dtype first."""

    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        return in_specs[0]

    def run(self, node: Node, xs: List, ctx: RunCtx):
        x = xs[0]
        eps = float(node.attr("epsilon", 1e-3))
        g, b, m, v = (
            torch.as_tensor(node.params[k], dtype=torch.float32).to(x.device)
            for k in ("gamma", "beta", "mean", "variance")
        )
        scale = g * torch.rsqrt(v + eps)
        offset = b - m * scale
        y = x * scale.to(x.dtype) + offset.to(x.dtype)
        return apply_activation(
            y, node.attr("activation", "linear"), float(node.attr("leaky_alpha", 0.3))
        )


def kernel_route(x) -> bool:
    """Does an InstanceNormalization of `x` run the hand-written kernel?
    bfloat16 on a CUDA device in a layout the kernel takes
    (`instnorm.refusal`: contiguous NHWC, C % 8 == 0), unless autograd
    wants a gradient of it."""
    return instnorm.refusal(x) is None and not (torch.is_grad_enabled() and x.requires_grad)


@register("InstanceNormalization", "InstanceNorm")
class InstanceNormalization(OpDef):
    """y = act(((x - mean) * rsqrt(var + eps) * gamma + beta) cast to x's
    dtype), in the JAX op's order: mean and the biased variance over H and
    W in float32, gamma and beta applied in float32, the cast, then the
    activation in x's dtype. On the kernel route gamma and beta are made
    float32 on the device once per parameter set (`ctx.cache`)."""

    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        return in_specs[0]

    def run(self, node: Node, xs: List, ctx: RunCtx):
        x = xs[0]
        eps = float(node.attr("epsilon", 1e-5))
        kind, alpha = node.attr("activation", "linear"), float(node.attr("leaky_alpha", 0.3))
        if kernel_route(x):
            def make():
                return tuple(torch.as_tensor(node.params[k]).to(x.device, torch.float32)
                             .reshape(-1).contiguous() if k in node.params else None
                             for k in ("gamma", "beta"))

            gamma, beta = make() if ctx.cache is None else ctx.cache(make)
            fused = instnorm.act_code(kind) is not None
            y = instnorm.run(x, gamma, beta, eps, kind if fused else "linear", alpha)
            return y if fused else apply_activation(y, kind, alpha)
        xf = x.float()
        mean = xf.mean(dim=(1, 2), keepdim=True)
        var = (xf - mean).square().mean(dim=(1, 2), keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + eps)
        for key, op in (("gamma", torch.mul), ("beta", torch.add)):
            if key in node.params:
                y = op(y, torch.as_tensor(node.params[key], dtype=torch.float32).to(x.device))
        return apply_activation(y.to(x.dtype), kind, alpha)
