"""Normalization ops (counterparts of shadernn_tpu/ops/normalize.py):
BatchNormalization with stored moving statistics, and
InstanceNormalization with per-(sample, channel) statistics over H and W
computed at run time.

`graph.fusion.fold_batchnorm` folds every BatchNormalization that follows a
conv into the conv's weights, so a run of MobileNetV2 never reaches its
`run`; shape inference still needs `infer`.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from shadernn_tpu_torch.graph.ir import Node, TensorSpec
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


@register("InstanceNormalization", "InstanceNorm")
class InstanceNormalization(OpDef):
    """y = act(((x - mean) * rsqrt(var + eps) * gamma + beta) cast to x's
    dtype), in the JAX op's order: mean and the biased variance over H and
    W in float32, gamma and beta applied in float32, the cast, then the
    activation in x's dtype."""

    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        return in_specs[0]

    def run(self, node: Node, xs: List, ctx: RunCtx):
        x = xs[0]
        eps = float(node.attr("epsilon", 1e-5))
        xf = x.float()
        mean = xf.mean(dim=(1, 2), keepdim=True)
        var = (xf - mean).square().mean(dim=(1, 2), keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + eps)
        for key, op in (("gamma", torch.mul), ("beta", torch.add)):
            if key in node.params:
                y = op(y, torch.as_tensor(node.params[key], dtype=torch.float32).to(x.device))
        return apply_activation(
            y.to(x.dtype), node.attr("activation", "linear"), float(node.attr("leaky_alpha", 0.3))
        )
