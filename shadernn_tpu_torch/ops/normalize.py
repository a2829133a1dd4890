"""BatchNormalization with stored moving statistics (counterpart of
shadernn_tpu/ops/normalize.py; InstanceNormalization comes later).

`graph.fusion.fold_batchnorm` folds every BatchNormalization that follows a
conv into the conv's weights, so a run of MobileNetV2 never reaches `run`;
shape inference still needs `infer`.
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
