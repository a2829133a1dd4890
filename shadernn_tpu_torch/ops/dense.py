"""Dense (fully connected) layer (counterpart of shadernn_tpu/ops/dense.py).
Weight layout (in_features, units), as in the reference's JSON
`weights.kernel` stream; float, or int8 with per-unit scales
(ops/conv.py get_weight).

The TORCH body flattens inputs above 2-D, takes `x @ W` with a float32
sum over the activation-dtype values (torch.matmul keeps float32 exact on
the card unless TF32 is switched on globally), rounds to the activation
dtype, adds the bias and applies the activation (softmax for the
classifiers). Under a calibrated INT8 engine the TORCH body runs A8W8
where ops/conv.py `a8w8_engaged` says so. Under KERNEL a layer inside the
fused-matmul kernel's gate runs on that kernel (kernels/matmul.py), bias
and the int8 scale folded into its float32 epilogue, as the JAX op does
under PALLAS.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from shadernn_tpu_torch.config import BackendKind
from shadernn_tpu_torch.graph.ir import Node, TensorSpec
from shadernn_tpu_torch.ops.common import apply_activation
from shadernn_tpu_torch.ops.conv import a8w8_engaged, int8_matmul, layer_weight, quantize_act
from shadernn_tpu_torch.ops.registry import OpDef, RunCtx, register
from shadernn_tpu_torch.utils import get_logger

log = get_logger("snn_torch.ops")


@register("Dense", "FullyConnected", "InnerProduct")
class Dense(OpDef):
    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        s = in_specs[0]
        return s.with_shape((s.n, int(node.attr("units"))))

    def flops(self, node: Node, in_specs: Sequence[TensorSpec]) -> int:
        s = in_specs[0]
        feat = 1
        for d in s.shape[1:]:
            feat *= d
        return 2 * s.n * feat * int(node.attr("units"))

    def run(self, node: Node, xs: List, ctx: RunCtx):
        x = xs[0]
        if ctx.backend == BackendKind.KERNEL:
            from shadernn_tpu_torch.kernels.matmul import GATE, dense_run_kernel, dense_supported

            # Prepared operands mean the planner has asked the gate already.
            if ctx.operands is not None or dense_supported(node):
                return dense_run_kernel(node, x, ctx.operands)
            log.warning("dense %s given to KERNEL runs on TORCH: outside the %s", node.name, GATE)
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        units = int(node.attr("units"))
        sa = a8w8_engaged(node, ctx, 1, x.shape[-1], units)
        w = layer_weight(node, ctx, x.dtype, x.device, sa)
        if sa:  # A8W8 (ops/conv.py): exact int32 sums, (sa * weight_scale) after
            rhs, col_scale = w
            y = (int8_matmul(quantize_act(x, sa), rhs).float() * col_scale).to(x.dtype)
        else:
            y = (x.float() @ w.float()).to(x.dtype)  # w: (in, units)
        if "bias" in node.params and node.attr("use_bias", True):
            y = y + torch.as_tensor(node.params["bias"]).to(y.dtype)
        return apply_activation(
            y, node.attr("activation", "linear"), float(node.attr("leaky_alpha", 0.3))
        )
