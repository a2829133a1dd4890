"""Elementwise / structural ops: InputLayer, Add, Activation
(counterparts of shadernn_tpu/ops/elementwise.py)."""

from __future__ import annotations

from typing import List, Sequence

from shadernn_tpu_torch.graph.ir import Node, TensorSpec
from shadernn_tpu_torch.ops.common import apply_activation
from shadernn_tpu_torch.ops.registry import OpDef, RunCtx, register


@register("InputLayer")
class InputLayer(OpDef):
    """Placeholder carrying input index/shape. Never executed — the engine
    binds model inputs directly."""

    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        raise AssertionError("InputLayer shapes are set by Graph.infer_shapes")

    def run(self, node: Node, xs: List, ctx: RunCtx):
        raise AssertionError("InputLayer is bound by the engine, not run")


@register("Add")
class Add(OpDef):
    """Elementwise residual add + optional activation."""

    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        return in_specs[0]

    def run(self, node: Node, xs: List, ctx: RunCtx):
        y = xs[0]
        for x in xs[1:]:
            y = y + x
        return apply_activation(
            y, node.attr("activation", "linear"), float(node.attr("leaky_alpha", 0.3))
        )


@register("Activation", "ReLU", "LeakyReLU")
class Activation(OpDef):
    """Standalone activation layer."""

    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        return in_specs[0]

    def run(self, node: Node, xs: List, ctx: RunCtx):
        kind = node.attr("activation", node.attr("kind", "relu"))
        return apply_activation(xs[0], kind, float(node.attr("leaky_alpha", 0.3)))
