"""Elementwise / structural ops: InputLayer, Add, Concatenate, Activation,
Unary, Calculate (counterparts of shadernn_tpu/ops/elementwise.py). All
are identity shape transforms but Concatenate (channel concatenation) and
Calculate's merge (the shape of its second input)."""

from __future__ import annotations

from typing import List, Sequence

import torch

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


@register("Concatenate", "Concat")
class Concatenate(OpDef):
    """Channel concatenation."""

    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        s = in_specs[0]
        return s.with_shape((*s.shape[:-1], sum(sp.c for sp in in_specs)))

    def run(self, node: Node, xs: List, ctx: RunCtx):
        return torch.cat(xs, dim=-1)


@register("Activation", "ReLU", "LeakyReLU")
class Activation(OpDef):
    """Standalone activation layer."""

    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        return in_specs[0]

    def run(self, node: Node, xs: List, ctx: RunCtx):
        kind = node.attr("activation", node.attr("kind", "relu"))
        return apply_activation(xs[0], kind, float(node.attr("leaky_alpha", 0.3)))


_UNARY_FNS = {
    "abs": torch.abs,
    "neg": torch.neg,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "square": torch.square,
    "exp": torch.exp,
    "log": torch.log,
    "sin": torch.sin,
    "cos": torch.cos,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "reciprocal": torch.reciprocal,
}


@register("Unary")
class Unary(OpDef):
    """Elementwise unary function selected by attrs['op_type']; mul/scale,
    add/shift and pow take attrs['op_value'], clip attrs['clip_range']. The
    constant is a Python float, so the result keeps x's dtype, as in the
    JAX op."""

    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        return in_specs[0]

    def run(self, node: Node, xs: List, ctx: RunCtx):
        op = str(node.attr("op_type", "abs")).lower()
        x = xs[0]
        if op in ("mul", "scale"):
            return x * float(node.attr("op_value", 1.0))
        if op in ("add", "shift"):
            return x + float(node.attr("op_value", 0.0))
        if op == "pow":
            return torch.pow(x, float(node.attr("op_value", 1.0)))
        if op == "clip":
            lo, hi = node.attr("clip_range", (0.0, 1.0))
            return torch.clamp(x, float(lo), float(hi))
        if op not in _UNARY_FNS:
            raise ValueError(f"unknown unary op_type {op!r}")
        return _UNARY_FNS[op](x)


@register("Calculate")
class Calculate(OpDef):
    """Image-pipeline merge op: recombines a processed luma plane with the
    source frame's chroma. attrs['expr']:
      'merge_y_uv': inputs (y:[...,1], src:[...,C>=3]) -> [y, src[..., 1:]]
      'add' / 'mul': elementwise add / multiply of the two inputs
    """

    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        if str(node.attr("expr", "merge_y_uv")) == "merge_y_uv":
            return in_specs[1]
        return in_specs[0]

    def run(self, node: Node, xs: List, ctx: RunCtx):
        expr = str(node.attr("expr", "merge_y_uv"))
        if expr == "merge_y_uv":
            y, src = xs[0], xs[1]
            return torch.cat([y[..., :1], src[..., 1:]], dim=-1)
        if expr == "add":
            return xs[0] + xs[1]
        if expr == "mul":
            return xs[0] * xs[1]
        raise ValueError(f"unknown Calculate expr {expr!r}")
