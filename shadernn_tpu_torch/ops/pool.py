"""Pooling ops: MaxPooling2D, AveragePooling2D, AdaptiveAvgPool2d
(counterparts of shadernn_tpu/ops/pool.py).

Shape transform (the reference's maxpool2d.cpp:26-35): scale = 1/stride;
translate = 1 - k/stride ("valid") or 1 - 1/stride ("same"). Padding
offsets share the conv rules.

Dtypes follow the JAX ops: max and average pooling and the divisible
adaptive path reduce in the input dtype (bfloat16 under BF16); the
adaptive path for sizes that do not divide sums an integral image in
float32 and casts back.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from shadernn_tpu_torch.graph.ir import Node, TensorSpec, Transform, transform_output_dims
from shadernn_tpu_torch.ops.common import padding_offsets
from shadernn_tpu_torch.ops.registry import OpDef, RunCtx, register


def _pool_transform(node: Node) -> Transform:
    k, st = int(node.attr("kernel_size")), int(node.attr("stride", 1))
    pad = str(node.attr("padding", "same"))
    if pad in ("0", "valid", "none"):
        tr = 1.0 - k / st
    else:
        tr = 1.0 - 1.0 / st
    return Transform(scale_w=1 / st, scale_h=1 / st, translate_w=tr, translate_h=tr)


def _pool_pads(node: Node):
    return padding_offsets(node.attr("padding", "same"), int(node.attr("kernel_size")))


def _window_sums(x_nchw: torch.Tensor, k: int, st: int) -> torch.Tensor:
    """Sum over every k x k window at stride st (no padding)."""
    return F.avg_pool2d(x_nchw, k, st, divisor_override=1)


class _Pool(OpDef):
    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        s = in_specs[0]
        h, w = transform_output_dims(_pool_transform(node), in_specs)
        return s.with_shape((s.n, h, w, s.c))


@register("MaxPooling2D", "MaxPool2D", "MaxPool")
class MaxPooling2D(_Pool):
    """Max over each window; padded positions are -inf."""

    def run(self, node: Node, xs: List, ctx: RunCtx):
        k, st = int(node.attr("kernel_size")), int(node.attr("stride", 1))
        t, b, l, r = _pool_pads(node)
        x = F.pad(xs[0].permute(0, 3, 1, 2), (l, r, t, b), value=float("-inf"))
        return F.max_pool2d(x, k, st).permute(0, 2, 3, 1).contiguous()


@register("AveragePooling2D", "AvgPool2D", "AveragePool")
class AveragePooling2D(_Pool):
    """Average pooling; padded positions are excluded from the mean
    (count_include_pad=False, the Keras/TF "same" semantics)."""

    def run(self, node: Node, xs: List, ctx: RunCtx):
        x = xs[0]
        k, st = int(node.attr("kernel_size")), int(node.attr("stride", 1))
        t, b, l, r = _pool_pads(node)
        sums = _window_sums(F.pad(x.permute(0, 3, 1, 2), (l, r, t, b)), k, st)
        ones = x.new_ones((1, 1, x.shape[1], x.shape[2]))
        counts = _window_sums(F.pad(ones, (l, r, t, b)), k, st)
        return (sums / counts).permute(0, 2, 3, 1).contiguous()


@register("AdaptiveAvgPool2d", "AdaptiveAvgPool")
class AdaptiveAvgPool2d(OpDef):
    """PyTorch-style adaptive average pooling to a fixed (oh, ow), computed
    as the JAX op computes it: window sums when the size divides, else a
    float32 integral image with static boundary gathers."""

    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        s = in_specs[0]
        oh = int(node.attr("output_height", node.attr("output_size", 1)))
        ow = int(node.attr("output_width", node.attr("output_size", 1)))
        return s.with_shape((s.n, oh, ow, s.c))

    def run(self, node: Node, xs: List, ctx: RunCtx):
        x = xs[0]
        n, h, w, c = x.shape
        oh = int(node.attr("output_height", node.attr("output_size", 1)))
        ow = int(node.attr("output_width", node.attr("output_size", 1)))
        if h % oh == 0 and w % ow == 0:
            kh, kw = h // oh, w // ow
            return x.reshape(n, oh, kh, ow, kw, c).sum(dim=(2, 4)) / (kh * kw)
        # Integral image: S[i, j] = sum of x[:i, :j]; region sums by 4 gathers.
        acc = torch.cumsum(torch.cumsum(x.float(), dim=1), dim=2)
        acc = F.pad(acc, (0, 0, 1, 0, 1, 0))
        hs = np.floor(np.arange(oh) * h / oh).astype(np.int64)
        he = np.ceil((np.arange(oh) + 1) * h / oh).astype(np.int64)
        ws = np.floor(np.arange(ow) * w / ow).astype(np.int64)
        we = np.ceil((np.arange(ow) + 1) * w / ow).astype(np.int64)

        def at(rows, cols):
            return acc[:, torch.from_numpy(rows)][:, :, torch.from_numpy(cols)]

        sums = at(he, we) - at(hs, we) - at(he, ws) + at(hs, ws)
        counts = torch.from_numpy(
            ((he - hs)[:, None] * (we - ws)[None, :]).astype(np.float32)
        ).to(x.device)
        return (sums / counts[None, :, :, None]).to(x.dtype)
