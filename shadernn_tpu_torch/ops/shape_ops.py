"""Shape/layout ops: Flatten, UpSampling2D, Pad (ZeroPadding2D), Subpixel,
SpaceToDepth (counterparts of shadernn_tpu/ops/shape_ops.py).

UpSampling2D's bilinear mode is `jax.image.resize(method="bilinear")`'s
function: half-pixel centres, with the weights of taps outside the image
dropped and the rest renormalized. For an integer upscale that is
`F.interpolate(mode="bilinear", align_corners=False)`, which clamps the
source coordinate at the borders instead (the same values: a clamped tap
lands on the edge pixel that renormalization weights 1).

Subpixel keeps TF depth_to_space channel order,
channel = (py*r + px)*co + c, which is what the Keras ESPCN uses.
`torch.pixel_shuffle` orders channels c*r*r + py*r + px instead; the two
agree only when co == 1, so it is not used here.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch.nn.functional as F

from shadernn_tpu_torch.graph.ir import Node, TensorSpec, Transform, transform_output_dims
from shadernn_tpu_torch.ops.common import padding_offsets
from shadernn_tpu_torch.ops.registry import OpDef, RunCtx, register


@register("Flatten")
class Flatten(OpDef):
    """NHWC -> (N, H*W*C), the Keras Flatten order (NHWC is the native
    layout, so a reshape)."""

    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        s = in_specs[0]
        return s.with_shape((s.n, int(np.prod(s.shape[1:]))))

    def run(self, node: Node, xs: List, ctx: RunCtx):
        return xs[0].reshape(xs[0].shape[0], -1)


@register("UpSampling2D", "Upsample")
class UpSampling2D(OpDef):
    """Nearest or bilinear resize by an integer scale (transform: scale,
    scale, 0, 0). Bilinear interpolates in float32 and rounds to x's dtype
    once; jax.image.resize runs in x's dtype (bfloat16 under BF16), so the
    two differ there by bfloat16 roundings only."""

    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        s = in_specs[0]
        f = float(node.attr("scale", 2))
        h, w = transform_output_dims(Transform(scale_w=f, scale_h=f), in_specs)
        return s.with_shape((s.n, h, w, s.c))

    def run(self, node: Node, xs: List, ctx: RunCtx):
        x = xs[0]
        f = int(node.attr("scale", 2))
        interp = str(node.attr("interpolation", "nearest")).lower()
        if interp == "nearest":
            return x.repeat_interleave(f, dim=1).repeat_interleave(f, dim=2)
        if interp in ("bilinear", "linear"):
            y = F.interpolate(x.permute(0, 3, 1, 2).float(), scale_factor=f, mode="bilinear",
                              align_corners=False, antialias=False)
            return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()
        raise ValueError(f"unknown interpolation {interp!r}")


@register("ZeroPadding2D", "Pad", "Padding")
class Pad(OpDef):
    """Constant / reflect / replicate padding layer."""

    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        s = in_specs[0]
        t, b, l, r = self._pads(node)
        return s.with_shape((s.n, s.h + t + b, s.w + l + r, s.c))

    @staticmethod
    def _pads(node: Node):
        if "padding" in node.attrs:
            return padding_offsets(node.attrs["padding"], 0)
        return tuple(int(node.attr(k, 0)) for k in ("pad_top", "pad_bottom", "pad_left", "pad_right"))

    def run(self, node: Node, xs: List, ctx: RunCtx):
        t, b, l, r = self._pads(node)
        mode = str(node.attr("mode", "constant")).lower()
        x = xs[0].permute(0, 3, 1, 2)  # F.pad pads the trailing dims
        if mode in ("constant", "zero"):
            y = F.pad(x, (l, r, t, b), value=float(node.attr("value", 0.0)))
        elif mode == "reflect":
            y = F.pad(x, (l, r, t, b), mode="reflect")
        elif mode in ("replicate", "edge", "symmetric"):
            y = F.pad(x, (l, r, t, b), mode="replicate")
        else:
            raise ValueError(f"unknown pad mode {mode!r}")
        return y.permute(0, 2, 3, 1).contiguous()


def depth_to_space(x, r: int):
    """NHWC depth_to_space in TF channel order: (N,H,W,r*r*co) -> (N,rH,rW,co)."""
    n, h, w, c = x.shape
    co = c // (r * r)
    x = x.reshape(n, h, w, r, r, co)
    x = x.permute(0, 1, 3, 2, 4, 5)  # n, h, r, w, r, co
    return x.reshape(n, h * r, w * r, co)


@register("Subpixel", "DepthToSpace", "PixelShuffle")
class Subpixel(OpDef):
    """depth_to_space for super-resolution heads; attrs['scale'] is the
    upscale factor r and C must be divisible by r*r."""

    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        s = in_specs[0]
        r = int(node.attr("scale", 2))
        if s.c % (r * r):
            raise ValueError(f"Subpixel: C={s.c} not divisible by {r * r}")
        return s.with_shape((s.n, s.h * r, s.w * r, s.c // (r * r)))

    def run(self, node: Node, xs: List, ctx: RunCtx):
        return depth_to_space(xs[0], int(node.attr("scale", 2)))


@register("SpaceToDepth")
class SpaceToDepth(OpDef):
    """Inverse of Subpixel (TF space_to_depth, block-major channel order);
    produced by the stride-2 conv folding pass (graph/fusion.py)."""

    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        s = in_specs[0]
        r = int(node.attr("scale", 2))
        if s.h % r or s.w % r:
            raise ValueError(f"SpaceToDepth: {s.h}x{s.w} not divisible by {r}")
        return s.with_shape((s.n, s.h // r, s.w // r, s.c * r * r))

    def run(self, node: Node, xs: List, ctx: RunCtx):
        x = xs[0]
        r = int(node.attr("scale", 2))
        n, h, w, c = x.shape
        x = x.reshape(n, h // r, r, w // r, r, c)
        x = x.permute(0, 1, 3, 2, 4, 5)  # n, h/r, w/r, by, bx, c
        return x.reshape(n, h // r, w // r, c * r * r)
