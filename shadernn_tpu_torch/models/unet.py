"""U-Net (counterpart of shadernn_tpu/models/unet.py; the reference zoo's
modelzoo/U-Net/unet.json, runner 256x256 luma).

Encoder/decoder with skip concatenations: per level two k3 relu convs and
a 2x2 max pool, a bottleneck, then per level a k2 stride-2 transposed
conv, the skip concatenation and two convs; a 1x1 sigmoid head.
`base_filters` scales the width. Seeded weights are bit-identical to the
JAX package's for the same seed.
"""

from __future__ import annotations

from shadernn_tpu_torch.graph.builder import GraphBuilder
from shadernn_tpu_torch.graph.ir import Graph


def _double_conv(b: GraphBuilder, x: str, filters: int, name: str) -> str:
    x = b.conv2d(x, filters, 3, activation="relu", name=f"{name}_conv1")
    return b.conv2d(x, filters, 3, activation="relu", name=f"{name}_conv2")


def build_unet(
    h: int = 256, w: int = 256, channels: int = 1, out_channels: int = 1,
    base_filters: int = 32, depth: int = 4, seed: int = 7767517,
) -> Graph:
    b = GraphBuilder("unet", seed=seed)
    x = b.input(h, w, channels, name="input")
    skips = []
    f = base_filters
    for d in range(depth):
        x = _double_conv(b, x, f, f"enc{d}")
        skips.append(x)
        x = b.maxpool(x, 2, 2, name=f"pool{d}")
        f *= 2
    x = _double_conv(b, x, f, "bottleneck")
    for d in reversed(range(depth)):
        f //= 2
        x = b.deconv(x, f, 2, stride=2, padding="same", name=f"up{d}")
        x = b.concat([skips[d], x], name=f"skip{d}")
        x = _double_conv(b, x, f, f"dec{d}")
    b.conv2d(x, out_channels, 1, activation="sigmoid", name="head")
    return b.build()
